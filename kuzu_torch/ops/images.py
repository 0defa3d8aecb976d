"""Image ingestion on the device (counterpart of ``kuzu/ops/images.py``)."""

from __future__ import annotations

import torch


def from_uint8(
    x: torch.Tensor,
    mean: float = 0.0,
    std: float = 1.0,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """uint8 pixels -> ``((x / 255) - mean) / std`` in ``dtype`` (f32 when
    None); float input is only cast to ``dtype``.

    The division runs in ``dtype`` itself, so a bf16 caller rounds as the
    JAX executor does (``x.astype(bf16) / 255``). The detectors use the
    defaults, the CRNN 0.5 / 0.5."""
    if x.dtype == torch.uint8:
        out = x.to(dtype or torch.float32) / 255.0
        if mean != 0.0 or std != 1.0:
            out = (out - mean) / std
        return out
    return x if dtype is None else x.to(dtype)
