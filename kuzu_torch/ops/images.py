"""Image ingestion on the device (counterpart of ``kuzu/ops/images.py``)."""

from __future__ import annotations

import torch


def from_uint8(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """uint8 pixels -> ``x / 255`` in ``dtype`` (f32 when None); float input
    is only cast to ``dtype``.

    The division runs in ``dtype`` itself, so a bf16 caller rounds as the
    JAX executor does (``x.astype(bf16) / 255``). The reference's
    mean/std normalisation waits for the recognizer slice, its first user."""
    if x.dtype == torch.uint8:
        return x.to(dtype or torch.float32) / 255.0
    return x if dtype is None else x.to(dtype)
