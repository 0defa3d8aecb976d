"""Image ingestion and photometric augmentation on the device (counterpart
of ``kuzu/ops/images.py``)."""

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


def photometric_draws(x: torch.Tensor, generator: torch.Generator,
                      contrast: tuple[float, float] = (0.85, 1.15), brightness: float = 0.12,
                      noise: float = 0.04) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draws of :func:`photometric_aug` for batch ``x``, in the
    reference's order: a contrast factor and a brightness shift per sample
    (uniform, shape (B, 1, ..., 1)) and gaussian noise of x's shape scaled
    by ``noise``."""
    shp = (x.shape[0],) + (1,) * (x.dim() - 1)
    kw = dict(generator=generator, device=x.device, dtype=x.dtype)
    c = torch.rand(shp, **kw) * (contrast[1] - contrast[0]) + contrast[0]
    t = torch.rand(shp, **kw) * (2 * brightness) - brightness
    n = torch.randn(x.shape, **kw) * noise
    return c, t, n


def photometric_from_draws(x: torch.Tensor, c: torch.Tensor, t: torch.Tensor,
                           n: torch.Tensor) -> torch.Tensor:
    """``clip(x * c + t + n, 0, 1)``: the arithmetic of
    ``kuzu/ops/images.py::photometric_aug`` on given draws."""
    return torch.clamp(x * c + t + n, 0.0, 1.0)


def photometric_aug(x: torch.Tensor, generator: torch.Generator,
                    contrast: tuple[float, float] = (0.85, 1.15), brightness: float = 0.12,
                    noise: float = 0.04) -> torch.Tensor:
    """Per-sample contrast, brightness and gaussian noise on a [0, 1] float
    batch, drawn from ``generator`` (:func:`photometric_draws`, then
    :func:`photometric_from_draws`): the recognize trainer's on-device
    jitter."""
    return photometric_from_draws(x, *photometric_draws(x, generator, contrast, brightness,
                                                        noise))
