"""Image resize / letterbox / normalize as f32 tensor functions on any
device (counterpart of ``kuzu/ops/letterbox.py``).

JAX's arithmetic, step for step: the gain is ``min(out_h / h, out_w / w)``
as an f32; the content size ``round(h * gain)`` rounds half to even in
both frameworks; the canvas is a gather resample at
``(i - floor(pad) + 0.5) / gain - 0.5`` (the division a product with the
f32 reciprocal, as XLA computes a division by a scalar) with the content
masked where that coordinate lies within ``[-0.5, size - 0.5]``. These are not the cv2-exact
byte resizes of ``kuzu_torch.data.image_io``, which stay separate.
"""

from __future__ import annotations

import numpy as np
import torch


def letterbox(
    image: torch.Tensor,
    out_h: int,
    out_w: int,
    fill: float = 114.0 / 255.0,
    method: str = "bilinear",
    center: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aspect-preserving resize of an (H, W, C) image onto an (out_h, out_w)
    canvas filled with ``fill`` (centred, or anchored top-left).

    Returns (canvas (out_h, out_w, C) f32, gain (f32 scalar), pad (2,) =
    (pad_x, pad_y), each floored). ``method`` is ``"bilinear"`` (on f32
    pixels) or ``"nearest"`` (in the image's dtype, the fill cast to it, as
    JAX's ``where``)."""
    h, w = image.shape[0], image.shape[1]
    dev = image.device
    f32 = torch.float32
    gain = torch.tensor(min(out_h / h, out_w / w), dtype=f32, device=dev)
    new_h = torch.round(h * gain).to(torch.int32)
    new_w = torch.round(w * gain).to(torch.int32)
    zero = torch.zeros((), dtype=f32, device=dev)
    pad_y = (out_h - new_h) / 2.0 if center else zero
    pad_x = (out_w - new_w) / 2.0 if center else zero

    inv = torch.reciprocal(gain)  # XLA divides by a scalar as a product with its reciprocal
    ys = (torch.arange(out_h, dtype=f32, device=dev) - torch.floor(pad_y) + 0.5) * inv - 0.5
    xs = (torch.arange(out_w, dtype=f32, device=dev) - torch.floor(pad_x) + 0.5) * inv - 0.5
    in_y = (ys >= -0.5) & (ys <= h - 0.5)
    in_x = (xs >= -0.5) & (xs <= w - 0.5)

    if method == "nearest":
        yi = torch.round(ys).to(torch.int64).clamp(0, h - 1)
        xi = torch.round(xs).to(torch.int64).clamp(0, w - 1)
        canvas = image[yi][:, xi]
    else:  # bilinear
        y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
        y1 = (y0 + 1).clamp(0, h - 1)
        x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
        x1 = (x0 + 1).clamp(0, w - 1)
        wy = (ys - y0.to(f32)).clamp(0.0, 1.0)[:, None, None]
        wx = (xs - x0.to(f32)).clamp(0.0, 1.0)[None, :, None]
        img = image.to(f32)
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        canvas = top * (1 - wy) + bot * wy

    mask = (in_y[:, None] & in_x[None, :])[..., None]
    canvas = torch.where(mask, canvas, torch.tensor(fill, dtype=f32).to(canvas.dtype).to(dev))
    return canvas.to(f32), gain, torch.stack([torch.floor(pad_x), torch.floor(pad_y)])


def resize_keep_aspect(
    image: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left anchored aspect-preserving resize with white fill (the TrOCR
    crop's ``ResizeWithPadding``). Returns (canvas, gain)."""
    canvas, gain, _ = letterbox(image, out_h, out_w, fill=1.0, method=method, center=False)
    return canvas, gain


def normalize_image(image: torch.Tensor, mean, std) -> torch.Tensor:
    """Channel normalize of an image in [0, 1], HWC or NHWC."""
    mean = torch.as_tensor(mean, dtype=image.dtype, device=image.device)
    std = torch.as_tensor(std, dtype=image.dtype, device=image.device)
    return (image - mean) / std


# Kuzushiji dataset channel statistics (numpy constants, as JAX's).
KUZUSHIJI_MEAN = np.array([0.75696, 0.71561, 0.63938], np.float32)
KUZUSHIJI_STD = np.array([0.19681, 0.20038, 0.24713], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
