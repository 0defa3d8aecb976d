"""Photometric and structural augmentations beyond the v8 core set
(counterpart of ``kuzu/data/augment_extra.py``): Gaussian noise, motion
blur, grid distortion and coarse dropout on RGB uint8 images, each drawing
from an ``np.random.Generator`` in the reference's order. cv2's
``filter2D`` and ``remap`` are ``data/image_io.py``'s, the same bytes.

JPEG compression needs a JPEG codec, which the card's machine lacks: where
it is drawn (``p_jpeg > 0``) it raises ``NotImplementedError``; its default
probability is 0.
"""

from __future__ import annotations

import numpy as np

from kuzu_torch.data import image_io as io


def gauss_noise(img: np.ndarray, rng: np.random.Generator, sigma: float = 12.0) -> np.ndarray:
    noise = rng.normal(0, sigma, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def motion_blur(img: np.ndarray, rng: np.random.Generator, max_ksize: int = 7) -> np.ndarray:
    """A k x k one-line kernel (k odd in [3, max_ksize]), horizontal or
    vertical at even odds, through cv2's ``filter2D``."""
    k = int(rng.integers(3, max_ksize + 1)) | 1
    kernel = np.zeros((k, k), np.float32)
    if rng.random() < 0.5:
        kernel[k // 2, :] = 1.0 / k
    else:
        kernel[:, k // 2] = 1.0 / k
    return io.filter2d_u8(img, kernel)


def jpeg_compression(img: np.ndarray, rng: np.random.Generator, quality_range=(40, 90)):
    raise NotImplementedError(
        "jpeg_compression encodes and decodes JPEG, which needs a JPEG codec (cv2's "
        "libjpeg in the reference); the port has none (ROADMAP: nvJPEG), so set jpeg=0")


def grid_distortion(img: np.ndarray, rng: np.random.Generator, num_steps: int = 5,
                    distort: float = 0.3) -> np.ndarray:
    """Piecewise-linear warp over a grid of ``num_steps`` cells a side
    (cv2's ``remap``, ``BORDER_REFLECT``)."""
    h, w = img.shape[:2]
    xs = np.linspace(0, w, num_steps + 1)
    ys = np.linspace(0, h, num_steps + 1)
    jx = xs + rng.uniform(-distort, distort, xs.shape) * (w / num_steps)
    jy = ys + rng.uniform(-distort, distort, ys.shape) * (h / num_steps)
    jx[0], jx[-1], jy[0], jy[-1] = 0, w, 0, h
    map_x = np.interp(np.arange(w), xs, jx).astype(np.float32)
    map_y = np.interp(np.arange(h), ys, jy).astype(np.float32)
    grid_x = np.tile(map_x, (h, 1))
    grid_y = np.tile(map_y[:, None], (1, w))
    return io.remap_linear_u8(img, grid_x, grid_y)


def coarse_dropout(img: np.ndarray, rng: np.random.Generator, max_holes: int = 8,
                   max_frac: float = 0.08, fill: int = 114) -> np.ndarray:
    out = img.copy()
    h, w = img.shape[:2]
    for _ in range(int(rng.integers(1, max_holes + 1))):
        hw = int(rng.uniform(0.02, max_frac) * w)
        hh = int(rng.uniform(0.02, max_frac) * h)
        x = int(rng.integers(0, max(w - hw, 1)))
        y = int(rng.integers(0, max(h - hh, 1)))
        out[y:y + hh, x:x + hw] = fill
    return out


def apply_photometric(img: np.ndarray, rng: np.random.Generator, p_noise: float = 0.0,
                      p_blur: float = 0.0, p_jpeg: float = 0.0, p_distort: float = 0.0,
                      p_dropout: float = 0.0) -> np.ndarray:
    """The extras with per-op probabilities, in the reference's order."""
    if p_noise and rng.random() < p_noise:
        img = gauss_noise(img, rng)
    if p_blur and rng.random() < p_blur:
        img = motion_blur(img, rng)
    if p_jpeg and rng.random() < p_jpeg:
        img = jpeg_compression(img, rng)
    if p_distort and rng.random() < p_distort:
        img = grid_distortion(img, rng)
    if p_dropout and rng.random() < p_dropout:
        img = coarse_dropout(img, rng)
    return img
