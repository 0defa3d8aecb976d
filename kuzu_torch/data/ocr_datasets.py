"""The recognizers' crop reader (counterpart of ``kuzu/data/ocr_datasets.py``'s
``load_letterboxed``; the image-file datasets are not ported yet).

PIL's decode and ``BILINEAR`` resize are reproduced to the byte by
``image_io`` (``imread_rgb(backend="pil")``, ``resize_pil_bilinear_u8``), so
no PIL is needed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from kuzu_torch.data.image_io import imread_rgb, resize_pil_bilinear_u8
from kuzu_torch.data.loader import next_bucket


def _decoded(path) -> np.ndarray:
    if isinstance(path, np.ndarray):
        return path
    if hasattr(path, "convert") and hasattr(path, "size"):  # a PIL image
        return np.array(path.convert("RGB"))
    return imread_rgb(path, backend="pil")


def load_letterboxed(
    path: str | Path | np.ndarray,
    out_h: int,
    out_w: int,
    fill: int = 255,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Read -> aspect resize (PIL's BILINEAR) -> paste at the top left of a
    ``fill`` canvas -> uint8 (out_h, out_w, 3).

    ``path`` is an image file, a decoded uint8 (H, W, 3) RGB array or a PIL
    image. With ``rng``, the reference's geometric train-time jitter: the
    gain times U(0.82, 1.0), then the paste offset x in [0, out_w - nw] and
    y in [0, min(out_h - nh, 12)], drawn in that order.

    As the reference, a file that fails to read or resize gives the blank
    canvas (``except Exception``). An ``ImportError`` is raised instead: it
    says that this machine lacks the format's codec (JPEG, TIFF, WebP
    without PIL), not that the file is bad, and a blank crop would read as
    empty text."""
    try:
        img = _decoded(path)
        h, w = img.shape[:2]
        gain = min(out_h / h, out_w / w)
        ox = oy = 0
        if rng is not None:
            gain *= float(rng.uniform(0.82, 1.0))
            nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
            ox = int(rng.integers(0, max(out_w - nw, 0) + 1))
            oy = int(rng.integers(0, min(max(out_h - nh, 0), 12) + 1))
        nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
        resized = resize_pil_bilinear_u8(img, (nh, nw))
        arr = np.full((out_h, out_w, 3), fill, np.uint8)
        arr[oy:oy + nh, ox:ox + nw] = resized[:out_h - oy, :out_w - ox]
    except ImportError:
        raise
    except Exception:
        arr = np.full((out_h, out_w, 3), fill, np.uint8)
    return arr


def letterboxed_batch(source, image_size, min_bucket: int = 1) -> tuple[torch.Tensor, int]:
    """A recognizer predictor's input: one image (a path, or a decoded array)
    or a list of them, each through :func:`load_letterboxed` at
    ``image_size`` (H, W), the count padded with zero images to
    ``next_bucket``. Returns (uint8 (bucket, H, W, 3) on the CPU, the count
    of real images)."""
    items = list(source) if isinstance(source, (list, tuple)) else [source]
    images = np.stack([load_letterboxed(p, *image_size) for p in items])
    n = len(images)
    npad = next_bucket(n, min_bucket=min_bucket)
    if npad > n:
        images = np.concatenate([images, np.zeros_like(images[:1]).repeat(npad - n, 0)])
    return torch.from_numpy(images), n
