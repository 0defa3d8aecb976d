"""The YOLO-format detection data's letterbox (counterpart of
``kuzu/data/yolo_dataset.py``'s ``letterbox_np``; its folder dataset and
augmentations are not ported yet).

The resize is cv2's ``INTER_LINEAR`` to the byte (``image_io.resize_linear_u8``),
so a frame letterboxes the same on the CPU, on the card and in the JAX
package's cv2 call.
"""

from __future__ import annotations

import numpy as np
import torch

from kuzu_torch.data.image_io import resize_linear_u8


def letterbox_np(img, size: int | tuple[int, int], fill: int = 114):
    """Letterbox an (H, W, 3) uint8 image (an ndarray, or a tensor on any
    device) to (size, size) or (h, w): resized by the gain min(th / H, tw /
    W) to (round(H gain), round(W gain)) (at least 1), centred on a ``fill``
    canvas. Returns (canvas of the input's kind, gain, (pad_x, pad_y))."""
    th, tw = (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))
    h, w = img.shape[:2]
    gain = min(th / h, tw / w)
    nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
    resized = resize_linear_u8(img, (nh, nw))
    px, py = (tw - nw) // 2, (th - nh) // 2
    if isinstance(img, np.ndarray):
        canvas = np.full((th, tw, 3), fill, np.uint8)
    else:
        canvas = torch.full((th, tw, 3), fill, dtype=torch.uint8, device=img.device)
    canvas[py:py + nh, px:px + nw] = resized
    return canvas, gain, (px, py)
