"""Box geometry on tensors (counterpart of ``kuzu/ops/boxes.py``).

``xyxy`` boxes are ``(x1, y1, x2, y2)``; ``xywh`` boxes are center-format.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """Center (x, y, w, h) -> corner (x1, y1, x2, y2). Works on (..., 4)."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, (..., 4) -> (...)."""
    wh = (box[..., 2:4] - box[..., 0:2]).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def box_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of two xyxy box sets: (N, 4) x (M, 4) -> (N, M).

    The operation order is the reference's: ``inter / ((a1 + a2 - inter) + EPS)``.
    """
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[:, None] + box_area(boxes2)[None, :] - inter
    return inter / (union + EPS)
