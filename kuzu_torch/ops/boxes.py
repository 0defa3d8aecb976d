"""Box geometry on tensors (counterpart of ``kuzu/ops/boxes.py``).

``xyxy`` boxes are ``(x1, y1, x2, y2)``; ``xywh`` boxes are center-format.
"""

from __future__ import annotations

import math

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
    """Pairwise IoU of two xyxy box sets: (..., N, 4) x (..., M, 4) ->
    (..., N, M), batched over the leading axes.

    The operation order is the reference's: ``inter / ((a1 + a2 - inter) + EPS)``.
    """
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return inter / (union + EPS)


def bbox_iou(
    box1: torch.Tensor,
    box2: torch.Tensor,
    xywh: bool = False,
    giou: bool = False,
    diou: bool = False,
    ciou: bool = False,
) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU between broadcast-compatible
    (..., 4) boxes, in the operation order of ``kuzu/ops/boxes.py::bbox_iou``.
    CIoU's ``alpha`` is a constant for the gradient (detached), as there."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1

    inter_w = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    inter_h = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = inter_w * inter_h
    union = w1 * h1 + w2 * h2 - inter + EPS
    iou = inter / union

    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing box w
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # enclosing box h
    if giou:
        c_area = cw * ch + EPS
        return iou - (c_area - union) / c_area

    c2 = cw * cw + ch * ch + EPS  # enclosing diagonal^2
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4.0
    if diou:
        return iou - rho2 / c2
    v = (4.0 / (math.pi**2)) * (torch.atan(w2 / (h2 + EPS)) - torch.atan(w1 / (h1 + EPS))) ** 2
    with torch.no_grad():
        # 0/0 guard where v = 0 and iou ~ 1, as the reference
        alpha = torch.where(v > 0, v / (v - iou + (1.0 + EPS)).clamp(min=EPS),
                            torch.zeros_like(v))
    return iou - (rho2 / c2 + v * alpha)
