"""DETR-style set-prediction detector (counterpart of
``kuzu/models/detr.py``): a strided ConvGN backbone, a transformer encoder
over the flattened features with 2D sin-cos positions, a decoder over
learned object queries, per-query class logits (with a no-object class)
and sigmoid cxcywh boxes.

Training matches queries to ground truths by the Hungarian algorithm
(scipy's ``linear_sum_assignment``, on the host, as JAX's
``pure_callback``): the cost matrix is copied to the host once a loss call.
Module and parameter names are the flax tree's (``down{i}``, ``proj``,
``enc{i}``, ``query_embed``, ``dec{i}``, ``norm``, ``cls``, ``box``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    DecoderBlock,
    EncoderBlock,
    dtype_products,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.models.unet_transformer import ConvGN
from kuzu_torch.ops.boxes import bbox_iou, xywh2xyxy
from kuzu_torch.ops.losses import softmax_cross_entropy_with_integer_labels

SIZE_REGISTRY: dict[str, dict] = {  # rfdetr-style nano -> large registry
    "nano": dict(dim=128, enc_depth=2, dec_depth=2, heads=4, queries=50),
    "small": dict(dim=192, enc_depth=3, dec_depth=3, heads=6, queries=100),
    "base": dict(dim=256, enc_depth=4, dec_depth=4, heads=8, queries=100),
    "large": dict(dim=384, enc_depth=6, dec_depth=6, heads=8, queries=300),
}


class DETR(nn.Module):
    """(B, H, W, C) images -> {'logits' (B, Q, nc + 1) f32, 'boxes' (B, Q, 4)
    normalized cxcywh f32}; class ``num_classes`` is no-object."""

    def __init__(self, num_classes: int, dim: int = 128, enc_depth: int = 2,
                 dec_depth: int = 2, heads: int = 4, queries: int = 50, downsamples: int = 4,
                 channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc_depth, self.dec_depth, self.downsamples, self.dtype = (
            enc_depth, dec_depth, downsamples, dtype)
        cin, ch = channels, 32
        for i in range(downsamples):
            self.add_module(f"down{i}", ConvGN(cin, min(ch, dim), 3, 2, dtype))
            cin, ch = min(ch, dim), ch * 2
        self.proj = Dense(cin, dim, dtype)
        for i in range(enc_depth):
            self.add_module(f"enc{i}", EncoderBlock(dim, heads, dtype=dtype))
        self.query_embed = nn.Parameter(torch.zeros(queries, dim))
        for i in range(dec_depth):
            self.add_module(f"dec{i}", DecoderBlock(dim, heads, dtype=dtype))
        self.norm = layer_norm(dim, dtype)
        self.cls = Dense(dim, num_classes + 1)  # f32
        self.box = Dense(dim, 4)  # f32

    def forward(self, images: torch.Tensor, train: bool = False) -> dict[str, torch.Tensor]:
        with dtype_products(self.dtype):
            x = images.permute(0, 3, 1, 2)
            for i in range(self.downsamples):
                x = getattr(self, f"down{i}")(x)
            b, c, h, w = x.shape
            tokens = self.proj(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
            pos = torch.from_numpy(sincos_2d_pos_embed(tokens.shape[-1], h, w))
            tokens = tokens + pos.to(tokens.device, tokens.dtype)[None]
            for i in range(self.enc_depth):
                tokens = getattr(self, f"enc{i}")(tokens, train=train)
            qx = self.query_embed[None].expand(b, -1, -1).to(tokens.dtype)
            for i in range(self.dec_depth):
                qx = getattr(self, f"dec{i}")(qx, tokens, train=train)
            qx = self.norm(qx)
            logits, boxes = self.cls(qx), torch.sigmoid(self.box(qx))
        return {"logits": logits, "boxes": boxes}


def _hungarian_host(cost: np.ndarray) -> np.ndarray:
    """(B, Q, M) cost -> (B, M) query index assigned to each ground-truth slot."""
    from scipy.optimize import linear_sum_assignment

    b, _, m = cost.shape
    out = np.zeros((b, m), np.int32)
    for i in range(b):
        rows, cols = linear_sum_assignment(cost[i])
        out[i, cols] = rows
    return out


def _cxcywh(gt_boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([(gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2,
                      gt_boxes[..., 2:] - gt_boxes[..., :2]], dim=-1)


def detr_cost(outputs: dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              mask_gt: torch.Tensor, num_classes: int, cls_w: float = 1.0, l1_w: float = 5.0,
              giou_w: float = 2.0) -> torch.Tensor:
    """The matching cost (B, Q, M): class probability, L1 over cxcywh and
    GIoU; padded ground-truth slots cost a flat 1e4."""
    logits, pred_boxes = outputs["logits"], outputs["boxes"]
    q = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    cls_idx = gt_labels.clamp(0, num_classes - 1).long()
    cost_cls = -probs.gather(2, cls_idx[:, None, :].expand(-1, q, -1))
    cost_l1 = (pred_boxes[:, :, None, :] - _cxcywh(gt_boxes)[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_boxes)[:, :, None, :], gt_boxes[:, None, :, :], giou=True)
    cost = cls_w * cost_cls + l1_w * cost_l1 + giou_w * (-giou)
    return torch.where(mask_gt[:, None, :], cost, 1e4)


def detr_loss(outputs: dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              mask_gt: torch.Tensor, num_classes: int, cls_w: float = 1.0, l1_w: float = 5.0,
              giou_w: float = 2.0, noobj_w: float = 0.1,
              assign: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Set-prediction loss over (B, M) ground truths (normalized xyxy,
    labels, validity): Hungarian matching on :func:`detr_cost` (or the
    given ``assign``, (B, M) query indices), then weighted cross-entropy
    (no-object at ``noobj_w``), L1 and GIoU on the matched queries.
    Returns (loss, metrics)."""
    logits, pred_boxes = outputs["logits"], outputs["boxes"]
    b, q, _ = logits.shape
    if assign is None:
        cost = detr_cost(outputs, gt_boxes, gt_labels, mask_gt, num_classes, cls_w, l1_w, giou_w)
        assign = torch.from_numpy(_hungarian_host(cost.detach().cpu().numpy()))
    assign = torch.as_tensor(assign).to(logits.device).long()
    cls_idx = gt_labels.clamp(0, num_classes - 1).long()
    targets = torch.full((b, q), num_classes, dtype=torch.long, device=logits.device)
    targets = targets.scatter(1, assign, torch.where(mask_gt, cls_idx, num_classes))
    ce = softmax_cross_entropy_with_integer_labels(logits, targets)
    weights = torch.where(targets == num_classes, noobj_w, 1.0)
    cls_loss = (ce * weights).sum() / weights.sum()
    matched = pred_boxes.gather(1, assign[..., None].expand(-1, -1, 4))  # (B, M, 4)
    m = mask_gt.float()
    n_gt = mask_gt.sum().clamp(min=1)
    l1 = ((matched - _cxcywh(gt_boxes)).abs().sum(-1) * m).sum() / n_gt
    giou_loss = ((1.0 - bbox_iou(xywh2xyxy(matched), gt_boxes, giou=True)) * m).sum() / n_gt
    total = cls_w * cls_loss + l1_w * l1 + giou_w * giou_loss
    return total, {"cls_loss": cls_loss, "l1_loss": l1, "giou_loss": giou_loss}


def detr_postprocess(outputs: dict[str, torch.Tensor], conf: float = 0.5,
                     image_size: int = 1) -> dict[str, torch.Tensor]:
    """Each query's most probable real class (no NMS): boxes xyxy in pixels
    of ``image_size``, scores, classes, and ``valid`` where the score
    passes ``conf``."""
    probs = torch.softmax(outputs["logits"], dim=-1)[..., :-1]
    scores, classes = probs.amax(dim=-1), probs.argmax(dim=-1)
    boxes = xywh2xyxy(outputs["boxes"]) * image_size
    return {"boxes": boxes, "scores": scores, "classes": classes, "valid": scores > conf}
