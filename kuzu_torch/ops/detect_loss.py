"""v8-style detection loss: BCE classes + CIoU boxes + DFL over TAL targets
(counterpart of ``kuzu/ops/detect_loss.py``).

Class BCE against the task-aligned soft targets over every anchor; CIoU and
distribution-focal loss on the foreground anchors weighted by their target
scores; all three normalised by ``max(sum(target_scores), 1)``. The loss runs
in f32 whatever the maps' dtype, and the assigner sees detached scores and
boxes. GTs arrive padded (B, M, 4) with a mask. :func:`e2e_detection_loss`
is yolov10's dual-head loss.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from kuzu_torch.models.yolo.modules import dfl_expectation
from kuzu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from kuzu_torch.ops.assigner import task_aligned_assign
from kuzu_torch.ops.boxes import bbox_iou

REG_MAX = 16


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int = REG_MAX):
    """Distribution focal loss, (N, 4, reg_max) logits and (N, 4) targets
    -> (N,): cross-entropy against the two integer bins around the target,
    linearly weighted."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    tl, tr = tl.clamp(0, reg_max - 1), tr.clamp(0, reg_max - 1)
    logits = pred_dist.reshape(-1, reg_max)
    ce_l = F.cross_entropy(logits, tl.reshape(-1), reduction="none").view_as(target)
    ce_r = F.cross_entropy(logits, tr.reshape(-1), reduction="none").view_as(target)
    return (ce_l * wl + ce_r * wr).mean(-1)


def detection_loss(
    feats: Sequence[torch.Tensor],  # per-level raw maps (B, H, W, 4*reg_max + nc)
    gt_labels: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy px
    mask_gt: torch.Tensor,  # (B, M) bool
    nc: int,
    imgsz: int,
    strides: Sequence[int],
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    topk: int = 10,
    return_assign: bool = False,
    reg_max: int = REG_MAX,
):
    """(total, metrics). Anchors come from the maps' own shapes; ``imgsz``
    is kept for the JAX signature. ``return_assign`` adds a third item, the
    assignment with ``score_sum``, for the losses that pair each anchor with
    its matched GT (segmentation, pose)."""
    b = feats[0].shape[0]
    cat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1).float()
    pred_dist = cat[..., : 4 * reg_max]
    pred_logits = cat[..., 4 * reg_max:]

    feat_shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchor_points, stride_t = make_anchors(feat_shapes, list(strides), device=cat.device)

    dist = dfl_expectation(pred_dist, reg_max)
    pred_bboxes_px = dist2bbox(dist, anchor_points[None], xywh=False) * stride_t[None]
    anc_px = anchor_points * stride_t

    pd_scores = torch.sigmoid(pred_logits)
    assign = task_aligned_assign(
        pd_scores.detach(), pred_bboxes_px.detach(), anc_px, gt_labels,
        gt_bboxes.float(), mask_gt, topk=topk, num_classes=nc)
    target_scores = assign["target_scores"]
    fg = assign["fg_mask"]
    score_sum = target_scores.sum().clamp(min=1.0)

    cls_loss = F.binary_cross_entropy_with_logits(
        pred_logits, target_scores, reduction="none").sum() / score_sum

    weight = target_scores.sum(-1) * fg  # (B, A)
    iou = bbox_iou(pred_bboxes_px, assign["target_bboxes"], ciou=True)
    box_loss = ((1.0 - iou) * weight).sum() / score_sum

    target_dist = bbox2dist(assign["target_bboxes"] / stride_t[None], anchor_points[None],
                            reg_max)
    dfl = dfl_loss(pred_dist.reshape(-1, 4, reg_max), target_dist.reshape(-1, 4),
                   reg_max).reshape(b, -1)
    dfl_l = (dfl * weight).sum() / score_sum

    total = box_w * box_loss + cls_w * cls_loss + dfl_w * dfl_l
    metrics = {
        "box_loss": box_loss.detach(),
        "cls_loss": cls_loss.detach(),
        "dfl_loss": dfl_l.detach(),
        "num_fg": fg.sum().float() / b,
    }
    if return_assign:
        return total, metrics, {**assign, "score_sum": score_sum}
    return total, metrics


def e2e_detection_loss(
    feats: dict,  # {"one2many": maps, "one2one": maps}
    gt_labels: torch.Tensor,
    gt_bboxes: torch.Tensor,
    mask_gt: torch.Tensor,
    nc: int,
    imgsz: int,
    strides: Sequence[int],
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    reg_max: int = REG_MAX,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """yolov10's dual-head loss (``kuzu/ops/detect_loss.py::
    e2e_detection_loss``): :func:`detection_loss` of the one2many maps at
    TAL top-10 plus that of the one2one maps at top-1; each metric is the
    two heads' sum. The one2one head read detached features, so its term
    trains that head alone."""
    kw = dict(nc=nc, imgsz=imgsz, strides=strides, box_w=box_w, cls_w=cls_w, dfl_w=dfl_w,
              reg_max=reg_max)
    t_m, m_m = detection_loss(feats["one2many"], gt_labels, gt_bboxes, mask_gt, topk=10, **kw)
    t_o, m_o = detection_loss(feats["one2one"], gt_labels, gt_bboxes, mask_gt, topk=1, **kw)
    return t_m + t_o, {k: m_m[k] + m_o[k] for k in m_m}
