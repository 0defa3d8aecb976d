"""Oriented-bounding-box math: probIoU, the rotated decode, rotated NMS and
the OBB loss (counterpart of ``kuzu/ops/obb.py``).

Rotated boxes travel as (..., 5) xywhr tensors (angle in radians). Every
expression is JAX's, in its order of operations, so the f32 results part
from JAX's only where the two libraries' ``cos`` / ``sin`` / ``log`` /
``exp`` / ``sqrt`` round differently (an ulp).

The rotated NMS keeps JAX's greedy keep: candidate i survives iff it is
valid and no surviving j < i of its class has probIoU(j, i) above the
threshold. JAX scans the candidates one by one; here the probIoU matrix of
the top ``k`` candidates is built in one batched pass and the keep is
resolved as the fixed point of ``keep = valid & ~any_j(keep_j & S_ji)``
over the strictly upper triangle ``S`` (:func:`greedy_keep`): iterated from
``keep = valid``, the first t candidates are final after t passes, and a
pass that changes nothing ends it, so the passes number the longest chain
of suppressions plus one, not ``k``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from kuzu_torch.models.yolo.modules import dfl_expectation
from kuzu_torch.ops.anchors import bbox2dist, make_anchors
from kuzu_torch.ops.assigner import task_aligned_assign
from kuzu_torch.ops.detect_loss import REG_MAX, dfl_loss
from kuzu_torch.ops.nms import _top_k


def _covariance(boxes: torch.Tensor):
    """(..., 5) xywhr -> (a, b, c) gaussian covariance terms."""
    a = boxes[..., 2] ** 2 / 12.0
    b = boxes[..., 3] ** 2 / 12.0
    r = boxes[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos ** 2, sin ** 2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU between rboxes (broadcasting over leading dims)."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _covariance(obb1)
    a2, b2, c2 = _covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 ** 2).clamp(min=0.0)
    det2 = (a2 * b2 - c2 ** 2).clamp(min=0.0)
    t3 = 0.5 * torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                         / (4 * torch.sqrt(det1 * det2) + eps) + eps)
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor,
              anchor_points: torch.Tensor) -> torch.Tensor:
    """Rotated decode: the lt/rb offset (grid units) rotated by the angle
    around the anchor; (..., 4) xywh (the angle travels separately)."""
    lt, rb = pred_dist[..., :2], pred_dist[..., 2:]
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    f = (rb - lt) / 2.0
    xf, yf = f[..., :1], f[..., 1:]
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def rbox_corners(rboxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) xywhr -> (..., 4, 2) corner points."""
    ctr = rboxes[..., None, :2]
    w, h, r = rboxes[..., 2], rboxes[..., 3], rboxes[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    vec1 = torch.stack([w / 2 * cos, w / 2 * sin], -1)[..., None, :]
    vec2 = torch.stack([-h / 2 * sin, h / 2 * cos], -1)[..., None, :]
    signs = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]],
                         dtype=rboxes.dtype, device=rboxes.device)
    return ctr + signs[..., :1] * vec1 + signs[..., 1:] * vec2


def anchors_in_rboxes(anc_points: torch.Tensor, gt_rboxes: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) x (B, M, 5) -> (B, M, A) bool: the anchor centre inside the
    rotated box, tested in the box's own frame."""
    d = anc_points[None, None] - gt_rboxes[..., None, :2]  # (B, M, A, 2)
    r = gt_rboxes[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)  # (B, M, 1)
    u = d[..., 0] * cos + d[..., 1] * sin
    v = -d[..., 0] * sin + d[..., 1] * cos
    return ((u.abs() < gt_rboxes[..., None, 2] / 2 - eps)
            & (v.abs() < gt_rboxes[..., None, 3] / 2 - eps))


def greedy_keep(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep of score-sorted candidates: (B, k, k) ``over[i, j]``
    (i would suppress j: above the threshold, same class) and (B, k) valid ->
    (B, k) keep, equal to the scan ``kuzu/ops/obb.py:134-143``. Resolved as
    the fixed point described in the module docstring; each pass is one
    batched product over the strictly upper triangle."""
    k = over.shape[-1]
    s = (over & torch.ones(k, k, dtype=torch.bool, device=over.device).triu(1)).to(
        torch.float32)
    keep = valid
    for _ in range(k + 1):
        hit = torch.bmm(keep.to(torch.float32)[:, None, :], s)[:, 0] > 0
        nxt = valid & ~hit
        if torch.equal(nxt, keep):
            return keep
        keep = nxt
    raise AssertionError("greedy keep did not converge")  # at most k + 1 passes


def nms_rotated_padded(
    rboxes: torch.Tensor,  # (B, N, 5) xywhr
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_det: int = 300,
    max_nms: int = 2048,
) -> dict[str, torch.Tensor]:
    """Greedy rotated NMS over the probIoU matrix: padded, score-sorted
    ``boxes`` (B, max_det, 5), ``scores``, ``classes``, ``valid``. Every
    top-k is a stable descending sort (ties to the lower index, as
    ``lax.top_k``)."""
    n = rboxes.shape[1]
    scores = torch.where(valid & (scores > score_threshold), scores,
                         torch.full_like(scores, -1.0))
    k = min(max_nms, n)
    top_scores, order = _top_k(scores, k)
    top_boxes = torch.gather(rboxes, 1, order[..., None].expand(-1, -1, 5))
    top_classes = torch.gather(classes, 1, order)
    top_valid = top_scores > 0.0

    iou = probiou(top_boxes[:, :, None], top_boxes[:, None, :])  # (B, k, k)
    same_cls = top_classes[:, :, None] == top_classes[:, None, :]
    keep = greedy_keep((iou > iou_threshold) & same_cls, top_valid) & top_valid

    kept_scores = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    out_scores, kept_order = _top_k(kept_scores, min(max_det, k))
    out_boxes = torch.gather(top_boxes, 1, kept_order[..., None].expand(-1, -1, 5))
    out_classes = torch.gather(top_classes, 1, kept_order)
    out_valid = out_scores > 0.0
    pad = max_det - k
    if pad > 0:
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_scores = F.pad(out_scores, (0, pad), value=-1.0)
        out_classes = F.pad(out_classes, (0, pad))
        out_valid = F.pad(out_valid, (0, pad))
    return {
        "boxes": torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes)),
        "scores": torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
        "classes": torch.where(out_valid, out_classes, torch.zeros_like(out_classes)),
        "valid": out_valid,
    }


def obb_loss(
    outputs: dict,  # {"det": maps, "angle": (B, A, 1)}
    gt_labels: torch.Tensor,  # (B, M)
    gt_rboxes: torch.Tensor,  # (B, M, 5) xywhr px
    mask_gt: torch.Tensor,  # (B, M)
    nc: int,
    imgsz: int,
    strides: Sequence[int],
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    topk: int = 10,
    reg_max: int = REG_MAX,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """v8's OBB loss: BCE classes over the rotated TAL assignment, probIoU
    boxes and DFL on the unrotated ltrb distances, each normalised by
    ``max(sum(target_scores), 1)``; in f32."""
    feats = outputs["det"]
    angle = outputs["angle"].float()
    b = feats[0].shape[0]
    cat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1).float()
    pred_dist = cat[..., : 4 * reg_max]
    pred_logits = cat[..., 4 * reg_max:]

    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchor_points, stride_t = make_anchors(shapes, list(strides), device=cat.device)

    dist = dfl_expectation(pred_dist, reg_max)
    pred_rboxes = torch.cat([dist2rbox(dist, angle, anchor_points[None]), angle], -1)
    pred_rboxes_px = torch.cat([pred_rboxes[..., :4] * stride_t[None], angle], -1)
    anc_px = anchor_points * stride_t

    pd_scores = torch.sigmoid(pred_logits)
    assign = task_aligned_assign(
        pd_scores.detach(), pred_rboxes_px.detach(), anc_px, gt_labels, gt_rboxes.float(),
        mask_gt, topk=topk, num_classes=nc, rotated=True)
    target_scores = assign["target_scores"]
    fg = assign["fg_mask"]
    tgt = assign["target_bboxes"]  # (B, A, 5) px

    score_sum = target_scores.sum().clamp(min=1.0)
    cls_loss = F.binary_cross_entropy_with_logits(
        pred_logits, target_scores, reduction="none").sum() / score_sum

    weight = target_scores.sum(-1) * fg
    tgt_grid = torch.cat([tgt[..., :4] / stride_t[None], tgt[..., 4:]], -1)
    iou = probiou(pred_rboxes, tgt_grid)
    box_loss = ((1.0 - iou) * weight).sum() / score_sum

    # DFL on the unrotated xywh -> ltrb distances
    cx, cy, w, h = (tgt_grid[..., i] for i in range(4))
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    target_dist = bbox2dist(xyxy, anchor_points[None], reg_max)
    dfl = dfl_loss(pred_dist.reshape(-1, 4, reg_max), target_dist.reshape(-1, 4),
                   reg_max).reshape(b, -1)
    dfl_l = (dfl * weight).sum() / score_sum

    total = box_w * box_loss + cls_w * cls_loss + dfl_w * dfl_l
    return total, {
        "box_loss": box_loss.detach(),
        "cls_loss": cls_loss.detach(),
        "dfl_loss": dfl_l.detach(),
        "num_fg": fg.sum().float() / b,
    }
