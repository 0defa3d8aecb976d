"""Task-aligned assigner (TAL) on padded tensors (counterpart of
``kuzu/ops/assigner.py``).

Align metric ``score^alpha * CIoU^beta`` (alpha 0.5, beta 6), the top-k (10)
candidates per GT among the anchors whose center lies inside the GT box,
anchors claimed by several GTs kept by the GT of highest overlap, and target
scores normalised per GT by ``max_overlap / max_align``. GTs arrive padded
as (B, M, 4) with a validity mask; outputs are dense (B, A, ...) tensors.

At the character detector's shapes (B=8, M=400, A=34,000) each (B, M, A)
f32 tensor is 435 MB, so the top-k loop works in place on one of them and
marks its picks by scatter instead of building a (B, M, A) comparison per
pass. Plain PyTorch: the assigner is not a kernel in the JAX package either.
"""

from __future__ import annotations

import torch

from kuzu_torch.ops.boxes import bbox_iou

EPS = 1e-9


def anchors_in_gts(anc_points: torch.Tensor, gt_bboxes: torch.Tensor,
                   eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) x (B, M, 4) -> (B, M, A) bool: anchor center inside GT box."""
    x, y = anc_points[:, 0], anc_points[:, 1]
    x1, y1, x2, y2 = (gt_bboxes[..., i: i + 1] for i in range(4))  # (B, M, 1)
    return (x - x1 > eps) & (y - y1 > eps) & (x2 - x > eps) & (y2 - y > eps)


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid probabilities
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy px, or (B, A, 5) xywhr (rotated)
    anc_points: torch.Tensor,  # (A, 2) px
    gt_labels: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4|5) px (zero rows for padding)
    mask_gt: torch.Tensor,  # (B, M) bool
    topk: int = 10,
    num_classes: int = 80,
    alpha: float = 0.5,
    beta: float = 6.0,
    rotated: bool = False,
) -> dict[str, torch.Tensor]:
    """Dense padded targets: ``target_labels`` (B, A) (``nc`` for
    background), ``target_bboxes`` (B, A, 4), ``target_scores`` (B, A, nc),
    ``fg_mask`` (B, A) and ``target_gt_idx`` (B, A).

    ``rotated=True`` is the rotated assigner of the OBB loss: boxes are
    (..., 5) xywhr, the overlaps probIoU, the candidate gate the anchor
    centre inside the rotated box."""
    b, a, nc = pd_scores.shape
    m = gt_labels.shape[1]
    gt_labels = gt_labels.long()
    mask_gt = mask_gt.bool()

    if rotated:
        from kuzu_torch.ops.obb import anchors_in_rboxes, probiou

        in_gts = anchors_in_rboxes(anc_points, gt_bboxes)
        overlaps = probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
    else:
        in_gts = anchors_in_gts(anc_points, gt_bboxes)
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], ciou=True)
    valid = in_gts & mask_gt[..., None]  # (B, M, A)
    overlaps = overlaps.clamp_(min=0.0)
    # scores of each anchor at the GT's class
    cls_idx = gt_labels.clamp(0, nc - 1)
    bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                               cls_idx[:, :, None].expand(-1, -1, a))  # (B, M, A)
    align = bbox_scores.pow(alpha) * overlaps.pow(beta)
    align = torch.where(valid, align, torch.zeros((), dtype=align.dtype, device=align.device))
    del bbox_scores

    # top-k anchors per GT by k argmax passes, the first index winning ties
    # (torch.argmax's documented rule, lax.argmax's too); no metric
    # threshold, so a cold start still assigns its in-GT candidates
    k = min(topk, a)
    topk_mask = torch.zeros(align.shape, dtype=torch.bool, device=align.device)
    work = align.clone()
    for _ in range(k):
        idx = work.argmax(dim=-1, keepdim=True)  # (B, M, 1)
        topk_mask.scatter_(-1, idx, True)
        work.scatter_(-1, idx, -1.0)  # align >= 0 everywhere
    del work
    mask_pos = topk_mask & valid
    del topk_mask, valid

    # an anchor claimed by several GTs keeps the GT of highest overlap
    claims = mask_pos.sum(dim=1)  # (B, A)
    best_gt = torch.where(mask_pos, overlaps, -1.0).argmax(dim=1)  # (B, A)
    one_best = best_gt[:, None, :] == torch.arange(m, device=best_gt.device)[None, :, None]
    mask_pos = torch.where((claims > 1)[:, None, :], one_best & mask_pos, mask_pos)
    del one_best

    fg_mask = mask_pos.any(dim=1)  # (B, A)
    # one claiming GT per anchor now: its row (0 for background)
    target_gt_idx = mask_pos.to(torch.uint8).argmax(dim=1)  # (B, A)
    target_labels = torch.gather(gt_labels, 1, target_gt_idx)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(
        -1, -1, gt_bboxes.shape[-1]))

    # normalised target scores
    zero = torch.zeros((), dtype=align.dtype, device=align.device)
    align_pos = torch.where(mask_pos, align, zero)
    pos_align = align_pos.amax(dim=-1, keepdim=True)  # (B, M, 1)
    pos_overlap = torch.where(mask_pos, overlaps, zero).amax(dim=-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + EPS)).amax(dim=1)  # (B, A)

    target_scores = torch.nn.functional.one_hot(target_labels.clamp(0, nc - 1), nc).to(
        pd_scores.dtype)
    target_scores = target_scores * (norm * fg_mask)[..., None]
    return {
        "target_labels": torch.where(fg_mask, target_labels, torch.full_like(target_labels, nc)),
        "target_bboxes": target_bboxes,
        "target_scores": target_scores,
        "fg_mask": fg_mask,
        "target_gt_idx": target_gt_idx,
    }
