"""Instance-segmentation loss: the v8 detect loss plus the prototype-mask
BCE (counterpart of ``kuzu/ops/seg_loss.py``).

The mask term composes each foreground anchor's mask from its predicted
coefficients and the shared prototypes (``coeffs @ protos``), takes the
BCE against its matched GT instance, crops the loss to the target box,
divides by the normalised box area and averages over foreground anchors.

As in JAX, a fixed ``max_fg`` anchors per image are selected by a top-k
over the 0/1 foreground mask, almost all ties: the top-k is a stable
descending sort, so the selected anchors are JAX's (``lax.top_k`` takes
tied entries lowest index first). The clipped share is the
``seg_fg_dropped`` metric. GT masks arrive as one overlap-index map per
image ((B, Hm, Wm) int, 0 background, i + 1 instance i).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from kuzu_torch.models.layers import f32_products
from kuzu_torch.ops.detect_loss import detection_loss
from kuzu_torch.ops.nms import _top_k


def crop_loss_to_box(loss: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero the per-pixel (..., H, W) loss outside the (..., 4) xyxy box
    (mask pixels)."""
    h, w = loss.shape[-2], loss.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=loss.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=loss.device)[None, :]
    x1, y1, x2, y2 = (boxes[..., i][..., None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return loss * inside


def segmentation_loss(
    outputs: dict,  # {"det": maps, "coeffs": (B, A, nm), "protos": (B, Hp, Wp, nm)}
    gt_labels: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy px
    gt_masks: torch.Tensor,  # (B, Hm, Wm) int overlap-index map
    mask_gt: torch.Tensor,  # (B, M)
    nc: int,
    imgsz: int,
    strides: Sequence[int],
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    max_fg: int = 128,
    reg_max: int = 16,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total, metrics): the detect loss plus ``box_w`` times the mask term."""
    feats = outputs["det"]
    coeffs = outputs["coeffs"].float()
    protos = outputs["protos"].float()
    b, a, nm = coeffs.shape
    hp, wp = protos.shape[1], protos.shape[2]

    det_total, metrics, assign = detection_loss(
        feats, gt_labels, gt_bboxes, mask_gt, nc=nc, imgsz=imgsz, strides=strides,
        box_w=box_w, cls_w=cls_w, dfl_w=dfl_w, reg_max=reg_max, return_assign=True)
    fg = assign["fg_mask"].float()
    tgt_idx = assign["target_gt_idx"]
    tgt_boxes = assign["target_bboxes"]

    k = min(max_fg, a)
    sel_fg, sel_idx = _top_k(fg, k)  # (B, K)
    sel_coeff = torch.gather(coeffs, 1, sel_idx[..., None].expand(-1, -1, nm))
    sel_gt = torch.gather(tgt_idx, 1, sel_idx)
    sel_box = torch.gather(tgt_boxes, 1, sel_idx[..., None].expand(-1, -1, 4))

    with f32_products():  # JAX's preferred_element_type=f32
        pred = torch.einsum("bkn,bhwn->bkhw", sel_coeff, protos)

    if gt_masks.shape[1] != hp or gt_masks.shape[2] != wp:  # nearest, by stride
        ry, rx = gt_masks.shape[1] // hp, gt_masks.shape[2] // wp
        gt_small = gt_masks[:, ::ry, ::rx][:, :hp, :wp]
    else:
        gt_small = gt_masks
    gt = (gt_small[:, None] == (sel_gt[..., None, None] + 1)).float()  # (B, K, Hp, Wp)
    bce = F.binary_cross_entropy_with_logits(pred, gt, reduction="none")

    norm_box = sel_box / imgsz
    mask_box = norm_box * torch.tensor([wp, hp, wp, hp], dtype=torch.float32,
                                       device=norm_box.device)
    area = ((norm_box[..., 2] - norm_box[..., 0])
            * (norm_box[..., 3] - norm_box[..., 1])).clamp(min=1e-4)
    per_anchor = crop_loss_to_box(bce, mask_box).mean((-2, -1)) / area  # (B, K)

    n_fg = fg.sum().clamp(min=1.0)
    seg = (per_anchor * sel_fg).sum() / n_fg
    dropped = (fg.sum() - sel_fg.sum()).clamp(min=0.0) / n_fg
    metrics = dict(metrics)
    metrics["seg_loss"] = seg.detach()
    metrics["seg_fg_dropped"] = dropped
    return det_total + box_w * seg, metrics
