"""Keypoint (pose) loss: the v8 detect loss plus the OKS location loss and
the visibility BCE (counterpart of ``kuzu/ops/pose_loss.py``).

Each anchor's decoded keypoints (grid units) are held against its matched
GT instance's through the COCO-eval OKS Gaussian ``1 - exp(-d^2 / (2
sigma)^2 / (2 area))``, masked by visibility, plus the BCE of the
visibility logit; the gather runs over every anchor with
``target_gt_idx`` and the foreground mask weights the sums.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from kuzu_torch.models.yolo.modules import kpts_decode
from kuzu_torch.ops.anchors import make_anchors
from kuzu_torch.ops.detect_loss import detection_loss

# COCO-17 OKS sigmas (the public keypoint-eval constants), f32 / 10 as JAX's
OKS_SIGMA_17 = torch.tensor(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
     1.07, 1.07, 0.87, 0.87, 0.89, 0.89], dtype=torch.float32) / 10.0


def pose_loss(
    outputs: dict,  # {"det": maps, "kpts_raw": (B, A, K, D)}
    gt_labels: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy px
    gt_kpts: torch.Tensor,  # (B, M, K, D) px (+ visibility)
    mask_gt: torch.Tensor,  # (B, M)
    nc: int,
    imgsz: int,
    strides: Sequence[int],
    box_w: float = 7.5,
    cls_w: float = 0.5,
    dfl_w: float = 1.5,
    pose_w: float = 12.0,
    kobj_w: float = 1.0,
    reg_max: int = 16,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(total, metrics): the detect loss plus ``pose_w`` OKS and ``kobj_w``
    visibility terms."""
    feats = outputs["det"]
    raw = outputs["kpts_raw"].float()
    b, a, k, d = raw.shape

    det_total, metrics, assign = detection_loss(
        feats, gt_labels, gt_bboxes, mask_gt, nc=nc, imgsz=imgsz, strides=strides,
        box_w=box_w, cls_w=cls_w, dfl_w=dfl_w, reg_max=reg_max, return_assign=True)
    fg = assign["fg_mask"].float()
    tgt_idx = assign["target_gt_idx"]
    tgt_boxes = assign["target_bboxes"]

    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchor_points, stride_t = make_anchors(shapes, list(strides), device=raw.device)
    pred = kpts_decode(anchor_points, raw)

    gk = gt_kpts.float()
    sel = torch.gather(gk, 1, tgt_idx[..., None, None].expand(-1, -1, k, d))
    sel_xy = sel[..., :2] / stride_t[None, :, None, :]
    vis = (sel[..., 2] != 0 if d == 3 else torch.ones(sel.shape[:-1], dtype=torch.bool,
                                                       device=sel.device)).float()

    wh = (tgt_boxes[..., 2:] - tgt_boxes[..., :2]) / stride_t[None]
    area = (wh[..., 0] * wh[..., 1]).clamp(min=1e-9)
    sig = (OKS_SIGMA_17 if k == 17 else torch.full((k,), 1.0 / k)).to(raw.device)
    d2 = ((pred[..., :2] - sel_xy) ** 2).sum(-1)
    e = d2 / ((2 * sig[None, None]) ** 2 * (area[..., None] + 1e-9) * 2)
    nvis = vis.sum(-1, keepdim=True).clamp(min=1e-9)
    factor = torch.full_like(nvis, k) / nvis  # k / nvis rounds as JAX's division
    per_anchor = (factor * (1 - torch.exp(-e)) * vis).mean(-1)
    n_fg = fg.sum().clamp(min=1.0)
    kpt_loss = (per_anchor * fg).sum() / n_fg

    if d == 3:
        kobj = F.binary_cross_entropy_with_logits(pred[..., 2], vis, reduction="none").mean(-1)
        kobj_loss = (kobj * fg).sum() / n_fg
    else:
        kobj_loss = torch.zeros((), device=raw.device)

    metrics = dict(metrics)
    metrics["kpt_loss"] = kpt_loss.detach()
    metrics["kobj_loss"] = kobj_loss.detach()
    return det_total + pose_w * kpt_loss + kobj_w * kobj_loss, metrics
