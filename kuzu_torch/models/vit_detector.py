"""ViT patch-head character detector (counterpart of
``kuzu/models/vit_detector.py``): a ViT backbone whose per-patch features
feed a detection head (x1y1x2y2 through a sigmoid, corners sorted, and a
confidence logit) and a classification head; the loss assigns each ground
truth its best patch above a scheduled IoU threshold, with a focal
confidence loss, GIoU regression and cross-entropy on the matched patches.

Module and parameter names are the flax tree's (``PatchEmbed_0/proj``,
``block{i}``, ``norm``, ``det_head``, ``cls_head``). The loss runs over the
whole batch at once (JAX ``vmap``s it over images); a patch that several
ground truths pick takes the largest target, ``scatter_reduce("amax")`` as
JAX's ``.at[].max``. :func:`freeze_mask` names, for each parameter, whether
it trains.
"""

from __future__ import annotations

import torch
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    EncoderBlock,
    PatchEmbed,
    dtype_products,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.ops.boxes import bbox_iou, box_iou_matrix
from kuzu_torch.ops.images import from_uint8
from kuzu_torch.ops.losses import (
    sigmoid_binary_cross_entropy,
    softmax_cross_entropy_with_integer_labels,
)


class ViTPatchDetector(nn.Module):
    """(B, H, W, C) images -> {'boxes' (B, P, 4) normalized xyxy, 'conf'
    (B, P) logits, 'cls' (B, P, nc)}; the heads in f32."""

    def __init__(self, num_classes: int, image_size=(1024, 64), patch_size=(16, 16),
                 dim: int = 256, depth: int = 8, num_heads: int = 8, channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        gh, gw = image_size[0] // patch_size[0], image_size[1] // patch_size[1]
        self.PatchEmbed_0 = PatchEmbed(dim, tuple(patch_size), cin=channels, dtype=dtype)
        self.register_buffer("pos", torch.from_numpy(sincos_2d_pos_embed(dim, gh, gw)),
                             persistent=False)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(dim, num_heads, dtype=dtype))
        self.norm = layer_norm(dim, dtype)
        self.det_head = Dense(dim, 5)  # x1y1x2y2 + conf, f32
        self.cls_head = Dense(dim, num_classes)  # f32

    def forward(self, images: torch.Tensor, train: bool = False) -> dict[str, torch.Tensor]:
        with dtype_products(self.dtype):
            x = self.PatchEmbed_0(from_uint8(images))
            x = x + self.pos[None].to(x.dtype)
            for i in range(self.depth):
                x = getattr(self, f"block{i}")(x, train=train)
            x = self.norm(x)
            det, cls = self.det_head(x), self.cls_head(x)
        boxes = torch.sigmoid(det[..., :4])
        x1 = torch.minimum(boxes[..., 0], boxes[..., 2])
        x2 = torch.maximum(boxes[..., 0], boxes[..., 2])
        y1 = torch.minimum(boxes[..., 1], boxes[..., 3])
        y2 = torch.maximum(boxes[..., 1], boxes[..., 3])
        return {"boxes": torch.stack([x1, y1, x2, y2], dim=-1), "conf": det[..., 4], "cls": cls}


def dynamic_iou_threshold(epoch, start: float = 0.3, end: float = 0.5,
                          ramp_epochs: int = 20) -> torch.Tensor:
    """The assignment IoU threshold, ramped from ``start`` to ``end`` over
    ``ramp_epochs``."""
    frac = torch.clamp(torch.as_tensor(epoch, dtype=torch.float32) / ramp_epochs, 0.0, 1.0)
    return start + (end - start) * frac


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal binary cross-entropy."""
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def vit_detector_loss(outputs: dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, mask_gt: torch.Tensor, iou_threshold,
                      num_classes: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """IoU-assignment loss over (B, M) ground truths (normalized xyxy,
    labels, validity): each ground truth matches its best patch where that
    IoU passes ``iou_threshold``; focal confidence on every patch, GIoU and
    cross-entropy on the matched ones. Returns (loss, metrics)."""
    pred_boxes, conf, cls_logits = outputs["boxes"], outputs["conf"], outputs["cls"]
    iou = box_iou_matrix(gt_boxes, pred_boxes)  # (B, M, P)
    iou = torch.where(mask_gt[..., None], iou, -1.0)
    best_patch = iou.argmax(dim=-1)  # (B, M), the first maximum
    matched = mask_gt & (iou.amax(dim=-1) > torch.as_tensor(iou_threshold))
    w = matched.float()
    conf_t = torch.zeros_like(conf).scatter_reduce(1, best_patch, w, "amax", include_self=True)
    conf_l = focal_loss(conf, conf_t).mean(dim=-1)
    mb = pred_boxes.gather(1, best_patch[..., None].expand(-1, -1, 4))  # (B, M, 4)
    giou = bbox_iou(mb, gt_boxes, giou=True)
    n = w.sum(dim=-1).clamp(min=1.0)
    box_l = ((1.0 - giou) * w).sum(dim=-1) / n
    picked = cls_logits.gather(1, best_patch[..., None].expand(-1, -1, cls_logits.shape[-1]))
    ce = softmax_cross_entropy_with_integer_labels(picked,
                                                   gt_labels.clamp(0, num_classes - 1))
    cls_l = (ce * w).sum(dim=-1) / n
    loss = conf_l.mean() + 2.0 * box_l.mean() + cls_l.mean()
    return loss, {"conf_loss": conf_l.mean(), "box_loss": box_l.mean(),
                  "cls_loss": cls_l.mean(), "n_matched": w.sum(dim=-1).mean()}


def freeze_mask(model: nn.Module, frozen_blocks: int) -> dict[str, bool]:
    """Parameter name -> whether it trains: the first ``frozen_blocks``
    encoder blocks are frozen."""
    frozen = {f"block{i}" for i in range(frozen_blocks)}
    return {name: not frozen.intersection(name.split("."))
            for name, _ in model.named_parameters()}
