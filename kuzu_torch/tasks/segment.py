"""Instance-segmentation task (counterpart of ``kuzu/tasks/segment.py``):
the detect stack plus prototype-mask training and mask composition at
predict time.

Training reads one overlap-index map an image (``YoloSegmentDataset``) into
``segmentation_loss``; validation is the detect task's box mAP over the
``det`` maps; prediction composes sigmoid(coeffs @ protos) for the NMS
survivors (``return_indices`` recovers the kept anchors' coefficient rows;
NMS on the K1 kernel on the card), cropped to each box, thresholded at 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from kuzu_torch.api.model import register_task
from kuzu_torch.api.results import Masks
from kuzu_torch.data.yolo_dataset import YoloSegmentDataset, load_dataset_yaml
from kuzu_torch.models.layers import f32_products
from kuzu_torch.ops.seg_loss import crop_loss_to_box, segmentation_loss
from kuzu_torch.tasks.detect import DetectPredictor, DetectTrainer, DetectValidator


class SegmentTrainer(DetectTrainer):
    head_kind = "segment"

    def build_datasets(self):
        """(train, val) loaders over ``cfg.data``'s segment folder: HSV and
        flips on the training split, the validation split (else the
        training one) letterboxed."""
        cfg = self.cfg
        imgsz = int(cfg.get("imgsz", 640))
        max_boxes = int(cfg.get("max_boxes", 300))
        spec = load_dataset_yaml(cfg.data)
        train_ds = YoloSegmentDataset(spec, split="train", imgsz=imgsz, max_boxes=max_boxes,
                                      augment=bool(cfg.get("augment", True)),
                                      seed=int(cfg.get("seed", 0)))
        try:
            val_ds = YoloSegmentDataset(spec, split="val", imgsz=imgsz, max_boxes=max_boxes,
                                        augment=False)
        except FileNotFoundError:
            val_ds = YoloSegmentDataset(spec, split="train", imgsz=imgsz, max_boxes=max_boxes,
                                        augment=False)
        return self.make_loaders(train_ds, val_ds, spec["nc"], spec["names"])

    def loss_fn(self, model, batch: dict, rng: torch.Generator | None = None):
        """``segmentation_loss`` of the training forward (``masks``: the
        overlap-index maps; ``seg_max_fg`` anchors an image, default 128)."""
        outputs = model(batch["image"])
        return segmentation_loss(
            outputs, batch["gt_labels"], batch["gt_boxes"], batch["masks"], batch["mask_gt"],
            nc=self.nc, imgsz=self.imgsz, strides=self.strides,
            box_w=float(self.cfg.get("box", 7.5)),
            cls_w=float(self.cfg.get("cls", 0.5)),
            dfl_w=float(self.cfg.get("dfl", 1.5)),
            max_fg=int(self.cfg.get("seg_max_fg", 128)),
            reg_max=self.spec.reg_max,
        )


def compose_masks(outputs: dict, nms_out: dict, imgsz: int,
                  threshold: float = 0.5) -> torch.Tensor:
    """(B, max_det, Hp, Wp) bool masks at prototype resolution: sigmoid of
    the kept anchors' coefficients times the prototypes (in full f32: TF32
    would move pixels near the threshold), zero outside the kept box, and
    only for valid detections."""
    coeffs, protos = outputs["coeffs"], outputs["protos"]  # (B, A, nm), (B, Hp, Wp, nm)
    hp, wp = protos.shape[1], protos.shape[2]
    idx = nms_out["indices"]
    sel = torch.gather(coeffs, 1, idx[..., None].expand(-1, -1, coeffs.shape[-1]))
    with f32_products():
        logits = torch.einsum("bdn,bhwn->bdhw", sel.float(), protos.float())
    masks = torch.sigmoid(logits)
    scale = torch.tensor([wp, hp, wp, hp], dtype=torch.float32, device=masks.device)
    masks = crop_loss_to_box(masks, nms_out["boxes"] / imgsz * scale)
    return (masks > threshold) & nms_out["valid"][..., None, None]


class SegmentPredictor(DetectPredictor):
    """The detect predictor whose forward also composes the kept boxes'
    masks; ``Results.masks`` holds them at prototype resolution, cropped to
    the frame's content region so that ``Masks.full()`` maps onto it."""

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        if not self.ready:
            self._setup()
        det = self.detector
        outputs = det.infer(images)
        out = det.select(det.decode(outputs), self.conf, self.iou, self.max_det,
                         return_indices=True)
        out["masks"] = compose_masks(outputs, out, self.imgsz)
        return out

    def _attach_extras(self, result, out, i, valid, orig_shape, gain, pad) -> None:
        m = np.asarray(out["masks"][i][valid])
        if len(m):
            hp, wp = m.shape[1:]
            px, py = pad
            h, w = orig_shape
            sx, sy = wp / (self.imgsz / 1.0), hp / (self.imgsz / 1.0)
            x1 = int(round(px * sx))
            y1 = int(round(py * sy))
            x2 = max(x1 + 1, int(round((px + w * gain) * sx)))
            y2 = max(y1 + 1, int(round((py + h * gain) * sy)))
            m = m[:, y1:y2, x1:x2]
        result.masks = Masks(m, orig_shape)


class SegmentValidator(DetectValidator):
    """The standalone validation of a segment run (box mAP). JAX's builds
    a ``DetectTrainer``, whose head check refuses a segment model; this
    one builds the segment trainer."""

    trainer_cls = SegmentTrainer


register_task("segment", trainer=SegmentTrainer, validator=SegmentValidator,
              predictor=SegmentPredictor)
