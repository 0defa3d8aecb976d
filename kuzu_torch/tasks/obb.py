"""Oriented-bounding-box task (counterpart of ``kuzu/tasks/obb.py``):
rotated TAL assignment, the probIoU box loss, rotated NMS and xywhr
predictions.

Validation and prediction decode the ``det`` maps with the ``angle``
branch into rotated pixel boxes and keep them by :func:`~kuzu_torch.ops.obb.
nms_rotated_padded` (probIoU over same-class pairs, the greedy keep as a
fixed point of batched passes); the validator matches by probIoU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kuzu_torch.api.model import register_task
from kuzu_torch.api.results import Boxes, OBBoxes, Results
from kuzu_torch.core.metrics import DetMetrics
from kuzu_torch.data.loader import next_bucket
from kuzu_torch.data.yolo_dataset import YoloOBBDataset, letterbox_np, load_dataset_yaml
from kuzu_torch.models.yolo.modules import dfl_expectation
from kuzu_torch.ops.anchors import make_anchors
from kuzu_torch.ops.obb import dist2rbox, nms_rotated_padded, obb_loss, probiou, rbox_corners
from kuzu_torch.tasks.base import resolve_val_batches
from kuzu_torch.tasks.detect import DetectPredictor, DetectTrainer, DetectValidator


class OBBTrainer(DetectTrainer):
    head_kind = "obb"

    def build_datasets(self):
        """(train, val) loaders over ``cfg.data``'s OBB folder (HSV only on
        the training split)."""
        cfg = self.cfg
        imgsz = int(cfg.get("imgsz", 640))
        max_boxes = int(cfg.get("max_boxes", 300))
        spec = load_dataset_yaml(cfg.data)

        def mk(split, augment):
            return YoloOBBDataset(spec, split=split, imgsz=imgsz, max_boxes=max_boxes,
                                  augment=augment, seed=int(cfg.get("seed", 0)))

        train_ds = mk("train", bool(cfg.get("augment", True)))
        try:
            val_ds = mk("val", False)
        except FileNotFoundError:
            val_ds = mk("train", False)
        return self.make_loaders(train_ds, val_ds, spec["nc"], spec["names"])

    def loss_fn(self, model, batch: dict, rng: torch.Generator | None = None):
        outputs = model(batch["image"])
        return obb_loss(
            outputs, batch["gt_labels"], batch["gt_rboxes"], batch["mask_gt"],
            nc=self.nc, imgsz=self.imgsz, strides=self.strides,
            box_w=float(self.cfg.get("box", 7.5)),
            cls_w=float(self.cfg.get("cls", 0.5)),
            dfl_w=float(self.cfg.get("dfl", 1.5)),
            reg_max=self.spec.reg_max,
        )

    @torch.no_grad()
    def validate(self, state) -> dict[str, float]:
        """mAP50 / mAP50-95 with probIoU as the matching similarity, and
        the probIoU@0.5 greedy precision, recall and F1 beside them."""
        det = self._val_det.load_state_dict(state.ema_state_dict())
        conf = float(self.cfg.get("conf") or 0.001)
        iou_t = float(self.cfg.get("iou", 0.7))
        max_det = int(self.cfg.get("max_det", 300))
        dm = DetMetrics(use_scipy=bool(self.cfg.get("val_scipy", False)))
        tp = fp = n_gt = 0
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            mask = batch.pop("sample_mask", np.ones(len(batch["image"]), np.float32))
            out = decode_rotated(det, det.infer(torch.from_numpy(batch["image"])), conf, iou_t,
                                 max_det)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for i in range(len(batch["image"])):
                if mask[i] == 0:
                    continue
                pv = out["valid"][i]
                pb, pc, ps = out["boxes"][i][pv], out["classes"][i][pv], out["scores"][i][pv]
                gv = np.asarray(batch["mask_gt"][i], bool)
                gb = np.asarray(batch["gt_rboxes"][i])[gv]
                gc = np.asarray(batch["gt_labels"][i])[gv]
                n_gt += len(gb)
                if len(pb) and len(gb):
                    iou = probiou(torch.from_numpy(gb)[:, None, :],
                                  torch.from_numpy(pb)[None, :, :]).numpy()
                else:
                    iou = np.zeros((len(gb), len(pb)), np.float32)
                dm.update(pb, ps, pc, np.ones(len(pb), bool), gb, gc, np.ones(len(gb), bool),
                          iou_matrix=iou)
                if not len(pb):
                    continue
                if not len(gb):
                    fp += len(pb)
                    continue
                cio = iou * (gc[:, None] == pc[None, :])
                used = np.zeros(len(gb), bool)
                for j in np.argsort(-ps):
                    g = int(np.argmax(cio[:, j]))
                    if cio[g, j] >= 0.5 and not used[g]:
                        used[g] = True
                        tp += 1
                    else:
                        fp += 1
        precision = tp / max(tp + fp, 1)
        recall = tp / max(n_gt, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        res = dm.compute()
        return {"map50": res["map50"], "map": res["map"], "precision": precision,
                "recall": recall, "f1": f1, "fitness": res["fitness"]}


def decode_rotated(detector, outputs: dict, conf: float, iou_t: float,
                   max_det: int) -> dict[str, torch.Tensor]:
    """Raw OBB maps -> the rotated NMS survivors: ``boxes`` (B, max_det, 5)
    xywhr pixels, ``scores``, ``classes``, ``valid``."""
    rboxes, scores, classes = rotated_candidates(detector, outputs)
    return nms_rotated_padded(rboxes, scores, classes,
                              torch.ones(scores.shape, dtype=torch.bool, device=scores.device),
                              iou_threshold=iou_t, score_threshold=conf, max_det=max_det)


def rotated_candidates(detector, outputs: dict):
    """Raw OBB maps -> every anchor's (rboxes (B, A, 5) xywhr pixels, best
    score (B, A), its class (B, A) int32)."""
    feats = outputs["det"]
    angle = outputs["angle"].float()
    b = feats[0].shape[0]
    cat = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in feats], dim=1).float()
    rm = detector.spec.reg_max
    pred_dist = cat[..., : 4 * rm]
    cls = torch.sigmoid(cat[..., 4 * rm:])
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchor_points, stride_t = make_anchors(shapes, detector.strides, device=cat.device)
    dist = dfl_expectation(pred_dist, rm)
    rb = dist2rbox(dist, angle, anchor_points[None]) * stride_t[None]
    rboxes = torch.cat([rb, angle], -1)
    scores, classes = cls.max(dim=-1)  # the first class among ties, as argmax
    classes = (classes.to(torch.int32) if cls.shape[-1] > 1
               else torch.zeros(scores.shape, dtype=torch.int32, device=scores.device))
    return rboxes, scores, classes


class OBBPredictor(DetectPredictor):
    """Rotated detections: ``Results.obb`` (xywhr in the frame's pixels) and,
    for the generic surface, ``Results.boxes`` as each rotated box's
    axis-aligned hull."""

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        if not self.ready:
            self._setup()
        det = self.detector
        return decode_rotated(det, det.infer(images), self.conf, self.iou, self.max_det)

    def _predict_frames(self, frames: list) -> list[Results]:
        images, meta = [], []
        for f in frames:
            h, w = f.image.shape[:2]
            img = torch.as_tensor(f.image).to(self.device)
            canvas, gain, (px, py) = letterbox_np(img, self.imgsz)
            images.append(canvas)
            meta.append((h, w, gain, px, py))
        npad = next_bucket(len(images), min_bucket=self.min_bucket)
        images.extend([torch.zeros_like(images[0])] * (npad - len(images)))
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in self._fwd(torch.stack(images)).items()}
        infer_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        results = []
        for i, (h, w, gain, px, py) in enumerate(meta):
            v = out["valid"][i]
            rb = out["boxes"][i][v].copy()
            rb[:, 0] = (rb[:, 0] - px) / gain
            rb[:, 1] = (rb[:, 1] - py) / gain
            rb[:, 2:4] /= gain
            conf, cls = out["scores"][i][v], out["classes"][i][v]
            if len(rb):  # the axis-aligned hull
                corners = rbox_corners(torch.from_numpy(rb)).numpy()
                xyxy = np.concatenate([corners.min(1), corners.max(1)], axis=1).clip(0, max(h, w))
            else:
                xyxy = np.zeros((0, 4), np.float32)
            r = Results(orig_img=frames[i].image, path=frames[i].path, names=self.names,
                        boxes=Boxes(xyxy, conf, cls, (h, w)), speed={"inference_ms": infer_ms})
            r.obb = OBBoxes(rb, conf, cls)
            results.append(r)
        return results


class OBBValidator(DetectValidator):
    """The standalone validation of an OBB run, through the OBB trainer
    (JAX's builds a ``DetectTrainer`` and refuses)."""

    trainer_cls = OBBTrainer


register_task("obb", trainer=OBBTrainer, validator=OBBValidator, predictor=OBBPredictor)
