"""FastSAM: promptable everything-segmentation over the YOLO-seg predictor
(counterpart of ``kuzu/models/fastsam.py``).

The segment predictor runs class-agnostic in "everything" mode (conf 0.25,
IoU 0.9, 300 detections by default; its NMS on the K1 kernel on the card),
boxes near the frame snap to it, then a prompt selects instances:

- a box prompt: the instance whose mask has the largest IoU with the box;
- point prompts: the instances whose mask holds a foreground point, less
  those hit by a background point; all-negative points start from every
  instance;
- a text prompt ranks crops with CLIP in the reference, whose weights are
  not available here: ``texts=`` raises.

Selection is host-side numpy over the predictor's ``Results``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from kuzu_torch.api.results import Boxes, Masks, Results


def adjust_boxes_to_border(boxes: np.ndarray, shape: tuple[int, int],
                           threshold: int = 20) -> np.ndarray:
    """Box edges within ``threshold`` px of the frame snapped to it."""
    h, w = shape
    out = boxes.copy()
    out[:, 0] = np.where(out[:, 0] < threshold, 0, out[:, 0])
    out[:, 1] = np.where(out[:, 1] < threshold, 0, out[:, 1])
    out[:, 2] = np.where(out[:, 2] > w - threshold, w, out[:, 2])
    out[:, 3] = np.where(out[:, 3] > h - threshold, h, out[:, 3])
    return out


def _subset_result(result: Results, idx: np.ndarray) -> Results:
    """A new ``Results`` holding only the selected instances."""
    b = result.boxes
    sel = Results(orig_img=result.orig_img, path=result.path, names=result.names,
                  boxes=Boxes(b.xyxy[idx], b.conf[idx], b.cls[idx], b.orig_shape),
                  speed=result.speed)
    if result.masks is not None:
        sel.masks = Masks(result.masks.data[idx], result.masks.orig_shape)
    return sel


class FastSAMPredictor:
    """Everything-mode segmentation and prompt selection over a segment run
    dir (``cfg.model``), on ``device`` (the card when None)."""

    def __init__(self, cfg, device: torch.device | str | None = None):
        from kuzu_torch.core.config import load_config
        from kuzu_torch.tasks.segment import SegmentPredictor

        overrides = dict(cfg)
        overrides.setdefault("conf", 0.25)
        overrides.setdefault("iou", 0.9)
        overrides.setdefault("max_det", 300)
        self._seg = SegmentPredictor(load_config(overrides=overrides), device=device)
        self.border_threshold = int(cfg.get("border", 20) or 20)

    @classmethod
    def from_segment_predictor(cls, seg, border: int = 20) -> "FastSAMPredictor":
        """A FastSAM predictor over a built ``SegmentPredictor``."""
        self = cls.__new__(cls)
        self._seg, self.border_threshold = seg, border
        return self

    def __call__(self, source, bboxes: Sequence | None = None, points: Sequence | None = None,
                 labels: Sequence | None = None, texts: Any = None) -> list[Results]:
        results = self._seg(source)
        for r in results:
            if len(r.boxes):
                r.boxes.xyxy[:] = adjust_boxes_to_border(r.boxes.xyxy, r.boxes.orig_shape,
                                                         self.border_threshold)
        return self.prompt(results, bboxes=bboxes, points=points, labels=labels, texts=texts)

    def prompt(self, results: list[Results], bboxes=None, points=None, labels=None,
               texts=None) -> list[Results]:
        """Instances selected by prompt (box and point prompts add up)."""
        if texts is not None:
            raise NotImplementedError(
                "text prompts rank crops with CLIP (reference fastsam/predict.py:122); CLIP "
                "weights are not available in this environment — use bboxes/points prompts")
        if bboxes is None and points is None:
            return results
        out = []
        for r in results:
            if len(r.boxes) == 0 or r.masks is None or len(r.masks) == 0:
                out.append(r)
                continue
            masks = r.masks.full()  # (n, H, W) bool in the original frame
            n = len(masks)
            idx = np.zeros(n, bool)
            if bboxes is not None:
                bb = np.atleast_2d(np.asarray(bboxes, np.int32))
                areas = (bb[:, 3] - bb[:, 1]) * (bb[:, 2] - bb[:, 0])
                inter = np.stack([masks[:, b[1]:b[3], b[0]:b[2]].sum((1, 2)) for b in bb])
                union = areas[:, None] + masks.sum((1, 2))[None] - inter
                idx[np.argmax(inter / np.maximum(union, 1), axis=1)] = True
            if points is not None:
                pts = np.atleast_2d(np.asarray(points, np.int32))
                lbl = np.ones(len(pts), np.int32) if labels is None else np.asarray(labels,
                                                                                    np.int32)
                if len(lbl) != len(pts):
                    raise ValueError(f"{len(lbl)} labels for {len(pts)} points")
                pidx = np.full(n, bool(lbl.sum() == 0))  # all negative: start from everything
                for (x, y), lab in zip(pts, lbl):
                    pidx[masks[:, y, x]] = bool(lab)
                idx |= pidx
            out.append(_subset_result(r, idx))
        return out


def register() -> None:
    """The ``fastsam`` task: training and validation are the segment
    task's (FastSAM trains a YOLO-seg model with nc 1), prediction is
    :class:`FastSAMPredictor`."""
    from kuzu_torch.api.model import register_task
    from kuzu_torch.tasks.segment import SegmentTrainer, SegmentValidator

    register_task("fastsam", trainer=SegmentTrainer, predictor=FastSAMPredictor,
                  validator=SegmentValidator)


register()
