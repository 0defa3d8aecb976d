"""Evaluation of run dirs: a detector's mAP with per-image P / R / F1 over a
YOLO split, and a recognizer's CER and exact match over a test split
(counterpart of ``kuzu/tools/evaluation.py``).

Both run the port's predictors on the card unless ``device`` says
otherwise, over image files (the port's decoders).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from kuzu_torch.core.config import load_config
from kuzu_torch.core.metrics import (
    DetMetrics,
    box_iou_np,
    character_accuracy,
    character_error_rate,
    compute_ap,
)
from kuzu_torch.data.ocr_datasets import ColumnInfoDataset, OneLineDataset
from kuzu_torch.data.yolo_dataset import YoloDetectionDataset
from kuzu_torch.tasks.detect import DetectPredictor
from kuzu_torch.tasks.recognize import RecognizePredictor


def evaluate_detector(
    run_dir: str | Path,
    dataset_yaml: str | Path,
    split: str = "val",
    conf: float = 0.001,
    iou: float = 0.7,
    max_images: int | None = None,
    save_panels: int = 0,
    out_dir: str | Path | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """A run dir's detector over ``split`` of ``dataset_yaml``, one image a
    forward: ``DetMetrics`` (mAP50, mAP50-95, fitness, ...), ``per_image``
    precision / recall / F1 at IoU 0.5, and ``worst_images`` (the lowest F1,
    at least 10). ``out_dir`` gets ``evaluation.json`` without the
    per-image rows."""
    predictor = DetectPredictor(
        load_config(overrides={"model": str(run_dir), "conf": conf, "iou": iou}), device=device)
    ds = YoloDetectionDataset(str(dataset_yaml), split=split, imgsz=640, augment=False)
    dm = DetMetrics()
    per_image, worst = [], []
    n = len(ds.images) if max_images is None else min(max_images, len(ds.images))
    for i in range(n):
        path = ds.images[i]
        _, gt_boxes, gt_labels = ds._load_raw(i)
        r = predictor([path])[0]
        dm.update(r["boxes"], r["scores"], r["classes"], np.ones(len(r["boxes"]), bool),
                  gt_boxes, gt_labels, np.ones(len(gt_boxes), bool))
        iou_m = box_iou_np(gt_boxes, r["boxes"])
        tp = int((iou_m.max(axis=1) >= 0.5).sum()) if iou_m.size else 0
        prec = tp / max(len(r["boxes"]), 1)
        rec = tp / max(len(gt_boxes), 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        per_image.append({"image": str(path), "precision": prec, "recall": rec, "f1": f1})
        worst.append((f1, str(path)))
    res = dm.compute()
    res["per_image"] = per_image
    res["worst_images"] = [p for _, p in sorted(worst)[: max(save_panels, 10)]]
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "evaluation.json").write_text(
            json.dumps({k: v for k, v in res.items() if k != "per_image"}, indent=2))
    return res


def evaluate_recognizer(
    run_dir: str | Path,
    data: str | Path,
    split: str = "test",
    max_samples: int | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """A recognize run's corpus CER and exact-match rate over ``split`` of a
    ``column_info.csv`` or a one-line folder, at the run's crop size."""
    predictor = RecognizePredictor(load_config(overrides={"model": str(run_dir)}), device=device)
    predictor._setup()
    tok = predictor.tokenizer
    if str(data).endswith(".csv"):
        ds = ColumnInfoDataset(data, tok, split=split, image_size=predictor.image_size)
        items = [(p, t) for p, t in ds.items]
    else:
        ds = OneLineDataset(data, tok, split=split, image_size=predictor.image_size)
        items = [(p, t) for p, t, _ in ds.items]
    if max_samples:
        items = items[:max_samples]
    preds = predictor([p for p, _ in items])
    refs = [t for _, t in items]
    cer = character_error_rate(preds, refs)
    exact = sum(p == r for p, r in zip(preds, refs)) / max(len(refs), 1)
    return {"cer": cer, "exact_match": exact, "n": len(refs)}


__all__ = ["evaluate_detector", "evaluate_recognizer", "character_accuracy", "compute_ap"]
