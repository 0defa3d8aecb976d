"""Detection task: YOLOv12 training and mAP validation (counterpart of
``kuzu/tasks/detect.py``'s ``DetectTrainer``).

Training runs the graph's training forward, the TAL assigner and the v8 loss
in f32; validation folds the EMA parameters with the live BatchNorm
statistics into the BN-folded executor (``YoloDetector``: the fused-ABlock,
area-attention and NMS kernels on the card) and runs infer -> decode ->
NMS (``multi_label``) into ``DetMetrics``.

``build_datasets`` keeps the JAX signature; its folder-dataset body
(``kuzu/data/yolo_dataset.py``) is not ported yet, so callers subclass it
and hand their datasets to :meth:`DetectTrainer.make_loaders`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from kuzu_torch.core.metrics import DetMetrics
from kuzu_torch.core.train import TrainState
from kuzu_torch.data.loader import DataLoader
from kuzu_torch.models.yolo.detector import YoloDetector
from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
from kuzu_torch.ops.detect_loss import detection_loss
from kuzu_torch.ops.nms import non_max_suppression
from kuzu_torch.tasks.base import BaseTrainer, resolve_val_batches


class DetectTrainer(BaseTrainer):
    def build_datasets(self):
        raise NotImplementedError(
            "the folder dataset (kuzu/data/yolo_dataset.py) is not ported yet: it "
            "decodes with cv2, which the GPU machine lacks; subclass DetectTrainer "
            "and return self.make_loaders(train_ds, val_ds, nc) from build_datasets")

    def make_loaders(self, train_ds, val_ds, nc: int, names: dict | None = None):
        """(train, val) loaders over datasets of the ``Dataset`` protocol
        (``image`` uint8 (H, W, 3), ``gt_boxes`` (M, 4) xyxy px,
        ``gt_labels`` (M,), ``mask_gt`` (M,)), batched as the JAX trainer
        batches its folder datasets."""
        cfg = self.cfg
        self.train_ds, self.val_ds = train_ds, val_ds
        self.data_spec = {"nc": int(nc), "names": names or {i: str(i) for i in range(nc)}}
        batch = int(cfg.get("batch", 16))
        workers = int(cfg.get("workers", 4))
        # set_epoch reaches the dataset (per-epoch augmentation seeds)
        train_loader = DataLoader(train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                                  num_workers=workers)
        val_loader = DataLoader(val_ds, batch, shuffle=False, pad_last=True,
                                num_workers=workers)
        return train_loader, val_loader

    def build_model(self) -> YoloGraph:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        self.imgsz = int(cfg.get("imgsz", 640))
        name = str(cfg.get("model") or "yolov12n")
        path, scale = resolve_model_spec(name)
        spec = parse_model_yaml(path, scale=scale, nc=self.data_spec["nc"])
        if cfg.get("reg_max"):
            spec.reg_max = int(cfg.get("reg_max"))
        pre = cfg.get("pretrained")
        if isinstance(pre, str) and Path(pre).exists():
            raise NotImplementedError(
                "pretrained grafts (partial_load, the P2-head graft) are not ported "
                "yet: a later slice")
        graph = YoloGraph(spec, dtype=dtype, remat=bool(cfg.get("remat", False)))
        graph.reset_parameters(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        self.spec, self.nc, self.strides = spec, spec.nc, list(spec.strides)
        # the validation executor: refilled and refolded from the EMA each time
        self._val_det = YoloDetector(spec, imgsz=self.imgsz, device=self.device)
        return graph.to(self.device)

    def loss_fn(self, model: YoloGraph, batch: dict) -> tuple[torch.Tensor, dict]:
        feats = model(batch["image"])
        return detection_loss(
            feats, batch["gt_labels"], batch["gt_boxes"], batch["mask_gt"],
            nc=self.nc, imgsz=self.imgsz, strides=self.strides,
            box_w=float(self.cfg.get("box", 7.5)),
            cls_w=float(self.cfg.get("cls", 0.5)),
            dfl_w=float(self.cfg.get("dfl", 1.5)),
            reg_max=self.spec.reg_max,
        )

    @torch.no_grad()
    def validate(self, state: TrainState) -> dict[str, float]:
        det = self._val_det.load_state_dict(state.ema_state_dict())
        conf = float(self.cfg.get("conf") or 0.001)
        iou_t = float(self.cfg.get("iou", 0.7))
        max_det = int(self.cfg.get("max_det", 300))
        dm = DetMetrics(use_scipy=bool(self.cfg.get("val_scipy", False)))
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            mask = batch.pop("sample_mask", np.ones(len(batch["image"]), np.float32))
            pred = det.decode(det.infer(torch.from_numpy(batch["image"])))
            # multi_label: every class above the threshold per anchor, the
            # reference validator's semantics
            out = non_max_suppression(pred, conf_thres=conf, iou_thres=iou_t,
                                      max_det=max_det, multi_label=True)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for i in range(len(batch["image"])):
                if mask[i] == 0:
                    continue
                dm.update(out["boxes"][i], out["scores"][i], out["classes"][i],
                          out["valid"][i], batch["gt_boxes"][i], batch["gt_labels"][i],
                          batch["mask_gt"][i])
        return dm.compute()

    def train(self) -> dict:
        """Closes mosaic for the last ``close_mosaic`` epochs, where the
        training dataset has mosaic."""
        close = int(self.cfg.get("close_mosaic", 10))
        epochs = int(self.cfg.get("epochs", 1))

        def maybe_close(trainer):
            if (close > 0 and trainer.epoch >= max(epochs - close, 0)
                    and hasattr(trainer.train_ds, "close_mosaic")):
                trainer.train_ds.close_mosaic()

        self.callbacks.add("on_epoch_start", maybe_close)
        return super().train()


def trainer_for(datasets: tuple[Any, Any, int], cls: type = DetectTrainer) -> type:
    """A ``DetectTrainer`` subclass whose ``build_datasets`` serves
    ``(train_ds, val_ds, nc)``: how tests and scripts train on datasets they
    build themselves until the folder dataset is ported."""

    class _Trainer(cls):
        def build_datasets(self):
            return self.make_loaders(*datasets)

    return _Trainer
