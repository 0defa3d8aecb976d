"""Detection task: training, mAP validation and prediction of the detect
zoo (yolov8, yolov9c, yolov10, yolo11, yolov12; counterpart of
``kuzu/tasks/detect.py``'s ``DetectTrainer``, ``DetectValidator`` and
``DetectPredictor``).

Training runs the graph's training forward, the TAL assigner and the v8 loss
(yolov10: the dual-head E2E loss) in f32; validation folds the EMA
parameters with the live BatchNorm statistics into the BN-folded executor
(``YoloDetector``: the fused-ABlock, area-attention and NMS kernels on the
card) and runs infer -> decode -> NMS (``multi_label``; yolov10: NMS-free
selection) into ``DetMetrics``.

``build_datasets`` reads ``cfg.data``, a ``dataset.yaml`` over a YOLO folder
(``data/yolo_dataset.py::YoloDetectionDataset``: the mosaic, warp, HSV and
flip recipe on the host, the reference's bytes); :meth:`DetectTrainer.
make_loaders` takes datasets decoded elsewhere (:func:`trainer_for`). Either
records the data's ``nc`` and ``names`` in the run dir's ``data_spec.yaml``
for :class:`DetectPredictor`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml

from kuzu_torch.api.export import Exporter
from kuzu_torch.api.model import register_task
from kuzu_torch.api.results import Boxes, Results
from kuzu_torch.core.callbacks import LOGGER
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params, partial_load
from kuzu_torch.core.config import Config, load_config, rebase_on_run_config
from kuzu_torch.core.metrics import DetMetrics
from kuzu_torch.core.train import TrainState, build_optimizer
from kuzu_torch.data.loader import DataLoader, next_bucket
from kuzu_torch.data.sources import Frame, batched_frames, resolve_source
from kuzu_torch.data.yolo_dataset import YoloDetectionDataset, letterbox_np, load_dataset_yaml
from kuzu_torch.models.yolo.detector import YoloDetector, resolve_device
from kuzu_torch.ops.detect_loss import detection_loss, e2e_detection_loss
from kuzu_torch.tasks import base
from kuzu_torch.tasks.base import BaseTrainer, resolve_val_batches

DATA_SPEC = "data_spec.yaml"  # a run's nc and names, written by make_loaders


HYP_KEYS = ("mosaic", "fliplr", "flipud", "hsv_h", "hsv_s", "hsv_v", "degrees", "translate",
            "scale", "shear", "perspective", "mixup", "copy_paste", "erasing")


def spec_head_kind(spec) -> str:
    """The head family of a parsed graph spec (classify, obb, pose, segment
    or detect), as ``kuzu/tasks/detect.py::spec_head_kind`` routes tasks."""
    if spec.classify:
        return "classify"
    if spec.obb:
        return "obb"
    if spec.kpt_shape:
        return "pose"
    if spec.seg_nm:
        return "segment"
    return "detect"


class DetectTrainer(BaseTrainer):
    # the head family the task's loss and validation expect: a model of
    # another family fails in build_model with a message naming the fix
    head_kind = "detect"
    # the model-construction hook: a class of the YoloDetector protocol
    # (resolve_spec, training_graph, for_validation; the nas task swaps in
    # models/nas.py::NASDetector)
    detector_cls = YoloDetector

    def build_datasets(self):
        """(train, val) loaders over the ``cfg.data`` folder: the training
        split augmented (``augment``, the ``HYP_KEYS`` hyperparameters,
        ``cache_images``), the validation split letterboxed (the training
        split where the yaml's has no images); ``rect`` batches both by
        shape bucket (the training split's only without augmentation)."""
        cfg = self.cfg
        imgsz = int(cfg.get("imgsz", 640))
        max_boxes = int(cfg.get("max_boxes", 300))
        hyp = {k: float(cfg.get(k)) for k in HYP_KEYS if cfg.get(k) is not None}
        spec = load_dataset_yaml(cfg.data)
        rect = bool(cfg.get("rect", False))
        self.train_ds = YoloDetectionDataset(
            spec, split="train", imgsz=imgsz, max_boxes=max_boxes,
            augment=bool(cfg.get("augment", True)), hyp=hyp, seed=int(cfg.get("seed", 0)),
            rect=rect, cache_images=cfg.get("cache_images"))
        try:
            self.val_ds = YoloDetectionDataset(spec, split="val", imgsz=imgsz,
                                               max_boxes=max_boxes, augment=False, rect=rect)
        except FileNotFoundError:
            self.val_ds = YoloDetectionDataset(spec, split="train", imgsz=imgsz,
                                               max_boxes=max_boxes, augment=False, rect=rect)
        return self.make_loaders(self.train_ds, self.val_ds, spec["nc"], spec["names"])

    def make_loaders(self, train_ds, val_ds, nc: int, names: dict | None = None,
                     kpt_shape=None):
        """(train, val) loaders over datasets of the ``Dataset`` protocol
        (``image`` uint8 (H, W, 3), ``gt_boxes`` (M, 4) xyxy px,
        ``gt_labels`` (M,), ``mask_gt`` (M,); the other heads' tasks add
        their fields), batched as the JAX trainer batches its folder
        datasets: a dataset with ``rect`` set in batches of its shape
        buckets (``batch_shape_key``). A pose run records ``kpt_shape``."""
        cfg = self.cfg
        self.train_ds, self.val_ds = train_ds, val_ds
        self.data_spec = {"nc": int(nc), "names": names or {i: str(i) for i in range(nc)}}
        if kpt_shape:
            self.data_spec["kpt_shape"] = [int(v) for v in kpt_shape]
        with open(self.save_dir / DATA_SPEC, "w") as f:
            yaml.safe_dump(self.data_spec, f, sort_keys=False, allow_unicode=True)
        batch = int(cfg.get("batch", 16))
        workers = int(cfg.get("workers", 4))

        def groups(ds):
            return ds.batch_shape_key if getattr(ds, "rect", False) else None

        # set_epoch reaches the dataset (per-epoch augmentation seeds)
        train_loader = DataLoader(train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                                  num_workers=workers, group_fn=groups(train_ds))
        val_loader = DataLoader(val_ds, batch, shuffle=False, pad_last=True,
                                num_workers=workers, group_fn=groups(val_ds))
        return train_loader, val_loader

    def build_model(self) -> torch.nn.Module:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        self.imgsz = int(cfg.get("imgsz", 640))
        name = str(cfg.get("model") or "yolov12n")
        spec = self._resolve_model(name)
        if cfg.get("reg_max"):
            spec.reg_max = int(cfg.get("reg_max"))
        kind = spec_head_kind(spec)
        if kind != self.head_kind:
            base = name.split("-")[0]
            hint = base if self.head_kind == "detect" else f"{base}-{self.head_kind}"
            raise ValueError(
                f"model '{name}' has a {kind} head but task "
                f"'{cfg.get('task', self.head_kind)}' needs a {self.head_kind} "
                f"head (e.g. model={hint})")
        graph = self.detector_cls.training_graph(spec, dtype, bool(cfg.get("remat", False)))
        graph.reset_parameters(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        pre = cfg.get("pretrained")
        if isinstance(pre, str) and Path(pre).exists():
            # the reference's partial load (the P2-head graft): a port weights
            # dir's live parameters (best, else last), by name and shape; the
            # BatchNorm statistics stay fresh, as the JAX trainer grafts params
            mgr = CheckpointManager(Path(pre))
            src = mgr.restore("best" if mgr.exists("best") else "last")["model"]
            own = {n: p.detach() for n, p in graph.named_parameters()}
            grafted, n, total = partial_load(own, src)
            graph.load_state_dict(grafted, strict=False)
            LOGGER.info(f"pretrained graft: {n}/{total} tensors from {pre}")
        self.spec, self.nc, self.strides = spec, spec.nc, list(spec.strides)
        # the validation executor: refilled and refolded from the EMA each time
        self._val_det = self.detector_cls.for_validation(spec, dtype, self.imgsz, self.device)
        return graph.to(self.device)

    def _resolve_model(self, name: str):
        """The parsed spec of the model ``name`` at the data's ``nc`` (a hook:
        the pose task takes ``kpt_shape`` from the dataset)."""
        return self.detector_cls.resolve_spec(name, nc=self.data_spec["nc"])

    def loss_fn(self, model: torch.nn.Module, batch: dict,
                rng: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
        """The v8 loss of the training forward (yolov10: the E2E loss of its
        two heads); it draws nothing (``rng`` unused, as the JAX trainer's)."""
        feats = model(batch["image"])
        loss = e2e_detection_loss if self.spec.end2end else detection_loss
        return loss(
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
            # reference validator's semantics (NMS-free selection for v10)
            out = det.select(pred, conf, iou_t, max_det, multi_label=True)
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
    """``cls`` serving ``(train_ds, val_ds, nc)``, datasets decoded elsewhere
    (``base.trainer_for``)."""
    return base.trainer_for(datasets, cls)


class DetectValidator:
    """The standalone validation of a detector run dir (``kuzu/tasks/
    detect.py::DetectValidator``): ``cfg.model`` names the run; its
    ``args.yaml`` becomes the config (the caller's explicit overrides on
    top, ``rebase_on_run_config``), the trainer is built as the run's, its
    validation loader served by ``build_datasets``, and the run's EMA
    weights (LoRA adapters fused) are validated as the live weights.

    ``trainer_cls`` is the trainer class (default ``DetectTrainer``, over
    ``cfg.data``'s folder; a :func:`trainer_for` class serves decoded
    datasets)."""

    trainer_cls: type | None = None

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg, self.device = cfg, device

    def run(self) -> dict:
        cfg = self.cfg
        ckpt = cfg.get("model")
        run_dir = Path(str(ckpt)) if ckpt else None
        if run_dir and (run_dir / "args.yaml").exists():
            cfg = rebase_on_run_config(cfg, run_dir)
        trainer = (self.trainer_cls or DetectTrainer)(cfg, device=self.device)
        trainer.train_loader, trainer.val_loader = trainer.build_datasets()
        model = trainer.build_model()
        if run_dir and (run_dir / "weights").exists():
            model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                        train_cfg=cfg))
        # the loaded weights as the live ones, no EMA (JAX: ema_params=None)
        state = TrainState(model, build_optimizer(self.cfg, model), use_ema=False)
        return trainer.validate(state)


def _load_data_spec(run_dir: Path, train_cfg: Config) -> dict:
    """A run's ``nc`` and ``names``: its ``data_spec.yaml`` where a trainer
    wrote one, else the dataset yaml its ``data`` names (``nc`` defaults to
    the number of names, as ``kuzu/data/yolo_dataset.py::load_dataset_yaml``)."""
    path = run_dir / DATA_SPEC
    if not path.exists():
        path = Path(str(train_cfg.get("data")))
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    names = d.get("names", {})
    if isinstance(names, list):
        names = dict(enumerate(names))
    names = {int(k): v for k, v in names.items()}
    out = {"nc": int(d.get("nc", len(names) or 1)), "names": names}
    if d.get("kpt_shape"):
        out["kpt_shape"] = list(d["kpt_shape"])
    return out


class DetectPredictor:
    """Padded detections on letterboxed uint8 batches: the BN-folded forward
    (bf16, the port's only executor; the JAX predictor builds its detector
    in f32), the DFL decode and NMS (yolov10: NMS-free selection) on the
    predictor's device.

    ``DetectPredictor(cfg)`` loads the run dir ``cfg.model`` (``args.yaml``
    and ``weights/`` as ``DetectTrainer`` writes them, EMA preferred, the
    run's ``reg_max`` and ``imgsz``) at the first :meth:`_setup`;
    :meth:`from_detector` wraps a built ``YoloDetector``. ``conf``, ``iou``
    and ``max_det`` come from ``cfg``. Calling it predicts over any source
    that ``data.sources.resolve_source`` takes (image paths, directories,
    globs, arrays and tensors; videos and streams raise), in groups of
    ``cfg.batch``, and returns a ``Results`` per frame."""

    min_bucket = 1  # the bucket floor; the port has no data-parallel mesh (dp)
    detector_cls = YoloDetector  # the model-construction hook, as DetectTrainer's

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.conf = float(cfg.get("conf") or 0.25)
        self.iou = float(cfg.get("iou", 0.7))
        self.max_det = int(cfg.get("max_det", 300))
        self.ready = False

    @classmethod
    def from_detector(cls, detector: YoloDetector, conf: float = 0.25, iou: float = 0.7,
                      max_det: int = 300) -> "DetectPredictor":
        self = cls(Config(conf=conf, iou=iou, max_det=max_det), device=detector.device)
        self.detector, self.imgsz, self.names = detector, detector.imgsz, {}
        self.ready = True
        return self

    def _setup(self) -> None:
        run_dir = Path(str(self.cfg.get("model")))
        if not (run_dir / "weights").is_dir():
            raise FileNotFoundError(f"{run_dir} holds no weights/ of a port run")
        args = run_dir / "args.yaml"
        train_cfg = load_config(args if args.exists() else None)
        self.imgsz = int(train_cfg.get("imgsz", 640))
        spec = _load_data_spec(run_dir, train_cfg)
        self.names = spec["names"]
        self.detector = self.detector_cls(
            self._resolve_arch(str(train_cfg.get("model") or "yolov12n"), spec),
            nc=spec["nc"], imgsz=self.imgsz, device=self.device,
            reg_max=int(train_cfg.get("reg_max")) if train_cfg.get("reg_max") else None)
        self.detector.load_state_dict(
            load_inference_params(CheckpointManager(run_dir / "weights"), train_cfg=train_cfg))
        self.ready = True

    def _resolve_arch(self, name: str, data_spec: dict):
        """The architecture to build (a hook, as ``DetectTrainer.
        _resolve_model``: the pose task patches ``kpt_shape``)."""
        return name

    def __call__(self, source, max_frames: int | None = None) -> list[Results]:
        """Predict over any source of ``resolve_source``, ``cfg.batch`` frames
        a forward, each frame's boxes in its own pixels."""
        if not self.ready:
            self._setup()
        frames = resolve_source(
            source,
            vid_stride=int(self.cfg.get("vid_stride", 1) or 1),
            max_frames=max_frames,
        )
        batch = int(self.cfg.get("batch", 8) or 8)
        results = []
        for group in batched_frames(frames, batch):
            results.extend(self._predict_frames(group))
        return results

    def _predict_frames(self, frames: list[Frame]) -> list[Results]:
        """One bucketed batch over decoded RGB frames: each letterboxed on the
        predictor's device (cv2's resize to the byte), the count padded to
        ``next_bucket``, one forward, boxes unscaled to the frame and
        clipped on the host as the reference does."""
        images, meta = [], []
        for f in frames:
            h, w = f.image.shape[:2]
            img = torch.as_tensor(f.image).to(self.device)
            canvas, gain, (px, py) = letterbox_np(img, self.imgsz)
            images.append(canvas)  # uint8; the model normalizes on the device
            meta.append((h, w, gain, px, py))
        npad = next_bucket(len(images), min_bucket=self.min_bucket)
        images.extend([torch.zeros_like(images[0])] * (npad - len(images)))
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in self._fwd(torch.stack(images)).items()}
        infer_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        results = []
        for i, (h, w, gain, px, py) in enumerate(meta):
            valid = out["valid"][i]
            boxes = out["boxes"][i][valid]
            boxes = (boxes - [px, py, px, py]) / gain
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            r = Results(
                orig_img=frames[i].image,
                path=frames[i].path,
                names=self.names,
                boxes=Boxes(
                    boxes, out["scores"][i][valid], out["classes"][i][valid], (h, w)
                ),
                speed={"inference_ms": infer_ms},
            )
            self._attach_extras(r, out, i, valid, (h, w), gain, (px, py))
            results.append(r)
        return results

    def _attach_extras(self, result, out, i, valid, orig_shape, gain, pad) -> None:
        """Hook for composite heads (segment masks, pose keypoints): receives
        the letterbox geometry so extras rescale into the original frame like
        the boxes do. The detect heads have none."""

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, imgsz, imgsz, 3) uint8 -> padded NMS output (``boxes``,
        ``scores``, ``classes``, ``valid``; yolov10: NMS-free selection) in
        the letterbox frame."""
        if not self.ready:
            self._setup()
        det = self.detector
        return det.select(det.decode(det.infer(images)), self.conf, self.iou, self.max_det)


register_task(
    "detect",
    trainer=DetectTrainer,
    validator=DetectValidator,
    predictor=DetectPredictor,
    exporter=Exporter,
)
