"""Glyph classification task (counterpart of ``kuzu/tasks/classify.py``):
over a glyph folder (``root/<class>/*.png``), the label-smoothed softmax
cross-entropy as optax computes it, top-1 accuracy as the fitness, EMA
weights for validation. Two routes, as JAX's:

- a model name with ``-cls``: the YOLO-cls module tree (a YOLO backbone and
  the ``Classify`` head) on RGB, BatchNorm statistics moving in the model;
  no BN-folded route (nor in JAX): validation and prediction run the
  module tree in eval mode (running statistics);
- any other name: ``models/simple_vit.py::SimpleViT`` (the default) on
  ``channels`` (1) at the config's ``imgsz`` (128), ``patch`` (16), ``dim``
  (256), ``depth`` (6), ``heads`` (8) and ``dropout``, its dropout drawing
  from the step's generator.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from kuzu_torch.api.model import register_task
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
from kuzu_torch.core.config import Config, load_config, rebase_on_run_config
from kuzu_torch.core.train import TrainState, build_optimizer
from kuzu_torch.data.folder_dataset import GlyphFolderDataset, load_glyph
from kuzu_torch.data.loader import DataLoader, next_bucket
from kuzu_torch.models.layers import flax_init_
from kuzu_torch.models.simple_vit import SimpleViT
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
from kuzu_torch.tasks.base import BaseTrainer


def is_yolo(name) -> bool:
    """Whether the model name is a YOLO-cls yaml (``-cls`` in it)."""
    return bool(name) and ("-cls" in str(name))


def build_classifier(cfg, nc: int, dtype: torch.dtype = torch.float32,
                     dropout: float = 0.0) -> torch.nn.Module:
    """The classifier of config ``cfg`` with ``nc`` classes: the YOLO-cls
    module tree of a ``-cls`` model name, else a SimpleViT at the config's
    widths (``dropout`` is the trainer's; predictors build it without)."""
    name = cfg.get("model")
    if is_yolo(name):
        path, scale = resolve_model_spec(str(name))
        return YoloGraph(parse_model_yaml(path, scale=scale, nc=nc), dtype=dtype)
    return SimpleViT(
        nc, image_size=(int(cfg.get("imgsz", 128)),) * 2,
        patch_size=(int(cfg.get("patch", 16)),) * 2, dim=int(cfg.get("dim", 256)),
        depth=int(cfg.get("depth", 6)), num_heads=int(cfg.get("heads", 8)), dropout=dropout,
        channels=int(cfg.get("channels", 1)), dtype=dtype)


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float) -> torch.Tensor:
    """optax's ``softmax_cross_entropy(logits, smooth_labels(one_hot(labels),
    smoothing))``, averaged: targets (1 - a) one_hot + a / n."""
    n = logits.shape[-1]
    target = F.one_hot(labels.long(), n).to(logits.dtype) * (1.0 - smoothing) + smoothing / n
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


class ClassifyTrainer(BaseTrainer):
    def build_datasets(self):
        """(train, val) loaders over ``cfg.data``: its ``train`` / ``val``
        subfolders where it has them (val: else the training one), else the
        folder itself; RGB for a YOLO-cls model, else ``channels``. The
        class map is written to the run's ``class_map.json``."""
        cfg = self.cfg
        root = Path(cfg.data)
        imgsz = int(cfg.get("imgsz", 128))
        channels = 3 if is_yolo(cfg.get("model")) else int(cfg.get("channels", 1))
        train_root = root / "train" if (root / "train").exists() else root
        val_root = root / "val" if (root / "val").exists() else train_root
        train_ds = GlyphFolderDataset(train_root, imgsz, channels)
        val_ds = GlyphFolderDataset(val_root, imgsz, channels, class_map=train_ds.class_map)
        return self.make_loaders(train_ds, val_ds)

    def make_loaders(self, train_ds, val_ds):
        """(train, val) loaders over glyph datasets (``image`` uint8 (S, S,
        C), ``label``), batched as the JAX trainer batches them."""
        cfg = self.cfg
        self.train_ds, self.val_ds = train_ds, val_ds
        train_ds.save_class_map(self.save_dir / "class_map.json")
        batch = int(cfg.get("batch", 16))
        workers = int(cfg.get("workers", 4))
        return (DataLoader(train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                           num_workers=workers),
                DataLoader(val_ds, batch, shuffle=False, pad_last=True, num_workers=workers))

    def build_model(self) -> torch.nn.Module:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        nc = self.train_ds.num_classes
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        model = build_classifier(cfg, nc, dtype, float(cfg.get("dropout", 0.0)))
        if isinstance(model, YoloGraph):
            model.reset_parameters(gen)
            self.spec = model.spec
        else:
            flax_init_(model, gen)
        # the validation copy: refilled from the EMA each time, eval mode
        self._val_model = build_classifier(cfg, nc, dtype).to(self.device).eval()
        return model.to(self.device)

    def loss_fn(self, model, batch: dict, rng: torch.Generator | None = None):
        """The label-smoothed (``label_smoothing``, default 0) softmax
        cross-entropy of the training forward (SimpleViT's dropout drawing
        from ``rng``), and the batch accuracy."""
        images = batch["image"]
        logits = (model(images, train=True, rng=rng) if isinstance(model, SimpleViT)
                  else model(images))
        labels = batch["label"].long()
        loss = smoothed_cross_entropy(logits, labels, float(self.cfg.get("label_smoothing", 0.0)))
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc.detach()}

    @torch.no_grad()
    def validate(self, state: TrainState) -> dict[str, float]:
        """Top-1 accuracy (the fitness) and the mean cross-entropy of the EMA
        weights with the live BatchNorm statistics, over the whole split."""
        model = self._val_model
        model.load_state_dict(state.ema_state_dict())
        total = correct = loss_sum = 0.0
        for batch in self.val_loader:
            mask = batch.pop("sample_mask", np.ones(len(batch["label"]), np.float32))
            logits = model(torch.from_numpy(batch["image"]).to(self.device))
            labels = torch.from_numpy(np.asarray(batch["label"])).long().to(self.device)
            ok = (logits.argmax(-1) == labels).float().cpu().numpy()
            ce = F.cross_entropy(logits, labels, reduction="none").cpu().numpy()
            correct += float((ok * mask).sum())
            loss_sum += float((ce * mask).sum())
            total += float(mask.sum())
        if total == 0:
            return {}
        acc = correct / total
        return {"acc": acc, "loss": loss_sum / total, "fitness": acc}


class ClassifyValidator:
    """The standalone validation of a classify run dir: its ``args.yaml`` as
    the config (the caller's explicit overrides on top), its EMA weights as
    the live weights, validated by the trainer's :meth:`ClassifyTrainer.
    validate`."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg, self.device = cfg, device

    def run(self) -> dict:
        cfg = self.cfg
        ckpt = cfg.get("model")
        wdir = None
        if ckpt and Path(str(ckpt)).exists():
            run_dir = Path(str(ckpt))
            if (run_dir / "weights").exists():
                wdir = run_dir / "weights"
            else:
                wdir, run_dir = run_dir, run_dir.parent
            cfg = rebase_on_run_config(cfg, run_dir)
        trainer = ClassifyTrainer(cfg, device=self.device)
        trainer.train_loader, trainer.val_loader = trainer.build_datasets()
        model = trainer.build_model()
        if wdir is not None:
            model.load_state_dict(load_inference_params(CheckpointManager(wdir), train_cfg=cfg))
        return trainer.validate(TrainState(model, build_optimizer(cfg, model), use_ema=False))


class ClassifyPredictor:
    """A trained run's class predictions for glyph image files: each image
    read as the trainer reads it (PIL's RGB or L convert and BILINEAR
    resize, in the port's ``image_io``), the batch padded to ``next_bucket``, softmax
    probabilities of the module tree in eval mode. Each result holds
    ``path``, ``class``, ``name``, ``confidence`` (JAX's keys) and
    ``top5``, the five best classes in order."""

    min_bucket = 1

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ready = False

    def _setup(self) -> None:
        run_dir = Path(str(self.cfg.get("model")))
        args = run_dir / "args.yaml"
        train_cfg = load_config(args if args.exists() else None)
        class_map = json.loads((run_dir / "class_map.json").read_text())
        self.idx_to_name = {int(v): k for k, v in class_map.items()}
        self.imgsz = int(train_cfg.get("imgsz", 128))
        self.channels = 3 if is_yolo(train_cfg.get("model")) else int(train_cfg.get("channels", 1))
        self.model = build_classifier(train_cfg, len(class_map))
        self.model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                         train_cfg=train_cfg))
        self.model.to(self.device).eval()
        self.ready = True

    @torch.no_grad()
    def probs(self, images) -> torch.Tensor:
        """(N, S, S, C) uint8 (an ndarray or a tensor) -> (N, nc) softmax
        probabilities."""
        if not self.ready:
            self._setup()
        x = images if torch.is_tensor(images) else torch.from_numpy(images)
        return torch.softmax(self.model(x.to(self.device)), -1)

    def __call__(self, source) -> list[dict]:
        if not self.ready:
            self._setup()
        paths = [source] if isinstance(source, (str, Path)) else list(source)
        imgs = [load_glyph(p, self.imgsz, self.channels) for p in paths]
        n = len(imgs)
        imgs.extend([np.zeros_like(imgs[0])] * (next_bucket(n, min_bucket=self.min_bucket) - n))
        probs = self.probs(np.stack(imgs))[:n].cpu().numpy()
        out = []
        for p, pr in zip(paths, probs):
            order = np.argsort(-pr, kind="stable")
            top = int(order[0])
            out.append({"path": str(p), "class": top,
                        "name": self.idx_to_name.get(top, str(top)),
                        "confidence": float(pr[top]),
                        "top5": [int(c) for c in order[:5]]})
        return out


register_task("classify", trainer=ClassifyTrainer, validator=ClassifyValidator,
              predictor=ClassifyPredictor)
