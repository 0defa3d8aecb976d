"""BaseTrainer — the task-agnostic training engine on one device
(counterpart of ``kuzu/tasks/base.py``).

Experiment directory with an ``args.yaml`` snapshot, the ``auto`` optimizer
rule, the epoch loop with ``set_epoch``, a one-deep host-to-device prefetch
on a side stream, per-epoch validation with a fitness scalar, a CSV row per
epoch, last/best checkpoints, early stop, resume, the time limit and
``final.json``. Subclasses supply the model, the data, the loss and the
validation.

``lora_rank`` trains low-rank adapters over a frozen base, as the JAX
trainer does for every task (``kuzu_torch/core/lora.py``): ``lora_alpha``
(default 2 rank), ``lora_targets`` (a regex over the flax parameter paths),
adapters drawn from ``seed + 7``.

One device only: the data-parallel mesh and tensor parallelism raise
``NotImplementedError`` naming the later slice that ports them.

``CropTrainer`` is the engine of the two recognizer tasks (recognize, CTC)
over line crops: their image-file datasets, loaders and photometric jitter.
:func:`trainer_for` serves a task's datasets decoded elsewhere.
"""

from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from kuzu_torch.core import lora
from kuzu_torch.core.callbacks import LOGGER, CallbackRegistry, CSVLogger, EarlyStopping
from kuzu_torch.core.checkpoint import CheckpointManager
from kuzu_torch.core.config import Config
from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
from kuzu_torch.data.loader import DataLoader
from kuzu_torch.data.ocr_datasets import ColumnInfoDataset, build_tokenizer_from_datasets
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.ops.images import from_uint8, photometric_aug


def resolve_val_batches(cfg: Config, loader: Any, key: str = "val_batches") -> int:
    """The full split unless the config caps it (an explicit cap is logged)."""
    try:
        total = len(loader)
    except TypeError:
        total = None
    cap = cfg.get(key)
    if cap in (None, "", -1, "None"):
        return total if total is not None else 10**9
    cap = int(cap)
    if total is not None and cap < total:
        LOGGER.info(f"validate: capped at {cap}/{total} batches ({key}={cap})")
    return cap


def _check_one_device(cfg: Config) -> None:
    mesh = cfg.get("mesh") or {}
    if int(mesh.get("data", -1)) not in (-1, 1):
        raise NotImplementedError(
            "data parallelism (mesh.data > 1) is not ported yet: a later slice "
            "(DDP, ROADMAP section 1 item 12)")
    if int(mesh.get("model", 1)) > 1 or cfg.get("tp_rules"):
        raise NotImplementedError(
            "tensor parallelism (mesh.model > 1, tp_rules) is not ported yet: a later "
            "slice (the recognizer and LM families, ROADMAP section 1 item 14)")


class BaseTrainer:
    # optimizer='auto' resolution for this task family
    auto_optimizer = "sgd"

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        """``device``: the card by default (raises where there is none);
        ``"cpu"`` runs the plain versions of the kernels."""
        self.cfg = cfg
        self.device = resolve_device(device)
        _check_one_device(cfg)
        if str(cfg.get("optimizer", "auto")).lower() == "auto":
            # resolved here so args.yaml records the actual optimizer
            cfg.optimizer = self.auto_optimizer
            if self.auto_optimizer == "adamw" and float(cfg.get("lr0", 0.01)) == 0.01:
                cfg.lr0 = 3e-4  # 0.01 is the SGD default, far too hot for Adam
        self.callbacks = CallbackRegistry()
        self.save_dir = self._setup_dir()
        self.ckpt = CheckpointManager(self.save_dir / "weights")
        self.csv = CSVLogger(self.save_dir / "results.csv")
        self.stopper = EarlyStopping(int(cfg.get("patience", 100)))
        self.epoch = 0
        self.state: TrainState | None = None

    # ------------------------------------------------------------- plumbing
    def _setup_dir(self) -> Path:
        name = self.cfg.get("name") or datetime.now().strftime("%Y%m%d_%H%M%S")
        d = Path(self.cfg.get("project", "runs")) / str(self.cfg.get("task", "task")) / name
        if d.exists() and not self.cfg.get("exist_ok", False):
            stem = d
            i = 2
            while d.exists():
                d = stem.parent / f"{stem.name}{i}"
                i += 1
        d.mkdir(parents=True, exist_ok=True)
        self.cfg.to_yaml(d / "args.yaml")
        return d

    # ------------------------------------------------------- subclass hooks
    def build_model(self) -> torch.nn.Module:
        """The model on ``self.device`` (and model refs stashed on self)."""
        raise NotImplementedError

    def build_datasets(self) -> tuple[Any, Any]:
        """(train_loader, val_loader-or-None)."""
        raise NotImplementedError

    def loss_fn(self, model: torch.nn.Module, batch: dict,
                rng: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) for one batch of device tensors; ``rng`` is the
        step's generator (:meth:`step_rng`), where the loss draws (dropout,
        masking, augmentation), as the JAX trainer's ``rng``."""
        raise NotImplementedError

    def step_rng(self, step: int) -> torch.Generator:
        """The randomness of update ``step``: a generator on the trainer's
        device seeded from ``cfg.seed`` and the step, so a resumed run draws
        what an unbroken one would."""
        seed = np.random.SeedSequence([int(self.cfg.get("seed", 0)), int(step)])
        return torch.Generator(device=self.device).manual_seed(int(seed.generate_state(1)[0]))

    def validate(self, state: TrainState) -> dict[str, float]:
        """Metrics incl. ``fitness`` (higher better). Default: none."""
        return {}

    def init_adapters(self, model: torch.nn.Module, rank: int) -> dict:
        """LoRA's adapters of ``model`` (``lora_targets``), drawn on the CPU
        from ``seed + 7`` (JAX draws from its own key ``seed + 7``: tests
        replace this hook to hand JAX's draws over)."""
        gen = torch.Generator().manual_seed(int(self.cfg.get("seed", 0)) + 7)
        return lora.init_lora(gen, model, rank, targets=self.cfg.get("lora_targets"))

    def wrap_lora(self, model: torch.nn.Module) -> torch.nn.Module:
        """With ``lora_rank``, the model's frozen base and its adapters (a
        ``LoRAModel``); else the model."""
        cfg = self.cfg
        rank = int(cfg.get("lora_rank", 0) or 0)
        if not rank:
            return model
        if cfg.get("remat"):
            raise NotImplementedError(
                "lora_rank with remat: the checkpointed blocks recompute in the backward, "
                "outside the merged weights")
        alpha = lora.resolve_alpha(cfg, rank)
        slots = lora.lora_slots(model, cfg.get("lora_targets"))
        wrapped = lora.combine(model, self.init_adapters(model, rank), alpha, slots)
        n_tr, n_tot = lora.trainable_count(wrapped)
        LOGGER.info(f"lora: rank {rank} alpha {alpha:g} — {n_tr / 1e6:.3f}M trainable / "
                    f"{n_tot / 1e6:.2f}M total ({len(slots)} kernels)")
        return wrapped

    def preprocess_batch(self, batch: dict) -> dict:
        return batch

    def _device_prefetch(self, loader: Any) -> Iterator[dict[str, torch.Tensor]]:
        """Batches as device tensors, batch N+1 copied on a side stream (from
        pinned memory) while the step of batch N runs: the counterpart of the
        JAX trainer's one-deep ``device_put`` double buffering."""
        dev = self.device

        def host(batch):
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in self.preprocess_batch(batch).items()}

        if dev.type != "cuda":
            for batch in loader:
                yield {k: v.to(dev) for k, v in host(batch).items()}
            return
        side = torch.cuda.Stream(dev)

        def ready(batch):
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(side)
            for t in batch.values():
                t.record_stream(cur)  # the allocator must not reuse it early
            return batch

        pending = None
        for batch in loader:
            with torch.cuda.stream(side):
                nxt = {k: v.pin_memory().to(dev, non_blocking=True)
                       for k, v in host(batch).items()}
            if pending is not None:
                yield ready(pending)
            pending = nxt
        if pending is not None:
            yield ready(pending)

    # ------------------------------------------------------------ the loop
    def train(self) -> dict:
        cfg = self.cfg
        if cfg.get("debug_nans"):
            torch.autograd.set_detect_anomaly(True)
        if cfg.get("deterministic", True):
            torch.backends.cudnn.deterministic = True
        t0 = time.perf_counter()
        train_loader, self.val_loader = self.build_datasets()
        steps_per_epoch = max(len(train_loader), 1)
        model = self.wrap_lora(self.build_model())
        tx = build_optimizer(cfg, model, steps_per_epoch)
        self.state = TrainState(model, tx, use_ema=bool(cfg.get("ema", True)))
        loss_fn = (lora.lora_loss(self.loss_fn) if isinstance(model, lora.LoRAModel)
                   else self.loss_fn)
        self._step = make_train_step(
            loss_fn, tx,
            ema_decay=float(cfg.get("ema_decay", 0.9999)),
            ema_tau=float(cfg.get("ema_tau", 2000)),
            accumulate=max(int(cfg.get("accumulate", 1)), 1),
        )

        start_epoch = 0
        if cfg.get("resume") and self.ckpt.exists("last"):
            self.ckpt.restore("last", like=self.state)
            start_epoch = int(self.ckpt.metadata("last").get("epoch", -1)) + 1
            LOGGER.info(f"resumed from epoch {start_epoch}")

        n_params = sum(p.numel() for p in model.parameters())
        LOGGER.info(
            f"kuzu_torch {cfg.get('task')} train: {n_params / 1e6:.2f}M params, "
            f"{steps_per_epoch} steps/epoch, device {self.device}, save_dir {self.save_dir}")
        self.callbacks.run("on_train_start", self)

        epochs = int(cfg.get("epochs", 1))
        time_limit_h = cfg.get("time")
        final_metrics: dict = {}
        for epoch in range(start_epoch, epochs):
            self.epoch = epoch
            train_loader.set_epoch(epoch)
            self.callbacks.run("on_epoch_start", self)
            agg: dict[str, torch.Tensor] = {}
            n_steps = 0
            te = time.perf_counter()
            for batch in self._device_prefetch(train_loader):
                metrics = self._step(self.state, batch, self.step_rng(self.state.step))
                n_steps += 1
                for k, v in metrics.items():  # summed on the device, read once
                    agg[k] = agg[k] + v if k in agg else v
                self.callbacks.run("on_step_end", self, metrics)
            train_metrics = {k: float(v) / max(n_steps, 1) for k, v in agg.items()}

            self.callbacks.run("on_val_start", self)
            val_metrics = self.validate(self.state) if cfg.get("val", True) else {}
            self.callbacks.run("on_val_end", self, val_metrics)
            fitness = float(val_metrics.get("fitness", -train_metrics.get("loss", 0.0)))

            row = {
                "epoch": epoch,
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{f"val/{k}": v for k, v in val_metrics.items()},
                "fitness": fitness,
                "time_s": time.perf_counter() - te,
            }
            self.csv.log(row)
            if cfg.get("verbose", True):
                LOGGER.info(f"epoch {epoch}/{epochs - 1}: " + " ".join(
                    f"{k}={v:.4g}" for k, v in row.items() if k != "epoch"))
            if cfg.get("save", True):
                self.ckpt.save(self.state, fitness=fitness, metadata={"epoch": epoch})
                self.callbacks.run("on_checkpoint_save", self)
            final_metrics = {**train_metrics, **val_metrics, "fitness": fitness}

            if self.stopper(epoch, fitness):
                LOGGER.info(f"early stop at epoch {epoch} (best "
                            f"{self.stopper.best_fitness:.4g} @ {self.stopper.best_epoch})")
                break
            if time_limit_h and (time.perf_counter() - t0) > float(time_limit_h) * 3600:
                LOGGER.info("time limit reached")
                break

        self.callbacks.run("on_train_end", self)
        final_metrics["train_time_s"] = time.perf_counter() - t0
        (self.save_dir / "final.json").write_text(
            json.dumps({k: float(v) for k, v in final_metrics.items()}))
        return final_metrics


class CropTrainer(BaseTrainer):
    """The engine of the recognizer tasks over line crops.

    ``build_datasets`` reads ``cfg.data`` as the reference does: a ``.csv``
    is a ``column_info.csv`` (``data/ocr_datasets.py::ColumnInfoDataset``),
    anything else a one-line folder (``OneLineDataset``); the tokenizer is
    the task's (:meth:`resolve_tokenizer`), else trained on the training
    split. Decoded datasets (``image`` uint8 (H, W, 3), ``tokens``
    (max_label_length,) ids, for the CTC task optionally ``boxes``
    (max_boxes, 4) xyxy px and ``num_boxes``) and their tokenizer go to
    :meth:`make_loaders` instead, or build the class with
    :func:`trainer_for`. Subclasses give :meth:`make_dataset`."""

    def resolve_tokenizer(self) -> CharTokenizer | None:
        """The run's tokenizer where the config names one (``tokenizer``)."""
        tok = self.cfg.get("tokenizer")
        return CharTokenizer.load(tok) if tok else None

    def make_dataset(self, split: str, tokenizer: CharTokenizer | None):
        """The ``split`` of ``cfg.data`` (``tokenizer`` None: texts only)."""
        raise NotImplementedError

    def column_dataset(self, split: str, tokenizer: CharTokenizer | None, image_size,
                       max_len: int) -> ColumnInfoDataset:
        """``cfg.data`` as a ``column_info.csv``, augmented (``augment``) in
        its training split, decoded once with ``cache_images=ram``."""
        cfg = self.cfg
        return ColumnInfoDataset(
            str(cfg.data), tokenizer, split=split, image_size=image_size, max_length=max_len,
            augment=bool(cfg.get("augment", True)) and split == "train",
            seed=int(cfg.get("seed", 0)), cache_images=cfg.get("cache_images"))

    def build_datasets(self):
        tokenizer = self.resolve_tokenizer()
        if tokenizer is None:
            tokenizer = build_tokenizer_from_datasets(self.make_dataset("train", None))
        return self.make_loaders(self.make_dataset("train", tokenizer),
                                 self.make_dataset("val", tokenizer), tokenizer)

    def make_loaders(self, train_ds, val_ds, tokenizer: CharTokenizer):
        """(train, val) loaders over decoded datasets, batched as the JAX
        trainer batches its datasets; the tokenizer is this run's, written to
        its ``tokenizer.json``."""
        cfg = self.cfg
        self.tokenizer = tokenizer
        tokenizer.save(self.save_dir / "tokenizer.json")
        self.train_ds, self.val_ds = train_ds, (val_ds if len(val_ds) else train_ds)
        batch = int(cfg.get("batch", 16))
        workers = int(cfg.get("workers", 4))
        return (
            DataLoader(self.train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                       num_workers=workers),
            DataLoader(self.val_ds, batch, shuffle=False, pad_last=True, num_workers=workers),
        )

    def aug_images(self, images: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
        """Photometric jitter of uint8 crops (draws from ``rng``), normalised
        to the models' convention (x - 0.5) / 0.5."""
        return (photometric_aug(from_uint8(images), rng) - 0.5) / 0.5


def trainer_for(datasets: tuple, cls: type) -> type:
    """A subclass of the trainer ``cls`` whose ``build_datasets`` returns
    ``self.make_loaders(*datasets)``: how tests and scripts train on data
    they decode themselves."""

    class _Trainer(cls):
        def build_datasets(self):
            return self.make_loaders(*datasets)

    return _Trainer
