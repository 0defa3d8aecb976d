"""CTC recognition task: CRNN training with the CTC loss and the box head,
CER validation and prediction (counterpart of ``kuzu/tasks/ctc.py``).

``CTCTrainer`` trains the CRNN (``models/crnn.py``, in ``cfg.dtype``) with
the CTC loss (blank 0) on the tokens' characters, photometric jitter on
uint8 crops and, with ``max_boxes > 0``, the Huber box term; validation
greedy-decodes with the EMA weights into the corpus CER, fitness ``1 -
cer``. The production recipe is ``kuzu/tools/production.py:539-555``: bf16
at imgsz [1024, 64], batch 16, max_label_length 128, adamw lr0 3e-4,
warmup 1 epoch.

``build_datasets`` reads ``cfg.data``, a ``column_info.csv`` or a one-line
folder (``tasks/base.py::CropTrainer``, ``data/ocr_datasets.py``); decoded
crops go to ``make_loaders`` or :func:`trainer_for`. ``CTCPredictor`` loads
a run dir (or wraps a CRNN in memory) and decodes crops; called, it
transcribes image files (``data/ocr_datasets.py::load_letterboxed``, PIL's
decode and resize reproduced without PIL).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kuzu_torch.api.model import register_task
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
from kuzu_torch.core.config import Config, load_config
from kuzu_torch.core.metrics import character_error_rate
from kuzu_torch.data.ocr_datasets import OneLineDataset, letterboxed_batch
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.crnn import CRNN, DIMS, ctc_frames
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.ops.ctc import (
    ctc_alignable,
    ctc_greedy_decode,
    ctc_loss,
    ctc_loss_recursion,
    pack_labels,
)
from kuzu_torch.tasks import base
from kuzu_torch.tasks.base import CropTrainer, resolve_val_batches


def _image_size(cfg) -> tuple[int, int]:
    v = cfg.get("imgsz", [512, 64])
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def build_crnn(cfg, num_classes: int, dtype: torch.dtype = torch.float32) -> CRNN:
    """The CRNN of a CTC config (``lstm_hidden``, ``time_axis``,
    ``max_boxes``) at the encoder widths ``DIMS``, as the JAX trainer
    builds it."""
    return CRNN(num_classes, dims=DIMS, lstm_hidden=int(cfg.get("lstm_hidden", 256)),
                time_axis=str(cfg.get("time_axis", "height")),
                max_boxes=int(cfg.get("max_boxes", 0)), dtype=dtype)


class CTCTrainer(CropTrainer):
    auto_optimizer = "adamw"  # the reference's ocr_lightning trains with Adam

    def make_dataset(self, split: str, tokenizer: CharTokenizer | None):
        """A ``column_info.csv`` (no box head: its boxes are in page pixels),
        else a one-line folder, unaugmented, with its character boxes where
        ``max_boxes > 0``."""
        cfg = self.cfg
        size, max_len = _image_size(cfg), int(cfg.get("max_label_length", 64))
        if str(cfg.data).endswith(".csv"):
            return self.column_dataset(split, tokenizer, size, max_len)
        boxes = int(cfg.get("max_boxes", 0))
        return OneLineDataset(str(cfg.data), tokenizer, split=split, image_size=size,
                              max_length=max_len, with_boxes=boxes > 0, max_boxes=max(boxes, 1))

    def build_model(self) -> CRNN:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        model = build_crnn(cfg, len(self.tokenizer), dtype)
        model.reset_parameters(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        self.model = model.to(self.device)
        self._val_model = copy.deepcopy(self.model).eval()  # EMA weights at validation
        self._val_model.lstm.flatten_parameters()  # a copy's LSTM weights lie apart
        return self.model

    def preprocess_batch(self, batch: dict) -> dict:
        """Marks, on the host before the step, the rows whose label has no
        alignment in the crops' CTC frames (``ctc_unaligned``, a key present
        only when a row has none): the loss takes them through the
        reference's recursion with no device read."""
        side = batch["image"].shape[1 if self.cfg.get("time_axis", "height") == "height" else 2]
        labels, lens = pack_labels(torch.from_numpy(np.asarray(batch["tokens"])).long())
        unaligned = ~ctc_alignable(labels, lens, torch.full_like(lens, ctc_frames(side)))
        return {**batch, "ctc_unaligned": unaligned.numpy()} if bool(unaligned.any()) else batch

    def loss_fn(self, model: CRNN, batch: dict, rng: torch.Generator):
        """The CTC loss of the characters (specials zeroed, left-packed,
        ``label_lens`` the characters, every row's T frames), each row's
        divided by its length, the batch mean; with the box head the Huber
        box term (delta 1) over the valid boxes, normalised by (W, H, W, H),
        times ``cfg.box``. uint8 crops get photometric jitter first (draws
        from ``rng``; ``augment``).

        A row with no alignment (length plus adjacent repeats over T;
        ``ctc_unaligned``, marked by :meth:`preprocess_batch`) takes the
        reference's recursion (``ctc_loss_recursion``): its loss is 1e30 and
        its gradient the reference's, as the JAX trainer, which masks
        nothing. Such rows cannot occur at the production shape (T = 256
        frames, at most 126 characters and 125 repeats)."""
        cfg = self.cfg
        images = batch["image"]
        if images.dtype == torch.uint8 and bool(cfg.get("augment", True)):
            images = self.aug_images(images, rng)
        logits, boxes = model(images)
        labels, label_lens = pack_labels(batch["tokens"].long())
        t = logits.shape[1]
        logit_lens = torch.full_like(label_lens, t)
        per = ctc_loss(logits, labels, logit_lens, label_lens, blank=0, reduction="none")
        if "ctc_unaligned" in batch:
            per = torch.where(batch["ctc_unaligned"], ctc_loss_recursion(
                logits, labels, logit_lens, label_lens), per)
        loss = (per / label_lens.to(per.dtype).clamp(min=1)).mean()
        metrics = {}
        if boxes is not None and "boxes" in batch:
            h, w = _image_size(cfg)
            norm = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
            gt = batch["boxes"].to(boxes.dtype) / norm
            valid = (torch.arange(gt.shape[1], device=gt.device)[None]
                     < batch["num_boxes"][:, None]).float()
            hub = F.huber_loss(boxes, gt, reduction="none", delta=1.0).mean(-1)
            box_loss = (hub * valid).sum() / valid.sum().clamp(min=1.0)
            loss = loss + float(cfg.get("box", 1.0)) * box_loss
            metrics["box_loss"] = box_loss
        return loss, metrics

    @torch.no_grad()
    def validate(self, state) -> dict[str, float]:
        """Greedy CTC decode of the validation crops with the EMA weights
        (``val_batches`` caps the batches, ``sample_mask`` drops the padded
        rows): corpus CER, fitness ``1 - cer``."""
        model = self._val_model
        model.load_state_dict(state.ema_state_dict())
        tok = self.tokenizer
        preds: list[str] = []
        refs: list[str] = []
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            n_real = int(np.asarray(batch.get("sample_mask", np.ones(len(batch["image"])))).sum())
            logits, _ = model(torch.from_numpy(batch["image"]).to(self.device))
            seqs, lens = (x.cpu().numpy() for x in ctc_greedy_decode(logits, blank=0))
            for i in range(n_real):
                preds.append(tok.decode(seqs[i][: lens[i]]))
                refs.append(tok.decode(batch["tokens"][i]))
        if not refs:
            return {}
        cer = character_error_rate(preds, refs)
        return {"cer": cer, "fitness": 1.0 - cer}


def trainer_for(datasets: tuple[Any, Any, CharTokenizer], cls: type = CTCTrainer) -> type:
    """``cls`` serving ``(train_ds, val_ds, tokenizer)`` (``base.trainer_for``)."""
    return base.trainer_for(datasets, cls)


class CTCPredictor:
    """A CRNN, its tokenizer and its crop size (H, W) on one device.

    ``CTCPredictor(cfg)`` loads the run dir ``cfg.model`` at the first
    :meth:`_setup` (``args.yaml``, ``tokenizer.json`` and ``weights/`` as
    ``CTCTrainer`` writes them, EMA preferred, ``best`` before ``last``,
    LoRA adapters fused); :meth:`from_model` wraps a CRNN in memory. The
    CRNN is f32 whatever the run trained in, as the JAX predictor builds
    it."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ready = False

    @classmethod
    def from_model(cls, model: CRNN, tokenizer: CharTokenizer, image_size,
                   device: torch.device | str | None = None) -> "CTCPredictor":
        self = cls(Config(imgsz=list(image_size)), device=device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.image_size = _image_size(self.cfg)
        self.ready = True
        return self

    def _setup(self) -> None:
        run_dir = Path(str(self.cfg.get("model")))
        if not (run_dir / "weights").is_dir():
            raise FileNotFoundError(f"{run_dir} holds no weights/ of a port run")
        args = run_dir / "args.yaml"
        train_cfg = load_config(args if args.exists() else None)
        self.tokenizer = CharTokenizer.load(run_dir / "tokenizer.json")
        self.image_size = _image_size(train_cfg)
        model = build_crnn(train_cfg, len(self.tokenizer))
        model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                    train_cfg=train_cfg))
        self.model = model.to(self.device).eval()
        self.ready = True

    def __call__(self, source) -> list[str]:
        """The texts of an image file or a list of them (or decoded uint8
        (H, W, 3) crops), each read by ``load_letterboxed`` at
        ``image_size``, the batch padded to ``next_bucket``, greedy CTC."""
        if not self.ready:
            self._setup()
        images, n = letterboxed_batch(source, self.image_size)
        (seqs, lens), _ = self._fwd(images.to(self.device))
        seqs, lens = seqs[:n].cpu().numpy(), lens[:n].cpu().numpy()
        return [self.tokenizer.decode(s[:m]) for s, m in zip(seqs, lens)]

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor):
        """(B, H, W, 3) uint8 crops -> ((sequences (B, T), lengths (B,)),
        boxes (B, max_boxes, 4) or None)."""
        if not self.ready:
            self._setup()
        logits, boxes = self.model(images.to(self.device))
        return ctc_greedy_decode(logits, blank=0), boxes


register_task("ctc", trainer=CTCTrainer, predictor=CTCPredictor)
