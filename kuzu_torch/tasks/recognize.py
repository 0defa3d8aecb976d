"""Recognition task: TrOCR training, CER validation and prediction
(counterpart of ``kuzu/tasks/recognize.py``).

``RecognizeTrainer`` trains a TrOCR with teacher-forced cross-entropy under
pad masking, on-device photometric jitter, scheduled sampling
(``ss_prob``) and the joint CTC loss on the encoder memory
(``ctc_weight``), in ``cfg.dtype``; its encoder's self-attention runs K3
and K4 on the card (``area_attention_trainable``). ``pretrained=`` grafts a
recognize run's weights by name and shape, ``decoder_init=`` a CharMLM
run's into the decoder (``graft_lm_decoder``). Validation: teacher-forced
accuracy and the corpus CER of greedy or beam generation with the EMA
weights, fitness ``1 - cer``.

``build_datasets`` reads ``cfg.data``, a ``column_info.csv`` or a one-line
folder (``tasks/base.py::CropTrainer``); decoded crops go to
``make_loaders`` or :func:`trainer_for`. ``RecognizePredictor`` loads a run
dir (or wraps a TrOCR in memory) and decodes crops; called, it transcribes
image files (``data/ocr_datasets.py::load_letterboxed``, PIL's decode and
resize reproduced without PIL).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any

import numpy as np
import torch

from kuzu_torch.api.model import register_task
from kuzu_torch.core.callbacks import LOGGER
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params, partial_load
from kuzu_torch.core.config import Config, load_config
from kuzu_torch.core.metrics import character_error_rate
from kuzu_torch.data.ocr_datasets import OneLineDataset, letterboxed_batch
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.layers import flax_init_
from kuzu_torch.models.trocr import TrOCR, beam_generate, generate, graft_lm_decoder
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.ops.ctc import ctc_loss, label_repeats, pack_labels
from kuzu_torch.tasks import base
from kuzu_torch.tasks.base import CropTrainer, resolve_val_batches


def _image_size(cfg) -> tuple[int, int]:
    v = cfg.get("imgsz", [1024, 64])
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


def build_trocr(cfg, vocab_size: int, dtype: torch.dtype = torch.float32,
                dropout: float = 0.0) -> TrOCR:
    """The TrOCR of a recognize config (its widths, crop size, patch,
    ``max_label_length``, the CTC head where ``ctc_weight > 0``)."""
    return TrOCR(
        vocab_size=vocab_size, image_size=_image_size(cfg),
        patch_size=(int(cfg.get("patch", 16)),) * 2,
        enc_dim=int(cfg.get("enc_dim", 384)), enc_depth=int(cfg.get("enc_depth", 6)),
        enc_heads=int(cfg.get("enc_heads", 6)), dec_dim=int(cfg.get("dec_dim", 256)),
        dec_depth=int(cfg.get("dec_depth", 4)), dec_heads=int(cfg.get("dec_heads", 8)),
        max_len=int(cfg.get("max_label_length", 128)),
        encoder_type=str(cfg.get("encoder", "vit")),
        ctc_head=float(cfg.get("ctc_weight", 0.0)) > 0, dropout=dropout, dtype=dtype)


def ctc_targets(tokens: torch.Tensor, t: int):
    """The joint CTC loss's labels from decoder tokens (B, L): the text
    characters (ids >= 5) left-packed, 0-padded, cut to ``t`` columns; their
    lengths (uncut); and the adjacent repeats a path needs extra frames
    for."""
    labels, lens = pack_labels(tokens)
    labels = labels[:, :t]
    return labels, lens, label_repeats(labels)


class RecognizeTrainer(CropTrainer):
    # from-scratch TrOCR under the YOLO SGD auto-rule stalls; the reference
    # fine-tunes with AdamW
    auto_optimizer = "adamw"

    def resolve_tokenizer(self) -> CharTokenizer | None:
        """``tokenizer``, else the ``pretrained`` recognize run's, else the
        ``decoder_init`` LM run's (token ids must line up with the grafted
        embeddings)."""
        cfg = self.cfg
        tok = cfg.get("tokenizer")
        if not tok and cfg.get("pretrained") not in (None, "", True, False):
            cand = Path(str(cfg.pretrained)) / "tokenizer.json"
            tok = cand if cand.exists() else None
        if not tok and cfg.get("decoder_init"):
            cand = Path(str(cfg.decoder_init)) / "tokenizer.json"
            tok = cand if cand.exists() else None
        return CharTokenizer.load(tok) if tok else None

    def make_dataset(self, split: str, tokenizer: CharTokenizer | None):
        """A ``column_info.csv`` or a one-line folder, augmented in the
        training split."""
        cfg = self.cfg
        size, max_len = _image_size(cfg), int(cfg.get("max_label_length", 128))
        if str(cfg.data).endswith(".csv"):
            return self.column_dataset(split, tokenizer, size, max_len)
        return OneLineDataset(str(cfg.data), tokenizer, split=split, image_size=size,
                              max_length=max_len,
                              augment=bool(cfg.get("augment", True)) and split == "train",
                              seed=int(cfg.get("seed", 0)))

    def build_model(self) -> TrOCR:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        model = build_trocr(cfg, len(self.tokenizer), dtype, float(cfg.get("dropout", 0.0)))
        flax_init_(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        pre = cfg.get("pretrained")
        if pre not in (None, "", True, False):
            # full-weight warm start from a previous recognize run
            sd, n, total = partial_load(model.state_dict(), load_inference_params(
                CheckpointManager(Path(str(pre)) / "weights")))
            model.load_state_dict(sd)
            LOGGER.info(f"pretrained: {n}/{total} tensors from {pre}")
        if cfg.get("decoder_init"):
            self._graft_decoder(model, Path(str(cfg.get("decoder_init"))))
        self.model = model.to(self.device)
        self._val_model = copy.deepcopy(self.model).eval()  # EMA weights at validation
        return self.model

    def _graft_decoder(self, model: TrOCR, lm_run: Path) -> tuple[int, int]:
        """Graft a trained CharMLM run (EMA preferred, best before last) into
        the AR decoder (reference ``trocr_model.py:225-231``); raises where
        the LM's embedding does not match the decoder's. Returns
        ``(n_loaded, n_decoder_total)``."""
        lm_sd = load_inference_params(CheckpointManager(lm_run / "weights"))
        lm_emb = tuple(lm_sd["embed.weight"].shape)
        dec_emb = tuple(model.decoder.embed.weight.shape)
        if lm_emb != dec_emb:
            raise ValueError(
                f"decoder_init={lm_run}: LM embedding {lm_emb} does not match decoder "
                f"embedding {dec_emb} — dim or vocab mismatch (dec_dim={model.dec_dim}); no "
                "tensors transferred")
        sd, n, total = graft_lm_decoder(model.decoder.state_dict(), lm_sd)
        model.decoder.load_state_dict(sd)
        LOGGER.info(f"decoder_init: grafted {n}/{total} decoder tensors from {lm_run}")
        return n, total

    def ss_draws(self, shape, rng: torch.Generator) -> torch.Tensor:
        """Scheduled sampling's uniform draws, one per input position."""
        return torch.rand(shape, generator=rng, device=rng.device)

    def loss_fn(self, model: TrOCR, batch: dict, rng: torch.Generator):
        """Teacher-forced CE under pad masking; with ``ss_prob > 0``
        scheduled sampling (a no-grad decoder pass, each non-BOS, non-pad
        input replaced by the model's previous-step prediction where its
        draw is below ``ss_prob``); with ``ctc_weight > 0`` the joint CTC
        loss on the encoder memory, rows without an alignment masked out.
        Draws, in order from ``rng``: the jitter, the encoder's dropout, the
        first pass's dropout, the replacement mask, the decoder's dropout."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        images = batch["image"]
        if images.dtype == torch.uint8 and bool(cfg.get("augment", True)):
            images = self.aug_images(images, rng)
        pad = self.tokenizer.pad_id
        ss_prob = float(cfg.get("ss_prob", 0.0))
        ctc_w = float(cfg.get("ctc_weight", 0.0))
        memory = model.encode_train(images, train=True, rng=rng)
        if ss_prob > 0:
            with torch.no_grad():
                preds = model.decode_tokens(inputs, memory, train=True, rng=rng).argmax(-1)
            prev_pred = torch.cat([inputs[:, :1], preds[:, :-1]], dim=1)
            pos = torch.arange(inputs.shape[1], device=inputs.device)[None]
            replace = (self.ss_draws(inputs.shape, rng) < ss_prob) & (pos > 0) & (inputs != pad)
            inputs = torch.where(replace, prev_pred, inputs)
        logits = model.decode_tokens(inputs, memory, train=True, rng=rng).float()
        mask = (targets != pad).float()
        ce = torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]
        denom = mask.sum().clamp(min=1.0)
        loss = (ce * mask).sum() / denom
        metrics = {"token_acc": ((logits.argmax(-1) == targets).float() * mask).sum() / denom}
        if ctc_w > 0:
            ctc_logits = model.ctc_logits(memory)
            t = ctc_logits.shape[1]
            labels, label_lens, reps = ctc_targets(tokens, t)
            per = ctc_loss(ctc_logits, labels, torch.full_like(label_lens, t),
                           label_lens.clamp(max=labels.shape[1]), blank=0, reduction="none")
            # a label needing more frames than T (length plus adjacent
            # repeats) has no alignment: masked, as the reference masks its
            # ~1e30 loss
            feasible = ((label_lens + reps <= t) & (per < 1e6)).float()
            per = torch.where(feasible > 0, per, torch.zeros_like(per))
            aux = (per / label_lens.float().clamp(min=1)).sum() / feasible.sum().clamp(min=1.0)
            loss = loss + ctc_w * aux
            metrics["ctc_loss"] = aux
        return loss, metrics

    @torch.no_grad()
    def validate(self, state) -> dict[str, float]:
        """Teacher-forced token accuracy and the corpus CER of the decoded
        validation crops (``decode`` greedy or beam, capped at
        ``val_gen_batches``) with the EMA weights; fitness ``1 - cer``."""
        model = self._val_model
        model.load_state_dict(state.ema_state_dict())
        cfg, tok = self.cfg, self.tokenizer
        preds: list[str] = []
        refs: list[str] = []
        n_correct = n_tok = 0.0
        max_batches = resolve_val_batches(cfg, self.val_loader, "val_gen_batches")
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            smask = np.asarray(batch.get("sample_mask", np.ones(len(batch["image"]))))
            n_real = int(smask.sum())
            images = torch.from_numpy(batch["image"]).to(self.device)
            tokens = torch.from_numpy(batch["tokens"]).long().to(self.device)
            logits = model(images, tokens[:, :-1], train=False)
            targets = tokens[:, 1:]
            m = (targets != tok.pad_id).float() * torch.from_numpy(smask).float().to(
                self.device)[:, None]
            n_correct += float(((logits.argmax(-1) == targets).float() * m).sum())
            n_tok += float(m.sum())
            out = generate(model, images, max_len=int(cfg.get("max_label_length", 128)),
                           bos_id=tok.bos_id, eos_id=tok.eos_id,
                           decode=str(cfg.get("decode", "greedy")),
                           num_beams=int(cfg.get("num_beams", 4)),
                           length_penalty=float(cfg.get("length_penalty", 1.0)))
            preds.extend(tok.batch_decode(out[:n_real].cpu().numpy()))
            refs.extend(tok.batch_decode(batch["tokens"][:n_real, 1:]))
        if not refs:
            return {}
        cer = character_error_rate(preds, refs)
        if cfg.get("verbose", True) and preds:
            LOGGER.info(f"  sample: pred={preds[0]!r} ref={refs[0]!r}")
        return {"cer": cer, "tf_acc": n_correct / max(n_tok, 1.0), "fitness": 1.0 - cer}


def trainer_for(datasets: tuple[Any, Any, CharTokenizer], cls: type = RecognizeTrainer) -> type:
    """``cls`` serving ``(train_ds, val_ds, tokenizer)`` (``base.trainer_for``)."""
    return base.trainer_for(datasets, cls)


class RecognizePredictor:
    """A TrOCR, its tokenizer and its crop size (H, W) on one device.

    ``RecognizePredictor(cfg)`` loads the run dir ``cfg.model`` at the first
    :meth:`_setup` (``args.yaml``, ``tokenizer.json`` and ``weights/`` as
    ``RecognizeTrainer`` writes them, EMA preferred, ``best`` before
    ``last``; the CTC head where the run trained with ``ctc_weight > 0``);
    :meth:`from_model` wraps a TrOCR in memory. The model is f32, as the
    JAX predictor builds it."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ready = False

    @classmethod
    def from_model(cls, model: TrOCR, tokenizer: CharTokenizer, image_size,
                   device: torch.device | str | None = None) -> "RecognizePredictor":
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
        model = build_trocr(train_cfg, len(self.tokenizer))
        model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                    train_cfg=train_cfg))
        self.model = model.to(self.device).eval()
        self.ready = True

    def __call__(self, source) -> list[str]:
        """The texts of an image file or a list of them (or decoded uint8
        (H, W, 3) crops), each read by ``load_letterboxed`` at
        ``image_size``, the batch padded to ``next_bucket``, generated with
        ``cfg``'s ``decode``, ``num_beams`` and ``length_penalty``."""
        if not self.ready:
            self._setup()
        images, n = letterboxed_batch(source, self.image_size)
        out = self._fwd(images.to(self.device), decode=str(self.cfg.get("decode", "greedy")),
                        num_beams=int(self.cfg.get("num_beams", 4)),
                        length_penalty=float(self.cfg.get("length_penalty", 1.0)))
        return self.tokenizer.batch_decode(out[:n].cpu().numpy())

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor, decode: str = "greedy", num_beams: int = 4,
             length_penalty: float = 1.0, return_nbest: bool = False):
        """(B, H, W, 3) uint8 crops on the device -> tokens (B, max_len), or
        with ``return_nbest`` (beam search) ``(tokens (B, K, max_len), scores
        (B, K))``."""
        if not self.ready:
            self._setup()
        images = images.to(self.device)
        tok, max_len = self.tokenizer, self.model.max_len
        if return_nbest:
            return beam_generate(self.model, images, max_len=max_len, bos_id=tok.bos_id,
                                 eos_id=tok.eos_id, num_beams=num_beams,
                                 length_penalty=length_penalty, return_nbest=True)
        return generate(self.model, images, max_len=max_len, bos_id=tok.bos_id,
                        eos_id=tok.eos_id, decode=decode, num_beams=num_beams,
                        length_penalty=length_penalty)


class RecognizeValidator:
    """The standalone CER evaluation of a trained recognize run on a data
    split (``kuzu/tasks/recognize.py::RecognizeValidator``): ``model``,
    ``data``, ``split`` (default ``val``) and ``max_samples`` from the
    config, through ``tools/evaluation.py::evaluate_recognizer``."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg, self.device = cfg, device

    def run(self) -> dict:
        from kuzu_torch.tools.evaluation import evaluate_recognizer

        return evaluate_recognizer(
            str(self.cfg.get("model")), str(self.cfg.get("data")),
            split=str(self.cfg.get("split", "val")), max_samples=self.cfg.get("max_samples"),
            device=self.device)


register_task("recognize", trainer=RecognizeTrainer, predictor=RecognizePredictor,
              validator=RecognizeValidator)
