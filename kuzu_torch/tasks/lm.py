"""Char-LM pretraining task: MLM over one-char tokens (counterpart of
``kuzu/tasks/lm.py``): ``TextLineDataset`` (plain text, one sample per
line), ``LMTrainer`` (15% dynamic masking from the step's generator, MLM
cross-entropy on the masked positions, validation with a fixed masking
seed, EMA weights) and ``LMPredictor`` (a trained run dir, or a CharMLM in
memory through :meth:`LMPredictor.from_model`; masked-text restoration).
The cascade rescores texts with the predictor
(``KuzushijiPipeline.rescore_texts``).
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from kuzu_torch.api.model import register_task
from kuzu_torch.core.callbacks import LOGGER
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
from kuzu_torch.core.config import Config, load_config
from kuzu_torch.data.loader import DataLoader
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.layers import flax_init_
from kuzu_torch.models.lm import CharMLM, mask_from_draws, mlm_draws
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.tasks.base import BaseTrainer, resolve_val_batches

MASK_CHAR = "〓"  # the placeholder LMPredictor restores


class TextLineDataset:
    """Plain text file(s): one training sample per line, fixed-length ids."""

    def __init__(self, source: str | Path, tokenizer: CharTokenizer, max_length: int = 128):
        p = Path(source)
        files = sorted(p.glob("*.txt")) if p.is_dir() else [p]
        self.lines: list[str] = []
        for f in files:
            self.lines.extend(
                ln.strip() for ln in f.read_text(encoding="utf-8").splitlines() if ln.strip())
        self.tokenizer = tokenizer
        self.max_length = max_length

    def texts(self) -> list[str]:
        return self.lines

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        tokens = self.tokenizer.encode(self.lines[idx], max_length=self.max_length)
        return {"tokens": tokens,
                "attention_mask": (tokens != self.tokenizer.pad_id).astype(np.float32)}


def mlm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """(mean CE over the masked positions, their count, correct argmaxes),
    as optax's ``softmax_cross_entropy_with_integer_labels`` on the
    positions with ``labels >= 0``."""
    sel = labels >= 0
    safe = torch.where(sel, labels, torch.zeros_like(labels)).long()
    logits = logits.float()
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, safe[..., None])[..., 0]
    count = sel.sum()
    correct = (sel & (logits.argmax(-1) == safe)).sum()
    return torch.where(sel, ce, torch.zeros_like(ce)).sum() / count.clamp(min=1), count, correct


class LMTrainer(BaseTrainer):
    auto_optimizer = "adamw"  # transformer LM: Adam, not the YOLO SGD rule

    def build_datasets(self):
        cfg = self.cfg
        max_len = int(cfg.get("max_length", 128))
        tok_path = cfg.get("tokenizer")
        src = Path(str(cfg.data))
        train_src = src / "train.txt" if (src / "train.txt").exists() else src
        val_src = src / "val.txt" if (src / "val.txt").exists() else None
        if tok_path:
            tokenizer = CharTokenizer.load(tok_path)
        else:
            tokenizer = CharTokenizer.train(
                TextLineDataset(train_src, CharTokenizer(), max_len).texts())
        self.tokenizer = tokenizer
        tokenizer.save(self.save_dir / "tokenizer.json")
        self.train_ds = TextLineDataset(train_src, tokenizer, max_len)
        self.val_ds = TextLineDataset(val_src, tokenizer, max_len) if val_src else self.train_ds
        batch = int(cfg.get("batch", 16))
        workers = int(cfg.get("workers", 4))
        return (
            DataLoader(self.train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                       num_workers=workers),
            DataLoader(self.val_ds, batch, shuffle=False, pad_last=True, num_workers=workers),
        )

    def build_model(self) -> CharMLM:
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        model = CharMLM(
            vocab_size=len(self.tokenizer), max_len=int(cfg.get("max_length", 128)),
            dim=int(cfg.get("dim", 256)), depth=int(cfg.get("depth", 6)),
            num_heads=int(cfg.get("heads", 8)), dropout=float(cfg.get("dropout", 0.0)),
            dtype=dtype)
        flax_init_(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        self.model = model.to(self.device)
        self._val_model = copy.deepcopy(self.model).eval()  # EMA weights at validation
        return self.model

    def mlm_draws(self, tokens: torch.Tensor, rng: torch.Generator):
        """The masking's draws (select, kind, random token) for ``tokens``."""
        return mlm_draws(tokens.shape, rng, len(self.tokenizer), device=tokens.device)

    def mask(self, tokens: torch.Tensor, rng: torch.Generator):
        """``apply_mlm_masking`` of ``tokens`` with this run's ``mlm_prob``:
        (masked tokens, labels)."""
        return mask_from_draws(tokens, *self.mlm_draws(tokens, rng),
                               mask_id=self.tokenizer.mask_id,
                               mlm_prob=float(self.cfg.get("mlm_prob", 0.15)))

    def loss_fn(self, model: CharMLM, batch: dict, rng: torch.Generator):
        """MLM cross-entropy on the masked positions (masking, then dropout,
        from ``rng``) and the masked-token accuracy."""
        masked, labels = self.mask(batch["tokens"].long(), rng)
        logits = model(masked, batch["attention_mask"], train=True, rng=rng)
        loss, count, correct = mlm_cross_entropy(logits, labels)
        return loss, {"masked_acc": correct / count.clamp(min=1)}

    @torch.no_grad()
    def validate(self, state) -> dict[str, float]:
        """Masked accuracy and CE over the validation split with the EMA
        weights, the masking drawn from a fixed seed (12345) for
        comparability; a restoration preview of the first two batches."""
        model = self._val_model
        model.load_state_dict(state.ema_state_dict())
        rng = torch.Generator(device=self.device).manual_seed(12345)
        total, correct, loss_sum, shown = 0, 0, 0.0, 0
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            tokens = torch.from_numpy(batch["tokens"]).long().to(self.device)
            rows = torch.from_numpy(np.asarray(
                batch.get("sample_mask", np.ones(len(tokens))))).to(self.device) > 0
            masked, labels = self.mask(tokens, rng)
            logits = model(masked, torch.from_numpy(batch["attention_mask"]).to(self.device))
            labels = torch.where(rows[:, None], labels, torch.full_like(labels, -100))
            ce, count, right = mlm_cross_entropy(logits, labels)
            total += int(count)
            correct += int(right)
            loss_sum += float(ce) * int(count)
            if shown < 2 and self.cfg.get("verbose", True):
                sel = labels[0] >= 0
                restored = tokens[0].clone()
                restored[sel] = logits[0].argmax(-1)[sel]
                LOGGER.info(f"  restore: in={self.tokenizer.decode(masked[0].tolist())!r} "
                            f"out={self.tokenizer.decode(restored.tolist())!r}")
                shown += 1
        if total == 0:
            return {}
        return {"masked_acc": correct / total, "loss": loss_sum / total,
                "fitness": correct / total}


class LMPredictor:
    """A CharMLM, its tokenizer and its text length, on one device.

    ``LMPredictor(cfg)`` loads the run dir ``cfg.model`` at the first
    :meth:`_setup` (``args.yaml``, ``tokenizer.json`` and ``weights/`` as
    ``LMTrainer`` writes them, EMA preferred, ``best`` before ``last``);
    :meth:`from_model` wraps a CharMLM in memory. The model is f32, as the
    JAX predictor builds it."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ready = False

    @classmethod
    def from_model(cls, model: CharMLM, tokenizer: CharTokenizer, max_len: int = 128,
                   device: torch.device | str | None = None) -> "LMPredictor":
        """``max_len`` is the text length in tokens, BOS and EOS included
        (the reference's ``max_length``, 128 by default)."""
        self = cls(Config(max_length=max_len), device=device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_len = int(max_len)
        self.ready = True
        return self

    def _setup(self) -> None:
        run_dir = Path(str(self.cfg.get("model")))
        if not (run_dir / "weights").is_dir():
            raise FileNotFoundError(f"{run_dir} holds no weights/ of a port run")
        args = run_dir / "args.yaml"
        train_cfg = load_config(args if args.exists() else None)
        self.tokenizer = CharTokenizer.load(run_dir / "tokenizer.json")
        self.max_len = int(train_cfg.get("max_length", 128))
        model = CharMLM(vocab_size=len(self.tokenizer), max_len=self.max_len,
                        dim=int(train_cfg.get("dim", 256)), depth=int(train_cfg.get("depth", 6)),
                        num_heads=int(train_cfg.get("heads", 8)))
        model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                    train_cfg=train_cfg))
        self.model = model.to(self.device).eval()
        self.ready = True

    @torch.no_grad()
    def __call__(self, source) -> list[str]:
        """Text(s) holding the mask character '〓' -> the texts with each
        masked character restored by the LM's argmax."""
        if not self.ready:
            self._setup()
        texts = [source] if isinstance(source, str) else list(source)
        tok = self.tokenizer
        out = []
        for t in texts:
            ids = tok.encode(t, max_length=self.max_len)
            for p, ch in enumerate(tok.normalize(t), start=1):  # after BOS
                if ch == MASK_CHAR and p < self.max_len:
                    ids[p] = tok.mask_id
            x = torch.from_numpy(ids[None]).long().to(self.device)
            pred = self.model(x, (x != tok.pad_id).float()).argmax(-1)[0].cpu().numpy()
            restored = np.where(ids == tok.mask_id, pred, ids)
            out.append(tok.decode(restored))
        return out


register_task("lm", trainer=LMTrainer, predictor=LMPredictor)
