"""Char-LM task, predict side (counterpart of ``kuzu/tasks/lm.py``'s
``LMPredictor``): a CharMLM, its tokenizer and its text length, on one
device. The cascade rescores texts with it
(``KuzushijiPipeline.rescore_texts``).

The LM trainer (and with it a run dir in the port's checkpoint format) is
a later slice (ROADMAP section 1 item 14), so a predictor is built from a
CharMLM in memory with :meth:`LMPredictor.from_model`; the masked-text
restoration of ``__call__`` is not ported.
"""

from __future__ import annotations

import torch

from kuzu_torch.core.config import Config
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.lm import CharMLM
from kuzu_torch.models.yolo.detector import resolve_device


class LMPredictor:
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
        raise NotImplementedError(
            "loading an LM run dir waits for the port's LM trainer and its checkpoint "
            "format (ROADMAP section 1 item 14); build the predictor with "
            "LMPredictor.from_model")
