"""CTC recognition task, predict side (counterpart of ``kuzu/tasks/ctc.py``'s
``CTCPredictor``): a CRNN reads letterboxed column crops and greedy CTC
decodes them.

The CTC trainer (and with it ``ctc_loss`` and a run dir in the port's
checkpoint format) is a later slice (ROADMAP section 1 item 8), so a
predictor is built from a CRNN in memory with :meth:`CTCPredictor.from_model`;
transcribing image files (``__call__``) waits for a port of
``load_letterboxed``, which reads with PIL.
"""

from __future__ import annotations

import torch

from kuzu_torch.core.config import Config
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.crnn import CRNN
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.ops.ctc import ctc_greedy_decode


def _image_size(cfg) -> tuple[int, int]:
    v = cfg.get("imgsz", [512, 64])
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


class CTCPredictor:
    """A CRNN, its tokenizer and its crop size (H, W) on one device."""

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
        raise NotImplementedError(
            "loading a CTC run dir waits for the port's CTC trainer and its checkpoint "
            "format (ROADMAP section 1 item 8); build the predictor with "
            "CTCPredictor.from_model")

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor):
        """(B, H, W, 3) uint8 crops -> ((sequences (B, T), lengths (B,)),
        boxes (B, max_boxes, 4) or None)."""
        if not self.ready:
            self._setup()
        logits, boxes = self.model(images.to(self.device))
        return ctc_greedy_decode(logits, blank=0), boxes
