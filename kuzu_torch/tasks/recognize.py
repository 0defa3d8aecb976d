"""Recognition task, predict side (counterpart of ``kuzu/tasks/recognize.py``'s
``RecognizePredictor``): a TrOCR reads letterboxed column crops with
greedy or beam decoding.

The recognize trainer (and with it a run dir in the port's checkpoint
format, ``graft_lm_decoder`` and K4's f32 route) is a later slice (ROADMAP
section 1 item 14), so a predictor is built from a TrOCR in memory with
:meth:`RecognizePredictor.from_model`; transcribing image files
(``__call__``) waits for a port of ``load_letterboxed``, which reads with
PIL.
"""

from __future__ import annotations

import torch

from kuzu_torch.core.config import Config
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.trocr import TrOCR, beam_generate, generate
from kuzu_torch.models.yolo.detector import resolve_device


def _image_size(cfg) -> tuple[int, int]:
    v = cfg.get("imgsz", [1024, 64])
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


class RecognizePredictor:
    """A TrOCR, its tokenizer and its crop size (H, W) on one device."""

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
        raise NotImplementedError(
            "loading a recognize run dir waits for the port's recognize trainer and its "
            "checkpoint format (ROADMAP section 1 item 14); build the predictor with "
            "RecognizePredictor.from_model")

    def __call__(self, source) -> list[str]:
        raise NotImplementedError(
            "transcribing image files needs load_letterboxed, which reads with PIL (not "
            "ported); pass decoded crops to _fwd or run the cascade on decoded pages")

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
