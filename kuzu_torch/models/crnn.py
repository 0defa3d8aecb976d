"""CTC CRNN recognizer: conv encoder -> BiLSTM -> per-timestep char logits
(counterpart of ``kuzu/models/crnn.py``).

The time axis is the column's long side (height for vertical text): the
encoder's strides halve it twice (T = H / 4) and halve the short side four
times, then average it away. ``dtype`` has flax's meaning: with bfloat16 the
encoder's convolutions and BatchNorms compute in bf16 over f32 parameters
(a conv casts its kernel to the input's dtype; BatchNorm is the yolov12
port's flax BatchNorm, ``models.yolo.modules.flax_batch_norm``: statistics
and normalisation in f32, momentum 0.97, eps 1e-3, the running variance
moved by the biased batch variance), and the features are cast to f32
before the BiLSTM; the LSTM, the head and the box head stay f32. Training
mode follows ``self.training``, as the yolov12 modules do. The JAX
predictor builds its CRNN in f32 whatever the run trained in, and so does
``CTCPredictor``.

Module names follow the flax tree, so ``kuzu_torch.bridge.crnn_from_flax``
maps it one to one (the LSTM's two flax cells, ``CRNN.flax_lstm_cells``,
are ``lstm``'s two directions).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import f32_products
from kuzu_torch.models.yolo.modules import flax_batch_norm
from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.images import from_uint8

STRIDES = ((2, 2), (2, 2), (1, 2), (1, 2))  # (time, short side) per stage
DIMS = (64, 128, 256, 256)


def ctc_frames(length: int) -> int:
    """The CRNN's time steps for a crop whose time side is ``length``
    pixels: each strided stage (3x3, padding 1) divides it, rounding up."""
    for s, _ in STRIDES:
        length = (length - 1) // s + 1
    return length


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)``: the f32 kernel cast to x's dtype."""
    return conv2d(x, m.weight.to(x.dtype), None, m.stride, m.padding)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + SiLU, flax's ``ConvBN``."""

    def __init__(self, cin: int, cout: int, stride=(1, 1)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(flax_batch_norm(self.bn, _conv(self.conv, x)))


class ConvEncoder(nn.Module):
    """Per stage a stride-1 ConvBN (``conv{i}a``), then a strided conv
    (``down{i}``) with its own BatchNorm (``bn{i}``) and SiLU; the short axis
    is averaged away at the end."""

    def __init__(self, dims=DIMS, time_axis: str = "height", cin: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if time_axis not in ("height", "width"):
            raise ValueError(f"time_axis is 'height' or 'width', got {time_axis!r}")
        self.time_axis, self.dtype = time_axis, dtype
        for i, (d, s) in enumerate(zip(dims, STRIDES)):
            self.add_module(f"conv{i}a", ConvBN(cin, d))
            self.add_module(f"down{i}", nn.Conv2d(d, d, 3, stride=s, padding=1, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(d, eps=1e-3, momentum=0.03))
            cin = d
        self.stages = len(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, T, C) in ``dtype`` (the short axis averaged
        in f32 and rounded once, as ``jnp.mean`` of bf16)."""
        x = x.to(self.dtype)
        if self.time_axis == "width":
            x = x.transpose(2, 3)  # time axis -> H
        for i in range(self.stages):
            x = getattr(self, f"conv{i}a")(x)
            x = flax_batch_norm(getattr(self, f"bn{i}"), _conv(getattr(self, f"down{i}"), x))
            x = F.silu(x)
        return _at_least_f32(x).mean(dim=3).to(self.dtype).transpose(1, 2)


class CRNN(nn.Module):
    # flax names the BiLSTM's cells by the parent's counter (they are built
    # in CRNN.__call__), forward first; the bridge maps them onto ``lstm``
    flax_lstm_cells = {"lstm": ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1")}

    def __init__(
        self,
        num_classes: int,
        dims=DIMS,
        lstm_hidden: int = 256,
        time_axis: str = "height",
        max_boxes: int = 0,  # > 0 enables the fixed-size box head
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes, self.max_boxes, self.dtype = num_classes, max_boxes, dtype
        self.encoder = ConvEncoder(dims, time_axis, dtype=dtype)
        self.lstm = nn.LSTM(dims[-1], lstm_hidden, batch_first=True, bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):  # flax's cells have one bias a gate
            getattr(self.lstm, name).requires_grad_(False)
        self.head = nn.Linear(2 * lstm_hidden, num_classes)
        if max_boxes > 0:
            self.box_fc = nn.Linear(2 * lstm_hidden, 512)
            self.box_out = nn.Linear(512, max_boxes * 4)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "CRNN":
        """Seeded init, flax's defaults in distribution: every weight lecun
        normal (truncated normal, variance 1 / fan_in; flax inits the LSTM's
        recurrent kernels orthogonal instead), biases zero, BatchNorm the
        identity."""
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:
            m.reset_parameters()
        skip = {id(p) for m in bns for p in m.parameters()}
        for p in self.parameters():
            if id(p) in skip:
                continue
            if p.dim() >= 2:
                std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            else:
                p.zero_()
        return self

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(B, H, W, 3) uint8 (or normalised float) -> (logits (B, T,
        num_classes), boxes (B, max_boxes, 4) normalised xyxy or None).

        In training mode (``self.training``) the BatchNorms normalise by the
        batch's statistics and move their running ones. Convolutions, the
        LSTM and the products run with TF32 off (:func:`f32_products`): the
        reference is f32, and TF32 keeps ~3 digits, far outside the logits'
        tolerance."""
        x = from_uint8(images, mean=0.5, std=0.5).permute(0, 3, 1, 2)
        with f32_products():
            feat = _at_least_f32(self.encoder(x))
            h, _ = self.lstm(feat)
            logits = self.head(h)
            boxes = None
            if self.max_boxes > 0:
                b = self.box_out(torch.relu(self.box_fc(h.mean(dim=1))))
                boxes = torch.sigmoid(b.reshape(-1, self.max_boxes, 4))
        return logits, boxes
