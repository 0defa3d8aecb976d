"""UNet-Transformer encoder for one-line OCR (counterpart of
``kuzu/models/unet_transformer.py``): a ConvGN stem, ``num_downsamples``
strided ConvGN stages, the feature map flattened to tokens, a learned
position embedding sized by the input, a transformer encoder stack (the
einsum attention, as JAX's: it routes no kernel) and a projection to
``out_dim``. The TrOCR takes it with ``encoder_type="unet"``.

``dtype`` has flax's meaning (``models/layers.py``); ``GroupNorm`` is
flax's (eps 1e-6, the fast variance ``E[x^2] - E[x]^2`` in f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import Dense, EncoderBlock, layer_norm
from kuzu_torch.ops.conv import conv2d


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups, dtype=...)`` on NCHW: eps 1e-6,
    statistics per (sample, group) in f32 with the fast variance (clamped
    at 0), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, the result
    in ``dtype``."""

    def __init__(self, num_groups: int, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, channels, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        g = xf.reshape(b, self.num_groups, -1)
        mean = g.mean(-1)
        var = ((g * g).mean(-1) - mean * mean).clamp(min=0.0)
        shape = (b, c) + (1,) * (x.dim() - 2)
        rep = c // self.num_groups
        mean = mean.repeat_interleave(rep, 1).reshape(shape)
        var = var.repeat_interleave(rep, 1).reshape(shape)
        pshape = (1, c) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(pshape)
        return ((xf - mean) * mul + self.bias.reshape(pshape)).to(self.dtype)


class ConvGN(nn.Module):
    """Conv (no bias, in ``dtype``) + GroupNorm (``min(32, c)`` groups) +
    SiLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, bias=False)
        self.gn = GroupNorm(min(32, features), features, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = conv2d(x.to(self.dtype), c.weight.to(self.dtype), None, c.stride, c.padding)
        return F.silu(self.gn(y))


class UNetTransformerEncoder(nn.Module):
    """(B, H, W, C) images -> (B, T, out_dim) tokens, T = the feature map's
    size after ``num_downsamples`` stride-2 stages (``image_size`` fixes
    the learned position embedding's length, as flax's init input does)."""

    def __init__(self, image_size=(1024, 64), out_dim: int = 256, base_channels: int = 64,
                 num_downsamples: int = 3, depth: int = 4, num_heads: int = 8,
                 mlp_ratio: float = 4.0, dropout: float = 0.0, cin: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = ConvGN(cin, base_channels, 3, dtype=dtype)
        ch, h, w = base_channels, image_size[0], image_size[1]
        self.num_downsamples, self.depth = num_downsamples, depth
        for i in range(num_downsamples):
            c2 = min(ch * 2, 512)
            self.add_module(f"down{i}", ConvGN(ch, c2, 3, stride=2, dtype=dtype))
            self.add_module(f"conv{i}", ConvGN(c2, c2, 3, dtype=dtype))
            ch, h, w = c2, (h - 1) // 2 + 1, (w - 1) // 2 + 1
        self.token_proj = Dense(ch, out_dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(h * w, out_dim))
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(out_dim, num_heads, mlp_ratio,
                                                      dropout=dropout, dtype=dtype))
        self.norm = layer_norm(out_dim, dtype)
        self.out_proj = Dense(out_dim, out_dim, dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.stem(images.permute(0, 3, 1, 2))
        for i in range(self.num_downsamples):
            x = getattr(self, f"conv{i}")(getattr(self, f"down{i}")(x))
        b, c, h, w = x.shape
        tokens = self.token_proj(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        tokens = tokens + self.pos_embed[None].to(tokens.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, train=train, rng=rng)
        return self.out_proj(self.norm(tokens))
