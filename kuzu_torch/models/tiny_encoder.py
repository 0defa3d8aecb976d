"""TinyViT-lite, the MobileSAM image encoder (counterpart of
``kuzu/models/tiny_encoder.py``): a convolutional patch embedding to stride
4, an MBConv stage, then windowed-attention stages with patch merging to
stride 16 and a Dense neck to the decoder's width, with the
``SAMImageEncoder`` contract ``(B, S, S, 3) -> (B, (S / 16)^2, dim)``.

Activations stay NHWC, as flax's; LayerNorm is over the channels.
flax's ``nn.Conv`` pads ``'SAME'``: for the stride-2 3 x 3 convolutions
(``embed0``, ``embed1``, ``merge{i}``) over even sizes that is no row
before and one after, not torch's one on each side (:func:`same_pad`).
Window attention is the einsum route always: ``attn_impl`` is accepted and
ignored, as in JAX (``kuzu/models/tiny_encoder.py:120``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import Dense, Mlp, MultiHeadAttention, gelu, layer_norm
from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.images import from_uint8


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, D) -> (B nH nW, w w, D); H and W must tile by w."""
    b, h, wd, d = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // w) * (wd // w), w * w, d)


def window_merge(x: torch.Tensor, w: int, hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    h, wd = hw
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, x.shape[-1])


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``'SAME'`` padding of one axis: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(..., dtype)`` (padding ``'SAME'``) on an NHWC tensor:
    input and kernel in ``dtype``, the bias (where there is one) added in
    ``dtype`` after the product."""
    (kh, kw), (sh, sw) = m.kernel_size, m.stride
    (t, b), (lft, r) = same_pad(x.shape[1], kh, sh), same_pad(x.shape[2], kw, sw)
    xn = F.pad(x.permute(0, 3, 1, 2).to(dtype), (lft, r, t, b))
    y = conv2d(xn, m.weight.to(dtype), None, m.stride, 0, 1, m.groups).permute(0, 2, 3, 1)
    return y if m.bias is None else y + m.bias.to(dtype)


class MBConv(nn.Module):
    """Inverted bottleneck: 1 x 1 expand, 3 x 3 depthwise, 1 x 1 project
    (no biases), LayerNorm + GELU after each, the residual."""

    def __init__(self, dim: int, expand: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        h = int(dim * expand)
        self.dtype = dtype
        self.pw1 = nn.Conv2d(dim, h, 1, bias=False)
        self.n1 = layer_norm(h, dtype)
        self.dw = nn.Conv2d(h, h, 3, groups=h, bias=False)
        self.n2 = layer_norm(h, dtype)
        self.pw2 = nn.Conv2d(h, dim, 1, bias=False)
        self.n3 = layer_norm(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = gelu(self.n1(conv_same(self.pw1, x, dt)))
        y = gelu(self.n2(conv_same(self.dw, y, dt)))
        return gelu(x + self.n3(conv_same(self.pw2, y, dt)))


class TinyBlock(nn.Module):
    """Window attention (window ``min(window, H, W)``), a depthwise 3 x 3
    local convolution with a bias, and the MLP."""

    def __init__(self, dim: int, num_heads: int, window: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.dtype = window, dtype
        self.norm1 = layer_norm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype)
        self.local = nn.Conv2d(dim, dim, 3, groups=dim)
        self.norm2 = layer_norm(dim, dtype)
        self.norm3 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, D)
        b, h, wd, d = x.shape
        w = min(self.window, h, wd)
        y = self.attn(window_partition(self.norm1(x), w))
        x = x + window_merge(y, w, (h, wd))
        x = x + conv_same(self.local, self.norm2(x), self.dtype)
        y = self.norm3(x).reshape(b, h * wd, d)
        return x + self.mlp(y).reshape(b, h, wd, d)


class TinyViTEncoder(nn.Module):
    """MobileSAM-lite image encoder: ``(B, S, S, 3) -> (B, (S / 16)^2, dim)``."""

    def __init__(self, img_size: int = 256, dim: int = 256, embed_dims=(64, 128, 160),
                 depths=(2, 2, 4), num_heads=(0, 4, 5), window: int = 8,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "einsum"):
        super().__init__()
        self.img_size, self.dtype = img_size, dtype
        self.embed_dims, self.depths = tuple(embed_dims), tuple(depths)
        d0 = embed_dims[0]
        self.embed0 = nn.Conv2d(3, d0 // 2, 3, stride=2)
        self.embed_n0 = layer_norm(d0 // 2, dtype)
        self.embed1 = nn.Conv2d(d0 // 2, d0, 3, stride=2)
        self.embed_n1 = layer_norm(d0, dtype)
        prev = d0
        for si, (d, depth) in enumerate(zip(embed_dims, depths)):
            if si > 0:
                self.add_module(f"merge{si}", nn.Conv2d(prev, d, 3, stride=2))
                self.add_module(f"merge_n{si}", layer_norm(d, dtype))
            for bi in range(depth):
                blk = (MBConv(d, dtype=dtype) if si == 0
                       else TinyBlock(d, num_heads[si], window, dtype=dtype))
                self.add_module(f"s{si}b{bi}", blk)
            prev = d
        self.neck = Dense(prev, dim, dtype)
        self.norm = layer_norm(dim, dtype)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = from_uint8(images)
        x = gelu(self.embed_n0(conv_same(self.embed0, x, dt)))
        x = gelu(self.embed_n1(conv_same(self.embed1, x, dt)))
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = conv_same(getattr(self, f"merge{si}"), x, dt)
                x = gelu(getattr(self, f"merge_n{si}")(x))
            for bi in range(depth):
                x = getattr(self, f"s{si}b{bi}")(x)
        g = self.img_size // 16
        x = self.neck(x.reshape(x.shape[0], g * g, x.shape[-1]))
        return self.norm(x)
