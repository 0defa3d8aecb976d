"""CSA-ViT: a ViT with structure and context modules, CTC or AR decoding
(counterpart of ``kuzu/models/csa_vit.py``).

- :class:`StructureModule` over the (gh, gw) patch grid: ``"cnn"``, a
  depthwise 3x3 conv with bias, flax's tanh-approximate GELU and a
  pointwise conv; ``"graph"``, the four shifted neighbours (zeros past the
  border) gated by a softmax over ``q . k / sqrt(c)`` (``gate_q/k/v``);
- :class:`CSAViTLayer`: self-attention, the optional structure module,
  the optional context module (cross-attention from the tokens to
  ``n_context`` context tokens, each the mean of ``step`` consecutive
  tokens), the MLP; every attention the einsum route, as JAX's;
- :class:`CSAViTEncoder` (``grad_checkpoint``: each layer under torch's
  non-reentrant checkpoint, dropout's draws replayed in the recompute) and
  :class:`CSAViT` with its ``ctc`` head (the memory averaged over the
  grid's width) or ``ar`` head (the TrOCR's ``ARDecoder``).

``dtype`` has flax's meaning (``models/layers.py``). The TrOCR takes the
encoder with ``encoder_type="csa"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kuzu_torch.models.layers import (
    Dense,
    Mlp,
    MultiHeadAttention,
    PatchEmbed,
    dtype_products,
    layer_norm,
    sincos_2d_pos_embed,
)
from kuzu_torch.ops.conv import conv2d


def _shift(x: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """``x`` moved by ``step`` along ``axis`` with zeros shifted in: entry
    i takes i - step (``jnp.pad`` then a slice)."""
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    if step > 0:
        return torch.cat([z, x.narrow(axis, 0, x.shape[axis] - 1)], axis)
    return torch.cat([x.narrow(axis, 1, x.shape[axis] - 1), z], axis)


class StructureModule(nn.Module):
    """Local structure over the (gh, gw) patch grid, added to the tokens."""

    def __init__(self, dim: int, mode: str = "cnn", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode, self.dtype = mode, dtype
        if mode == "cnn":
            self.dw = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
            self.pw = nn.Conv2d(dim, dim, 1)
        else:
            self.gate_q = Dense(dim, dim, dtype)
            self.gate_k = Dense(dim, dim, dtype)
            self.gate_v = Dense(dim, dim, dtype)

    def forward(self, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        b, t, c = tokens.shape
        x = tokens.reshape(b, gh, gw, c)
        dt = self.dtype
        if self.mode == "cnn":
            y = x.permute(0, 3, 1, 2).to(dt)
            y = conv2d(y, self.dw.weight.to(dt), self.dw.bias.to(dt), 1, 1, 1, c)
            y = F.gelu(y, approximate="tanh")
            y = conv2d(y, self.pw.weight.to(dt), self.pw.bias.to(dt)).permute(0, 2, 3, 1)
        else:  # the four neighbours up, down, left, right, gated
            neigh = torch.stack([_shift(x, 1, 1), _shift(x, 1, -1), _shift(x, 2, 1),
                                 _shift(x, 2, -1)], dim=-2)  # (B, H, W, 4, C)
            q, k = self.gate_q(x), self.gate_k(neigh)
            scale = torch.full((), math.sqrt(c), dtype=torch.float32, device=x.device)
            att = torch.softmax((q[..., None, :] * k).sum(-1) / scale, dim=-1)
            y = (att[..., None] * self.gate_v(neigh)).sum(-2)
        return tokens + y.reshape(b, t, c)


class CSAViTLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 structure: str | None = None, context: bool = False, n_context: int = 8,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.context, self.n_context = context, n_context
        self.norm1 = layer_norm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dropout=dropout, dtype=dtype)
        self.structure = StructureModule(dim, structure, dtype) if structure else None
        if context:
            self.norm_ctx = layer_norm(dim, dtype)
            self.context_attn = MultiHeadAttention(dim, num_heads, dropout=dropout, dtype=dtype)
        self.norm2 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, gh: int, gw: int, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), train=train, rng=rng)
        if self.structure is not None:
            x = self.structure(x, gh, gw)
        if self.context:
            b, t, c = x.shape
            step = max(t // self.n_context, 1)
            ctx = x[:, : step * self.n_context].reshape(b, self.n_context, step, c).mean(2)
            x = x + self.context_attn(self.norm_ctx(x), kv=ctx, train=train, rng=rng)
        return x + self.mlp(self.norm2(x), train, rng)


def _replaying(layer: nn.Module, rng: torch.Generator | None):
    """``layer`` as a function for ``checkpoint`` whose recompute draws
    dropout's masks from a copy of ``rng`` as it stood before the first
    call, so both passes draw the same masks and ``rng`` advances once."""
    if rng is None:
        return lambda *a: layer(*a, rng=None)
    state, calls = rng.get_state(), [0]

    def run(*a):
        calls[0] += 1
        g = rng
        if calls[0] > 1:  # the recompute in the backward
            g = torch.Generator(device=rng.device)
            g.set_state(state)
        return layer(*a, rng=g)

    return run


class CSAViTEncoder(nn.Module):
    def __init__(self, image_size=(1024, 64), patch_size=(16, 16), dim: int = 256,
                 depth: int = 6, num_heads: int = 8, structure: str | None = "cnn",
                 structure_layers=(0, 2, 4), context_layers=(1, 3, 5), dropout: float = 0.0,
                 grad_checkpoint: bool = False, cin: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gh = image_size[0] // patch_size[0]
        self.gw = image_size[1] // patch_size[1]
        self.depth, self.grad_checkpoint = depth, grad_checkpoint
        self.PatchEmbed_0 = PatchEmbed(dim, patch_size, cin=cin, dtype=dtype)
        self.register_buffer("pos", torch.from_numpy(sincos_2d_pos_embed(dim, self.gh, self.gw)),
                             persistent=False)
        for i in range(depth):
            self.add_module(f"layer{i}", CSAViTLayer(
                dim, num_heads, structure=structure if i in structure_layers else None,
                context=i in context_layers, dropout=dropout, dtype=dtype))
        self.norm = layer_norm(dim, dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.PatchEmbed_0(images)
        x = x + self.pos[None].to(x.dtype)
        for i in range(self.depth):
            layer = getattr(self, f"layer{i}")
            if self.grad_checkpoint and torch.is_grad_enabled():
                x = checkpoint(_replaying(layer, rng), x, self.gh, self.gw, train,
                               use_reentrant=False)
            else:
                x = layer(x, self.gh, self.gw, train, rng)
        return self.norm(x)


class CSAViT(nn.Module):
    """Encoder + head: ``"ctc"`` (per-row logits (B, gh, vocab), f32) or
    ``"ar"`` (the ``ARDecoder``'s teacher-forced logits)."""

    def __init__(self, vocab_size: int, head: str = "ctc", image_size=(1024, 64),
                 patch_size=(16, 16), dim: int = 256, depth: int = 6, num_heads: int = 8,
                 structure: str | None = "cnn", max_len: int = 128, dec_depth: int = 4,
                 grad_checkpoint: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        from kuzu_torch.models.trocr import ARDecoder

        self.head, self.dim, self.dtype = head, dim, dtype
        self.gh = image_size[0] // patch_size[0]
        self.gw = image_size[1] // patch_size[1]
        self.encoder = CSAViTEncoder(image_size, patch_size, dim, depth, num_heads,
                                     structure=structure, grad_checkpoint=grad_checkpoint,
                                     dtype=dtype)
        if head == "ctc":
            self.ctc_head = Dense(dim, vocab_size)  # f32
        else:
            self.decoder = ARDecoder(vocab_size, max_len, dim, dec_depth, num_heads,
                                     enc_dim=dim, dtype=dtype)

    def encode(self, images: torch.Tensor, train: bool = False,
               rng: torch.Generator | None = None) -> torch.Tensor:
        with dtype_products(self.dtype):
            return self.encoder(images, train, rng)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor | None = None,
                train: bool = False, rng: torch.Generator | None = None) -> torch.Tensor:
        mem = self.encode(images, train, rng)
        with dtype_products(self.dtype):
            if self.head == "ctc":
                rows = mem.reshape(mem.shape[0], self.gh, self.gw, self.dim).mean(2)
                return self.ctc_head(rows)
            if tokens is None:
                raise ValueError("the AR head needs teacher-forcing tokens")
            return self.decoder(tokens, mem, train, rng)
