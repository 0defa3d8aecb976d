"""Transformer building blocks of the TrOCR and char-LM families
(counterpart of ``kuzu/models/layers.py``).

flax's defaults where they differ from torch's: LayerNorm eps 1e-6, GELU
the tanh approximation, masks as ``where(mask, s, -1e30)``. Module and
parameter names follow the flax tree, so ``kuzu_torch.bridge`` maps them
one to one. ``ConvBN`` is not copied: the YOLO modules have their own.

``dtype`` has flax's meaning: parameters stay f32; :class:`Dense`,
:class:`Embed` and the patch conv compute in ``dtype``; :class:`LayerNorm`
takes its statistics in f32 and returns ``dtype``; attention scores and
softmax are f32, P is cast to ``dtype`` before P V. The JAX predictors
build f32, the trainers ``cfg.dtype``.

``train`` has flax's meaning (``deterministic = not train``) and is passed
down explicitly, not read from ``nn.Module.training``: it switches dropout
(on the masks of :class:`Mlp` and of the attention probabilities) and the
kernel route's train-mode gate. Dropout draws from the generator ``rng``
passed down beside it, the counterpart of flax's ``rngs={"dropout": key}``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.flash_attention import (
    JAX_SCORES_BYTES,
    area_attention,
    area_attention_trainable,
)

NEG = -1e30  # masked scores and dead beams, as the reference's where(mask, s, -1e30)
KERNEL_IMPLS = ("flash", "flash_train", "flash_interpret")
TRAIN_KERNEL_IMPLS = ("flash_train", "flash_interpret")  # the kernel route in train mode too

def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """flax's ``nn.leaky_relu``: ``where(x >= 0, x, slope x)``, whose
    gradient at 0 is 1 (torch's ``F.leaky_relu`` takes ``slope`` there, and
    a zero-bias layer over a blank region sits at exactly 0)."""
    return torch.where(x >= 0, x, slope * x)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: torch.Generator | None) -> torch.Tensor:
    """flax's ``nn.Dropout``: with ``train`` and ``rate > 0``, each entry
    kept with probability ``1 - rate`` (a uniform draw from ``rng`` below
    it) and scaled by ``1 / (1 - rate)``, the rest 0; else ``x``."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in train mode draws from a generator: pass rng")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def f32_products():
    """Full f32 matrix products and convolutions inside the block (TF32 off
    for cuBLAS and cuDNN), the previous settings restored after it: the
    recognizer and the LM are f32 in the reference, and TF32 keeps about
    three digits. The detectors' bf16 paths never run inside it."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(old)


def dtype_products(dtype: torch.dtype):
    """:func:`f32_products` for a model computing in f32; a bf16 model's
    forward leaves the settings as they are."""
    return f32_products() if dtype == torch.float32 else contextlib.nullcontext()


def sincos_2d_pos_embed(dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """2D sin-cos position embedding for a (grid_h, grid_w) patch grid, a
    copy of the reference's numpy: half the channels encode the y
    coordinate, half the x, each as sin then cos over log-spaced
    frequencies. Returns (grid_h*grid_w, dim) float32, h-major."""
    assert dim % 4 == 0, "sincos 2D embed needs dim % 4 == 0"
    quarter = dim // 4

    def axis_embed(positions: np.ndarray) -> np.ndarray:
        omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
        out = np.einsum("p,f->pf", positions.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)  # (P, dim/2)

    gy, gx = np.meshgrid(
        np.arange(grid_h, dtype=np.float32),
        np.arange(grid_w, dtype=np.float32),
        indexing="ij",
    )
    emb = np.concatenate(
        [axis_embed(gy.reshape(-1)), axis_embed(gx.reshape(-1))], axis=1
    )
    return emb.astype(np.float32)  # (H*W, dim)


@torch.no_grad()
def flax_init_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init, flax's defaults in distribution (not in bits): Dense and
    Conv kernels lecun normal (truncated normal, variance 1 / fan_in),
    biases zero, embeddings normal with variance 1 / vocab (flax's
    ``default_embed_init``), LayerNorm the identity, learned position
    embeddings normal(0.02). Returns ``root``."""
    for m in root.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[0]), generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        for name, p in m.named_parameters(recurse=False):
            if name == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
    return root


@torch.no_grad()
def conv_transpose_init_(m: nn.ConvTranspose2d, generator: torch.Generator) -> None:
    """flax's ``ConvTranspose`` init in distribution: lecun normal over the
    kernel's ``kh kw cin`` fan-in, bias zero."""
    cin, _, kh, kw = m.weight.shape
    std = math.sqrt(1.0 / (cin * kh * kw)) / 0.87962566103423978
    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    m.bias.zero_()


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=...)``: f32 parameters, input, kernel and
    bias cast to ``dtype`` and the product in ``dtype``."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype = torch.float32):
        super().__init__(din, dout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Embedding):
    """flax's ``nn.Embed(dtype=...)``: the f32 table's rows in ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num, dim)
        self.dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return super().forward(tokens).to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=...)``: eps 1e-6, scale and bias; the
    statistics and the normalisation in f32, the output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


def layer_norm(dim: int, dtype: torch.dtype = torch.float32) -> LayerNorm:
    """flax's ``nn.LayerNorm``: eps 1e-6, scale and bias."""
    return LayerNorm(dim, dtype)


class PatchEmbed(nn.Module):
    """Conv patchifier: (B, H, W, C) NHWC -> (B, H/p * W/p, dim), tokens in
    h-major order as flax's reshape of its NHWC output; the conv in
    ``dtype``."""

    def __init__(self, dim: int, patch_size=(16, 16), cin: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, tuple(patch_size), stride=tuple(patch_size))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, p = self.dtype, self.proj
        y = conv2d(x.permute(0, 3, 1, 2).to(dt), p.weight.to(dt), p.bias.to(dt),
                   stride=p.stride)
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int | None = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, out_dim or dim, dtype)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(gelu(self.fc1(x)), self.dropout, train, rng)
        return dropout(self.fc2(x), self.dropout, train, rng)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular bool mask."""
    return torch.ones((length, length), dtype=torch.bool, device=device).tril()[None, None]


class MultiHeadAttention(nn.Module):
    """MHA with optional cross-attention input and a decode-time KV cache.

    Routes, as the reference's:

    - the kernel route, for unmasked, uncached self-attention with
      ``attn_impl`` one of ``KERNEL_IMPLS`` where the reference's gate holds
      (N % 16 == 0, N^2 * 4 <= 8 MiB; in train mode only for
      ``TRAIN_KERNEL_IMPLS``, and only where dropout is 0): q, k, v
      head-packed (B, N, C) into :func:`area_attention` (K3), or, where a
      gradient is wanted, :func:`area_attention_trainable` (K3 with its row
      statistics forward, K4 backward), in the compute dtype (bf16 or f32).
      Each runs its plain version for a CPU tensor (the counterpart of
      ``flash_interpret``) and its kernel for a CUDA tensor, raising for a
      shape the kernel cannot take (a head width outside 16-128 in steps of
      16) rather than leaving the card's kernel for the plain version.
      ``"auto"`` takes it on the card (as ``flash_train``) and the einsum
      path on the CPU (``kuzu/models/trocr.py:146-153``);
    - the einsum path for everything else: f32 scores divided by sqrt(hd)
      after the product, masked scores -1e30, f32 softmax cast to the
      compute dtype, dropout, P V accumulated in f32 and cast back.

    With ``cache`` (a dict with ``"k"`` of shape (B, h, hd, max_len) and
    ``"v"`` of shape (B, h, max_len, hd), the layouts the products take, so
    no step copies it) and ``step``, one decode step: this step's k and v
    are written at ``step`` and the query attends to positions <= step of
    the cache (its zeros past ``step`` masked). With ``kv_heads`` (a
    cross-attention's keys and values of the memory, as :meth:`kv_heads`
    gives them, batch B' with B a multiple of B'), the keys and values are
    not recomputed; each group of B / B' consecutive queries shares one
    memory (a beam's hypotheses). ``kv_dim`` is the width of a
    cross-attention's ``kv`` where it differs from ``dim`` (flax's Dense
    takes its input width from the input)."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "einsum",
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 kv_dim: int | None = None):
        super().__init__()
        self.num_heads, self.attn_impl, self.dropout = num_heads, attn_impl, dropout
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(kv_dim or dim, dim, dtype)
        self.v = Dense(kv_dim or dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def _kernel_route(self, x: torch.Tensor, train: bool) -> bool:
        """The reference's ``flash_ok`` (``kuzu/models/layers.py:129-141``)
        for unmasked, uncached self-attention."""
        impl = self.attn_impl
        if impl == "auto":
            impl = "flash_train" if x.is_cuda else "einsum"
        n = x.shape[1]
        return (impl in KERNEL_IMPLS
                and (not train or impl in TRAIN_KERNEL_IMPLS)
                and (self.dropout == 0.0 or not train)
                and n % 16 == 0 and n * n * 4 <= JAX_SCORES_BYTES)

    def kv_heads(self, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This layer's keys and values of ``memory`` in the layouts the
        products take: k as (B, h, hd, S), v as (B, h, S, hd), contiguous."""
        b, n, _ = memory.shape
        k = self.k(memory).reshape(b, n, self.num_heads, -1).permute(0, 2, 3, 1)
        v = self.v(memory).reshape(b, n, self.num_heads, -1).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    def forward(
        self,
        x: torch.Tensor,  # (B, Tq, D) queries
        kv: torch.Tensor | None = None,  # (B, Tk, D), or None for self-attention
        mask: torch.Tensor | None = None,  # broadcastable to (B, h, Tq, Tk)
        cache: dict | None = None,
        step: int | None = None,
        kv_heads: tuple[torch.Tensor, torch.Tensor] | None = None,
        train: bool = False,
        rng: torch.Generator | None = None,
    ) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        if (kv is None and kv_heads is None and mask is None and cache is None
                and self._kernel_route(x, train)):
            q, k, v = self.q(x), self.k(x), self.v(x)
            if torch.is_grad_enabled() and any(u.requires_grad for u in (q, k, v)):
                out = area_attention_trainable(q, k, v, h)
            else:
                out = area_attention(q, k, v, h)
            return self.out(out)
        k, v = kv_heads if kv_heads is not None else self.kv_heads(x if kv is None else kv)
        if cache is not None:  # k, v of this step into the cache, kept in the products' layouts
            cache["k"][..., step] = k[..., 0]
            cache["v"][:, :, step] = v[:, :, 0]
            k, v = cache["k"], cache["v"]
            pos = torch.arange(k.shape[-1], device=x.device)
            mask = (pos <= step)[None, None, None, :]
        r = b // k.shape[0]  # queries sharing one memory
        q = self.q(x).reshape(k.shape[0], r * t, h, -1).transpose(1, 2)  # (B', h, r*Tq, hd)
        dt = q.dtype
        s = q.float() @ k.float()  # (B', h, r*Tq, Tk), f32 as preferred_element_type
        s = s / torch.full((), math.sqrt(d // h), dtype=s.dtype, device=s.device)
        if mask is not None:
            s = torch.where(mask, s, NEG)
        p = dropout(torch.softmax(s, dim=-1).to(dt), self.dropout, train, rng)
        out = (p.float() @ v.float()).to(dt).transpose(1, 2).reshape(b, t, d)
        return self.out(out)


class EncoderBlock(nn.Module):
    """Pre-norm transformer encoder block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "einsum", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = layer_norm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, attn_impl, dropout, dtype)
        self.norm2 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask=mask, train=train, rng=rng)
        return x + self.mlp(self.norm2(x), train, rng)


class DecoderBlock(nn.Module):
    """Pre-norm transformer decoder block: causal self-attention,
    cross-attention over the memory, MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = layer_norm(dim, dtype)
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout=dropout, dtype=dtype)
        self.norm2 = layer_norm(dim, dtype)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dropout=dropout, dtype=dtype)
        self.norm3 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        memory: torch.Tensor | None = None,
        self_mask: torch.Tensor | None = None,
        cache: dict | None = None,
        step: int | None = None,
        memory_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        train: bool = False,
        rng: torch.Generator | None = None,
    ) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), mask=self_mask, cache=cache, step=step,
                               train=train, rng=rng)
        x = x + self.cross_attn(self.norm2(x), kv=memory, kv_heads=memory_kv, train=train,
                                rng=rng)
        return x + self.mlp(self.norm3(x), train, rng)
