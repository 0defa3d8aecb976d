"""Transformer building blocks of the TrOCR and char-LM families
(counterpart of ``kuzu/models/layers.py``).

f32 throughout, as the JAX predictors build them. flax's defaults where
they differ from torch's: LayerNorm eps 1e-6, GELU the tanh approximation,
masks as ``where(mask, s, -1e30)``. Module and parameter names follow the
flax tree, so ``kuzu_torch.bridge`` maps them one to one. Inference only:
dropout (0 in every configuration the predictors build) and training
through the kernel route wait for the recognize trainer (ROADMAP section 1
item 14). ``ConvBN`` is not copied: the YOLO modules have their own.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.ops.flash_attention import JAX_SCORES_BYTES, area_attention

NEG = -1e30  # masked scores and dead beams, as the reference's where(mask, s, -1e30)
KERNEL_IMPLS = ("flash", "flash_train", "flash_interpret")


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


def layer_norm(dim: int) -> nn.LayerNorm:
    """flax's ``nn.LayerNorm``: eps 1e-6, scale and bias."""
    return nn.LayerNorm(dim, eps=1e-6)


class PatchEmbed(nn.Module):
    """Conv patchifier: (B, H, W, C) NHWC -> (B, H/p * W/p, dim), tokens in
    h-major order as flax's reshape of its NHWC output."""

    def __init__(self, dim: int, patch_size=(16, 16), cin: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, tuple(patch_size), stride=tuple(patch_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular bool mask."""
    return torch.ones((length, length), dtype=torch.bool, device=device).tril()[None, None]


class MultiHeadAttention(nn.Module):
    """MHA with optional cross-attention input and a decode-time KV cache.

    Routes, as the reference's:

    - the kernel route, for unmasked, uncached self-attention with
      ``attn_impl`` one of ``KERNEL_IMPLS`` where the reference's gate holds
      (N % 16 == 0, N^2 * 4 <= 8 MiB): q, k, v head-packed (B, N, C) into
      :func:`area_attention` (K3), which runs its plain version for a CPU
      tensor (the counterpart of ``flash_interpret``) and the kernel for a
      CUDA tensor, raising for a shape the kernel cannot take (a head width
      outside 16-128 in steps of 16) rather than leaving the card's kernel
      for the plain version. ``"auto"`` takes it on the card and the einsum
      path on the CPU (``kuzu/models/trocr.py:146-153``);
    - the einsum path for everything else: f32 scores divided by sqrt(hd)
      after the product, masked scores -1e30, softmax, P V.

    With ``cache`` (a dict with ``"k"`` of shape (B, h, hd, max_len) and
    ``"v"`` of shape (B, h, max_len, hd), the layouts the products take, so
    no step copies it) and ``step``, one decode step: this step's k and v
    are written at ``step`` and the query attends to positions <= step of
    the cache (its zeros past ``step`` masked). With ``kv_heads`` (a
    cross-attention's keys and values of the memory, as :meth:`kv_heads`
    gives them, batch B' with B a multiple of B'), the keys and values are
    not recomputed; each group of B / B' consecutive queries shares one
    memory (a beam's hypotheses)."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "einsum"):
        super().__init__()
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def _kernel_route(self, x: torch.Tensor) -> bool:
        impl = self.attn_impl
        if impl == "auto":
            impl = "flash_train" if x.is_cuda else "einsum"
        if impl not in KERNEL_IMPLS:
            return False
        n = x.shape[1]
        if self.training and impl == "flash":  # the reference's train mode: einsum
            return False
        if not (n % 16 == 0 and n * n * 4 <= JAX_SCORES_BYTES):
            return False
        if x.is_cuda and torch.is_grad_enabled() and (
                x.requires_grad or self.q.weight.requires_grad):
            raise NotImplementedError(
                "training through K3's f32 route needs K4's f32 route, the recognize "
                "trainer's slice (ROADMAP section 1 item 14)")
        return True

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
    ) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        if (kv is None and kv_heads is None and mask is None and cache is None
                and self._kernel_route(x)):
            out = area_attention(self.q(x), self.k(x), self.v(x), h)
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
        s = q @ k  # (B', h, r*Tq, Tk)
        s = s / torch.full((), math.sqrt(d // h), dtype=s.dtype, device=s.device)
        if mask is not None:
            s = torch.where(mask, s, NEG)
        p = torch.softmax(s, dim=-1)
        out = (p @ v).transpose(1, 2).reshape(b, t, d)
        return self.out(out)


class EncoderBlock(nn.Module):
    """Pre-norm transformer encoder block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "einsum"):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, num_heads, attn_impl)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask=mask)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Pre-norm transformer decoder block: causal self-attention,
    cross-attention over the memory, MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.cross_attn = MultiHeadAttention(dim, num_heads)
        self.norm3 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(
        self,
        x: torch.Tensor,
        memory: torch.Tensor | None = None,
        self_mask: torch.Tensor | None = None,
        cache: dict | None = None,
        step: int | None = None,
        memory_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), mask=self_mask, cache=cache, step=step)
        x = x + self.cross_attn(self.norm2(x), kv=memory, kv_heads=memory_kv)
        return x + self.mlp(self.norm3(x))
