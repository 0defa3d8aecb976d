"""Fused ABlock: the CUDA kernel ``csrc/fused_ablock.cu`` and its plain version
(counterpart of ``kuzu/ops/fused_ablock.py``).

Replaces ``kuzu/ops/fused_ablock.py::fused_ablock``. For every (image, area)
chunk of ``na`` tokens, with BN folded into the weights::

    qk = x·Wqk + b                       per head: o = softmax(q kᵀ/√hd)·v
    x₁ = x + (o + pe)·Wp + bp            out = x₁ + W₂·silu(W₁·x₁ + b₁) + b₂

``v`` and its 5x5 depthwise ``pe`` are computed outside. :func:`fused_ablock`
calls the operator ``kuzu_torch::fused_ablock`` (``ops/registry.py``), which
runs :func:`fused_ablock_plain` for a CPU tensor and launches the kernels
(:func:`launch`) for a CUDA tensor: four products on the wgmma GEMM of
``csrc/gemm.cuh`` around the forward attention of ``csrc/attention_fwd.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

from kuzu_torch import _build
from kuzu_torch.ops.flash_attention import (
    FWD_DS,
    JAX_SCORES_BYTES,
    SMEM_LIMIT,
    attn_fwd_smem_bytes,
)


def fold_conv_bn(weight: torch.Tensor, bn: torch.nn.BatchNorm2d, eps: float = 1e-3):
    """Conv weight (OIHW) + BN -> (W bf16 OIHW, b f32) with BN folded, as
    ``kuzu/ops/fused_c3k2.py::fold_conv_bn``."""
    mult = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + eps)
    b = bn.bias.detach().float() - bn.running_mean.float() * mult
    w = weight.detach().float() * mult.view(-1, 1, 1, 1)
    return w.to(torch.bfloat16), b


def ablock_weights(block) -> list[torch.Tensor]:
    """The kernel's weight list from an ``ABlock`` module: folded qk, proj,
    mlp1 and mlp2 as (Cin, Cout) bf16 matrices with (1, Cout) f32 biases."""
    out = []
    for conv in (block.attn.qk, block.attn.proj, block.mlp1, block.mlp2):
        w, b = fold_conv_bn(conv.conv.weight, conv.bn)
        out += [w[:, :, 0, 0].t().contiguous(), b.reshape(1, -1)]
    return out


# The GEMM of csrc/gemm.cuh, shared with K6's 1x1 convs: 128-row tiles in
# column tiles of GEMM_WIDTHS, 64 of k per ring stage, GEMM_STAGES[bn] stages.
GEMM_ROWS = 128  # kBM
GEMM_K = 64  # kBK
GEMM_WIDTHS = (64, 128, 192)  # kWidths
GEMM_STAGES = {64: 3, 128: 6, 192: 4}  # stages(bn): two 64-column blocks share an SM


def gemm_epilogue_bytes(bn: int) -> int:
    """The epilogue's share of a block (``epilogue_bytes`` in
    ``csrc/gemm.cuh``): the 128 x bn bf16 staging tile and each consumer
    warpgroup's f32 copy of the tile's bias."""
    return GEMM_ROWS * bn * 2 + 2 * bn * 4


def gemm_smem_bytes(bn: int) -> int:
    """Shared memory of one GEMM block with ``bn``-column tiles
    (``gemm_smem_bytes`` in ``csrc/gemm.cuh``): 1024 bytes of alignment, the
    ring of A (128 x 64) and W (64 x bn) tiles, the epilogue's share, 128
    bytes of barriers. It depends on no width of the product."""
    return (1024 + GEMM_STAGES[bn] * (GEMM_ROWS * GEMM_K * 2 + GEMM_K * bn * 2)
            + gemm_epilogue_bytes(bn) + 128)


def ablock_smem_bytes(c: int, heads: int) -> int:
    """Largest shared memory of the kernel's launches (``ablock_smem_bytes``
    in ``csrc/fused_ablock.cu``): the attention block's and the GEMM
    block's at every column tile, none of which depends on the chunk's
    length, the GEMM's on no width either."""
    return max(attn_fwd_smem_bytes(c // heads), *(gemm_smem_bytes(bn) for bn in GEMM_WIDTHS))


def fused_ablock_fits(na: int, c: int, heads: int, hidden: int) -> bool:
    """Shapes the kernel takes. ``C % 128``, ``hd % 8``, ``na % 16`` and
    ``na^2 * 4 <= 8 MiB`` are the reference gate's terms
    (``kuzu/models/yolo/infer.py:315-321``), kept so that the port routes
    each node as the JAX executor does. The kernel adds: head widths of
    16-128 in steps of 16 for the attention, ``hidden % 8`` (16-byte rows for
    TMA) and each launch's block within the shared memory."""
    hd = c // heads
    return (
        c % 128 == 0
        and c % heads == 0
        and hd in FWD_DS
        and hidden % 8 == 0
        and na % 16 == 0
        and na * na * 4 <= JAX_SCORES_BYTES
        and ablock_smem_bytes(c, heads) <= SMEM_LIMIT
    )


def fused_ablock_plain(x, v, pe, weights, area: int, heads: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, with the bf16 rounding points
    of ``kuzu/ops/fused_ablock.py:52-85``."""
    wqk, bqk, wp, bp, w1, b1, w2, b2 = weights
    b_, n, c = x.shape
    na = n // area
    hd = c // heads
    dt = x.dtype

    def mm(a, w, b):  # bf16 x bf16 products, f32 accumulation, f32 bias
        return a.float() @ w.float() + b

    xs = x.reshape(b_ * area, na, c)
    qk = mm(xs, wqk, bqk).to(dt)

    def split(t):  # (G, na, C) -> (G, H, na, hd)
        return t.float().reshape(b_ * area, na, heads, hd).transpose(1, 2)

    q = split(qk[..., :c]) * (hd**-0.5)
    s = q @ split(qk[..., c:]).transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = (p @ split(v.reshape(b_ * area, na, c))).to(dt)  # each o_h rounded
    o = o.transpose(1, 2).reshape(b_ * area, na, c)
    attn = mm(o + pe.reshape(b_ * area, na, c), wp, bp).to(dt)
    x1 = xs + attn
    y = mm(x1, w1, b1)
    hmid = (y * torch.sigmoid(y)).to(dt)
    out = x1 + mm(hmid, w2, b2).to(dt)
    return out.reshape(b_, n, c)


def _kernel_fn():
    return _build.function("fused_ablock", "kuzu_fused_ablock", [ctypes.c_void_p] * 16 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def fused_ablock(
    x: torch.Tensor,  # (B, N, C) bf16, N row-major over (H, W)
    v: torch.Tensor,  # (B, N, C), the AAttn v conv output
    pe: torch.Tensor,  # (B, N, C), 5x5 depthwise positional conv of v
    weights: list[torch.Tensor],
    area: int,
    heads: int,
) -> torch.Tensor:
    """The block through the operator ``kuzu_torch::fused_ablock``
    (``ops/registry.py``): the plain version for CPU tensors, the kernels
    for CUDA tensors, whose shapes, dtypes and devices are checked here."""
    b_, n, c = x.shape
    if n % area:
        raise ValueError(f"N={n} is not a multiple of area={area}")
    if x.device.type != "cpu":
        if x.device.type != "cuda":
            raise ValueError(f"fused_ablock takes CPU or CUDA tensors, got {x.device}")
        _check_kernel_args(x, v, pe, weights, area, heads)
    return torch.ops.kuzu_torch.fused_ablock(x, v, pe, list(weights), area, heads)


def _check_kernel_args(x, v, pe, weights, area: int, heads: int) -> None:
    b_, n, c = x.shape
    na = n // area
    hidden = weights[4].shape[1]
    if not fused_ablock_fits(na, c, heads, hidden):
        raise ValueError(f"fused_ablock kernel cannot take na={na}, C={c}, "
                         f"heads={heads}, hidden={hidden}")
    expect = [(c, 2 * c), (1, 2 * c), (c, c), (1, c), (c, hidden), (1, hidden),
              (hidden, c), (1, c)]
    for i, (w, shp) in enumerate(zip(weights, expect)):
        want = torch.float32 if i % 2 else torch.bfloat16
        if tuple(w.shape) != shp or w.dtype != want or w.device != x.device:
            raise ValueError(f"weight {i}: {tuple(w.shape)} {w.dtype} {w.device}, "
                             f"want {shp} {want} {x.device}")
    if any(t.dtype != torch.bfloat16 or t.shape != x.shape or t.device != x.device
           for t in (x, v, pe)):
        raise ValueError("fused_ablock kernel takes bf16 x/v/pe of one shape")


def launch(x, v, pe, weights, area: int, heads: int) -> torch.Tensor:
    """The kernels on CUDA tensors that :func:`fused_ablock` has checked
    (the operator's CUDA implementation)."""
    b_, n, c = x.shape
    na = n // area
    hidden = weights[4].shape[1]
    # x, v and the weights go through TMA tensor maps: 16-byte aligned bases
    acts = [_build.aligned(t) for t in (x, v, pe)]
    ws = [_build.aligned(w) for w in weights]
    m = b_ * n
    qk = torch.empty((m, 2 * c), dtype=x.dtype, device=x.device)
    a = torch.empty_like(acts[0])  # the attention output plus pe
    x1 = torch.empty_like(acts[0])
    h = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(acts[0])
    err = _kernel_fn()(
        *(_build.ptr(t) for t in (*acts, *ws, qk, a, x1, h, out)),
        b_ * area, na, c, heads, hidden, float((c // heads) ** -0.5),
        _build.stream_ptr(x),
    )
    _build.check(err, "kuzu_fused_ablock")
    fused_ablock.launches += 1
    return out


fused_ablock.launches = 0
fused_ablock.plain_calls = 0
