"""Area attention forward and backward: the CUDA kernels
``csrc/area_attention.cu`` and ``csrc/area_attention_bwd.cu`` and their plain
versions (counterpart of ``kuzu/ops/flash_attention.py``).

Replaces ``kuzu/ops/flash_attention.py::area_attention`` (forward) and
``::area_attention_bwd`` (backward); :class:`AreaAttention` pairs them as
``area_attention_trainable`` does. q, k, v are head-packed ``(G, N, C)``:
head h owns channels ``[h*hd, (h+1)*hd)``. Each wrapper runs its plain
version for a CPU tensor and launches its kernel for a CUDA tensor.
:func:`xla_attention` is the materialised attention used where the kernels'
gate fails.
"""

from __future__ import annotations

import ctypes

import torch

from kuzu_torch import _build

# Shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 227 * 1024
MAX_HD = 64  # kMaxHd in csrc/attention.cuh


def _r128(b: int) -> int:
    return (b + 127) // 128 * 128


def attn_smem_bytes(n: int, hd: int) -> int:
    """Shared memory of one attention block (``attn_smem_bytes`` in
    ``csrc/attention.cuh``): K_h and V_h in bf16, rows padded to hd + 8."""
    return _r128(2 * n * (hd + 8) * 2)


def attn_bwd_smem_bytes(n: int, hd: int) -> int:
    """Shared memory of one backward block (``attn_bwd_smem_bytes`` in
    ``csrc/area_attention_bwd.cu``): Q_h, K_h, V_h and dO_h in bf16, rows
    padded to hd + 8, then the f32 row statistics m, 1/l and D."""
    return 4 * _r128(n * (hd + 8) * 2) + _r128(3 * n * 4)


def area_attention_fits(n: int, c: int, num_heads: int) -> bool:
    """Shapes both kernels take: head widths of 16, 32, 48 or 64 and N a
    multiple of 16 (the tensor-core tiles), and each kernel's block within
    the shared memory (the forward's K_h and V_h, the backward's Q_h, K_h,
    V_h and dO_h). ``n % 16`` is also the reference gate's term, so the port
    routes each node as the JAX executor does; the TPU's 8 MiB VMEM term
    becomes the shared-memory limit."""
    hd = c // num_heads
    return (
        c % num_heads == 0
        and hd % 16 == 0
        and hd <= MAX_HD
        and n % 16 == 0
        and max(attn_smem_bytes(n, hd), attn_bwd_smem_bytes(n, hd)) <= SMEM_LIMIT
    )


def area_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 from bf16 inputs, q
    scaled before the product, softmax as max, exp, divide by the sum, the
    output rounded once to the input dtype."""
    g, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(g, n, num_heads, hd).transpose(1, 2)  # (G, H, N, hd)

    qh = heads(q) * scale
    s = qh @ heads(k).transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p @ heads(v)
    return o.transpose(1, 2).reshape(g, n, c).to(q.dtype)


def _kernel_fn():
    fn = _build.library("area_attention").kuzu_area_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _row_stride(t: torch.Tensor, n: int) -> int:
    """Row stride of a (G, N, C) tensor whose rows may be column slices."""
    if t.stride(2) != 1 or t.stride(0) != n * t.stride(1):
        raise ValueError(f"unsupported strides {t.stride()} for area_attention")
    return t.stride(1)


def area_attention(
    q: torch.Tensor,  # (G, N, C) bf16, heads packed along C
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """softmax(q_h k_h^T / sqrt(hd)) v_h per head, (G, N, C) out."""
    g, n, c = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    scale = 1.0 / ((c // num_heads) ** 0.5)
    if q.device.type == "cpu":
        area_attention.plain_calls += 1
        return area_attention_plain(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"area_attention takes CPU or CUDA tensors, got {q.device}")
    if not all(t.dtype == torch.bfloat16 and t.device == q.device for t in (q, k, v)):
        raise ValueError("area_attention kernel takes bf16 q/k/v on one device")
    if not area_attention_fits(n, c, num_heads):
        raise ValueError(f"area_attention kernel cannot take N={n}, C={c}, "
                         f"heads={num_heads}")
    out = torch.empty((g, n, c), dtype=q.dtype, device=q.device)
    err = _kernel_fn()(
        _build.ptr(q), _row_stride(q, n), _build.ptr(k), _row_stride(k, n),
        _build.ptr(v), _row_stride(v, n), _build.ptr(out), g, n, c, num_heads,
        float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "kuzu_area_attention")
    area_attention.launches += 1
    return out


area_attention.launches = 0
area_attention.plain_calls = 0


def area_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    num_heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch, step by step as
    ``_area_attn_bwd_kernel``: f32 from the inputs, S and P recomputed per
    head, dV = P^T dO, dP = dO V^T, dS = P o (dP - rowsum(dP o P)),
    dQ = scale dS K, dK = dS^T (scale Q); outputs rounded once to q's dtype."""
    g, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(g, n, num_heads, hd).transpose(1, 2)  # (G, H, N, hd)

    qh = heads(q) * scale
    kh, vh, doh = heads(k), heads(v), heads(do)
    s = qh @ kh.transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ kh) * scale
    dk = ds.transpose(-1, -2) @ qh

    def back(t):
        return t.transpose(1, 2).reshape(g, n, c).to(q.dtype)

    return back(dq), back(dk), back(dv)


def _bwd_kernel_fn():
    fn = _build.library("area_attention_bwd").kuzu_area_attention_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def area_attention_bwd(
    q: torch.Tensor,  # (G, N, C), as given to area_attention
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,  # (G, N, C), the gradient of area_attention's output
    num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`area_attention`, each (G, N, C) contiguous."""
    g, n, c = q.shape
    if any(t.shape != q.shape for t in (k, v, do)):
        raise ValueError(f"q/k/v/do shapes differ: {q.shape} {k.shape} {v.shape} {do.shape}")
    scale = 1.0 / ((c // num_heads) ** 0.5)
    if q.device.type == "cpu":
        area_attention_bwd.plain_calls += 1
        return area_attention_bwd_plain(q, k, v, do, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"area_attention_bwd takes CPU or CUDA tensors, got {q.device}")
    if not all(t.dtype == torch.bfloat16 and t.device == q.device for t in (q, k, v, do)):
        raise ValueError("area_attention_bwd kernel takes bf16 q/k/v/do on one device")
    if not area_attention_fits(n, c, num_heads):
        raise ValueError(f"area_attention_bwd kernel cannot take N={n}, C={c}, "
                         f"heads={num_heads}")
    if do.stride(2) != 1 or do.stride(0) != n * do.stride(1):
        do = do.contiguous()
    dq, dk, dv = (torch.empty((g, n, c), dtype=q.dtype, device=q.device) for _ in range(3))
    err = _bwd_kernel_fn()(
        _build.ptr(q), _row_stride(q, n), _build.ptr(k), _row_stride(k, n),
        _build.ptr(v), _row_stride(v, n), _build.ptr(do), _row_stride(do, n),
        _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), g, n, c, num_heads,
        float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "kuzu_area_attention_bwd")
    area_attention_bwd.launches += 1
    return dq, dk, dv


area_attention_bwd.launches = 0
area_attention_bwd.plain_calls = 0


class AreaAttention(torch.autograd.Function):
    """Area attention with a hand-written backward, as
    ``area_attention_trainable``: forward through :func:`area_attention`
    (K3), backward through :func:`area_attention_bwd` (K4), with only q, k
    and v saved between them. q and k are the two column halves of one
    ``(G, N, 2C)`` token tensor ``qk`` (the qk conv's output); the backward
    returns its gradient as one tensor, ``cat([dq, dk])``.

    ``AreaAttention.apply(qk, v, num_heads) -> (G, N, C)``."""

    @staticmethod
    def forward(ctx, qk: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
        c = v.shape[-1]
        ctx.num_heads = num_heads
        ctx.save_for_backward(qk, v)
        return area_attention(qk[..., :c], qk[..., c:], v, num_heads)

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qk, v = ctx.saved_tensors
        c = v.shape[-1]
        dq, dk, dv = area_attention_bwd(qk[..., :c], qk[..., c:], v, do, ctx.num_heads)
        return torch.cat([dq, dk], dim=-1), dv, None


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Materialised softmax(QK^T / sqrt(D))V over (BH, N, D), the reference
    path of ``kuzu/ops/flash_attention.py::xla_attention``: f32 scores,
    softmax cast to v's dtype, f32 accumulation, output in q's dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def materialised_area_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """:func:`xla_attention` over head-packed (G, N, C) tensors, heads folded
    into the batch and back: the route where the kernels' gate fails."""
    g, n, c = v.shape
    hd = c // num_heads

    def fold(t):  # (G, N, C) -> (G*H, N, hd)
        return t.reshape(g, n, num_heads, hd).transpose(1, 2).reshape(-1, n, hd)

    out = xla_attention(fold(q), fold(k), fold(v))
    return out.reshape(g, num_heads, n, hd).transpose(1, 2).reshape(g, n, c)
