"""Attention kernels: area attention forward and backward
(``csrc/area_attention.cu``, ``csrc/area_attention_bwd.cu``) and flash
attention (``csrc/flash_attention.cu``), each with its plain version
(counterpart of ``kuzu/ops/flash_attention.py``).

Replaces ``kuzu/ops/flash_attention.py::area_attention`` (forward),
``::area_attention_bwd`` (backward) and ``::flash_attention``;
:func:`area_attention_trainable` pairs the first two over separate q, k, v
as ``area_attention_trainable`` does (the TrOCR encoder's self-attention),
:class:`AreaAttention` over YOLO's packed qk. Both the forward and the
backward have a bf16 route (wgmma kernels) and an f32 route (wgmma kernels
in 3xTF32: each operand split into two TF32 parts, hi = cvt.rna.tf32.f32(x)
and lo = the same rounding of x - hi, and each product taken as lo hi + hi
lo + hi hi, accumulated in f32 by the tensor core: as accurate as f32
products, whatever ``torch.backends.cuda.matmul.allow_tf32`` says), as the
TPU kernels take any dtype and compute in f32. For area attention q, k, v are head-packed ``(G, N, C)``: head h owns
channels ``[h*hd, (h+1)*hd)``; flash attention takes ``(BH, N, D)`` with the
heads folded into the batch. Each wrapper runs its plain version for a CPU
tensor and launches its kernel for a CUDA tensor; :func:`area_attention`'s
inference route (no log-sum-exp) does so through the operator
``kuzu_torch::area_attention`` (``ops/registry.py``). :func:`xla_attention` is
the materialised attention used where the kernels' gate fails, and the route
:func:`flash_attention_auto` takes below its crossover.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kuzu_torch import _build

# Shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 227 * 1024
FWD_DS = tuple(range(16, 129, 16))  # head widths of the forward kernel (attention_fwd.cuh)
FWD_ROWS = 128  # query rows per forward block, kRowsQ
FWD_KEYS = 64  # keys per streamed K/V tile, kKeys
FWD_STAGES = 3  # depth of the K/V ring, kStages
F32_ROWS = 128  # query rows per block of the f32 forward, kFwdRows in csrc/attention_f32.cuh
F32_BWD_ROWS = 64  # fixed rows per block of the f32 backward, kRows in csrc/attention_f32_bwd.cuh
LOG2E = 1.0 / math.log(2.0)
# the reference executor's term for its area-attention kernel: the N x N f32
# scores of one group within 8 MiB of VMEM (kuzu/models/yolo/infer.py:279-283)
JAX_SCORES_BYTES = 8 * 2**20


def attn_fwd_smem_bytes(hd: int) -> int:
    """Shared memory of one forward-attention block (``attn_fwd_smem_bytes``
    in ``csrc/attention_fwd.cuh``): 1024 bytes to align the swizzled panels,
    the 128-row Q tile, FWD_STAGES K and V tiles of 64 keys, 128 bytes of
    barriers. It does not depend on N."""
    return 1024 + FWD_ROWS * hd * 2 + FWD_STAGES * 2 * FWD_KEYS * hd * 2 + 128


def attn_bwd_smem_bytes(hd: int) -> int:
    """Shared memory of one block of either backward kernel
    (``attn_bwd_smem_bytes`` in ``csrc/area_attention_bwd.cu``): 1024 bytes
    of alignment, two fixed 128-row tiles, FWD_STAGES pairs of 64-row tiles
    with their f32 lse and D, 128 bytes of barriers. It does not depend on N
    and fits the shared memory at every head width of FWD_DS (166,528 bytes
    at hd=128)."""
    stage = 2 * FWD_KEYS * hd * 2 + 2 * FWD_KEYS * 4
    return 1024 + 2 * FWD_ROWS * hd * 2 + FWD_STAGES * stage + 128


def f32_attn_smem_bytes(hd: int) -> int:
    """Shared memory of one block of the f32 attention kernel
    (``f32attn::smem_bytes`` in ``csrc/attention_f32.cuh``, K3's f32 route
    and K5's f32 path): 1024 bytes of alignment, the hi and lo TF32 parts of
    the 128-row Q tile, stages (two up to hd=112, one at 128) of the parts of
    a K tile and a V^T tile of 64 keys (32 above hd=64), 128 bytes of
    barriers. It does not depend on N."""
    keys = 64 if hd <= 64 else 32
    stages = 2 if hd <= 112 else 1
    return 1024 + 2 * F32_ROWS * hd * 4 + stages * 16 * keys * hd + 128


def f32_attn_bwd_smem_bytes(hd: int) -> int:
    """Shared memory of the larger block of the f32 backward's two kernels
    (``f32bwd::dq_smem_bytes`` / ``dkdv_smem_bytes`` in
    ``csrc/attention_f32_bwd.cuh``): 1024 bytes of alignment, the hi and lo
    parts of two fixed 64-row tiles (dQ: scaled Q and dO; dK/dV: K and V),
    64 bytes of barriers, and stages of streamed tiles: dQ, 32 keys of K
    (K-major and transposed) and V, two stages up to hd=80; dK/dV, 32
    query rows (16 at hd=128) of Q and dO in both layouts with their lse and
    D, two stages up to hd=64. It does not depend on N (230,720 bytes at
    hd=112)."""
    dq = 1024 + 4 * F32_BWD_ROWS * hd * 4 + (2 if hd <= 80 else 1) * 24 * 32 * hd + 64
    rows = 32 if hd <= 112 else 16
    dkdv = (1024 + 4 * F32_BWD_ROWS * hd * 4
            + (2 if hd <= 64 else 1) * (32 * rows * hd + 8 * rows) + 64)
    return max(dq, dkdv)


def area_attention_fwd_fits(n: int, c: int, num_heads: int,
                            dtype: torch.dtype = torch.bfloat16) -> bool:
    """The inference route's gate (``infer.aattn``, and the ViT encoder's
    self-attention in ``models/layers.py``): the reference executor's terms
    for its kernel, ``N % 16 == 0`` and ``N^2 * 4 <= 8 MiB``
    (``kuzu/models/yolo/infer.py:279-283``, ``kuzu/models/layers.py:
    129-150``), so both packages route every node alike, and the kernel's
    own: head widths of 16-128 in steps of 16, its block within the shared
    memory (the bf16 wgmma kernel's, or the 3xTF32 kernel's for f32)."""
    hd = c // num_heads
    smem = f32_attn_smem_bytes(hd) if dtype == torch.float32 else attn_fwd_smem_bytes(hd)
    return (
        c % num_heads == 0
        and hd in FWD_DS
        and n % 16 == 0
        and n * n * 4 <= JAX_SCORES_BYTES
        and smem <= SMEM_LIMIT
    )


# The training route's gate (``AAttn.forward``, the TrOCR encoder's
# self-attention; the forward and backward kernels as a pair) is the
# forward's: the backward kernels of both dtypes stream their tiles and take
# every shape the forward takes (attn_bwd_smem_bytes, f32_attn_bwd_smem_bytes
# fit at every head width), as ``area_attention_trainable`` does wherever
# the JAX executor takes its kernel.
area_attention_train_fits = area_attention_fwd_fits


def area_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    return_lse: bool = False,
):
    """The kernel's arithmetic in plain PyTorch: f32 from bf16 inputs, q
    scaled before the product, softmax as max, exp, divide by the sum, the
    output rounded once to the input dtype. With ``return_lse``,
    ``(out, lse, out_lo)`` as the kernel's training route writes them: each
    row's log-sum-exp in base 2, (G, heads, N) f32, and the output's
    remainder rounded to its dtype (out + out_lo is the f32 output to about
    16 significant bits); for f32 inputs ``out_lo`` is None (the output is
    f32 already)."""
    g, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(g, n, num_heads, hd).transpose(1, 2)  # (G, H, N, hd)

    qh = heads(q) * scale
    s = qh @ heads(k).transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o32 = (p @ heads(v)).transpose(1, 2).reshape(g, n, c)
    o = o32.to(q.dtype)
    if return_lse:
        lo = None if q.dtype == torch.float32 else (o32 - o.float()).to(q.dtype)
        return o, torch.logsumexp(s, dim=-1) * LOG2E, lo
    return o


def _kernel_fn():
    return _build.function("area_attention", "kuzu_area_attention", [
        ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p])


def _f32_kernel_fn():
    return _build.function("area_attention", "kuzu_area_attention_f32", [
        ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p])


def _row_stride(t: torch.Tensor, n: int) -> int:
    """Row stride of a (G, N, C) tensor whose rows may be column slices."""
    if t.stride(2) != 1 or t.stride(0) != n * t.stride(1):
        raise ValueError(f"unsupported strides {t.stride()} for area_attention")
    return t.stride(1)


def _tma_stride(t: torch.Tensor, n: int) -> int:
    """Row stride of a forward kernel input: the bf16 kernel reads it
    through a TMA tensor map, the f32 kernel with 16-byte copies; both take
    a 16-byte aligned base and row stride."""
    stride = _row_stride(t, n)
    if t.data_ptr() % 16 or (stride * t.element_size()) % 16:
        raise ValueError(f"area_attention kernel takes 16-byte aligned rows; got base "
                         f"{t.data_ptr() % 16} bytes past a boundary, row stride {stride}")
    return stride


def attention_scale(q: torch.Tensor, num_heads: int) -> float:
    """1 / sqrt(head width) of (G, N, C) head-packed ``q``."""
    return 1.0 / ((q.shape[-1] // num_heads) ** 0.5)


def area_attention(
    q: torch.Tensor,  # (G, N, C) bf16 or f32, heads packed along C
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    return_lse: bool = False,
):
    """softmax(q_h k_h^T / sqrt(hd)) v_h per head, (G, N, C) out in q's
    dtype; with ``return_lse`` (the training route), ``(out, lse, out_lo)``:
    each row's base-2 log-sum-exp of the scaled scores, (G, heads, N) f32,
    and in bf16 the output's bf16 remainder (P enters P V in two bf16 parts
    then), in f32 None in its place (the output is f32 already), which
    :func:`area_attention_bwd` takes. On the card bf16 runs the wgmma
    kernel, f32 the 3xTF32 wgmma kernel (f32-accurate products, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says), as the TPU kernel
    takes any dtype and computes in f32."""
    g, n, c = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.device.type != "cpu":
        if q.device.type != "cuda":
            raise ValueError(f"area_attention takes CPU or CUDA tensors, got {q.device}")
        if q.dtype not in (torch.bfloat16, torch.float32) or not all(
                t.dtype == q.dtype and t.device == q.device for t in (k, v)):
            raise ValueError("area_attention kernel takes bf16 or f32 q/k/v of one dtype on "
                             "one device")
        if not area_attention_fwd_fits(n, c, num_heads, q.dtype):
            raise ValueError(f"area_attention kernel cannot take N={n}, C={c}, "
                             f"heads={num_heads}")
    if not return_lse:  # the inference route: the operator kuzu_torch::area_attention
        return torch.ops.kuzu_torch.area_attention(q, k, v, num_heads)
    if q.device.type == "cpu":
        area_attention.plain_calls += 1
        return area_attention_plain(q, k, v, num_heads, attention_scale(q, num_heads), True)
    return _launch(q, k, v, num_heads, True)


def launch_area_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """The forward kernel without the log-sum-exp on CUDA tensors that
    :func:`area_attention` has checked (the operator's CUDA implementation)."""
    return _launch(q, k, v, num_heads, False)


def _launch(q, k, v, num_heads: int, return_lse: bool):
    g, n, c = q.shape
    scale = attention_scale(q, num_heads)
    out = torch.empty((g, n, c), dtype=q.dtype, device=q.device)
    lse = out_lo = None
    if return_lse:
        lse = torch.empty((g, num_heads, n), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        err = _f32_kernel_fn()(
            _build.ptr(q), _tma_stride(q, n), _build.ptr(k), _tma_stride(k, n),
            _build.ptr(v), _tma_stride(v, n), _build.ptr(out), c,
            None if lse is None else _build.ptr(lse), g, n, c, num_heads, float(scale),
            _build.stream_ptr(q))
        _build.check(err, "kuzu_area_attention_f32")
        area_attention.f32_launches += 1
        return (out, lse, None) if return_lse else out
    if return_lse:
        out_lo = torch.empty_like(out)
    err = _kernel_fn()(
        _build.ptr(q), _tma_stride(q, n), _build.ptr(k), _tma_stride(k, n),
        _build.ptr(v), _tma_stride(v, n), _build.ptr(out),
        None if out_lo is None else _build.ptr(out_lo),
        None if lse is None else _build.ptr(lse), g, n, c, num_heads,
        float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "kuzu_area_attention")
    area_attention.launches += 1
    return (out, lse, out_lo) if return_lse else out


area_attention.launches = 0  # the bf16 kernel's
area_attention.f32_launches = 0  # the f32 kernel's
area_attention.plain_calls = 0


def area_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    num_heads: int, scale: float, out: torch.Tensor | None = None,
    lse: torch.Tensor | None = None, out_lo: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch, step by step as
    ``_area_attn_bwd_kernel``: f32 from the inputs, S and P recomputed per
    head, dV = P^T dO, dP = dO V^T, dS = P o (dP - D) with
    D = rowsum(dP o P), dQ = scale dS K, dK = dS^T (scale Q); outputs rounded
    once to q's dtype. Given the forward's ``out``, ``lse`` and ``out_lo``
    (``area_attention(..., return_lse=True)``), as the kernels take them: P
    is exp2(log2(e) S - lse) and D = rowsum(dO o (out + out_lo)), or
    rowsum(dO o out) where ``out_lo`` is None (f32); without them, P is the
    softmax of S."""
    g, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(g, n, num_heads, hd).transpose(1, 2)  # (G, H, N, hd)

    qh = heads(q) * scale
    kh, vh, doh = heads(k), heads(v), heads(do)
    s = qh @ kh.transpose(-1, -2)
    if lse is None:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    else:
        p = torch.exp2(s * LOG2E - lse.float()[..., None])
    dv = p.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if out is None:
        d = (dp * p).sum(dim=-1, keepdim=True)
    else:
        o = heads(out) if out_lo is None else heads(out) + heads(out_lo)
        d = (doh * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - d)
    dq = (ds @ kh) * scale
    dk = ds.transpose(-1, -2) @ qh

    def back(t):
        return t.transpose(1, 2).reshape(g, n, c).to(q.dtype)

    return back(dq), back(dk), back(dv)


def _bwd_kernel_fn():
    return _build.function("area_attention_bwd", "kuzu_area_attention_bwd", [
        ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p])


def _bwd_f32_kernel_fn():
    return _build.function("area_attention_bwd", "kuzu_area_attention_bwd_f32", [
        ctypes.c_void_p, ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [
        ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p])


def _bwd(q, k, v, do, num_heads: int, stats: tuple | None, want_qk: bool):
    """Shared body of :func:`area_attention_bwd`, :class:`AreaAttention` and
    :func:`area_attention_trainable`; ``stats`` is the forward's ``(out,
    lse, out_lo)`` (``out_lo`` None in f32) or None. For a CPU tensor the
    plain version (``(dq, dk, dv)``, or ``(cat([dq, dk]), dv)`` with
    ``want_qk``); for a CUDA tensor the kernels (bf16: the wgmma kernels,
    f32: the 3xTF32 kernels), which write dq and dk into the two column
    halves of one (G, N, 2C) tensor ``dqk``: ``(dqk[..., :C], dqk[..., C:],
    dv)``, or ``(dqk, dv)`` with ``want_qk``."""
    g, n, c = q.shape
    if any(t.shape != q.shape for t in (k, v, do)):
        raise ValueError(f"q/k/v/do shapes differ: {q.shape} {k.shape} {v.shape} {do.shape}")
    scale = 1.0 / ((c // num_heads) ** 0.5)
    if q.device.type == "cpu":
        area_attention_bwd.plain_calls += 1
        dq, dk, dv = area_attention_bwd_plain(q, k, v, do, num_heads, scale, *(stats or ()))
        return (torch.cat([dq, dk], dim=-1), dv) if want_qk else (dq, dk, dv)
    if q.device.type != "cuda":
        raise ValueError(f"area_attention_bwd takes CPU or CUDA tensors, got {q.device}")
    f32 = q.dtype == torch.float32
    if q.dtype not in (torch.bfloat16, torch.float32) or not all(
            t.dtype == q.dtype and t.device == q.device for t in (k, v, do)):
        raise ValueError("area_attention_bwd kernel takes bf16 or f32 q/k/v/do of one dtype "
                         "on one device")
    if not area_attention_train_fits(n, c, num_heads, q.dtype):
        raise ValueError(f"area_attention_bwd kernel cannot take N={n}, C={c}, "
                         f"heads={num_heads}")
    if stats is None:  # the forward's output and row statistics, from K3
        stats = area_attention(q, k, v, num_heads, return_lse=True)
    out, lse, out_lo = stats
    if (lse.shape != (g, num_heads, n) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous() or lse.data_ptr() % 16):
        raise ValueError(f"lse must be contiguous (G, heads, N) f32 on {q.device}, 16-byte "
                         f"aligned; got {tuple(lse.shape)} {lse.dtype}")
    parts = (out,) if f32 else (out, out_lo)
    if (f32 and out_lo is not None) or any(
            t is None or t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
            or not t.is_contiguous() or t.data_ptr() % 16 for t in parts):
        raise ValueError("out (and in bf16 out_lo; None in f32) must be contiguous (G, N, C) "
                         "like q, from area_attention(..., return_lse=True)")
    do = _build.aligned(do)
    dqk = torch.empty((g, n, 2 * c), dtype=q.dtype, device=q.device)
    dv = torch.empty((g, n, c), dtype=q.dtype, device=q.device)
    dvec = torch.empty((g, num_heads, n), dtype=torch.float32, device=q.device)  # D
    dk_ptr = ctypes.c_void_p(dqk.data_ptr() + c * dqk.element_size())
    head = (_build.ptr(q), _tma_stride(q, n), _build.ptr(k), _tma_stride(k, n),
            _build.ptr(v), _tma_stride(v, n), _build.ptr(do), _tma_stride(do, n))
    tail = (_build.ptr(dqk), 2 * c, dk_ptr, 2 * c, _build.ptr(dv), c, g, n, num_heads,
            c // num_heads, float(scale), _build.stream_ptr(q))
    if f32:
        err = _bwd_f32_kernel_fn()(*head, _build.ptr(out), c, _build.ptr(lse),
                                   _build.ptr(dvec), *tail)
        _build.check(err, "kuzu_area_attention_bwd_f32")
        area_attention_bwd.f32_launches += 1
    else:
        err = _bwd_kernel_fn()(*head, _build.ptr(out), _build.ptr(out_lo), c,
                               _build.ptr(lse), _build.ptr(dvec), *tail)
        _build.check(err, "kuzu_area_attention_bwd")
        area_attention_bwd.launches += 1
    return (dqk, dv) if want_qk else (dqk[..., :c], dqk[..., c:], dv)


def area_attention_bwd(
    q: torch.Tensor,  # (G, N, C), as given to area_attention
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,  # (G, N, C), the gradient of area_attention's output
    num_heads: int,
    out: torch.Tensor | None = None,
    lse: torch.Tensor | None = None,
    out_lo: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`area_attention`, each (G, N, C), in q's dtype
    (bf16 or f32). ``out``, ``lse`` and ``out_lo`` are the forward's
    (``area_attention(..., return_lse=True)``): all three in bf16, ``out``
    and ``lse`` in f32 (its ``out_lo`` is None), or none; without them the
    kernel route runs the forward kernel first to get them. On the card dq
    and dk are the column halves of one (G, N, 2C) tensor."""
    need = (out, lse) if q.dtype == torch.float32 else (out, lse, out_lo)
    given = [t is not None for t in need]
    if any(given) and not all(given):
        raise ValueError("area_attention_bwd takes the forward's out, lse and (bf16) out_lo "
                         "together, or none")
    return _bwd(q, k, v, do, num_heads, (out, lse, out_lo) if all(given) else None,
                want_qk=False)


area_attention_bwd.launches = 0  # the bf16 kernels'
area_attention_bwd.f32_launches = 0  # the f32 kernels'
area_attention_bwd.plain_calls = 0


class AreaAttention(torch.autograd.Function):
    """Area attention with a hand-written backward, as
    ``area_attention_trainable``: forward through :func:`area_attention`
    (K3), backward through :func:`area_attention_bwd`'s kernels (K4), with
    q, k, v, the output in two bf16 parts and each row's log-sum-exp saved
    between them (the TPU kernel saves q, k, v and recomputes the softmax
    statistics and D). q and k are the two column halves of one
    ``(G, N, 2C)`` token tensor ``qk`` (the qk conv's output); on the card
    the backward kernels write its gradient as one tensor, no
    concatenation.

    ``AreaAttention.apply(qk, v, num_heads) -> (G, N, C)``."""

    @staticmethod
    def forward(ctx, qk: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
        c = v.shape[-1]
        ctx.num_heads = num_heads
        out, lse, out_lo = area_attention(qk[..., :c], qk[..., c:], v, num_heads,
                                          return_lse=True)
        ctx.save_for_backward(qk, v, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qk, v, out, lse, out_lo = ctx.saved_tensors
        c = v.shape[-1]
        dqk, dv = _bwd(qk[..., :c], qk[..., c:], v, do, ctx.num_heads, (out, lse, out_lo),
                       want_qk=True)
        return dqk, dv, None


class AreaAttentionTrainable(torch.autograd.Function):
    """:func:`area_attention_trainable`'s autograd pair over separate q, k,
    v (each (G, N, C), bf16 or f32, with its own row stride): forward
    through :func:`area_attention` with ``return_lse`` (K3's training route
    in the inputs' dtype), backward through :func:`area_attention_bwd`'s
    kernels (K4: the bf16 kernels for bf16, the f32 kernels for f32), the
    forward's output and row statistics saved between them (the TPU pair
    saves q, k, v and recomputes them). On the card dq and dk come back as
    the column halves of one (G, N, 2C) tensor (strided gradients); for a
    CPU tensor both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> torch.Tensor:
        ctx.num_heads = num_heads
        out, lse, out_lo = area_attention(q, k, v, num_heads, return_lse=True)
        ctx.has_lo = out_lo is not None
        ctx.save_for_backward(q, k, v, out, lse, *((out_lo,) if ctx.has_lo else ()))
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, out, lse, *lo = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, do, ctx.num_heads, (out, lse, lo[0] if lo else None),
                          want_qk=False)
        return dq, dk, dv, None


def area_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """:func:`area_attention` with a hand-written backward (the counterpart
    of ``kuzu/ops/flash_attention.py::area_attention_trainable``): K3 with
    its row statistics forward, K4 backward, in bf16 or f32."""
    return AreaAttentionTrainable.apply(q, k, v, num_heads)


def xla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Materialised softmax(QK^T * scale)V over (BH, N, D), the reference
    path of ``kuzu/ops/flash_attention.py::xla_attention``: f32 scores,
    softmax cast to v's dtype, f32 accumulation, output in q's dtype. The
    default scale is D^-1/2."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
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


# ------------------------------------------------------------ flash attention

BLOCK_K = 128  # the TPU kernel's key tile where N % 128 == 0
NEG_INF = -1e30  # the running maximum's start value, as the TPU kernel's
FLASH_DS = FWD_DS  # head widths the kernels are built for


def _key_block(n: int) -> int:
    """The TPU kernel's key tile for sequence length ``n``: 128 where N is a
    multiple of 128, else one block of all N keys, which it allows for
    N <= 1024 with N % 16 == 0 (``kuzu/ops/flash_attention.py:88-95``)."""
    if n % BLOCK_K == 0:
        return BLOCK_K
    if n <= 1024 and n % 16 == 0:
        return n
    raise ValueError(f"flash_attention takes N % 128 == 0, or N <= 1024 with N % 16 == 0; "
                     f"got N={n}")


def flash_attention_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Shared memory of one flash-attention block (``flash_smem_bytes`` in
    ``csrc/flash_attention.cu``). bf16: the forward-attention kernel's
    (:func:`attn_fwd_smem_bytes`); f32: the 3xTF32 kernel's
    (:func:`f32_attn_smem_bytes`)."""
    if dtype == torch.float32:
        return f32_attn_smem_bytes(d)
    return attn_fwd_smem_bytes(d)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_flash_kernel``) in plain PyTorch: q
    cast to f32 and scaled, f32 scores against each key tile in turn, the
    running maximum m (from -1e30) and sum l with acc rescaled by
    exp(m - m_new), f32 P V, then acc / max(l, 1e-30) cast to q's dtype."""
    bh, n, d = q.shape
    bk = _key_block(n)
    if scale is None:
        scale = 1.0 / (d**0.5)
    qs = q.float() * scale
    acc = torch.zeros((bh, n, d), dtype=torch.float32, device=q.device)
    m = torch.full((bh, n, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, n, 1), dtype=torch.float32, device=q.device)
    for j0 in range(0, n, bk):
        s = qs @ k[:, j0:j0 + bk].float().transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[:, j0:j0 + bk].float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _flash_kernel_fn():
    return _build.function("flash_attention", "kuzu_flash_attention", [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention(
    q: torch.Tensor,  # (BH, N, D), bf16 or f32
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Non-causal softmax(q k^T * scale) v with no N x N tensor anywhere,
    (BH, N, D) in q's dtype. Takes the shapes the TPU kernel takes (N a
    multiple of 128, or N <= 1024 with N % 16 == 0) and raises on the rest;
    the default scale is D^-1/2 of the unpadded D."""
    bh, n, d = q.shape
    _key_block(n)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if scale is None:
        scale = 1.0 / (d**0.5)
    if q.device.type == "cpu":
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention kernel takes bf16 or f32 q/k/v of one dtype "
                         "on one device")
    if d not in FLASH_DS:
        raise ValueError(f"flash_attention kernel takes D in {FLASH_DS}, got D={d}")
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    err = _flash_kernel_fn()(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), bh, n, d,
        int(q.dtype == torch.float32), float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "kuzu_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.plain_calls = 0


def flash_attention_auto(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, min_seq: int = 8192
) -> torch.Tensor:
    """The flash kernel only where its O(N) memory matters, as
    ``kuzu/ops/flash_attention.py::flash_attention_auto``: for a tensor on
    the card with N >= ``min_seq`` and N % 128 == 0; :func:`xla_attention`
    otherwise (the JAX function's "backend is the TPU" term becomes "the
    tensor is on the card", so the CPU takes the materialised path in both
    packages)."""
    n = q.shape[1]
    if q.is_cuda and n >= min_seq and n % BLOCK_K == 0:
        return flash_attention(q, k, v)
    return xla_attention(q, k, v)
