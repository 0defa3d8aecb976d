"""Fused C3k2 block: the CUDA kernel ``csrc/fused_c3k2.cu`` and its plain
version (counterpart of ``kuzu/ops/fused_c3k2.py``).

Replaces ``kuzu/ops/fused_c3k2.py::fused_c3k2``, which the JAX package keeps
as an op of its own and does not wire into its executor; neither does the
port. The block is ``C3k2`` with c3k=True, n=2 and the shortcut (the only
variant the TPU kernel takes), BN folded into the weights, on NHWC bf16::

    cv1(1x1) -> split(a, b) -> m0 = C3k(b) -> m1 = C3k(m0)
    -> cv2(1x1) over concat(a, b, m0, m1)
    C3k: cv3(1x1)(concat(bottleneck(bottleneck(cv1(x))), cv2(x)))
    bottleneck: x + conv3x3(conv3x3(x))        (every conv + SiLU)

Every conv sums in f32, adds the f32 bias, applies SiLU in f32 and rounds to
bf16; the bottleneck residual adds two bf16 tensors with one rounding. SAME
padding is exact at every image border: each 3x3 conv reads zeros outside
the image. :func:`fused_c3k2` runs :func:`fused_c3k2_plain` for a CPU tensor
and launches the kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kuzu_torch import _build
from kuzu_torch.ops.fused_ablock import (
    GEMM_K,
    GEMM_ROWS,
    GEMM_WIDTHS,
    fold_conv_bn,
    gemm_epilogue_bytes,
    gemm_smem_bytes,
)

HALO = 8  # 2 C3k x 2 bottlenecks x 2 convs, one row/col per 3x3 conv
N_C3K = 2  # the C3k modules the kernel takes, as the TPU kernel
N_CONVS = 1 + 7 * N_C3K + 1  # cv1, 7 per C3k, cv2
N_LAUNCHES = 1 + 6 * N_C3K + 1  # the kernel merges each C3k's cv1 and bypass cv2

# The kernel's conv blocks: 128 pixels x BN output channels in column tiles
# of these widths, 64 channels of the reduction per slab. The 1x1 convs run
# on K2's GEMM (csrc/gemm.cuh, fused_ablock.gemm_smem_bytes); the 3x3 block
# (csrc/conv.cuh) holds two halo buffers of HALO_BYTES and as many (64 x BN)
# W tiles as the rest of its shared memory holds (at most 28), and both the
# GEMM's epilogue (gemm_epilogue_bytes).
TILE_M, TILE_K = GEMM_ROWS, GEMM_K
COLUMN_TILES = GEMM_WIDTHS
HALO_BYTES = 26624
SMEM_LIMIT = 232448


def c3k2_weights(module, n: int = N_C3K) -> list[torch.Tensor]:
    """The kernel's ordered (W, b) list from a ``C3k2`` module (c3k=True), BN
    folded, in ``kuzu/ops/fused_c3k2.py::c3k2_weights``'s order and layout:
    cv1; per C3k its cv1, m0.cv1, m0.cv2, m1.cv1, m1.cv2, cv2, cv3; cv2.
    Each W is HWIO flattened dy-major to ``(kh*kw*C, N)`` bf16, each b
    ``(1, N)`` f32."""
    from kuzu_torch.models.yolo import modules as M

    if module.n != n or not all(isinstance(getattr(module, f"m{j}"), M.C3k)
                                for j in range(n)):
        raise ValueError(f"c3k2_weights takes a C3k2 with c3k=True and n={n}")
    convs = [module.cv1]
    for j in range(n):
        c3 = getattr(module, f"m{j}").c3
        convs += [c3.cv1, c3.m0.cv1, c3.m0.cv2, c3.m1.cv1, c3.m1.cv2, c3.cv2, c3.cv3]
    convs.append(module.cv2)
    out = []
    for conv in convs:
        w, b = fold_conv_bn(conv.conv.weight, conv.bn)
        cout, cin, kh, kw = w.shape
        out += [w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout).contiguous(),
                b.reshape(1, -1)]
    return out


def band_rows(h: int, tile: int) -> int:
    """The band height of ``kuzu/ops/fused_c3k2.py:205-207``: ``tile``
    halved until it divides H."""
    t = tile
    while h % t:
        t //= 2
    return t


def _widths(weights: list[torch.Tensor], cin: int) -> tuple[int, int, int]:
    """(c, hid, c2) of a weight list, raising unless it is the c3k=True,
    n=2, shortcut block's list for ``cin`` input channels."""
    if len(weights) != 2 * N_CONVS:
        raise ValueError(f"fused_c3k2 takes the {2 * N_CONVS} tensors of a C3k2 with "
                         f"c3k=True and n={N_C3K}, got {len(weights)}")
    c = weights[0].shape[1] // 2
    hid = weights[2].shape[1]
    c2 = weights[-2].shape[1]
    shapes = [(cin, 2 * c)]
    for j in range(N_C3K):
        shapes += [(c, hid)] + [(9 * hid, hid)] * 4 + [(c, hid), (2 * hid, c)]
    shapes.append(((2 + N_C3K) * c, c2))
    for i, shp in enumerate(shapes):
        w, b = weights[2 * i], weights[2 * i + 1]
        if tuple(w.shape) != shp or tuple(b.shape) != (1, shp[1]):
            raise ValueError(f"conv {i}: W {tuple(w.shape)}, b {tuple(b.shape)}; want "
                             f"W {shp}, b (1, {shp[1]})")
    return c, hid, c2


def fused_c3k2_plain(x: torch.Tensor, weights: list[torch.Tensor], n: int = N_C3K,
                     tile: int = 16) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_kernel``) in plain PyTorch, band by
    band: x zero-padded by HALO, cut into bands of T + 2 HALO rows (T =
    :func:`band_rows`), every conv output re-masked to zero outside the
    image, 3x3 convs as three products over column-packed taps; f32 sums,
    f32 bias and SiLU, bf16 after every conv. (B, H, W, c2) out."""
    if n != N_C3K:
        raise ValueError(f"fused_c3k2 takes n={N_C3K}, got n={n}")
    bsz, h, w, cin = x.shape
    c, _, c2 = _widths(weights, cin)
    t_rows = band_rows(h, tile)
    nb = h // t_rows
    rows = t_rows + 2 * HALO
    xp = F.pad(x, (0, 0, HALO, HALO, HALO, HALO))
    bands = torch.stack([xp[:, i * t_rows:i * t_rows + rows] for i in range(nb)], 1)
    bands = bands.reshape(bsz * nb, rows, w + 2 * HALO, cin)
    row0 = (torch.arange(nb, device=x.device) * t_rows).repeat(bsz)  # band's first row
    wit = iter(zip(weights[0::2], weights[1::2]))

    def mask(t, lvl):
        """Zero cells outside the image; t's cell (0, 0) sits at padded
        coordinate (band row0 + lvl, lvl)."""
        r = torch.arange(t.shape[1], device=t.device)[None, :, None] + row0[:, None, None] + lvl
        cc = torch.arange(t.shape[2], device=t.device)[None, None, :] + lvl
        ok = (r >= HALO) & (r < HALO + h) & (cc >= HALO) & (cc < HALO + w)
        return t * ok[..., None].to(t.dtype)

    def silu_bf16(y):
        return (y * torch.sigmoid(y)).to(x.dtype)

    def c1x1(t):
        wt, b = next(wit)
        y = t.reshape(-1, t.shape[-1]).float() @ wt.float() + b
        return silu_bf16(y).reshape(*t.shape[:-1], -1)

    def c3x3(t, lvl_out):
        wt, b = next(wit)  # (9 C, N), row dy * 3C + dx * C + c
        g, ro, co, ch = t.shape[0], t.shape[1] - 2, t.shape[2] - 2, t.shape[3]
        pc = torch.cat([t[:, :, 0:co], t[:, :, 1:co + 1], t[:, :, 2:co + 2]], dim=-1).float()
        acc = 0.0
        for dy in range(3):
            acc = acc + (pc[:, dy:ro + dy].reshape(-1, 3 * ch)
                         @ wt[dy * 3 * ch:(dy + 1) * 3 * ch].float())
        return mask(silu_bf16(acc + b).reshape(g, ro, co, -1), lvl_out)

    def crop(t, k):
        return t[:, k:-k, k:-k] if k else t

    y = mask(c1x1(bands), 0)
    parts = [(y[..., :c], 0), (y[..., c:], 0)]
    m, lvl = y[..., c:], 0
    for _ in range(n):
        l0 = lvl
        u = mask(c1x1(m), l0)
        for _ in range(2):  # bottlenecks
            u2 = c3x3(c3x3(u, lvl + 1), lvl + 2)
            u = crop(u, 2) + u2
            lvl += 2
        byp = crop(mask(c1x1(m), l0), lvl - l0)
        m = mask(c1x1(torch.cat([u, byp], dim=-1)), lvl)
        parts.append((m, lvl))
    out = c1x1(torch.cat([crop(t, lvl - lv) for t, lv in parts], dim=-1))
    return out.reshape(bsz, nb, t_rows, w, c2).reshape(bsz, h, w, c2)


def kernel_weights(weights: list[torch.Tensor]) -> list[torch.Tensor]:
    """:func:`c3k2_weights`' list as the kernel's 14 launches take it: each
    W as it is (``(taps * C, N)`` bf16, read by the kernel in that layout),
    each bias flat, and each C3k's cv1 and bypass cv2 side by side as one
    ``(c, 2 hid)`` weight with its ``(2 hid,)`` bias (the only copies); in
    launch order: cv1; per C3k the merged pair, m0.cv1, m0.cv2, m1.cv1,
    m1.cv2, cv3; cv2."""
    ws, bs = weights[0::2], [b.reshape(-1) for b in weights[1::2]]
    out = [ws[0], bs[0]]
    for j in range(N_C3K):
        i = 1 + 7 * j  # cv1, four 3x3, cv2, cv3
        out += [torch.cat([ws[i], ws[i + 5]], 1), torch.cat([bs[i], bs[i + 5]])]
        for k in range(i + 1, i + 5):
            out += [ws[k], bs[k]]
        out += [ws[i + 6], bs[i + 6]]
    return out + [ws[-1], bs[-1]]


def w_stages(bn: int) -> int:
    """The 3x3 block's W tiles (``w_stages`` in ``csrc/conv.cuh``)."""
    rest = SMEM_LIMIT - 1024 - 2 * HALO_BYTES - gemm_epilogue_bytes(bn) - 512
    return min(rest // (bn * TILE_K * 2), 28)


def fused_c3k2_smem_bytes(bn: int, k3: bool = False) -> int:
    """Shared memory of one conv block at column tile ``bn``: the 1x1
    block is the GEMM's (:func:`~kuzu_torch.ops.fused_ablock.gemm_smem_bytes`,
    ``csrc/gemm.cuh``); the 3x3 block (``conv3x3_smem_bytes`` in
    ``csrc/conv.cuh``) 1024 bytes of alignment, two halos, w_stages(bn) W
    tiles (64 rows of bn columns, bf16), the epilogue's share and 512 bytes
    of barriers."""
    if not k3:
        return gemm_smem_bytes(bn)
    return (1024 + 2 * HALO_BYTES + w_stages(bn) * bn * TILE_K * 2 + gemm_epilogue_bytes(bn)
            + 512)


def fused_c3k2_fits(cin: int, c: int, hid: int, c2: int) -> bool:
    """Widths the kernel takes: every channel count a multiple of 8 (TMA
    wants 16-byte strides and bases for the channel slices). Its blocks'
    shared memory (:func:`fused_c3k2_smem_bytes`) depends only on the column
    tile, held under the launch's limit by a ``static_assert`` in the
    kernel's source, so H and W are free."""
    return all(v % 8 == 0 for v in (cin, c, hid, c2))


def _kernel_fn():
    return _build.function("fused_c3k2", "kuzu_fused_c3k2",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def fused_c3k2(x: torch.Tensor, weights: list[torch.Tensor], n: int = N_C3K,
               tile: int = 16) -> torch.Tensor:
    """The whole C3k2 (c3k=True, n=2, shortcut) on (B, H, W, Cin) bf16 NHWC,
    (B, H, W, c2) bf16 out; ``weights`` from :func:`c3k2_weights`. ``tile``
    is the band height of the plain version (halved until it divides H, as
    the TPU kernel's); the kernel tiles pixels its own way, and the result
    does not depend on the tiling because every intermediate is zero outside
    the image."""
    if n != N_C3K:
        raise ValueError(f"fused_c3k2 takes n={N_C3K}, got n={n}")
    bsz, h, w, cin = x.shape
    c, hid, c2 = _widths(weights, cin)
    if x.device.type == "cpu":
        fused_c3k2.plain_calls += 1
        return fused_c3k2_plain(x, weights, n, tile)
    if x.device.type != "cuda":
        raise ValueError(f"fused_c3k2 takes CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_c3k2 kernel takes bf16 x, got {x.dtype}")
    for i, t in enumerate(weights):
        want = torch.float32 if i % 2 else torch.bfloat16
        if t.dtype != want or t.device != x.device:
            raise ValueError(f"weight {i}: {t.dtype} on {t.device}, want {want} on {x.device}")
    if not fused_c3k2_fits(cin, c, hid, c2):
        raise ValueError(f"fused_c3k2 kernel cannot take Cin={cin}, c={c}, hid={hid}, c2={c2}")
    x = _build.aligned(x)
    ws = [_build.aligned(t) for t in kernel_weights(weights)]
    wptrs = (ctypes.c_void_p * len(ws))(*(t.data_ptr() for t in ws))
    z = torch.empty((bsz, h, w, (2 + N_C3K) * c), dtype=x.dtype, device=x.device)
    u = torch.empty((bsz, h, w, 2 * hid), dtype=x.dtype, device=x.device)
    v1 = torch.empty((bsz, h, w, hid), dtype=x.dtype, device=x.device)
    out = torch.empty((bsz, h, w, c2), dtype=x.dtype, device=x.device)
    err = _kernel_fn()(
        _build.ptr(x), ctypes.cast(wptrs, ctypes.c_void_p), _build.ptr(z), _build.ptr(u),
        _build.ptr(v1), _build.ptr(out), bsz, h, w, cin, c, hid, c2, _build.stream_ptr(x),
    )
    _build.check(err, "kuzu_fused_c3k2")
    fused_c3k2.launches += 1
    return out


fused_c3k2.launches = 0
fused_c3k2.plain_calls = 0
