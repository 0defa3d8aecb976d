"""BN-folded inference executor for the YOLO graph (the detect zoo of
``kuzu/models/yolo/infer.py``: yolov8, yolov9c, yolov10, yolo11, yolov12;
and the Segment, Pose and OBB heads, whose dicts carry their extra outputs
in f32 beside the ``det`` maps).

:func:`fold_graph` folds every BatchNorm into its conv once, at load:
weights become bf16 and biases stay f32, as ``_fold_bn`` does. Each ABlock
also gets its fused-kernel weight list. :func:`run_graph` then walks the
GraphSpec on bf16 NCHW tensors in ``torch.channels_last``, so the NHWC view
the attention kernels take is free. Token order is the NHWC row-major
flatten, so areas are contiguous chunks of H*W as in the reference.

Rounding points kept from JAX: the conv runs in bf16 and adds its bias cast
to bf16 (``infer.py:85``); SiLU then runs on that bf16 sum. PSA attention
(C2PSA, PSA) is ``xla_attention``'s materialised arithmetic, as JAX's
executor runs it; the max pools are ``F.max_pool2d`` (-inf padding, exact),
ADown's 2x2 average adds its taps in XLA's order (``modules.avg_pool2``).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.yolo import modules as M
from kuzu_torch.models.yolo.graph import unsupported
from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.flash_attention import (
    area_attention,
    area_attention_fwd_fits,
    materialised_area_attention,
    xla_attention,
)
from kuzu_torch.ops.fused_ablock import (
    ablock_weights,
    fold_conv_bn,
    fused_ablock,
    fused_ablock_fits,
)
from kuzu_torch.ops.images import from_uint8
from kuzu_torch.ops.s2d import dense_k2, s2d_kernel, space_to_depth


@torch.no_grad()
def fold_graph(graph: nn.Module) -> dict[str, object]:
    """Folded weights keyed by module path: ``(W bf16 OIHW, b f32)`` per conv,
    ``<A2C2f>.gamma`` and ``<ABlock>.fused`` (the K2 weight list)."""
    table: dict[str, object] = {}
    for name, m in graph.named_modules():
        if isinstance(m, M.Conv):
            w, b = fold_conv_bn(m.conv.weight, m.bn)
            # the activations are channels_last; weights in the same format
            # spare cuDNN a layout conversion of the weights on every call
            table[name] = (w.contiguous(memory_format=torch.channels_last), b)
        elif isinstance(m, nn.Conv2d) and m.bias is not None:  # Detect leaves
            table[name] = (m.weight.detach().to(torch.bfloat16), m.bias.detach().float())
        elif isinstance(m, M.A2C2f) and m.gamma is not None:
            table[name + ".gamma"] = m.gamma.detach()
        if isinstance(m, M.ABlock):
            table[name + ".fused"] = ablock_weights(m)
    return table


class _P:
    """Cursor over the folded table at one module path."""

    def __init__(self, table: dict, path: str):
        self.table, self.path = table, path

    def child(self, name: str) -> "_P":
        return _P(self.table, f"{self.path}.{name}")

    def get(self, suffix: str = ""):
        return self.table[self.path + suffix]


def conv(p: _P, x: torch.Tensor, s: int = 1, g: int = 1, act: bool = True):
    """Conv + folded BN (+ SiLU)."""
    w, b = p.get()
    y = conv2d(x, w, None, s, w.shape[-1] // 2, 1, g)
    y = y + b.to(y.dtype).view(1, -1, 1, 1)
    return F.silu(y) if act else y


def stem_conv_s2d(p: _P, x: torch.Tensor) -> torch.Tensor:
    """The stem Conv(3 -> C, k3, s2) as a dense k2 convolution over the
    2 x 2 space-to-depth packing of the image (``kuzu/models/yolo/infer.py::
    stem_conv_s2d``): the same products as :func:`conv`, summed in another
    order. The folded kernel is gathered (exactly) in bf16."""
    w, b = p.get()
    if tuple(w.shape[1:]) != (3, 3, 3):
        raise ValueError(f"stem_conv_s2d takes an RGB 3 x 3 stem, got {tuple(w.shape)}")
    y = dense_k2(space_to_depth(x), s2d_kernel(w).to(x.dtype))
    return F.silu(y + b.to(y.dtype).view(1, -1, 1, 1))


def _gather_taps(w: torch.Tensor, rows: np.ndarray, cols: np.ndarray, ok_r: np.ndarray,
                 ok_c: np.ndarray) -> torch.Tensor:
    """``w_hwio[rows, cols] * (ok_r & ok_c)`` with numpy index arrays that
    broadcast, the kernel ``w`` given OIHW: a gather of the 3 x 3 taps,
    zero where a tap falls outside the kernel."""
    dev = w.device
    w_hwio = w.permute(2, 3, 1, 0)
    out = w_hwio[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)]
    ok = torch.from_numpy(ok_r & ok_c).to(dev)
    return out * ok[..., None, None].to(out.dtype)


def stem_pair_packed(p0: _P, p1: _P, x: torch.Tensor, g1: int = 1) -> torch.Tensor:
    """Nodes 0 and 1 (both k3 s2 convolutions) as two dense k2 convolutions
    on a 4 x 4 space-to-depth packing (``kuzu/models/yolo/infer.py::
    stem_pair_packed``), the same math up to summation order:

    - stage A: X4 = s2d(x, 4) (B, 16 cin, H / 4, W / 4); node 0 becomes a k2
      s1 convolution over X4 whose output Y packs node 0's 2 x 2 output
      pixels into channels in o-major order (o * 4 + a * 2 + b), so that
      groups stay contiguous: y[2p + a, 2q + b] reads x rows 4p + 2a + di,
      i.e. packed rows {p - 1, p}, taps (k, u) with di = 4k - 4 + u - 2a,
      zero where |di| > 1;
    - stage B: node 1 becomes a k2 s1 convolution over Y: z[m] reads y rows
      2m + di = Y rows {m - 1, m}, taps (k, a) with di = 2(k - 1) + a, zero
      at (k, a) = (0, 0). A grouped node 1 (yolov12's node 1 has g = 2)
      slices each group's packed channels.

    Kernels are gathered from the folded bf16 weights (exact) in JAX's
    order; the biases are added in the activation dtype and SiLU follows."""
    w0, b0 = p0.get()
    w1, b1 = p1.get()
    cin, c0, c1 = w0.shape[1], w0.shape[0], w1.shape[0]
    dt = x.dtype
    xp = space_to_depth(x, 4)

    # stage A: HWIO (2, 2, (u, v, c) = 16 cin, (o, a, b) = 4 c0)
    k, u, a = np.meshgrid(np.arange(2), np.arange(4), np.arange(2), indexing="ij")
    di = 4 * k - 4 + u - 2 * a  # (2, 4, 2)
    ok = (di >= -1) & (di <= 1)
    idx = np.clip(di + 1, 0, 2)
    wa = _gather_taps(w0, idx[:, :, None, None, :, None], idx[None, None, :, :, None, :],
                      ok[:, :, None, None, :, None], ok[None, None, :, :, None, :])
    wa = wa.permute(0, 2, 1, 3, 6, 7, 4, 5).reshape(2, 2, 16 * cin, 4 * c0)
    y = dense_k2(xp, wa.permute(3, 2, 0, 1).to(dt))
    y = F.silu(y + b0.repeat_interleave(4).to(y.dtype).view(1, -1, 1, 1))

    # stage B: HWIO (2, 2, (o, a, b) = 4 c0g, c1); a grouped kernel is
    # group-local on its input axis already
    c0g = w1.shape[1]
    k, a = np.meshgrid(np.arange(2), np.arange(2), indexing="ij")
    di = 2 * (k - 1) + a  # (2, 2) in {-2 .. 1}
    ok = di >= -1
    idx = np.clip(di + 1, 0, 2)
    wb = _gather_taps(w1, idx[:, :, None, None], idx[None, None, :, :],
                      ok[:, :, None, None], ok[None, None])
    wb = wb.permute(0, 2, 4, 1, 3, 5).reshape(2, 2, 4 * c0g, c1).permute(3, 2, 0, 1).to(dt)
    if g1 > 1:
        cgp, og = 4 * c0g, c1 // g1
        z = torch.cat([dense_k2(y[:, gi * cgp:(gi + 1) * cgp], wb[gi * og:(gi + 1) * og])
                       for gi in range(g1)], dim=1)
    else:
        z = dense_k2(y, wb)
    return F.silu(z + b1.to(z.dtype).view(1, -1, 1, 1))


def stem_fusable(spec, table: dict, x: torch.Tensor) -> bool:
    """``stem_packed``'s preconditions (JAX's ``_stem_fusable``): nodes 0
    and 1 are both k3 s2 Convs with SiLU, node 0 ungrouped from RGB, node 1
    reads only node 0, nothing else reads node 0, and the image tiles by
    4. Like JAX's it does not check the convolutions' padding."""
    if len(spec.nodes) < 2 or x.shape[2] % 4 or x.shape[3] % 4:
        return False
    n0, n1 = spec.nodes[0], spec.nodes[1]
    if any(0 in nd.frm for nd in spec.nodes[2:]):
        return False
    for nd, need_g1 in ((n0, True), (n1, False)):
        if nd.module != "Conv":
            return False
        a = nd.args
        if (a[2] if len(a) > 2 else 1) != 2:
            return False
        if need_g1 and (a[4] if len(a) > 4 else 1) != 1:
            return False
        if not (a[5] if len(a) > 5 else True):
            return False
        if tuple(table[f"n{nd.index}_Conv"][0].shape[2:]) != (3, 3):
            return False
    return x.shape[1] == 3 and list(n1.frm) == [0]


def plain_conv(p: _P, x: torch.Tensor):
    """Bias-carrying 1x1 conv without BN (Detect leaves)."""
    w, b = p.get()
    y = conv2d(x, w.to(x.dtype))
    return y + b.to(y.dtype).view(1, -1, 1, 1)


def bottleneck(p: _P, x, shortcut: bool = True):
    y = conv(p.child("cv2"), conv(p.child("cv1"), x))
    return x + y if shortcut and x.shape[1] == y.shape[1] else y


def c3k(p: _P, x, shortcut: bool = True):
    p = p.child("c3")
    a = conv(p.child("cv1"), x)
    for i in range(2):
        a = bottleneck(p.child(f"m{i}"), a, shortcut)
    b = conv(p.child("cv2"), x)
    return conv(p.child("cv3"), torch.cat([a, b], dim=1))


def c3k2(p: _P, x, n: int, c3k_flag: bool, shortcut: bool = True):
    y = conv(p.child("cv1"), x)
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    for i in range(n):
        blk = c3k if c3k_flag else bottleneck
        parts.append(blk(p.child(f"m{i}"), parts[-1], shortcut))
    return conv(p.child("cv2"), torch.cat(parts, dim=1))


def c2f(p: _P, x, n: int, shortcut: bool = False, block=bottleneck):
    """C2f; ``block`` is the inner block (C2fCIB passes ``cib``)."""
    y = conv(p.child("cv1"), x)
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    for i in range(n):
        parts.append(block(p.child(f"m{i}"), parts[-1], shortcut))
    return conv(p.child("cv2"), torch.cat(parts, dim=1))


def psa_attn(p: _P, x, num_heads: int):
    """PSA attention (``modules.Attention``), materialised."""
    b, _, h, w = x.shape
    dim = p.child("proj").get()[0].shape[0]
    kd = (dim // num_heads) // 2
    q, k, v = M.psa_tokens(conv(p.child("qkv"), x, act=False), num_heads, kd)
    out = xla_attention(q, k, v, scale=kd ** -0.5)
    pe = conv(p.child("pe"), M.psa_unfold(v, b, h, w), g=dim, act=False)
    return conv(p.child("proj"), M.psa_unfold(out, b, h, w) + pe, act=False)


def psa_ffn(p: _P, b):
    """b + attn(b), then b + ffn2(ffn1(b)): a PSABlock, and PSA's body."""
    c = b.shape[1]
    b = b + psa_attn(p.child("attn"), b, max(c // 64, 1))
    return b + conv(p.child("ffn2"), conv(p.child("ffn1"), b), act=False)


def c2psa(p: _P, x, n: int):
    y = conv(p.child("cv1"), x)
    c = y.shape[1] // 2
    a, b = y[:, :c], y[:, c:]
    for i in range(n):
        b = psa_ffn(p.child(f"m{i}"), b)
    return conv(p.child("cv2"), torch.cat([a, b], dim=1))


def psa(p: _P, x):
    y = conv(p.child("cv1"), x)
    c = y.shape[1] // 2
    return conv(p.child("cv2"), torch.cat([y[:, :c], psa_ffn(p, y[:, c:])], dim=1))


def repconv(p: _P, x):
    return F.silu(conv(p.child("conv1"), x, act=False) + conv(p.child("conv2"), x, act=False))


def repcsp(p: _P, x, n: int):
    a = conv(p.child("cv1"), x)
    for i in range(n):
        m = p.child(f"m{i}")
        y = conv(m.child("cv2"), repconv(m.child("cv1"), a))
        a = a + y if a.shape[1] == y.shape[1] else y
    return conv(p.child("cv3"), torch.cat([a, conv(p.child("cv2"), x)], dim=1))


def repncspelan4(p: _P, x, n: int):
    y = conv(p.child("cv1"), x)
    t = conv(p.child("cv2_conv"), repcsp(p.child("cv2_csp"), y[:, y.shape[1] // 2:], n))
    u = conv(p.child("cv3_conv"), repcsp(p.child("cv3_csp"), t, n))
    return conv(p.child("cv4"), torch.cat([y, t, u], dim=1))


def adown(p: _P, x):
    x = M.avg_pool2(x)
    c = x.shape[1] // 2
    x1 = conv(p.child("cv1"), x[:, :c], s=2)
    x2 = conv(p.child("cv2"), M.max_pool(x[:, c:], 3, 2))
    return torch.cat([x1, x2], dim=1)


def sppf(p: _P, x, k: int = 5, last: str = "cv2"):
    """SPPF; SPPELAN is the same with its merge conv named ``cv5``."""
    y = [conv(p.child("cv1"), x)]
    for _ in range(3):
        y.append(M.max_pool(y[-1], k))
    return conv(p.child(last), torch.cat(y, dim=1))


def scdown(p: _P, x, s: int):
    y = conv(p.child("cv1"), x)
    return conv(p.child("cv2"), y, s=s, g=y.shape[1], act=False)


def cib(p: _P, x, shortcut: bool, lk: bool):
    y = conv(p.child("pw1"), conv(p.child("dw1"), x, g=x.shape[1]))
    if lk:
        r = p.child("rep")
        y = F.silu(conv(r.child("conv"), y, g=y.shape[1], act=False)
                   + conv(r.child("conv1"), y, g=y.shape[1], act=False))
    else:
        y = conv(p.child("dw2"), y, g=y.shape[1])
    y = conv(p.child("pw2"), y)
    y = conv(p.child("dw3"), y, g=y.shape[1])
    return x + y if shortcut and x.shape[1] == y.shape[1] else y


def aattn(p: _P, x, num_heads: int, area: int):
    """Area attention: the K3 kernel route where it fits, else materialised."""
    b, _, h, w = x.shape
    qk = conv(p.child("qk"), x, act=False)
    v = conv(p.child("v"), x, act=False)
    dim = v.shape[1]
    pe = conv(p.child("pe"), v, g=dim, act=False)
    area = area if area > 0 else 1
    na = (h * w) // area
    qk_t = M.nhwc_tokens(qk, area)
    v_t = M.nhwc_tokens(v, area)
    q, k = qk_t[..., :dim], qk_t[..., dim:]
    if area_attention_fwd_fits(na, dim, num_heads):
        out = area_attention(q, k, v_t, num_heads)
    else:
        out = materialised_area_attention(q, k, v_t, num_heads)
    return conv(p.child("proj"), M.nchw(out, b, h, w) + pe, act=False)


def ablock(p: _P, x, num_heads: int, area: int):
    b, c, h, w = x.shape
    ar = max(area, 1)
    na = (h * w) // ar
    fused = p.get(".fused")
    if fused_ablock_fits(na, c, num_heads, fused[4].shape[1]):
        attn_p = p.child("attn")
        v = conv(attn_p.child("v"), x, act=False)
        pe = conv(attn_p.child("pe"), v, g=c, act=False)
        out = fused_ablock(
            M.nhwc_tokens(x, 1), M.nhwc_tokens(v, 1), M.nhwc_tokens(pe, 1),
            fused, ar, num_heads,
        )
        return M.nchw(out, b, h, w)
    x = x + aattn(p.child("attn"), x, num_heads, area)
    y = conv(p.child("mlp2"), conv(p.child("mlp1"), x), act=False)
    return x + y


def a2c2f(p: _P, x, n: int, a2: bool, area: int, residual: bool):
    w_cv1, _ = p.child("cv1").get()
    num_heads = max(w_cv1.shape[0] // 32, 1)
    y = [conv(p.child("cv1"), x)]
    for i in range(n):
        if a2:
            t = ablock(p.child(f"m{i}_0"), y[-1], num_heads, area)
            t = ablock(p.child(f"m{i}_1"), t, num_heads, area)
        else:
            t = c3k(p.child(f"m{i}"), y[-1])
        y.append(t)
    out = conv(p.child("cv2"), torch.cat(y, dim=1))
    if a2 and residual:
        return x + p.get(".gamma").to(out.dtype).view(1, -1, 1, 1) * out
    return out


def detect(p: _P, feats: list, legacy: bool = False):
    outs = []
    for i, x in enumerate(feats):
        bx = conv(p.child(f"box{i}_1"), conv(p.child(f"box{i}_0"), x))
        bx = plain_conv(p.child(f"box{i}_2"), bx)
        if legacy:  # the v8 cls branch: two 3x3 convs
            c = conv(p.child(f"cls{i}_1"), conv(p.child(f"cls{i}_0"), x))
        else:
            c = conv(p.child(f"cls{i}_0dw").child("dw"), x, g=x.shape[1])
            c = conv(p.child(f"cls{i}_0pw"), c)
            c = conv(p.child(f"cls{i}_1dw").child("dw"), c, g=c.shape[1])
            c = conv(p.child(f"cls{i}_1pw"), c)
        c = plain_conv(p.child(f"cls{i}_2"), c)
        outs.append(torch.cat([bx, c], dim=1).permute(0, 2, 3, 1))  # NHWC view
    return outs


def proto(p: _P, x):
    """Mask prototypes (``modules.Proto``): conv3 -> 2x up -> conv3 -> conv1."""
    return conv(p.child("cv3"), conv(p.child("cv2"), M.upsample2x(conv(p.child("cv1"), x))))


def branch(p: _P, feats: list, prefix: str, width: int) -> torch.Tensor:
    """A Segment / Pose / OBB head's per-level branch, (B, A, width) in f32."""
    out = []
    for i, x in enumerate(feats):
        m = plain_conv(p.child(f"{prefix}{i}_2"),
                       conv(p.child(f"{prefix}{i}_1"), conv(p.child(f"{prefix}{i}_0"), x)))
        out.append(m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, width))
    return torch.cat(out, dim=1).float()


def segment(p: _P, feats: list, legacy: bool, nm: int) -> dict:
    """Segment head: Detect + mask coefficients + Proto, f32 coeffs / protos."""
    protos = proto(p.child("proto"), feats[0])
    return {"det": detect(p.child("detect"), feats, legacy=legacy),
            "coeffs": branch(p, feats, "m", nm),
            "protos": protos.permute(0, 2, 3, 1).float()}


def pose(p: _P, feats: list, legacy: bool, kpt_shape) -> dict:
    """Pose head: Detect + keypoint branches, ``kpts_raw`` (B, A, K, D) f32."""
    k, d = kpt_shape
    raw = branch(p, feats, "k", k * d)
    return {"det": detect(p.child("detect"), feats, legacy=legacy),
            "kpts_raw": raw.reshape(raw.shape[0], raw.shape[1], k, d)}


def obb(p: _P, feats: list, legacy: bool, ne: int) -> dict:
    """OBB head: Detect + angle branches, theta = (sigmoid - 0.25) pi in f32."""
    raw = branch(p, feats, "a", ne)
    return {"det": detect(p.child("detect"), feats, legacy=legacy),
            "angle": (torch.sigmoid(raw) - 0.25) * math.pi}


@torch.no_grad()
def run_graph(spec, table: dict, images: torch.Tensor, stem_s2d: bool = False,
              stem_packed: bool = False) -> list[torch.Tensor] | dict:
    """Execute the parsed GraphSpec on (B, H, W, 3) images (uint8, or float
    already in [0, 1]); returns the per-level raw maps (B, H, W, 4*reg_max+nc)
    as NHWC views; for yolov10's dual head ``{"one2one": maps}``, the head
    that inference decodes (JAX's returns one2many's maps too, which its
    jitted callers discard unread); Segment ``{"det", "coeffs",
    "protos"}``, Pose ``{"det", "kpts_raw"}``, OBB ``{"det", "angle"}``.

    The stem is the plain strided conv unless a math option asks for a
    rewrite (both off by default, as JAX's): ``stem_s2d`` computes an RGB
    k3 s2 node 0 by :func:`stem_conv_s2d`; ``stem_packed``, where
    :func:`stem_fusable` holds, nodes 0 and 1 by :func:`stem_pair_packed`
    (it wins over ``stem_s2d`` there)."""
    x = from_uint8(images, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    outputs: dict[int, torch.Tensor] = {}
    cur = x
    result = None
    fuse_stem = stem_packed and stem_fusable(spec, table, x)
    for node in spec.nodes:
        if fuse_stem and node.index == 0:
            continue  # computed with node 1
        ins = [cur if f == node.index - 1 else outputs[f] for f in node.frm]
        m, a = node.module, node.args
        p = _P(table, f"n{node.index}_{m}")
        if fuse_stem and node.index == 1:
            cur = stem_pair_packed(_P(table, "n0_Conv"), p, x, g1=a[4] if len(a) > 4 else 1)
        elif m == "Conv":
            s, g, act = a[2] if len(a) > 2 else 1, a[4] if len(a) > 4 else 1, (
                a[5] if len(a) > 5 else True)
            if (stem_s2d and node.index == 0 and s == 2 and g == 1 and act
                    and ins[0].shape[1] == 3 and ins[0].shape[2] % 2 == 0
                    and ins[0].shape[3] % 2 == 0 and tuple(p.get()[0].shape[2:]) == (3, 3)):
                cur = stem_conv_s2d(p, ins[0])
            else:
                cur = conv(p, ins[0], s=s, g=g, act=act)
        elif m == "DWConv":
            cur = conv(p.child("dw"), ins[0], s=a[2] if len(a) > 2 else 1,
                       g=ins[0].shape[1])
        elif m == "C3k2":
            cur = c3k2(p, ins[0], n=node.repeats, c3k_flag=a[1])
        elif m == "C2f":
            cur = c2f(p, ins[0], n=node.repeats, shortcut=a[1])
        elif m == "A2C2f":
            cur = a2c2f(p, ins[0], n=node.repeats, a2=a[1], area=a[2], residual=a[3])
        elif m == "C2PSA":
            cur = c2psa(p, ins[0], n=node.repeats)
        elif m == "C2fCIB":
            cur = c2f(p, ins[0], n=node.repeats, shortcut=a[1], block=partial(cib, lk=a[2]))
        elif m == "RepNCSPELAN4":
            cur = repncspelan4(p, ins[0], n=a[3])
        elif m == "ADown":
            cur = adown(p, ins[0])
        elif m == "SPPELAN":
            cur = sppf(p, ins[0], last="cv5")
        elif m == "SCDown":
            cur = scdown(p, ins[0], s=a[2])
        elif m == "PSA":
            cur = psa(p, ins[0])
        elif m == "SPPF":
            cur = sppf(p, ins[0], k=a[1])
        elif m == "Upsample":
            cur = M.upsample2x(ins[0])
        elif m == "Concat":
            cur = torch.cat(ins, dim=1)
        elif m == "Detect":
            result = detect(p, ins, legacy=spec.legacy_head)
            cur = ins[0]
        elif m == "v10Detect":  # one2many is for training only (JAX's jit drops it)
            result = {"one2one": detect(p.child("one2one"), ins)}
            cur = ins[0]
        elif m == "Segment":
            result = segment(p, ins, legacy=spec.legacy_head, nm=a[1])
            cur = ins[0]
        elif m == "Pose":
            result = pose(p, ins, legacy=spec.legacy_head, kpt_shape=tuple(a[1]))
            cur = ins[0]
        elif m == "OBB":
            result = obb(p, ins, legacy=spec.legacy_head, ne=a[1])
            cur = ins[0]
        elif m == "Classify":
            raise NotImplementedError(
                "Classify has no BN-folded route (nor in the JAX package): the classify "
                "task runs the module tree in eval mode")
        else:
            raise unsupported(m)
        if node.index in spec.save:
            outputs[node.index] = cur
    if result is None:
        raise ValueError("model yaml has no head node")
    return result
