"""The YOLO zoo's building blocks as ``nn.Module``s (the modules of
``kuzu/models/yolo/modules.py``: the detect zoo yolov8, yolov9c, yolov10,
yolo11 and yolov12, and the Segment, Pose, OBB and Classify heads).

Each module holds the parameters of its flax counterpart under the same
names, so ``kuzu_torch.bridge`` maps a flax checkpoint one to one:
``Conv`` has ``conv`` (an ``nn.Conv2d`` without bias, flax ``conv/kernel``)
and ``bn`` (``nn.BatchNorm2d`` with eps 1e-3, flax ``bn/scale|bias`` and
``batch_stats bn/mean|var``).

``forward`` is the flax ``__call__`` on NCHW tensors, following
``self.training`` as flax follows ``train``; training runs through it, while
inference runs through the BN-folded executor ``kuzu_torch.models.yolo.infer``.
The compute dtype is the input's: the graph casts the images once, and the
rounding points of flax under ``dtype=bf16`` are written out, not left to
``torch.autocast``:

- a conv casts its f32 master weight to the input dtype and returns that
  dtype (flax ``nn.Conv(dtype=bf16)``);
- BatchNorm is flax's, not torch's: statistics from the batch in f32, the
  normalisation in f32, the result cast back; the running statistics move as
  ``ra = 0.97 ra + 0.03 stat`` with the *biased* batch variance
  ``E[x^2] - E[x]^2`` (``F.batch_norm``'s own update would use the unbiased
  one, so it only normalises here);
- SiLU, residual adds and concatenations run in the compute dtype.

Area attention tokens are the NHWC row-major flatten of H*W, split into
``area`` contiguous chunks; PSA attention (``Attention``) takes all H*W
tokens, heads packed as flax packs them.
"""

from __future__ import annotations

import contextlib
import math
import threading
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.flash_attention import (
    AreaAttention,
    area_attention_train_fits,
    materialised_area_attention,
    xla_attention,
)
from kuzu_torch.ops.s2d import s2d_strided_conv

BN_MOMENTUM = 0.97  # flax momentum: ra = 0.97 ra + 0.03 batch statistic

_bn_state = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """Train-mode BatchNorm leaves its running statistics as they are in
    this thread: the recomputation of a checkpointed block (``remat``) runs
    its forward a second time, and flax's ``nn.remat`` moves the statistics
    once per step."""
    prev = getattr(_bn_state, "frozen", False)
    _bn_state.frozen = True
    try:
        yield
    finally:
        _bn_state.frozen = prev


def flax_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.97, epsilon=1e-3)`` on an NCHW tensor:
    batch statistics in f32 when ``bn.training`` (updating the running ones
    in place, except under :func:`frozen_batch_stats`), running statistics
    otherwise; the result in x's dtype. Statistics and normalisation run in
    x's dtype promoted to at least f32, as flax's."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if bn.training:
        if not getattr(_bn_state, "frozen", False):
            with torch.no_grad():
                mean = xf.mean(dim=(0, 2, 3))
                var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
                bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
                bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
        y = F.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    else:
        y = F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
                         0.0, bn.eps)
    return y.to(x.dtype)


def plain_conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A bias-carrying 1x1 conv in x's dtype: the product, then the bias
    added in that dtype (flax ``nn.Conv(dtype=...)`` with a bias)."""
    y = conv2d(x, m.weight.to(x.dtype))
    return y + m.bias.to(x.dtype).view(1, -1, 1, 1)


def nhwc_tokens(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*groups, H*W/groups, C), row-major over (H, W)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b * groups, h * w // groups, c)


def nchw(t: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Tokens (B*groups, N, C) row-major over (H, W) -> a (B, C, H, W) view."""
    return t.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU (``act``) as flax ``Conv``; padding is
    ``k // 2``.

    ``impl="s2d"`` computes an eligible convolution (k3, s2, p1, even H and
    W, channels divisible by the groups: JAX's gate) as a dense k2
    convolution over a space-to-depth packing (``ops/s2d.py``), the same
    math up to summation order; anything else takes the native convolution.
    The parameters stay the 3 x 3 kernel either way."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True, impl: str = "native"):
        super().__init__()
        if impl not in ("native", "s2d"):
            raise ValueError(f"Conv impl '{impl}': 'native' or 's2d'")
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act
        self.impl = impl

    def s2d_eligible(self, x: torch.Tensor) -> bool:
        """JAX's gate (``kuzu/models/yolo/modules.py:85-88``)."""
        c = self.conv
        return (self.impl == "s2d" and c.kernel_size == (3, 3) and c.stride == (2, 2)
                and c.padding == (1, 1) and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
                and c.out_channels % c.groups == 0 and x.shape[1] % c.groups == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.s2d_eligible(x):
            y = s2d_strided_conv(x, c.weight.to(x.dtype), c.groups)
        else:
            y = conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding, 1, c.groups)
        y = flax_batch_norm(self.bn, y)
        return F.silu(y) if self.act else y


class DWConv(nn.Module):
    """Depthwise Conv (groups = gcd(c1, c2)), nested under ``dw`` as in flax."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.dw = Conv(c1, c2, k, s, g=math.gcd(c1, c2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dw(x)


class Bottleneck(nn.Module):
    """cv1 -> cv2 with the residual where ``shortcut`` and the widths agree."""

    def __init__(self, c1: int, c2: int, g: int = 1, k: tuple[int, int] = (3, 3),
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1], g=g)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut and x.shape[1] == y.shape[1] else y


class C3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, g: int = 1, e: float = 0.5,
                 bott_k: tuple[int, int] = (1, 3), bott_e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, g, bott_k, bott_e))
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k(nn.Module):
    """C3 with k=3 bottlenecks, nested under ``c3`` as in flax."""

    def __init__(self, c1: int, c2: int, n: int = 2, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c3 = C3(c1, c2, n, g, e, bott_k=(3, 3), bott_e=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c3(x)


class C3k2(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, g: int = 1):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(
                f"m{i}", C3k(c, c, 2, g) if c3k else Bottleneck(c, c, g, (3, 3), 0.5))
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class C2f(nn.Module):
    """cv1 split -> n full-width blocks -> concat -> cv2 (the v8 family's
    block). ``block(c, c, shortcut=)`` builds each inner block: bottlenecks
    (k 3x3, e 1.0), C2fCIB's CIBs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 e: float = 0.5, block=partial(Bottleneck, e=1.0)):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", block(c, c, shortcut=shortcut))
        self.cv2 = Conv((2 + n) * c, c2, 1)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


def max_pool(x: torch.Tensor, k: int, s: int = 1) -> torch.Tensor:
    """k x k max pool at stride s, padded k // 2 with -inf (flax's
    ``nn.max_pool`` with that padding, the executor's ``reduce_window``)."""
    return F.max_pool2d(x, k, s, k // 2)


class SPPF(nn.Module):
    """cv1 -> three chained k x k max pools -> concat -> the merge conv
    ``last`` (cv2; SPPELAN's cv5), over ``c_`` channels (c1 // 2)."""

    def __init__(self, c1: int, c2: int, k: int = 5, c_: int | None = None,
                 last: str = "cv2"):
        super().__init__()
        c_ = c_ or c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.add_module(last, Conv(4 * c_, c2, 1))
        self.k, self.last = k, last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(max_pool(y[-1], self.k))
        return self.get_submodule(self.last)(torch.cat(y, dim=1))


def psa_tokens(qkv: torch.Tensor, heads: int, kd: int):
    """The ``qkv`` conv's (B, heads * (2 kd + hd), H, W) output -> q, k, v
    with heads folded into the batch, (B * heads, H*W, kd | kd | hd): flax
    reshapes the NHWC map to (B, H*W, heads, 2 kd + hd) and slices."""
    b, ch, h, w = qkv.shape
    t = qkv.permute(0, 2, 3, 1).reshape(b, h * w, heads, ch // heads)

    def fold(z):
        return z.transpose(1, 2).reshape(b * heads, h * w, -1)

    return fold(t[..., :kd]), fold(t[..., kd:2 * kd]), fold(t[..., 2 * kd:])


def psa_unfold(t: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """(B * heads, H*W, hd) -> the (B, heads * hd, H, W) map, channels head
    by head."""
    heads = t.shape[0] // b
    t = t.reshape(b, heads, h * w, -1).transpose(1, 2)
    return t.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class Attention(nn.Module):
    """PSA multi-head attention over all H*W tokens: the ``qkv`` 1x1 conv
    (q and k ``kd = hd * attn_ratio`` wide, v ``hd``), the 3x3 depthwise
    ``pe`` on v and the ``proj`` 1x1 conv. The attention itself is
    ``xla_attention``'s arithmetic, flax's: f32 scores scaled by kd^-1/2,
    the softmax cast to v's dtype, f32 accumulation, the result in x's
    dtype. It is materialised: q and k are narrower than v, which the
    attention kernels do not take, and JAX's executor runs it the same way
    (``infer.py:_psa_attn``)."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        hd = dim // num_heads
        self.kd = int(hd * attn_ratio)
        self.qkv = Conv(dim, dim + 2 * self.kd * num_heads, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        q, k, v = psa_tokens(self.qkv(x), self.num_heads, self.kd)
        out = xla_attention(q, k, v, scale=self.kd ** -0.5)
        pe = self.pe(psa_unfold(v, b, h, w))
        return self.proj(psa_unfold(out, b, h, w) + pe)


class PSABlock(nn.Module):
    """x + attn(x), then x + ffn2(ffn1(x))."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4):
        super().__init__()
        self.add_body(c, attn_ratio, num_heads)

    def add_body(self, c: int, attn_ratio: float, num_heads: int) -> None:
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn1 = Conv(c, 2 * c, 1)
        self.ffn2 = Conv(2 * c, c, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    """cv1 split; n PSABlocks on the second half; concat -> cv2 (yolo11)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", PSABlock(c, 0.5, max(c // 64, 1)))
        self.cv2 = Conv(2 * c, c2, 1)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        c = y.shape[1] // 2
        a, b = y[:, :c], y[:, c:]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))


class PSA(PSABlock):
    """cv1 split; a PSABlock's body (its attn, ffn1, ffn2) on the second
    half; concat -> cv2 (yolov10)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        nn.Module.__init__(self)  # cv1 first: the seeded draws follow this order
        c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c, 1)
        self.add_body(c, 0.5, max(c // 64, 1))
        self.cv2 = Conv(2 * c, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        c = y.shape[1] // 2
        return self.cv2(torch.cat([y[:, :c], super().forward(y[:, c:])], dim=1))


class RepConv(nn.Module):
    """silu(3x3 conv + BN  +  1x1 conv + BN), unfused as in flax."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 3, act=False)
        self.conv2 = Conv(c1, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(nn.Module):
    """RepConv -> 3x3 Conv, with the residual where the widths agree."""

    def __init__(self, c1: int, c2: int, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_)
        self.cv2 = Conv(c_, c2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if x.shape[1] == y.shape[1] else y


class RepCSP(nn.Module):
    """C3 with RepBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        for i in range(n):
            self.add_module(f"m{i}", RepBottleneck(c_, c_, 1.0))
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class RepNCSPELAN4(nn.Module):
    """cv1 split; two chained RepCSP + 3x3 Conv branches; concat -> cv4
    (the yolov9 block)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1)
        self.cv2_csp = RepCSP(c3 - c3 // 2, c4, n)
        self.cv2_conv = Conv(c4, c4, 3)
        self.cv3_csp = RepCSP(c4, c4, n)
        self.cv3_conv = Conv(c4, c4, 3)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        half = y.shape[1] // 2
        t = self.cv2_conv(self.cv2_csp(y[:, half:]))
        u = self.cv3_conv(self.cv3_csp(t))
        return self.cv4(torch.cat([y, t, u], dim=1))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average at stride 1, no padding, as XLA reduces the window: the
    taps added in row-major order, each sum rounded to x's dtype, then
    x 0.25 (exact). Bit-equal to flax's ``nn.avg_pool`` and the executor's
    ``reduce_window`` on the CPU in bf16 and f32."""
    a, b = x[:, :, :-1, :-1], x[:, :, :-1, 1:]
    c, d = x[:, :, 1:, :-1], x[:, :, 1:, 1:]
    return (((a + b) + c) + d) * 0.25


class ADown(nn.Module):
    """The yolov9 downsample: 2x2 average, channel split, a strided 3x3
    conv on the first half, a 3x3/2 max pool and 1x1 conv on the second."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1 // 2, c2 // 2, 3, 2)
        self.cv2 = Conv(c1 - c1 // 2, c2 // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = avg_pool2(x)
        c = x.shape[1] // 2
        return torch.cat([self.cv1(x[:, :c]), self.cv2(max_pool(x[:, c:], 3, 2))], dim=1)


class SPPELAN(SPPF):
    """SPPF over c3 channels, its merge conv named cv5 (yolov9)."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__(c1, c2, k, c_=c3, last="cv5")


class SCDown(nn.Module):
    """1x1 Conv, then a k x k depthwise conv at stride s without SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """silu(7x7 depthwise + BN  +  3x3 depthwise + BN), unfused."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, g=ed, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """dw1 -> pw1 -> (RepVGGDW ``rep`` if lk, else dw2) -> pw2 -> dw3, with
    the residual where ``shortcut`` and the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.dw1 = Conv(c1, c1, 3, g=c1)
        self.pw1 = Conv(c1, 2 * c_, 1)
        if lk:
            self.rep = RepVGGDW(2 * c_)
        else:
            self.dw2 = Conv(2 * c_, 2 * c_, 3, g=2 * c_)
        self.pw2 = Conv(2 * c_, c2, 1)
        self.dw3 = Conv(c2, c2, 3, g=c2)
        self.shortcut, self.lk = shortcut, lk

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.dw1(x))
        y = self.rep(y) if self.lk else self.dw2(y)
        y = self.dw3(self.pw2(y))
        return x + y if self.shortcut and x.shape[1] == y.shape[1] else y


class C2fCIB(C2f):
    """C2f with CIB blocks (yolov10)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 lk: bool = False, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, e, block=partial(CIB, e=1.0, lk=lk))


class AAttn(nn.Module):
    """Area attention: qk and v 1x1 convs, 5x5 depthwise ``pe`` on v, and the
    ``proj`` 1x1 conv; areas are contiguous chunks of the row-major H*W axis.

    Route: where :func:`area_attention_train_fits` holds, :class:`AreaAttention`
    (the K3 forward and K4 backward kernels on the card for bf16, their plain
    versions on the CPU), in training as in evaluation; elsewhere, and for
    other dtypes on the card (the kernels take bf16), the materialised
    :func:`materialised_area_attention` under autograd. This is the route of the JAX
    package's ``attn_impl='flash_train'`` (its TPU default), whose kernels
    keep P in f32 through P.V; the JAX einsum route (its CPU default) rounds
    P to the input dtype first. In f32 the two are the same arithmetic."""

    def __init__(self, dim: int, num_heads: int = 1, area: int = 1):
        super().__init__()
        self.qk = Conv(dim, 2 * dim, 1, act=False)
        self.v = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 5, 1, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.dim, self.num_heads, self.area = dim, num_heads, area

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        dim, heads = self.dim, self.num_heads
        qk = self.qk(x)
        v = self.v(x)
        pe = self.pe(v)
        area = self.area if self.area > 0 else 1
        na = (h * w) // area
        qk_t, v_t = nhwc_tokens(qk, area), nhwc_tokens(v, area)
        if area_attention_train_fits(na, dim, heads) and (
                x.device.type == "cpu" or x.dtype == torch.bfloat16):
            out = AreaAttention.apply(qk_t, v_t, heads)
        else:
            out = materialised_area_attention(qk_t[..., :dim], qk_t[..., dim:], v_t, heads)
        return self.proj(nchw(out, b, h, w) + pe)


class ABlock(nn.Module):
    """x + attn(x); x + mlp2(mlp1(x))."""

    def __init__(self, dim: int, mlp_ratio: float = 1.2, num_heads: int = 1, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        h = int(dim * mlp_ratio)
        self.mlp1 = Conv(dim, h, 1)
        self.mlp2 = Conv(h, dim, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp2(self.mlp1(x))


class A2C2f(nn.Module):
    """R-ELAN block: cv1 -> n stages (2x ABlock or C3k) -> concat -> cv2, with
    the layer-scale residual ``gamma`` (init 0.01) at l/x scale."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5,
                 g: int = 1, area: int = 1):
        super().__init__()
        c_ = int(c2 * e)
        heads = max(c_ // 32, 1)
        self.cv1 = Conv(c1, c_, 1)
        for i in range(n):
            if a2:
                self.add_module(f"m{i}_0", ABlock(c_, mlp_ratio, heads, area))
                self.add_module(f"m{i}_1", ABlock(c_, mlp_ratio, heads, area))
            else:
                self.add_module(f"m{i}", C3k(c_, c_, 2, g))
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.empty(c2)) if a2 and residual else None
        self.n, self.a2 = n, a2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for i in range(self.n):
            if self.a2:
                t = getattr(self, f"m{i}_1")(getattr(self, f"m{i}_0")(y[-1]))
            else:
                t = getattr(self, f"m{i}")(y[-1])
            y.append(t)
        out = self.cv2(torch.cat(y, dim=1))
        if self.gamma is not None:
            return x + self.gamma.to(out.dtype).view(1, -1, 1, 1) * out
        return out


class Detect(nn.Module):
    """Anchor-free head: per level ``box{i}_0..2`` and the cls branch, the
    v12 one (``cls{i}_0dw, 0pw, 1dw, 1pw``: depthwise 3x3 + 1x1, twice) or
    with ``legacy`` the v8 one (``cls{i}_0, 1``: two 3x3 Convs), then
    ``cls{i}_2``; ``box{i}_2``/``cls{i}_2`` are plain 1x1 convs with bias."""

    def __init__(self, nc: int, ch: list[int], reg_max: int = 16, legacy: bool = False):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            self.add_module(f"box{i}_0", Conv(c, c2, 3))
            self.add_module(f"box{i}_1", Conv(c2, c2, 3))
            self.add_module(f"box{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            if legacy:
                self.add_module(f"cls{i}_0", Conv(c, c3, 3))
                self.add_module(f"cls{i}_1", Conv(c3, c3, 3))
            else:
                self.add_module(f"cls{i}_0dw", DWConv(c, c, 3))
                self.add_module(f"cls{i}_0pw", Conv(c, c3, 1))
                self.add_module(f"cls{i}_1dw", DWConv(c3, c3, 3))
                self.add_module(f"cls{i}_1pw", Conv(c3, c3, 1))
            self.add_module(f"cls{i}_2", nn.Conv2d(c3, nc, 1))
        self.nl, self.legacy = len(ch), legacy

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per-level raw maps (B, H, W, 4*reg_max + nc), as NHWC views."""
        outs = []
        for i, x in enumerate(feats):
            bx = self.get_submodule(f"box{i}_1")(self.get_submodule(f"box{i}_0")(x))
            bx = plain_conv(self.get_submodule(f"box{i}_2"), bx)
            if self.legacy:
                c = self.get_submodule(f"cls{i}_1")(self.get_submodule(f"cls{i}_0")(x))
            else:
                c = self.get_submodule(f"cls{i}_0pw")(self.get_submodule(f"cls{i}_0dw")(x))
                c = self.get_submodule(f"cls{i}_1pw")(self.get_submodule(f"cls{i}_1dw")(c))
            c = plain_conv(self.get_submodule(f"cls{i}_2"), c)
            outs.append(torch.cat([bx, c], dim=1).permute(0, 2, 3, 1))
        return outs


class V10Detect(nn.Module):
    """The yolov10 dual head: ``one2many`` and ``one2one``, two v12-style
    Detect heads. one2one reads detached features (flax's
    ``stop_gradient``), so only one2many's loss reaches the backbone; both
    move their BatchNorm statistics in training."""

    def __init__(self, nc: int, ch: list[int], reg_max: int = 16):
        super().__init__()
        self.one2many = Detect(nc, ch, reg_max)
        self.one2one = Detect(nc, ch, reg_max)

    def forward(self, feats: list[torch.Tensor]) -> dict[str, list[torch.Tensor]]:
        return {"one2many": self.one2many(feats),
                "one2one": self.one2one([f.detach() for f in feats])}


class Proto(nn.Module):
    """Mask prototypes over the P3 map: Conv 3x3 -> 2x upsample -> Conv 3x3
    -> Conv 1x1 to ``nm`` channels (``cv1..cv3``)."""

    def __init__(self, c1: int, npr: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, npr, 3)
        self.cv2 = Conv(npr, npr, 3)
        self.cv3 = Conv(npr, nm, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(upsample2x(self.cv1(x))))


class _BranchHead(nn.Module):
    """A Detect head (``detect``) plus a per-level branch ``{p}{i}_0, 1, 2``
    of ``width`` channels over ``c4 = max(ch[0] // 4, width)``."""

    prefix = ""

    def __init__(self, nc: int, ch: list[int], width: int, reg_max: int, legacy: bool):
        super().__init__()
        c4 = max(ch[0] // 4, width)
        for i, c in enumerate(ch):
            self.add_module(f"{self.prefix}{i}_0", Conv(c, c4, 3))
            self.add_module(f"{self.prefix}{i}_1", Conv(c4, c4, 3))
            self.add_module(f"{self.prefix}{i}_2", nn.Conv2d(c4, width, 1))
        self.detect = Detect(nc, ch, reg_max, legacy=legacy)
        self.width = width

    def branch(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Each level's two 3x3 Convs and plain 1x1 conv, (B, H*W, width) in
        NHWC order, concatenated over the levels to (B, A, width) in f32."""
        g, p, out = self.get_submodule, self.prefix, []
        for i, x in enumerate(feats):
            m = plain_conv(g(f"{p}{i}_2"), g(f"{p}{i}_1")(g(f"{p}{i}_0")(x)))
            out.append(m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, self.width))
        return torch.cat(out, 1).float()


class Segment(_BranchHead):
    """Instance segmentation: Detect plus per-level mask coefficients
    (``m{i}_*``) and the Proto over P3. Returns ``{"det": maps, "coeffs":
    (B, A, nm) f32, "protos": (B, Hp, Wp, nm) f32}``."""

    prefix = "m"

    def __init__(self, nc: int, ch: list[int], nm: int = 32, npr: int = 256,
                 reg_max: int = 16, legacy: bool = True):
        super().__init__(nc, ch, nm, reg_max, legacy)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats: list[torch.Tensor]) -> dict:
        protos = self.proto(feats[0])
        coeffs = self.branch(feats)
        return {"det": self.detect(feats), "coeffs": coeffs,
                "protos": protos.permute(0, 2, 3, 1).float()}


class Pose(_BranchHead):
    """Keypoints: Detect plus per-level ``K * D`` values an anchor
    (``k{i}_*``). Returns ``{"det": maps, "kpts_raw": (B, A, K, D) f32}``;
    :func:`kpts_decode` decodes them."""

    prefix = "k"

    def __init__(self, nc: int, ch: list[int], kpt_shape: tuple[int, int] = (17, 3),
                 reg_max: int = 16, legacy: bool = True):
        super().__init__(nc, ch, kpt_shape[0] * kpt_shape[1], reg_max, legacy)
        self.kpt_shape = tuple(kpt_shape)

    def forward(self, feats: list[torch.Tensor]) -> dict:
        raw = self.branch(feats)
        return {"det": self.detect(feats),
                "kpts_raw": raw.reshape(raw.shape[0], raw.shape[1], *self.kpt_shape)}


def kpts_decode(anchor_points: torch.Tensor, kpts_raw: torch.Tensor) -> torch.Tensor:
    """Anchor-relative keypoints in grid units: xy 2 + anchor - 0.5; the
    other values (visibility logits) pass through."""
    xy = kpts_raw[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
    return torch.cat([xy, kpts_raw[..., 2:]], dim=-1)


class OBB(_BranchHead):
    """Oriented boxes: Detect plus per-level angle logits (``a{i}_*``);
    theta = (sigmoid - 0.25) pi in [-pi/4, 3 pi/4]. Returns ``{"det": maps,
    "angle": (B, A, ne) f32}``."""

    prefix = "a"

    def __init__(self, nc: int, ch: list[int], ne: int = 1, reg_max: int = 16,
                 legacy: bool = True):
        super().__init__(nc, ch, ne, reg_max, legacy)

    def forward(self, feats: list[torch.Tensor]) -> dict:
        raw = self.branch(feats)
        return {"det": self.detect(feats), "angle": (torch.sigmoid(raw) - 0.25) * math.pi}


class Classify(nn.Module):
    """Classification: Conv 1x1 to 1280 channels (``conv``), the spatial
    mean, then ``linear`` in f32 whatever the weights' dtype (flax
    ``nn.Dense(dtype=f32)``), logits (B, c2)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = Conv(c1, 1280, 1)
        self.linear = nn.Linear(1280, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x).mean(dim=(2, 3))
        return F.linear(x.float(), self.linear.weight.float(), self.linear.bias.float())


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal (+-2 std) with variance
    1/fan_in, fan_in = kh * kw * cin / groups (a Dense's: its inputs)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """The flax default init in distribution (not in bits): conv and Dense
    kernels lecun_normal, BN scale 1 / bias 0 / mean 0 / var 1, Detect biases 1.0
    (box) and -4.6 (cls) in every head (the legacy one, both of yolov10's),
    A2C2f gamma 0.01. The Detect biases are set after
    the walk: ``modules()`` visits a Detect before its convs, whose step
    zeroes every bias."""
    for m in root.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, A2C2f) and m.gamma is not None:
            m.gamma.fill_(0.01)
    for m in root.modules():
        if isinstance(m, Detect):
            for i in range(m.nl):
                getattr(m, f"box{i}_2").bias.fill_(1.0)
                getattr(m, f"cls{i}_2").bias.fill_(-4.6)  # ~log(0.01/0.99)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def dfl_expectation(box_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """DFL decode: softmax-expectation over ``reg_max`` bins, (..., 4*reg_max)
    -> (..., 4), in the input dtype.

    Written op by op as ``jax.nn.softmax`` and ``sum`` run in JAX for a bf16
    input: exp and the division round to bf16, the sums accumulate in f32
    and round once. The maximum is a constant for the gradient, as in
    ``jax.nn.softmax``."""
    d = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max)
    e = torch.exp(d - d.amax(dim=-1, keepdim=True).detach())
    p = e / e.float().sum(-1, keepdim=True).to(e.dtype)
    bins = torch.arange(reg_max, dtype=p.dtype, device=p.device)
    return (p * bins).float().sum(-1).to(p.dtype)
