"""YOLOv12 building blocks as ``nn.Module``s (yolov12 subset of
``kuzu/models/yolo/modules.py``).

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
``area`` contiguous chunks.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.flash_attention import (
    AreaAttention,
    area_attention_train_fits,
    materialised_area_attention,
)

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
    ``k // 2``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
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
    """cv1 -> cv2 with the residual where the widths agree (the yolov12
    family always asks for the shortcut)."""

    def __init__(self, c1: int, c2: int, g: int = 1, k: tuple[int, int] = (3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1], g=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if x.shape[1] == y.shape[1] else y


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
    """Anchor-free head (v12 cls branch): per level ``box{i}_0..2`` and
    ``cls{i}_0dw, 0pw, 1dw, 1pw, 2``; ``box{i}_2``/``cls{i}_2`` are plain 1x1
    convs with bias."""

    def __init__(self, nc: int, ch: list[int], reg_max: int = 16):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            self.add_module(f"box{i}_0", Conv(c, c2, 3))
            self.add_module(f"box{i}_1", Conv(c2, c2, 3))
            self.add_module(f"box{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            self.add_module(f"cls{i}_0dw", DWConv(c, c, 3))
            self.add_module(f"cls{i}_0pw", Conv(c, c3, 1))
            self.add_module(f"cls{i}_1dw", DWConv(c3, c3, 3))
            self.add_module(f"cls{i}_1pw", Conv(c3, c3, 1))
            self.add_module(f"cls{i}_2", nn.Conv2d(c3, nc, 1))
        self.nl = len(ch)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per-level raw maps (B, H, W, 4*reg_max + nc), as NHWC views."""
        outs = []
        for i, x in enumerate(feats):
            bx = self.get_submodule(f"box{i}_1")(self.get_submodule(f"box{i}_0")(x))
            bx = plain_conv(self.get_submodule(f"box{i}_2"), bx)
            c = self.get_submodule(f"cls{i}_0pw")(self.get_submodule(f"cls{i}_0dw")(x))
            c = self.get_submodule(f"cls{i}_1pw")(self.get_submodule(f"cls{i}_1dw")(c))
            c = plain_conv(self.get_submodule(f"cls{i}_2"), c)
            outs.append(torch.cat([bx, c], dim=1).permute(0, 2, 3, 1))
        return outs


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal (+-2 std) with variance
    1/fan_in, fan_in = kh * kw * cin / groups."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """The flax default init in distribution (not in bits): conv kernels
    lecun_normal, BN scale 1 / bias 0 / mean 0 / var 1, Detect biases 1.0
    (box) and -4.6 (cls), A2C2f gamma 0.01. The Detect biases are set after
    the walk: ``modules()`` visits a Detect before its convs, whose step
    zeroes every bias."""
    for m in root.modules():
        if isinstance(m, nn.Conv2d):
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
