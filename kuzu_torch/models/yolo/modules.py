"""YOLOv12 building blocks as ``nn.Module`` parameter trees (yolov12 subset of
``kuzu/models/yolo/modules.py``).

Each module holds the parameters of its flax counterpart under the same
names, so ``kuzu_torch.bridge`` maps a flax checkpoint one to one:
``Conv`` has ``conv`` (an ``nn.Conv2d`` without bias, flax ``conv/kernel``)
and ``bn`` (``nn.BatchNorm2d`` with eps 1e-3, flax ``bn/scale|bias`` and
``batch_stats bn/mean|var``). Inference runs through the BN-folded executor
``kuzu_torch.models.yolo.infer``, not through these modules, so they carry
no ``forward``. :func:`upsample2x` and :func:`dfl_expectation` are the two
tensor functions of the family.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """Conv2d + BatchNorm (+ SiLU, chosen by the executor) as flax ``Conv``;
    padding is ``k // 2``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)


class DWConv(nn.Module):
    """Depthwise Conv (groups = gcd(c1, c2)), nested under ``dw`` as in flax."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.dw = Conv(c1, c2, k, s, g=math.gcd(c1, c2))


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, g: int = 1, k: tuple[int, int] = (3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1], g=g)


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


class C3k(nn.Module):
    """C3 with k=3 bottlenecks, nested under ``c3`` as in flax."""

    def __init__(self, c1: int, c2: int, n: int = 2, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c3 = C3(c1, c2, n, g, e, bott_k=(3, 3), bott_e=1.0)


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


class AAttn(nn.Module):
    """Area attention: qk and v 1x1 convs, 5x5 depthwise ``pe`` on v, and the
    ``proj`` 1x1 conv; areas are contiguous chunks of the row-major H*W axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.qk = Conv(dim, 2 * dim, 1)
        self.v = Conv(dim, dim, 1)
        self.pe = Conv(dim, dim, 5, 1, g=dim)
        self.proj = Conv(dim, dim, 1)


class ABlock(nn.Module):
    """x + attn(x); x + mlp2(mlp1(x))."""

    def __init__(self, dim: int, mlp_ratio: float = 1.2):
        super().__init__()
        self.attn = AAttn(dim)
        h = int(dim * mlp_ratio)
        self.mlp1 = Conv(dim, h, 1)
        self.mlp2 = Conv(h, dim, 1)


class A2C2f(nn.Module):
    """R-ELAN block: cv1 -> n stages (2x ABlock or C3k) -> concat -> cv2, with
    the layer-scale residual ``gamma`` (init 0.01) at l/x scale."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 residual: bool = False, mlp_ratio: float = 2.0, e: float = 0.5,
                 g: int = 1):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        for i in range(n):
            if a2:
                self.add_module(f"m{i}_0", ABlock(c_, mlp_ratio))
                self.add_module(f"m{i}_1", ABlock(c_, mlp_ratio))
            else:
                self.add_module(f"m{i}", C3k(c_, c_, 2, g))
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = nn.Parameter(torch.empty(c2)) if a2 and residual else None


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
    (box) and -4.6 (cls), A2C2f gamma 0.01."""
    for m in root.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, A2C2f) and m.gamma is not None:
            m.gamma.fill_(0.01)
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
    and round once."""
    d = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max)
    e = torch.exp(d - d.amax(dim=-1, keepdim=True))
    p = e / e.float().sum(-1, keepdim=True).to(e.dtype)
    bins = torch.arange(reg_max, dtype=p.dtype, device=p.device)
    return (p * bins).float().sum(-1).to(p.dtype)
