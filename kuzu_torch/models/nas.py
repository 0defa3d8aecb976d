"""YOLO-NAS: the re-parameterisable detector and its ``nas`` task
(counterpart of ``kuzu/models/nas.py``).

The architecture is JAX's: QARepVGG blocks (three branches in training:
``relu(BN(BN3(conv3x3 x) + conv1x1 x [+ x]))``), CSP stages over them,
SPPF, a PAN neck and a decoupled DFL head, at the hand-scaled s / m / l
widths and depths. Parameter names are flax's, so ``kuzu_torch.bridge``
maps a flax tree one to one (``w3`` / ``w1`` HWIO -> OIHW, the four
hand-written BatchNorm statistics from ``batch_stats``).

A QARepVGG's BatchNorms are written by hand, as JAX's are: eps 1e-3, the
running statistics moving as ``0.97 ra + 0.03 stat`` with the *biased*
batch variance, the branch-3 BN normalising in f32 after the conv. At
inference the three branches re-parameterise into one 3x3 conv and a bias
(:meth:`QARepVGG.fold`): JAX folds in-graph at every fused forward, the
port folds once when the detector loads its weights (:func:`fold_nas`), as
the YOLO executor folds BatchNorm; the parameter tree stays one tree.

The forward returns per-level NHWC maps ``(B, H, W, 4 * reg_max + nc)`` at
strides 8, 16 and 32, the contract of ``YoloGraph``, so ``detect_loss``
trains it unchanged and :class:`NASDetector` decodes it as
``YoloDetector`` does; an f32 forward runs with TF32 off
(``f32_products``). NMS runs on the K1 kernel on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from kuzu_torch.models.layers import dtype_products
from kuzu_torch.models.yolo import modules as M
from kuzu_torch.models.yolo.detector import YoloDetector, resolve_device
from kuzu_torch.ops.conv import conv2d
from kuzu_torch.ops.images import from_uint8

BN_EPS = 1e-3
BN_MOMENTUM = 0.97

# size -> (width multiple, per-stage CSP depths)
SIZES = {
    "s": (0.50, (1, 1, 2, 1)),
    "m": (0.75, (2, 2, 3, 2)),
    "l": (1.00, (2, 3, 4, 2)),
}
BASE_CH = (64, 128, 256, 512, 768)


def mult16(c: float) -> int:
    """Channels rounded to a multiple of 16 (at least 16)."""
    return max(16, int(round(c / 16)) * 16)


def _bn(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    """``(y - mean) * rsqrt(var + eps) * scale + bias`` over NCHW channels."""
    v = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
    return (y - v(mean)) * torch.rsqrt(v(var) + BN_EPS) * v(scale) + v(bias)


def _batch_stats(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor):
    """The batch's mean and biased variance over (N, H, W) (differentiable,
    as flax's), the running ones moved in place."""
    mu = y.mean(dim=(0, 2, 3))
    var_b = (y - mu.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    with torch.no_grad():
        mean.copy_(BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * mu)
        var.copy_(BN_MOMENTUM * var + (1 - BN_MOMENTUM) * var_b)
    return mu, var_b


class QARepVGG(nn.Module):
    """Quantization-aware RepVGG block (QARepVGG-B layout): BN on the 3x3
    branch only, the raw 1x1 and the identity (stride 1 and ``ci == co``),
    one BN after the add. ``forward`` follows ``self.training``; with
    ``folded`` (:func:`fold_nas`'s dict) the eval forward is the one
    re-parameterised 3x3 conv."""

    # the bridge's layouts of the bare leaves, and the statistics' names
    flax_layouts = {"w3": "conv", "w1": "conv"}
    flax_batch_stats = ("bn3_mean", "bn3_var", "bn_mean", "bn_var")

    def __init__(self, ci: int, co: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.has_id = stride == 1 and ci == co
        self.w3 = nn.Parameter(torch.empty(co, ci, 3, 3))
        self.w1 = nn.Parameter(torch.empty(co, ci, 1, 1))
        self.bn3_scale = nn.Parameter(torch.ones(co))
        self.bn3_bias = nn.Parameter(torch.zeros(co))
        self.bn_scale = nn.Parameter(torch.ones(co))
        self.bn_bias = nn.Parameter(torch.zeros(co))
        for name in ("bn3_mean", "bn_mean"):
            self.register_buffer(name, torch.zeros(co))
        for name in ("bn3_var", "bn_var"):
            self.register_buffer(name, torch.ones(co))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's ``he_normal`` kernels (truncated normal, variance 2 /
        fan_in), BN scale 1 and bias 0, statistics 0 and 1."""
        for w in (self.w3, self.w1):
            std = math.sqrt(2.0 / w[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        for p, v in ((self.bn3_scale, 1.0), (self.bn3_bias, 0.0), (self.bn_scale, 1.0),
                     (self.bn_bias, 0.0), (self.bn3_mean, 0.0), (self.bn3_var, 1.0),
                     (self.bn_mean, 0.0), (self.bn_var, 1.0)):
            p.fill_(v)

    @torch.no_grad()
    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The re-parameterised (3x3 kernel OIHW, bias), f32, from the running
        statistics, in JAX's order: BN3 folded into ``w3``, ``w1`` added at
        the centre tap, the identity added there (before the post-add
        scale), then the post-add BN folded."""
        s3 = self.bn3_scale * torch.rsqrt(self.bn3_var + BN_EPS)
        k = self.w3 * s3.view(-1, 1, 1, 1) + F.pad(self.w1, (1, 1, 1, 1))
        bias = self.bn3_bias - self.bn3_mean * s3
        if self.has_id:
            k[:, :, 1, 1] += torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
        s = self.bn_scale * torch.rsqrt(self.bn_var + BN_EPS)
        k = k * s.view(-1, 1, 1, 1)
        bias = (bias - self.bn_mean) * s + self.bn_bias
        return k, bias

    def _conv(self, x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
        return conv2d(x, w.to(x.dtype), None, self.stride, pad)

    def forward(self, x: torch.Tensor, folded: dict | None = None) -> torch.Tensor:
        dt = x.dtype
        if folded is not None and not self.training:
            k, bias = folded[self]
            return F.relu(self._conv(x, k, 1) + bias.to(dt).view(1, -1, 1, 1))
        f = torch.promote_types(dt, torch.float32)  # the BNs' f32 (an f64 module's f64)
        y3 = self._conv(x, self.w3, 1).to(f)
        if self.training:
            mu3, var3 = _batch_stats(y3, self.bn3_mean, self.bn3_var)
        else:
            mu3, var3 = self.bn3_mean, self.bn3_var
        y = _bn(y3, mu3, var3, self.bn3_scale, self.bn3_bias)
        y = y + self._conv(x, self.w1, 0).to(f)
        if self.has_id:
            y = y + x.to(f)
        if self.training:
            mu, var = _batch_stats(y, self.bn_mean, self.bn_var)
        else:
            mu, var = self.bn_mean, self.bn_var
        return F.relu(_bn(y, mu, var, self.bn_scale, self.bn_bias)).to(dt)


class NASStage(nn.Module):
    """CSP stage over QARepVGG blocks: 1x1 ``cva`` / ``cvb`` to ``co // 2``,
    ``n`` blocks on the first, concatenation, 1x1 ``cvo``."""

    def __init__(self, c1: int, co: int, n: int = 1):
        super().__init__()
        c_ = co // 2
        self.cva = M.Conv(c1, c_, 1)
        self.cvb = M.Conv(c1, c_, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", QARepVGG(c_, c_))
        self.cvo = M.Conv(2 * c_, co, 1)

    def forward(self, x: torch.Tensor, folded: dict | None = None) -> torch.Tensor:
        a, b = self.cva(x), self.cvb(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a, folded)
        return self.cvo(torch.cat([a, b], dim=1))


class YoloNAS(nn.Module):
    """QARepVGG backbone + PAN neck + decoupled DFL head in ``dtype``
    (master weights f32). ``forward(images)`` follows ``self.training``
    and returns the per-level NHWC maps at strides 8 / 16 / 32."""

    def __init__(self, nc: int = 80, size: str = "s", reg_max: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nc, self.size, self.reg_max, self.dtype = nc, size, reg_max, dtype
        wm, depths = SIZES[size]
        ch = [mult16(c * wm) for c in BASE_CH]
        self.stem = QARepVGG(3, ch[0], stride=2)
        for i, (c, n) in enumerate(zip(ch[1:], depths)):
            self.add_module(f"down{i}", QARepVGG(ch[i], c, stride=2))
            self.add_module(f"stage{i}", NASStage(c, c, n))
        self.sppf = M.SPPF(ch[4], ch[4])
        self.red5 = M.Conv(ch[4], ch[3], 1)
        self.up4 = NASStage(2 * ch[3], ch[3], depths[2])
        self.red4 = M.Conv(ch[3], ch[2], 1)
        self.up3 = NASStage(2 * ch[2], ch[2], depths[1])
        self.dn3 = QARepVGG(ch[2], ch[2], stride=2)
        self.dn4 = NASStage(ch[2] + ch[3], ch[3], depths[1])
        self.dn5 = QARepVGG(ch[3], ch[3], stride=2)
        self.dn6 = NASStage(ch[3] + ch[4], ch[4], depths[1])
        for i, t in enumerate(ch[2:]):
            s = max(t // 2, 64)
            self.add_module(f"h{i}_stem", M.Conv(t, s, 1))
            self.add_module(f"h{i}_reg", M.Conv(s, s, 3))
            self.add_module(f"h{i}_reg_out", nn.Conv2d(s, 4 * reg_max, 1))
            self.add_module(f"h{i}_cls", M.Conv(s, s, 3))
            self.add_module(f"h{i}_cls_out", nn.Conv2d(s, nc, 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init in distribution: the Conv / BN / head trees as the
        YOLO modules' (``init_weights``: lecun normal, head biases 0, as
        flax's plain ``nn.Conv``), the QARepVGG blocks he normal."""
        M.init_weights(self, generator)
        for m in self.modules():
            if isinstance(m, QARepVGG):
                m.reset_parameters(generator)

    def forward(self, images: torch.Tensor, folded: dict | None = None) -> list[torch.Tensor]:
        """(B, H, W, 3) images (uint8, or float in [0, 1]) -> the NHWC maps;
        ``folded`` (eval mode) runs each QARepVGG as its one fused conv."""
        with dtype_products(self.dtype):
            return self._forward(images, folded)

    def _forward(self, images: torch.Tensor, folded: dict | None) -> list[torch.Tensor]:
        x = from_uint8(images, dtype=self.dtype).permute(0, 3, 1, 2)
        x = self.stem(x.contiguous(memory_format=torch.channels_last), folded)
        feats = []
        for i in range(4):
            x = getattr(self, f"down{i}")(x, folded)
            x = getattr(self, f"stage{i}")(x, folded)
            if i >= 1:
                feats.append(x)
        p3, p4, p5 = feats
        p5 = self.sppf(p5)
        r5 = self.red5(p5)
        u4 = self.up4(torch.cat([M.upsample2x(r5), p4], dim=1), folded)
        r4 = self.red4(u4)
        n3 = self.up3(torch.cat([M.upsample2x(r4), p3], dim=1), folded)
        n4 = self.dn4(torch.cat([self.dn3(n3, folded), u4], dim=1), folded)
        n5 = self.dn6(torch.cat([self.dn5(n4, folded), p5], dim=1), folded)
        outs = []
        for i, t in enumerate((n3, n4, n5)):
            s = getattr(self, f"h{i}_stem")(t)
            r = M.plain_conv(getattr(self, f"h{i}_reg_out"), getattr(self, f"h{i}_reg")(s))
            c = M.plain_conv(getattr(self, f"h{i}_cls_out"), getattr(self, f"h{i}_cls")(s))
            outs.append(torch.cat([r, c], dim=1).permute(0, 2, 3, 1))
        return outs


def fold_nas(module: nn.Module) -> dict:
    """Every QARepVGG block of ``module`` -> its re-parameterised (kernel,
    bias), the dict ``YoloNAS.forward(..., folded=...)`` takes."""
    return {m: m.fold() for m in module.modules() if isinstance(m, QARepVGG)}


@dataclass
class NASSpec:
    """The ``GraphSpec`` surface the detect task reads, and the size."""

    nc: int
    reg_max: int = 16
    size: str = "s"
    strides: tuple = (8, 16, 32)
    end2end: bool = False
    classify: bool = False
    obb: bool = False
    kpt_shape: tuple | None = None
    seg_nm: int = 0
    legacy_head: bool = True


def nas_size(model: str) -> str:
    """``yolo_nas_{s,m,l}`` -> the size letter (``yolo_nas`` alone: s)."""
    size = str(model).replace("yolo_nas_", "").replace("yolo_nas", "") or "s"
    if size not in SIZES:
        raise ValueError(f"unknown YOLO-NAS size {model!r} (sizes: {sorted(SIZES)})")
    return size


class NASDetector(YoloDetector):
    """The ``YoloDetector`` protocol over a :class:`YoloNAS`: ``infer`` runs
    the re-parameterised forward (folded once at load) in ``dtype`` (f32
    by default, as JAX's predictor builds it), ``decode`` and ``select``
    are ``YoloDetector``'s (NMS on K1), ``decoded`` the super_gradients
    contract."""

    def __init__(self, model: str | NASSpec = "yolo_nas_s", nc: int | None = None,
                 dtype: torch.dtype = torch.float32, imgsz: int = 640,
                 device: torch.device | str | None = None, reg_max: int | None = None, **_):
        self.device = resolve_device(device)
        self.spec = model if isinstance(model, NASSpec) else self.resolve_spec(
            str(model), nc=nc)
        if reg_max is not None:
            self.spec.reg_max = int(reg_max)
        self.nc, self.strides, self.imgsz, self.dtype = (
            self.spec.nc, list(self.spec.strides), imgsz, dtype)
        self.graph = self.training_graph(self.spec, dtype)
        self.folded: dict | None = None

    @staticmethod
    def resolve_spec(name: str, nc: int | None = None) -> NASSpec:
        return NASSpec(nc=int(nc or 80), size=nas_size(name))

    @staticmethod
    def training_graph(spec: NASSpec, dtype: torch.dtype, remat: bool = False) -> YoloNAS:
        """The module the trainer trains (``remat`` is taken and unused, as
        JAX's ``NASDetector`` takes it)."""
        return YoloNAS(spec.nc, spec.size, spec.reg_max, dtype)

    @classmethod
    def for_validation(cls, spec: NASSpec, dtype: torch.dtype, imgsz: int,
                       device: torch.device) -> "NASDetector":
        """The validation detector: the trainer's dtype, as JAX validates
        with its training detector."""
        return cls(spec, dtype=dtype, imgsz=imgsz, device=device)

    def _load(self) -> "NASDetector":
        self.graph.to(self.device).eval()
        self.folded = fold_nas(self.graph)
        return self

    @torch.no_grad()
    def infer(self, images: torch.Tensor) -> list[torch.Tensor]:
        """The re-parameterised eval forward of (B, H, W, 3) images."""
        if self.folded is None:
            raise RuntimeError("call init() or load_flax() first")
        return self.graph(images.to(self.device), folded=self.folded)

    @torch.no_grad()
    def apply(self, images: torch.Tensor) -> list[torch.Tensor]:
        """The unfused eval forward (three branches, running statistics)."""
        return self.graph.eval()(images.to(self.device))

    @torch.no_grad()
    def decoded(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The super_gradients eval contract: (xyxy boxes (B, A, 4), scores
        (B, A, nc))."""
        pred = self.decode(self.infer(images)).transpose(1, 2)
        xywh, scores = pred[..., :4], pred[..., 4:]
        half = xywh[..., 2:] / 2
        return torch.cat([xywh[..., :2] - half, xywh[..., :2] + half], -1), scores

