"""YAML model-graph parser and the module tree it describes.

The parser (``make_divisible``, ``NodeSpec``, ``GraphSpec``,
``parse_model_yaml``, ``resolve_model_spec``) is a copy of
``kuzu/models/yolo/graph.py``: a model yaml lists ``[from, repeats, module,
args]`` rows; compound scaling (depth/width/max_channels per scale letter)
resizes repeats and channels, and channels and strides propagate statically.
:class:`YoloGraph` builds the ``nn.Module`` tree of a parsed spec with the
parameter names of the flax graph (``n{i}_{Module}``) and runs it as the
flax graph's ``__call__`` does (the training forward).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch
import yaml
from torch import nn
from torch.utils.checkpoint import checkpoint

from kuzu_torch.models.layers import dtype_products
from kuzu_torch.models.yolo import modules as M
from kuzu_torch.ops.images import from_uint8

MODEL_DIR = Path(__file__).resolve().parent.parent.parent / "cfg" / "models"


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclass
class NodeSpec:
    index: int
    frm: list[int]  # absolute input indices (-1 resolved)
    module: str
    args: list[Any]
    c_out: int
    stride: int
    repeats: int = 1


@dataclass
class GraphSpec:
    nc: int
    scale: str
    nodes: list[NodeSpec]
    save: list[int]  # indices whose outputs later nodes consume
    detect_ch: list[int] = field(default_factory=list)
    strides: list[int] = field(default_factory=list)
    legacy_head: bool = False  # v8-style Detect cls branch
    end2end: bool = False  # v10 dual head (NMS-free one2one inference)
    seg_nm: int = 0  # Segment head: number of mask coefficients (0 = detect)
    seg_npr: int = 0  # Segment head: prototype channels
    kpt_shape: tuple[int, int] | None = None  # Pose head (K, D)
    obb: bool = False  # OBB head (rotated boxes)
    classify: bool = False  # Classify head (plain logits)
    # DFL bins per side. Max representable box extent is reg_max*stride px
    # per side from the anchor; the reference hardcodes 16
    # (``nn/modules/head.py`` Detect.reg_max), which truncates objects
    # taller than 2*16*stride px (e.g. book columns). Overridable via the
    # model yaml key ``reg_max`` or the trainer cfg.
    reg_max: int = 16


def parse_model_yaml(
    path_or_dict: str | Path | dict, scale: str | None = None, nc: int | None = None
) -> GraphSpec:
    if isinstance(path_or_dict, (str, Path)):
        with open(path_or_dict) as f:
            d = yaml.safe_load(f)
    else:
        d = dict(path_or_dict)
    scales = d.get("scales", {})
    scale = scale or d.get("scale") or (next(iter(scales)) if scales else "n")
    depth, width, max_ch = scales.get(scale, (1.0, 1.0, float("inf")))
    nc = nc if nc is not None else int(d.get("nc", 80))

    rows = list(d["backbone"]) + list(d["head"])
    nodes: list[NodeSpec] = []
    ch: list[int] = []  # output channels per node
    strides: list[int] = []
    save: set[int] = set()
    detect_ch: list[int] = []
    det_strides: list[int] = []

    for i, (frm, n, mod, args) in enumerate(rows):
        frm_list = [frm] if isinstance(frm, int) else list(frm)
        frm_abs = [(i + f) if f < 0 else f for f in frm_list]
        for f in frm_abs:
            if f != i - 1:
                save.add(f)
        n_scaled = max(round(n * depth), 1) if n > 1 else n
        args = list(args)

        c_in = ch[frm_abs[0]] if ch else 3
        s_in = strides[frm_abs[0]] if strides else 1

        if mod in ("Conv", "DWConv"):
            c2 = make_divisible(min(args[0], max_ch) * width)
            s = args[2] if len(args) > 2 else 1
            nodes.append(
                NodeSpec(i, frm_abs, mod, [c2] + args[1:], c2, s_in * s, n_scaled)
            )
        elif mod in ("C3k2",):
            c2 = make_divisible(min(args[0], max_ch) * width)
            c3k = bool(args[1]) if len(args) > 1 else False
            if scale in "mlx":
                c3k = True
            e = float(args[2]) if len(args) > 2 else 0.5
            nodes.append(
                NodeSpec(i, frm_abs, mod, [c2, c3k, e], c2, s_in, n_scaled)
            )
        elif mod == "C2f":
            c2 = make_divisible(min(args[0], max_ch) * width)
            shortcut = bool(args[1]) if len(args) > 1 else False
            nodes.append(
                NodeSpec(i, frm_abs, mod, [c2, shortcut], c2, s_in, n_scaled)
            )
        elif mod == "A2C2f":
            c2 = make_divisible(min(args[0], max_ch) * width)
            a2 = bool(args[1]) if len(args) > 1 else True
            area = int(args[2]) if len(args) > 2 else 1
            residual, mlp_ratio = False, 2.0
            if scale in "lx":
                residual, mlp_ratio = True, 1.5
            nodes.append(
                NodeSpec(
                    i, frm_abs, mod, [c2, a2, area, residual, mlp_ratio],
                    c2, s_in, n_scaled,
                )
            )
        elif mod == "RepNCSPELAN4":
            c2 = make_divisible(min(args[0], max_ch) * width)
            c3 = make_divisible(min(args[1], max_ch) * width)
            c4 = make_divisible(min(args[2], max_ch) * width)
            nrep = int(args[3]) if len(args) > 3 else 1
            nodes.append(
                NodeSpec(i, frm_abs, mod, [c2, c3, c4, nrep], c2, s_in, 1)
            )
        elif mod == "ADown":
            c2 = make_divisible(min(args[0], max_ch) * width)
            nodes.append(NodeSpec(i, frm_abs, mod, [c2], c2, s_in * 2, 1))
        elif mod == "SPPELAN":
            c2 = make_divisible(min(args[0], max_ch) * width)
            c3 = make_divisible(min(args[1], max_ch) * width)
            nodes.append(NodeSpec(i, frm_abs, mod, [c2, c3], c2, s_in, 1))
        elif mod == "C2fCIB":
            c2 = make_divisible(min(args[0], max_ch) * width)
            shortcut = bool(args[1]) if len(args) > 1 else False
            lk = bool(args[2]) if len(args) > 2 else False
            nodes.append(
                NodeSpec(i, frm_abs, mod, [c2, shortcut, lk], c2, s_in, n_scaled)
            )
        elif mod == "SCDown":
            c2 = make_divisible(min(args[0], max_ch) * width)
            k = int(args[1]) if len(args) > 1 else 3
            st = int(args[2]) if len(args) > 2 else 2
            nodes.append(NodeSpec(i, frm_abs, mod, [c2, k, st], c2, s_in * st, 1))
        elif mod == "PSA":
            c2 = make_divisible(min(args[0], max_ch) * width)
            e = float(args[1]) if len(args) > 1 else 0.5
            nodes.append(NodeSpec(i, frm_abs, mod, [c2, e], c2, s_in, 1))
        elif mod == "C2PSA":
            c2 = make_divisible(min(args[0], max_ch) * width)
            e = float(args[1]) if len(args) > 1 else 0.5
            nodes.append(NodeSpec(i, frm_abs, mod, [c2, e], c2, s_in, n_scaled))
        elif mod == "SPPF":
            c2 = make_divisible(min(args[0], max_ch) * width)
            k = int(args[1]) if len(args) > 1 else 5
            nodes.append(NodeSpec(i, frm_abs, mod, [c2, k], c2, s_in, 1))
        elif mod in ("Upsample", "nn.Upsample"):
            nodes.append(NodeSpec(i, frm_abs, "Upsample", [], c_in, s_in // 2, 1))
        elif mod == "Concat":
            c2 = sum(ch[f] for f in frm_abs)
            nodes.append(NodeSpec(i, frm_abs, mod, [], c2, s_in, 1))
        elif mod == "Classify":
            nodes.append(NodeSpec(i, frm_abs, mod, [nc], 0, s_in, 1))
        elif mod in ("Detect", "v10Detect", "Segment", "Pose", "OBB"):
            detect_ch = [ch[f] for f in frm_abs]
            det_strides = [strides[f] for f in frm_abs]
            if mod == "OBB":
                ne = int(args[0]) if args else 1
                nodes.append(NodeSpec(i, frm_abs, mod, [nc, ne], 0, s_in, 1))
            elif mod == "Pose":
                ks = tuple(args[0]) if args else (17, 3)
                nodes.append(
                    NodeSpec(i, frm_abs, mod, [nc, list(ks)], 0, s_in, 1)
                )
            elif mod == "Segment":
                # reference Segment(nc, nm=32, npr=256) — npr width-scales
                seg_nm = int(args[0]) if args else 32
                seg_npr = make_divisible(
                    (int(args[1]) if len(args) > 1 else 256) * width
                )
                nodes.append(
                    NodeSpec(i, frm_abs, mod, [nc, seg_nm, seg_npr], 0, s_in, 1)
                )
            else:
                nodes.append(NodeSpec(i, frm_abs, mod, [nc], 0, s_in, 1))
            save.update(frm_abs)
        else:
            raise ValueError(f"unknown module '{mod}' in model yaml")
        ch.append(nodes[-1].c_out)
        strides.append(nodes[-1].stride)

    legacy = not any(
        n.module in ("C3k2", "A2C2f", "v10Detect", "PSA") for n in nodes
    )
    seg = next((n for n in nodes if n.module == "Segment"), None)
    pose = next((n for n in nodes if n.module == "Pose"), None)
    return GraphSpec(
        nc=nc,
        scale=scale,
        nodes=nodes,
        save=sorted(save),
        detect_ch=detect_ch,
        strides=det_strides,
        legacy_head=legacy,
        end2end=any(n.module == "v10Detect" for n in nodes),
        seg_nm=seg.args[1] if seg else 0,
        seg_npr=seg.args[2] if seg else 0,
        kpt_shape=tuple(pose.args[1]) if pose else None,
        obb=any(n.module == "OBB" for n in nodes),
        classify=any(n.module == "Classify" for n in nodes),
        reg_max=int(d.get("reg_max", 16)),
    )


def resolve_model_spec(name: str) -> tuple[Path, str | None]:
    """'yolov12n' -> (yolov12.yaml path, 'n'); explicit .yaml passes through."""
    p = Path(name)
    if p.suffix == ".yaml":
        if p.exists():
            return p, None
        cand = MODEL_DIR / p.name
        if cand.exists():
            return cand, None
        raise FileNotFoundError(f"no model yaml '{name}' (looked in {MODEL_DIR})")
    stem = name
    # task-suffixed variants: 'yolov8n-seg' -> yolov8-seg.yaml, scale 'n'
    for suffix in ("-seg", "-pose", "-obb", "-cls"):
        if stem.endswith(suffix):
            core = stem[: -len(suffix)]
            if core and core[-1] in "nsmlx":
                base = MODEL_DIR / f"{core[:-1]}{suffix}.yaml"
                if base.exists():
                    return base, core[-1]
    if stem and stem[-1] in "nsmlx":
        base = MODEL_DIR / f"{stem[:-1]}.yaml"
        if base.exists():
            return base, stem[-1]
    cand = MODEL_DIR / f"{stem}.yaml"
    if cand.exists():
        return cand, None
    raise FileNotFoundError(f"no model yaml for '{name}' (looked in {MODEL_DIR})")


# Modules of the YOLO zoo (yolov8, yolov9c, yolov10, yolo11, yolov12 and the
# Segment / Pose / OBB / Classify heads).
SUPPORTED = ("Conv", "DWConv", "C2f", "C3k2", "A2C2f", "C2PSA", "RepNCSPELAN4", "ADown",
             "SPPELAN", "C2fCIB", "SCDown", "PSA", "SPPF", "Upsample", "Concat", "Detect",
             "v10Detect", "Segment", "Pose", "OBB", "Classify")
# What the port does not build from a yaml.
LATER = "YOLO-NAS is built by the nas task (models/nas.py), not from a yaml"
# The block modules the flax graph wraps in nn.remat (``_block``); plain
# convs, the pools' blocks, Concat, Upsample and the heads are not wrapped.
REMAT_BLOCKS = ("C2f", "C3k2", "A2C2f", "C2PSA", "RepNCSPELAN4", "C2fCIB", "PSA")
# Heads over the listed feature maps; Classify reads one map.
HEADS = ("Detect", "v10Detect", "Segment", "Pose", "OBB")


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute leaves the
    BatchNorm running statistics alone, so they move once, as under flax."""
    return contextlib.nullcontext(), M.frozen_batch_stats()


def unsupported(module: str) -> NotImplementedError:
    """The error for a module the port does not build."""
    return NotImplementedError(f"module '{module}' is not ported: the port builds the "
                               f"YOLO zoo's modules; {LATER}")


def build_node(node: NodeSpec, spec: GraphSpec, c1: int, conv_impl: str = "native") -> nn.Module:
    """The module of one parsed node, as the flax graph builds it;
    ``conv_impl`` reaches the graph's ``Conv`` nodes only, as in JAX."""
    m, a, n = node.module, node.args, node.repeats
    if m == "Conv":
        return M.Conv(c1, a[0], k=a[1] if len(a) > 1 else 1, s=a[2] if len(a) > 2 else 1,
                      g=a[4] if len(a) > 4 else 1, act=a[5] if len(a) > 5 else True,
                      impl=conv_impl)
    if m == "DWConv":
        return M.DWConv(c1, a[0], k=a[1] if len(a) > 1 else 3, s=a[2] if len(a) > 2 else 1)
    if m == "C2f":
        return M.C2f(c1, a[0], n=n, shortcut=a[1])
    if m == "C3k2":
        return M.C3k2(c1, a[0], n=n, c3k=a[1], e=a[2])
    if m == "A2C2f":
        return M.A2C2f(c1, a[0], n=n, a2=a[1], residual=a[3], mlp_ratio=a[4], area=a[2])
    if m == "C2PSA":
        return M.C2PSA(c1, a[0], n=n, e=a[1])
    if m == "RepNCSPELAN4":
        return M.RepNCSPELAN4(c1, a[0], a[1], a[2], n=a[3])
    if m == "ADown":
        return M.ADown(c1, a[0])
    if m == "SPPELAN":
        return M.SPPELAN(c1, a[0], a[1])
    if m == "C2fCIB":
        return M.C2fCIB(c1, a[0], n=n, shortcut=a[1], lk=a[2])
    if m == "SCDown":
        return M.SCDown(c1, a[0], a[1], a[2])
    if m == "PSA":
        return M.PSA(c1, a[0], e=a[1])
    if m == "SPPF":
        return M.SPPF(c1, a[0], a[1])
    if m == "Detect":
        return M.Detect(spec.nc, spec.detect_ch, spec.reg_max, legacy=spec.legacy_head)
    if m == "v10Detect":
        return M.V10Detect(spec.nc, spec.detect_ch, spec.reg_max)
    if m == "Segment":
        return M.Segment(spec.nc, spec.detect_ch, nm=a[1], npr=a[2], reg_max=spec.reg_max,
                         legacy=spec.legacy_head)
    if m == "Pose":
        return M.Pose(spec.nc, spec.detect_ch, kpt_shape=tuple(a[1]), reg_max=spec.reg_max,
                      legacy=spec.legacy_head)
    if m == "OBB":
        return M.OBB(spec.nc, spec.detect_ch, ne=a[1], reg_max=spec.reg_max,
                     legacy=spec.legacy_head)
    if m == "Classify":
        return M.Classify(c1, spec.nc)
    raise unsupported(m)


class YoloGraph(nn.Module):
    """The module tree of a parsed GraphSpec: the detect zoo (yolov8,
    yolov9c, yolov10, yolo11, yolov12 and its P2 variant) and the Segment,
    Pose, OBB and Classify heads.

    ``forward`` is the flax graph's ``__call__`` (``kuzu/models/yolo/graph.py``)
    in ``dtype`` (master weights stay f32), following ``self.training``: the
    training path. Inference runs through the BN-folded executor
    ``kuzu_torch.models.yolo.infer.run_graph``.

    ``remat=True`` recomputes each block's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of the flax
    graph's ``nn.remat`` on its blocks (``REMAT_BLOCKS``): less memory for a
    second forward of each block. Values, gradients and BatchNorm statistics
    are unchanged.

    ``conv_impl="s2d"`` computes each eligible ``Conv`` node (k3, s2, even
    H and W) as a dense k2 convolution over a space-to-depth packing
    (``modules.Conv``), the same math up to summation order, with the same
    parameters."""

    def __init__(self, spec: GraphSpec, dtype: torch.dtype = torch.float32,
                 remat: bool = False, conv_impl: str = "native"):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.remat = remat
        ch: list[int] = []
        for node in spec.nodes:
            if node.module not in SUPPORTED:
                raise unsupported(node.module)
            if node.module not in ("Upsample", "Concat"):
                self.add_module(f"n{node.index}_{node.module}",
                                build_node(node, spec, ch[node.frm[0]] if ch else 3,
                                           conv_impl))
            ch.append(node.c_out)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor] | dict:
        """(B, H, W, 3) images (uint8, or float in [0, 1]) -> the per-level
        raw maps (B, H, W, 4*reg_max + nc) as NHWC views; yolov10's dual
        head returns ``{"one2many": maps, "one2one": maps}``, Segment
        ``{"det", "coeffs", "protos"}``, Pose ``{"det", "kpts_raw"}``, OBB
        ``{"det", "angle"}`` and Classify the (B, nc) f32 logits. Pixels become
        f32 ``x / 255`` and then ``dtype``, as the flax graph's first conv
        casts them; activations are NCHW in ``channels_last``. An f32 graph
        runs with TF32 off (``f32_products``: torch's default lets cuDNN
        take TF32 convolutions); a bf16 graph leaves the settings alone."""
        with dtype_products(self.dtype):
            return self._forward(images)

    def _forward(self, images: torch.Tensor) -> list[torch.Tensor] | dict:
        x = from_uint8(images).to(self.dtype).permute(0, 3, 1, 2)
        cur = x.contiguous(memory_format=torch.channels_last)
        outputs: dict[int, torch.Tensor] = {}
        result = None
        for node in self.spec.nodes:
            ins = [cur if f == node.index - 1 else outputs[f] for f in node.frm]
            m = node.module
            if m == "Upsample":
                cur = M.upsample2x(ins[0])
            elif m == "Concat":
                cur = torch.cat(ins, dim=1)
            elif m in HEADS:
                result = self.get_submodule(f"n{node.index}_{m}")(ins)
                cur = ins[0]
            elif m == "Classify":
                result = self.get_submodule(f"n{node.index}_{m}")(ins[0])
                cur = ins[0]
            else:
                mod = self.get_submodule(f"n{node.index}_{m}")
                if (self.remat and m in REMAT_BLOCKS and self.training
                        and torch.is_grad_enabled()):
                    cur = checkpoint(mod, ins[0], use_reentrant=False,
                                     context_fn=_remat_contexts)
                else:
                    cur = mod(ins[0])
            if node.index in self.spec.save:
                outputs[node.index] = cur
        if result is None:
            raise ValueError("model yaml has no head node")
        return result

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with flax's distributions (see ``modules.init_weights``)."""
        M.init_weights(self, generator)
