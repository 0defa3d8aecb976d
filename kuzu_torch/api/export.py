"""Model export: a portable graph through ``torch.export`` (counterpart of
``kuzu/api/export.py``).

JAX serializes the jitted forward + decode (+ NMS) with frozen weights as
StableHLO. The port's portable format is the ``torch.export`` program, saved
as ``<out>.pt2`` beside a ``<out>.json`` of its input and output shapes and
dtypes, the model dtype, the device and the ``kuzu_torch::`` operators the
graph holds. The config's ``format: stablehlo`` (the default config is
JAX's, copied) names this format in the port. The detector's kernels are
operators (``kuzu_torch/ops/registry.py``), so the graph holds them as nodes
and reloading a ``.pt2`` needs ``import kuzu_torch`` first (the package
registers them). Shapes are static, as JAX's.

``onnx`` needs the ``onnx`` and ``onnxscript`` packages, ``saved_model`` and
``tflite`` need ``tensorflow``; none is in the port's environment, and each
format raises naming its packages, as JAX's ``export_onnx`` gate does.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import warnings
from pathlib import Path
from typing import Any

import torch
from torch.utils._pytree import tree_leaves, tree_unflatten

from kuzu_torch.models.yolo.infer import run_graph
from kuzu_torch.ops.registry import graph_operators


def _aval(t: torch.Tensor) -> str:
    """``float32[8,640,640,3]``: dtype and shape, as JAX's aval strings."""
    return f"{str(t.dtype).removeprefix('torch.')}[{','.join(str(int(s)) for s in t.shape)}]"


def export_fn(
    module: torch.nn.Module,
    example_args: tuple,
    out_path: str | Path,
    metadata: dict | None = None,
) -> Path:
    """Export ``module`` (non-strict ``torch.export``, no gradients, the
    example's static shapes) to ``<out_path>.pt2`` with ``<out_path>.json``
    metadata; returns the ``.pt2`` path."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args), strict=False)
    blob = out_path.with_suffix(".pt2")
    with warnings.catch_warnings():
        # channels_last weights are dense but not contiguous: the archive
        # writes each one's whole storage with its strides, and warns
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, blob)
    outs = [n.meta["val"] for n in program.graph.output_node().args[0]]
    out_tree = tree_unflatten(outs, program.call_spec.out_spec)
    meta = {
        "in_avals": [_aval(a) for a in tree_leaves(example_args)],
        "out_avals": ({k: _aval(v) for k, v in out_tree.items()}
                      if isinstance(out_tree, dict) else [_aval(v) for v in outs]),
        "device": str(next(t for t in tree_leaves(example_args)
                           if isinstance(t, torch.Tensor)).device),
        "operators": graph_operators(program.graph_module),
        **(metadata or {}),
    }
    out_path.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return blob


def load_exported(path: str | Path):
    """Load a ``.pt2`` and return its callable (a ``torch.fx`` module on the
    device it was exported on)."""
    return torch.export.load(Path(path)).module()


class DetectorProgram(torch.nn.Module):
    """What an exported detector computes: (B, H, W, 3) f32 images in [0, 1]
    -> the forward, the DFL decode and, with ``include_nms``, the padded
    ``{boxes, scores, classes, valid}`` of :meth:`YoloDetector.select` (else
    the decoded (B, 4 + nc, A) tensor).

    In bf16 the forward is the BN-folded executor (``run_graph``, the
    predictor's) over the detector's folded tensors, held here as buffers;
    in f32 it is a copy of the module tree in eval mode (its parameters and
    BatchNorm statistics), which runs with TF32 off (``YoloGraph.forward``)."""

    def __init__(self, det, include_nms: bool = True, conf: float = 0.25, iou: float = 0.45,
                 max_det: int = 300, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if det.folded is None:
            raise RuntimeError("the detector has no weights: call init() or load them first")
        self.det, self.dtype = det, dtype
        self.include_nms, self.conf, self.iou, self.max_det = include_nms, conf, iou, max_det
        self.slots: list[tuple[str, type, list[str]]] = []
        if dtype == torch.bfloat16:
            for key, value in det.folded.items():
                parts = list(value) if isinstance(value, (tuple, list)) else [value]
                names = []
                for t in parts:
                    names.append(f"w{sum(len(s[2]) for s in self.slots) + len(names)}")
                    # a copy of its own: views of one storage save as one blob
                    self.register_buffer(names[-1], t.detach().clone())
                self.slots.append((key, type(value), names))
        elif dtype == torch.float32:
            self.tree = copy.deepcopy(det.graph).eval()
        else:
            raise ValueError(f"a detector exports in bf16 or f32, not {dtype}")

    def table(self) -> dict:
        """The folded table of ``fold_graph``'s layout over the buffers."""
        out = {}
        for key, kind, names in self.slots:
            parts = [getattr(self, n) for n in names]
            out[key] = parts[0] if kind is torch.Tensor else kind(parts)
        return out

    def forward(self, images: torch.Tensor):
        det = self.det
        if self.dtype == torch.bfloat16:
            maps = run_graph(det.spec, self.table(), images, stem_s2d=det.stem_s2d,
                             stem_packed=det.stem_packed)
        else:
            maps = self.tree(images)
        pred = det.decode(maps)
        if self.include_nms:
            return det.select(pred, self.conf, self.iou, self.max_det)
        return pred


def export_detector(
    source: Any,
    out_path: str | Path | None = None,
    batch: int = 1,
    include_nms: bool = True,
    conf: float = 0.25,
    iou: float = 0.45,
    max_det: int = 300,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
) -> Path:
    """Export a detector: image batch -> padded detections. ``source`` is a
    port run dir (or ``hub://`` name), loaded as ``DetectPredictor`` loads
    it on ``device`` (the card when None), or a built ``YoloDetector`` (then
    ``out_path`` is needed). The program runs on the device it was
    exported on."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    if isinstance(source, YoloDetector):
        det, run_dir = source, None
        if out_path is None:
            raise ValueError("export_detector of a YoloDetector needs out_path")
    else:
        from kuzu_torch.core.config import load_config
        from kuzu_torch.core.hub import resolve
        from kuzu_torch.tasks.detect import DetectPredictor

        run_dir = resolve(source)
        predictor = DetectPredictor(
            load_config(overrides={"model": str(run_dir), "conf": conf, "iou": iou,
                                   "max_det": max_det}), device=device)
        predictor._setup()
        det = predictor.detector
    program = DetectorProgram(det, include_nms, conf, iou, max_det, dtype)
    example = (torch.zeros((batch, det.imgsz, det.imgsz, 3), dtype=torch.float32,
                           device=det.device),)
    out_path = Path(out_path or (run_dir / "export" / "detector"))
    return export_fn(
        program,
        example,
        out_path,
        metadata={
            "model": str(run_dir) if run_dir else f"YoloDetector scale {det.spec.scale}",
            "imgsz": det.imgsz,
            "batch": batch,
            "include_nms": include_nms,
            "conf": conf,
            "iou": iou,
            "max_det": max_det,
            "dtype": str(dtype).removeprefix("torch."),
        },
    )


def require_packages(fmt: str, packages: tuple[str, ...]) -> None:
    """Raise ``ImportError`` naming ``packages`` where one is missing, else
    ``NotImplementedError`` naming them too: the format has no route in the
    port yet. Looks the packages up without importing them."""
    names = " + ".join(repr(p) for p in packages)
    if any(importlib.util.find_spec(p) is None for p in packages):
        raise ImportError(f"format={fmt} needs the {names} package(s) (not in this "
                          f"environment); export format=stablehlo (the .pt2 program) instead")
    raise NotImplementedError(f"format={fmt}: the port has no route through {names} to it "
                              f"yet (ROADMAP.md); export format=stablehlo (the .pt2 program)")


class Exporter:
    """Task-map component for ``Model(...).export()``: ``cfg.model`` names
    the run, ``cfg.format`` the format, ``cfg.nms`` whether NMS is in the
    program (off in the default config, as JAX's)."""

    def __init__(self, cfg: Any, device: torch.device | str | None = None):
        self.cfg, self.device = cfg, device

    def run(self) -> Path:
        fmt = str(self.cfg.get("format", "stablehlo"))
        if fmt == "stablehlo":
            return export_detector(
                str(self.cfg.get("model")),
                batch=int(self.cfg.get("batch", 1)),
                include_nms=bool(self.cfg.get("nms", True)),
                conf=float(self.cfg.get("conf") or 0.25),
                iou=float(self.cfg.get("iou", 0.45)),
                max_det=int(self.cfg.get("max_det", 300)),
                device=self.device,
            )
        if fmt == "onnx":
            require_packages(fmt, ("onnx", "onnxscript"))
        if fmt in ("saved_model", "tflite"):
            require_packages(fmt, ("tensorflow",))
        raise NotImplementedError(f"format '{fmt}' not supported")
