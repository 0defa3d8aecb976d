"""AutoBackend: run inference from a run directory or an exported program
(counterpart of ``kuzu/api/backend.py``).

One class that loads a port run directory or a ``.pt2`` that
``api/export.py`` wrote, and exposes the same padded-detection call as
JAX's: (B, H, W, 3) f32 images in [0, 1] -> a dict of numpy arrays. It
tells the kinds apart as JAX's ``_detect_kind`` does; a ``.tflite``, a
SavedModel directory and a ``.onnx`` raise naming the package their runtime
needs (``tensorflow``, ``onnxruntime``), and a ``.stablehlo`` is JAX's
artifact, which the port does not run.

A ``.pt2`` runs on the device it was exported on; a CUDA program where there
is no card raises (it never moves to the CPU). An exported program does not
carry ``f32_products`` (the f32 graph enters it at run time, so
``torch.export`` never records it): the call runs inside
``dtype_products(<the .json's dtype>)``, so an f32 program runs cuDNN and
cuBLAS with TF32 off, as the eager f32 path does.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from kuzu_torch.models.layers import dtype_products


def _require(package: str, what: str) -> None:
    """Raise naming ``package``: ``ImportError`` where it is missing, else
    ``NotImplementedError`` (the port has no route through it yet)."""
    if importlib.util.find_spec(package) is None:
        raise ImportError(f"loading {what} requires the '{package}' package "
                          f"(not in this environment)")
    raise NotImplementedError(f"loading {what}: the port has no {package} route yet "
                              f"(ROADMAP.md); export format=stablehlo (the .pt2 program)")


class AutoBackend:
    def __init__(self, source: str | Path, device: torch.device | str | None = None,
                 **cfg: Any):
        """``source``: a run dir (or ``hub://`` name) or a ``.pt2``;
        ``device`` is the run dir's predictor's (the card when None); ``cfg``
        overrides its config (``conf``, ``iou``, ``max_det``)."""
        from kuzu_torch.core.hub import resolve

        self.source = resolve(source)
        self.kind = self._detect_kind(self.source)
        self.meta: dict = {}
        self._load(device, cfg)

    @staticmethod
    def _detect_kind(p: Path) -> str:
        if p.is_dir() and (p / "weights").exists():
            return "run_dir"
        if p.suffix == ".pt2":
            return "pt2"
        if p.suffix == ".stablehlo":
            return "stablehlo"
        if p.suffix == ".tflite":
            return "tflite"
        if p.suffix == ".onnx":
            return "onnx"
        if p.is_dir() and (p / "saved_model.pb").exists():
            return "saved_model"
        raise ValueError(f"cannot identify model artifact: {p}")

    def _load(self, device, cfg: dict) -> None:
        if self.kind == "run_dir":
            from kuzu_torch.core.config import load_config
            from kuzu_torch.tasks.detect import DetectPredictor

            self._predictor = DetectPredictor(
                load_config(overrides={"model": str(self.source), **cfg}), device=device)
            self._predictor._setup()
        elif self.kind == "pt2":
            from kuzu_torch.api.export import load_exported

            meta = self.source.with_suffix(".json")
            self.meta = json.loads(meta.read_text()) if meta.exists() else {}
            self.device = torch.device(self.meta.get("device", "cpu"))
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"{self.source} was exported on {self.device} and CUDA is "
                                   "not available; export it again with device='cpu'")
            self.dtype = getattr(torch, self.meta.get("dtype", "bfloat16"))
            self._fn = load_exported(self.source)
        elif self.kind == "stablehlo":
            raise NotImplementedError(f"{self.source} is a JAX StableHLO artifact; the port's "
                                      "exported program is a .pt2")
        elif self.kind in ("saved_model", "tflite"):
            _require("tensorflow", f"a {self.kind} artifact")
        else:
            _require("onnxruntime", ".onnx")

    def __call__(self, images) -> dict[str, np.ndarray]:
        """(B, H, W, 3) float32 [0,1] -> padded detections dict (an exported
        program without NMS: ``{"pred": (B, 4 + nc, A)}``)."""
        if self.kind == "run_dir":
            if not isinstance(images, torch.Tensor):
                images = torch.as_tensor(np.asarray(images))
            out = self._predictor._fwd(images)
            return {k: v.cpu().numpy() for k, v in out.items()}
        if not isinstance(images, torch.Tensor):
            images = torch.as_tensor(np.asarray(images, np.float32))
        x = images.to(self.device, torch.float32)
        with torch.no_grad(), dtype_products(self.dtype):
            out = self._fn(x)
        if isinstance(out, dict):
            return {k: v.cpu().numpy() for k, v in out.items()}
        return {"pred": out.float().cpu().numpy()}
