"""Detector wrapper: graph, BN-folded forward and anchor-free decode
(counterpart of ``kuzu/models/yolo/detector.py``).

``infer`` returns the per-level raw maps (B, H, W, 4*reg_max + nc) as NHWC
views (yolov10: ``{"one2one": maps}``; Segment, Pose, OBB: a dict with the
maps under ``det``); ``decode`` turns them into
the (B, 4 + nc, A) tensor that ``kuzu_torch.ops.nms.non_max_suppression``
consumes, or, for yolov10, ``nms_free_select`` (:meth:`YoloDetector.select`
picks by ``spec.end2end``).
"""

from __future__ import annotations

import torch

from kuzu_torch.bridge import from_flax
from kuzu_torch.models.yolo.graph import (
    GraphSpec,
    YoloGraph,
    parse_model_yaml,
    resolve_model_spec,
)
from kuzu_torch.models.yolo.infer import fold_graph, run_graph
from kuzu_torch.models.yolo.modules import dfl_expectation
from kuzu_torch.ops.anchors import dist2bbox, make_anchors
from kuzu_torch.ops.nms import nms_free_select, non_max_suppression


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the card; asking for CUDA where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class YoloDetector:
    """Spec + parameters + folded weights on one device."""

    def __init__(
        self,
        model: str | GraphSpec,
        nc: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        imgsz: int = 640,
        device: torch.device | str | None = None,
        reg_max: int | None = None,
        conv_impl: str = "native",
        stem_s2d: bool = False,
        stem_packed: bool = False,
    ):
        """``conv_impl`` is the module tree's (``YoloGraph``); ``stem_s2d``
        and ``stem_packed`` are the folded executor's stem rewrites
        (``infer.run_graph``). All three are math options, off by default:
        JAX's detector passes ``stem_s2d`` on a TPU only."""
        if dtype != torch.bfloat16:
            raise NotImplementedError("the folded executor runs in bf16 only")
        self.device = resolve_device(device)
        if isinstance(model, GraphSpec):
            self.spec = model
        else:
            self.spec = self.resolve_spec(str(model), nc=nc)
        if reg_max is not None:  # a run's override of the DFL range
            self.spec.reg_max = int(reg_max)
        self.graph = YoloGraph(self.spec, conv_impl=conv_impl)
        self.stem_s2d, self.stem_packed = stem_s2d, stem_packed
        self.dtype = dtype
        self.imgsz = imgsz
        self.strides = list(self.spec.strides)
        self.nc = self.spec.nc
        self.folded: dict | None = None

    # ------------------------------------- the detect task's construction hooks
    @staticmethod
    def resolve_spec(name: str, nc: int | None = None) -> GraphSpec:
        """The parsed spec of the model name ``name`` at ``nc`` classes."""
        path, scale = resolve_model_spec(name)
        return parse_model_yaml(path, scale=scale, nc=nc)

    @staticmethod
    def training_graph(spec: GraphSpec, dtype: torch.dtype, remat: bool = False) -> YoloGraph:
        """The module tree the trainer trains, in ``dtype``."""
        return YoloGraph(spec, dtype=dtype, remat=remat)

    @classmethod
    def for_validation(cls, spec: GraphSpec, dtype: torch.dtype, imgsz: int,
                       device: torch.device) -> "YoloDetector":
        """The trainer's validation detector: the BN-folded executor (bf16,
        whatever the training dtype)."""
        return cls(spec, imgsz=imgsz, device=device)

    # ------------------------------------------------------------ lifecycle
    def init(self, seed: int = 0) -> "YoloDetector":
        """Seeded random weights (drawn on the CPU, so every device gets the
        same ones), then fold."""
        self.graph.reset_parameters(torch.Generator().manual_seed(seed))
        return self._load()

    def load_flax(self, variables: dict) -> "YoloDetector":
        """Weights from a flax ``{params, batch_stats}`` tree of numpy arrays."""
        self.graph.to("cpu")
        from_flax(self.graph, variables)
        return self._load()

    def load_state_dict(self, state_dict: dict[str, torch.Tensor]) -> "YoloDetector":
        """Weights from a ``YoloGraph`` state dict (parameters and BatchNorm
        statistics, e.g. a trainer's EMA with the live statistics), then
        fold."""
        self.graph.load_state_dict(state_dict)
        return self._load()

    def _load(self) -> "YoloDetector":
        self.graph.to(self.device)
        self.folded = fold_graph(self.graph)
        return self

    def infer(self, images: torch.Tensor) -> list[torch.Tensor] | dict:
        """BN-folded forward of (B, H, W, 3) images on the detector's device."""
        if self.folded is None:
            raise RuntimeError("call init() or load_flax() first")
        return run_graph(self.spec, self.folded, images.to(self.device),
                         stem_s2d=self.stem_s2d, stem_packed=self.stem_packed)

    # ------------------------------------------------------------- helpers
    def feat_shapes(self, imgsz: int) -> list[tuple[int, int]]:
        return [(imgsz // s, imgsz // s) for s in self.strides]

    def anchors(self, imgsz: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(anchor_points (A, 2) grid units, strides (A, 1))."""
        return make_anchors(self.feat_shapes(imgsz), self.strides, device=self.device)

    def flatten_feats(self, feats: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-level NHWC maps -> (box_dist (B, A, 4*reg_max), cls (B, A, nc))."""
        cat = torch.cat([f.reshape(f.shape[0], -1, f.shape[-1]) for f in feats], dim=1)
        rm = self.spec.reg_max
        return cat[..., : 4 * rm], cat[..., 4 * rm:]

    @torch.no_grad()
    def decode(self, feats: list[torch.Tensor] | dict) -> torch.Tensor:
        """Raw maps -> (B, 4 + nc, A): xywh pixel boxes + sigmoid scores; of
        yolov10's heads the one2one maps, as inference uses them; of a
        Segment, Pose or OBB output its ``det`` maps.

        DFL runs in the maps' dtype (bf16) and is promoted to f32 at
        ``dist2bbox``; the class sigmoid runs in f32."""
        if isinstance(feats, dict):  # yolov10's one2one; Segment / Pose / OBB's det
            feats = feats["one2one"] if "one2one" in feats else feats["det"]
        box_dist, cls = self.flatten_feats(feats)
        shapes = [(f.shape[1], f.shape[2]) for f in feats]
        anchor_points, stride_t = make_anchors(shapes, self.strides, device=box_dist.device)
        dist = dfl_expectation(box_dist, self.spec.reg_max)
        boxes = dist2bbox(dist, anchor_points[None], xywh=True) * stride_t[None]
        pred = torch.cat([boxes, torch.sigmoid(cls.float())], dim=-1)
        return pred.transpose(1, 2)

    def select(self, pred: torch.Tensor, conf: float, iou: float, max_det: int,
               multi_label: bool = False,
               return_indices: bool = False) -> dict[str, torch.Tensor]:
        """Padded detections of a decoded (B, 4 + nc, A) tensor, as the JAX
        predictor and validator choose: yolov10's one2one head by NMS-free
        top-k (``iou`` and ``multi_label`` unused), every other head by NMS
        on the K1 kernel."""
        if self.spec.end2end:
            return nms_free_select(pred, conf_thres=conf, max_det=max_det)
        return non_max_suppression(pred, conf_thres=conf, iou_thres=iou, max_det=max_det,
                                   multi_label=multi_label, return_indices=return_indices)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.graph.parameters())
