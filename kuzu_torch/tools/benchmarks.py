"""Benchmark harness: model / batch matrix timing (counterpart of
``kuzu/tools/benchmarks.py``).

The matrix spans model scales and batch sizes on the live device, each row
one call of the detector's forward, decode and NMS timed by
``kuzu_torch.tools.profiling.timed`` (CUDA events on the card), its TFLOP/s
from ``flops_of``'s count (products and convolutions, the ``kuzu_torch::``
operators by their formulas). ``format_table`` is a copy of JAX's.
"""

from __future__ import annotations

from pathlib import Path

import torch

from kuzu_torch.tools.profiling import timed


def benchmark_detectors(
    scales: tuple[str, ...] = ("yolov12n", "yolov12s"),
    batches: tuple[int, ...] = (1, 8),
    imgsz: int = 640,
    dtype: torch.dtype = torch.bfloat16,
    include_nms: bool = True,
    nc: int = 80,
    device: torch.device | str | None = None,
) -> list[dict]:
    """Per (model, batch): median ms, ms/img, TFLOP/s, as JAX's rows. A
    seeded detector on ``device`` (the card when None): the BN-folded
    executor in bf16 (the predictor's), the module tree in eval mode in
    f32."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    rows = []
    for scale in scales:
        det = YoloDetector(scale, nc=nc, imgsz=imgsz, device=device).init(0)
        forward = det.infer if dtype == torch.bfloat16 else det.graph.eval()
        n_params = det.param_count()
        for b in batches:
            imgs = torch.zeros((b, imgsz, imgsz, 3), dtype=torch.float32, device=det.device)

            def fwd(imgs):
                pred = det.decode(forward(imgs))
                if include_nms:
                    return det.select(pred, conf=0.25, iou=0.45, max_det=300)
                return pred

            t = timed(fwd, imgs, reps=5)
            rows.append(
                {
                    "model": scale,
                    "batch": b,
                    "params_m": round(n_params / 1e6, 2),
                    "median_ms": round(t["median_ms"], 2),
                    "ms_per_img": round(t["median_ms"] / b, 3),
                    "tflops": round(t["tflops"], 1),
                }
            )
    return rows


def benchmark_model(model, batches: tuple[int, ...] = (1, 8), **kwargs) -> dict:
    """``Model.benchmark()`` entry: times the facade's own architecture on
    its device. A trained-run directory resolves to its architecture via
    args.yaml."""
    spec = str(model.model_spec)
    run_args = Path(spec) / "args.yaml"
    if run_args.exists():
        from kuzu_torch.core.config import load_config

        spec = str(load_config(run_args).get("model") or "yolov12n")
    kwargs.setdefault("device", model.device)
    rows = benchmark_detectors(scales=(spec,), batches=tuple(batches), **kwargs)
    return {"rows": rows}


def format_table(rows: list[dict]) -> str:
    if not rows:
        return "(no results)"
    keys = list(rows[0])
    widths = {k: max(len(k), *(len(str(r[k])) for r in rows)) for k in keys}
    header = "  ".join(k.ljust(widths[k]) for k in keys)
    lines = [header, "-" * len(header)]
    for r in rows:
        lines.append("  ".join(str(r[k]).ljust(widths[k]) for k in keys))
    return "\n".join(lines)
