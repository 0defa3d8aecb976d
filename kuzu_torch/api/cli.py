"""kuzu_torch CLI: ``python -m kuzu_torch.api.cli <mode> <task> k=v ...``
(counterpart of ``kuzu/api/cli.py``).

Positional mode / task tokens plus ``k=v`` overrides with typed coercion, as
the reference's ``yolo`` entry point. ``device=`` picks the device (the card
by default; ``device=cpu`` for the CPU). The JAX CLI's
``force_cpu_if_requested`` and its XLA compilation cache have no torch
counterpart and are left out. ``track`` runs ``Model.track``, ``tune``
``Model.tune``, ``export`` ``Model.export`` (prints the ``.pt2`` path) and
``benchmark`` ``Model.benchmark`` at the config's ``imgsz`` and ``batch``
(prints its table).
"""

from __future__ import annotations

import sys

from kuzu_torch.api.model import Model
from kuzu_torch.core.config import load_config

MODES = ("train", "val", "predict", "track", "tune", "export", "benchmark")
TASKS = ("detect", "segment", "pose", "obb", "recognize", "classify", "lm", "ctc")

HELP = f"""kuzu CLI
usage: python -m kuzu_torch.api.cli <mode> [<task>] key=value ...
modes: {MODES}
tasks: {TASKS}
examples:
  python -m kuzu_torch.api.cli train classify data=glyphs/ epochs=10 imgsz=128
  python -m kuzu_torch.api.cli train detect model=yolov12n data=dataset.yaml
  python -m kuzu_torch.api.cli predict detect model=runs/detect/x/weights source=page.jpg
  python -m kuzu_torch.api.cli track detect model=runs/detect/x source=frames/ tracker=botsort
  python -m kuzu_torch.api.cli tune detect data=dataset.yaml iterations=10 epochs=3
  python -m kuzu_torch.api.cli export detect model=runs/detect/x nms=True batch=8
  python -m kuzu_torch.api.cli benchmark detect model=yolov12x imgsz=640 batch=8
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(HELP)
        return 0
    mode = argv.pop(0)
    if mode not in MODES:
        print(f"unknown mode '{mode}'\n{HELP}")
        return 2
    task = None
    if argv and "=" not in argv[0]:
        task = argv.pop(0)
        if task not in TASKS:
            # registry-registered extras are valid too
            from kuzu_torch.api.model import task_map

            if task not in task_map():
                print(f"unknown task '{task}'\n{HELP}")
                return 2
    cfg = load_config(overrides=argv)
    task = task or cfg.get("task", "detect")
    device = cfg.get("device")  # None: the card; "cpu", "cuda:1", or a card index
    model = Model(str(cfg.get("model") or task), task=task,
                  device=f"cuda:{device}" if isinstance(device, int) else device)
    overrides = {
        k: v for k, v in cfg.items() if k not in ("mode", "task", "device")
    }
    if mode == "train":
        result = model.train(**overrides)
    elif mode == "val":
        result = model.val(**overrides)
    elif mode == "predict":
        source = overrides.pop("source", None)
        result = model.predict(source, **overrides)
    elif mode == "track":
        source = overrides.pop("source", None)
        result = model.track(source, **overrides)
    elif mode == "tune":
        result = model.tune(**overrides)
    elif mode == "export":
        result = model.export(**overrides)
    else:
        from kuzu_torch.tools.benchmarks import format_table

        rows = model.benchmark(imgsz=int(cfg.get("imgsz", 640)),
                               batches=(int(cfg.get("batch", 1)),))["rows"]
        print(format_table(rows))
        return 0
    if isinstance(result, dict):
        print(
            " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in result.items()
            )
        )
    elif isinstance(result, list):
        for i, r in enumerate(result):
            if isinstance(r, str):  # recognize/lm: predicted text
                print(f"[{i}] {r}")
            elif isinstance(r, dict):  # classify: {name, conf, ...}
                print(
                    f"[{i}] "
                    + " ".join(
                        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in r.items()
                    )
                )
            else:
                boxes = getattr(r, "boxes", None)
                n = len(boxes) if boxes is not None else 0
                ids = getattr(boxes, "id", None) if boxes is not None else None
                tag = (
                    f" ids={ids.tolist()}"
                    if ids is not None and len(ids)
                    else ""
                )
                print(f"[{i}] {getattr(r, 'path', '')}: {n} boxes{tag}")
    elif result is not None:  # export: the .pt2 path
        print(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
