#!/usr/bin/env python3
"""The exported detector against the eager one on one card, call by call.

    python3 export_ab.py [--rounds 20] [--out build/export_ab.json]

Builds ``chip_smoke.py``'s TRACK run dir (yolov12x@640, nc 1, seeded,
BatchNorm calibrated, box head set) in a temporary directory, exports it
through ``Model.export`` (NMS in, batch 8) and times, on its 8 frames as
f32 in [0, 1], five ways of running the same detections:

- ``eager``: ``DetectPredictor._fwd`` (the folded executor, decode, NMS);
- ``program``: the ``DetectorProgram`` module that is exported, run eagerly;
- ``exported``: ``torch.export.export``'s program, its ``module()``, before
  it is saved;
- ``loaded``: the ``.pt2`` loaded back (what ``AutoBackend`` runs);
- ``loaded_no_asserts``: the same with its ``aten._assert_tensor_metadata``
  nodes taken out.

Rounds run the five in turn in one process, each call timed on the host
clock twice: until it returns (the host's launch time; the outputs stay on
the card) and until ``torch.cuda.synchronize()`` after it (the call's
wall time). Then the host's time a call of four operators the exported
graph calls most, on small tensors on the card, through the operator
object the graph holds (``torch.ops.aten.conv2d.default``, ...) and through
the Python function eager code calls (``F.conv2d``, ...): the lesser of two
runs of 2000 calls each. It prints the medians, each variant's detections
against ``eager``'s (entries differing), the card's name and power limit,
and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _smoke():
    """This tree's chip_smoke.py (its run dir and frames), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--out", default="build/export_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("export_ab: no CUDA device", flush=True)
        return 1
    smoke = _smoke()
    from kuzu_torch import _build
    from kuzu_torch.api.export import DetectorProgram
    from kuzu_torch.api.model import Model
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectPredictor

    _build.build_all()
    dev = torch.device("cuda")
    name, sz, b = smoke.TRACK
    frames = smoke.track_frames()
    imgs = torch.from_numpy(np.stack(frames)).to(dev).float() / 255.0
    kw = dict(conf=smoke.CONF, iou=0.7, max_det=smoke.TRACK_MAX_DET)
    with tempfile.TemporaryDirectory() as tmp:
        run = smoke.track_run_dir(dev, Path(tmp), frames)
        blob = Model(str(run), device=dev).export(nms=True, batch=b, **kw)
        pred = DetectPredictor(load_config(overrides={"model": str(run), **kw}), device=dev)
        pred._setup()
        program = DetectorProgram(pred.detector, True, dtype=torch.bfloat16, **kw)
        with torch.no_grad():
            exported = torch.export.export(program, (imgs,), strict=False).module()
        loaded = torch.export.load(blob).module()
        stripped = torch.export.load(blob).module()
        for node in list(stripped.graph.nodes):
            if node.op == "call_function" and "_assert_tensor_metadata" in str(node.target):
                stripped.graph.erase_node(node)
        stripped.recompile()
    variants = {"eager": pred._fwd, "program": program, "exported": exported,
                "loaded": loaded, "loaded_no_asserts": stripped}
    host = {k: [] for k in variants}
    wall = {k: [] for k in variants}
    with torch.no_grad():
        ref = variants["eager"](imgs)
        differing = {k: {key: int((fn(imgs)[key] != ref[key]).sum()) for key in ref}
                     for k, fn in variants.items()}
        for fn in variants.values():  # warm-up
            fn(imgs)
        torch.cuda.synchronize()
        for _ in range(args.rounds):
            for k, fn in variants.items():
                t0 = time.perf_counter()
                fn(imgs)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                host[k].append((t1 - t0) * 1e3)
                wall[k].append((t2 - t0) * 1e3)
    op_us = op_call_us(dev)
    for k, (graph_us, eager_us) in op_us.items():
        print(f"{k}: host {graph_us:.2f} us a call as the graph calls it, {eager_us:.2f} us "
              f"as eager code does")
    card = smoke.card_line()
    res = {k: dict(host_ms=statistics.median(host[k]), wall_ms=statistics.median(wall[k]),
                   wall_ms_per_img=statistics.median(wall[k]) / b, differing=differing[k])
           for k in variants}
    for k, r in res.items():
        print(f"{k}: host {r['host_ms']:.3f} ms, wall {r['wall_ms']:.3f} ms a batch of {b} "
              f"({r['wall_ms_per_img']:.4f} ms/img; medians of {args.rounds} calls), entries "
              f"differing from eager {r['differing']}")
    print(card)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"variants": res, "op_call_us": op_us,
                                          "rounds": args.rounds,
                                          "model": f"{name}@{sz} b{b}", "card": card}, indent=1))
    return 0


def op_call_us(dev) -> dict:
    """{operator: (host us a call through the graph's operator object,
    through the Python function)} on small bf16 tensors on ``dev``."""
    import torch.nn.functional as F

    aten = torch.ops.aten
    x = torch.randn((8, 64, 20, 20), device=dev).to(torch.bfloat16)
    w = torch.randn((64, 64, 1, 1), device=dev).to(torch.bfloat16)
    b = torch.randn((64,), device=dev)
    pairs = {
        "conv2d": (lambda: aten.conv2d.default(x, w, None, [1, 1], [0, 0], [1, 1], 1),
                   lambda: F.conv2d(x, w, None, 1, 0, 1, 1)),
        "add": (lambda: aten.add.Tensor(x, x), lambda: x + x),
        "to": (lambda: aten.to.dtype(b, torch.bfloat16), lambda: b.to(torch.bfloat16)),
        "_assert_tensor_metadata": (
            lambda: aten._assert_tensor_metadata.default(b, dtype=torch.float32, device=dev,
                                                         layout=torch.strided),
            lambda: None),
    }

    def us(fn, n: int = 2000) -> float:
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return best

    return {k: (us(g), us(e)) for k, (g, e) in pairs.items()}


if __name__ == "__main__":
    raise SystemExit(main())
