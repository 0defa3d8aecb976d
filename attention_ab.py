#!/usr/bin/env python3
"""Attention kernels, K2 and K6 of two checkouts on one card, in turns.

    python3 attention_ab.py OTHER_TREE [--out chiprun_out/attention_ab.json]

OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``). Each round runs one fresh process per
tree, in the order other, this, this, other, so that drift of the card over
the call shows up on both sides. Each process builds its tree's kernels, then
times at the shapes of ``chip_smoke.py``'s kernels line:

- K3 ``area_attention`` at G=32, N=400, C=64 / 2 heads (yolov12n node 6) and
  C=384 / 12 heads with q, k column slices (the training route);
- K4 at G=32, N=400, C=384, 12 heads: the ``AreaAttention`` pair (K3
  forward, then K4 backward, through autograd), ``area_attention_bwd``
  alone as both trees take it (q, k, v, dO), and, where the tree's
  ``area_attention_bwd`` takes the forward's ``lse`` (with its output), the
  training route's call with them; beside SDPA's forward + backward and
  backward;
- K2 ``fused_ablock`` at G=32 and G=8, na=400, C=384, 12 heads, hidden 576
  (yolov12x@640 b8 nodes 6 and 8), with its device time split by kernel;
- K5 ``flash_attention`` bf16 at BH=16, N=8192, D=64 and BH=384, N=400,
  D=32, and f32 at BH=16, N=2048, D=64;
- the f32 routes at the TrOCR's shapes: K3 f32 at G=1024, N=256, C=384, 6
  heads (the encoder over a bucket of 1024 crops), and at G=16 (a training
  step's batch) K3 f32 with its lse and K4 f32 given the forward's out and
  lse, with its device time split by kernel; beside SDPA in f32 (TF32 off);
- K6 ``fused_c3k2`` at the shapes of yolov12x@640 b8 nodes 2, 4 and 20
  (random weights of the block's shapes), with its device time split by
  kernel (its 1x1 convs share K2's GEMM);

each as ``ms`` (CUDA events around the Python call, what a caller sees) and
``device_ms`` (the call's own device time from torch.profiler), both from
``chip_smoke.py``, beside SDPA's forward on the same inputs. The card's name
and power limit are printed with the results.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """This tree's chip_smoke.py (timing helpers), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> dict:
    """Times the kernels of the checkout at ``tree`` (imported from there)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import importlib

    import torch

    smoke = _smoke()
    from kuzu_torch import _build

    fa = importlib.import_module("kuzu_torch.ops.flash_attention")
    from kuzu_torch.ops.fused_ablock import fused_ablock

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}

    def row(label, fn, lib=None):
        r = dict(ms=smoke.time_ms(fn), device_ms=smoke.device_ms(fn))
        if lib is not None:
            r.update(library_ms=smoke.time_ms(lib), library_device_ms=smoke.device_ms(lib))
        rows[label] = r

    for g, n, c, heads in ((32, 400, 64, 2), (32, 400, 384, 12)):
        qk, v = (torch.randn((g, n, w), generator=gen, device=dev).to(torch.bfloat16)
                 for w in (2 * c, c))
        q, k = qk[..., :c], qk[..., c:]
        sd = [t.reshape(g, n, heads, c // heads).transpose(1, 2).contiguous() for t in (q, k, v)]
        row(f"K3 G={g} N={n} C={c} h={heads}", lambda: fa.area_attention(q, k, v, heads),
            lambda: sdpa(*sd))

    # K4 at the training shape (the last K3 case's inputs)
    do = torch.randn((g, n, c), generator=gen, device=dev).to(torch.bfloat16)
    qk_a, v_a = qk.clone().requires_grad_(), v.clone().requires_grad_()
    sd_a = [t.detach().requires_grad_() for t in sd]
    sd_do = do.reshape(g, n, heads, c // heads).transpose(1, 2).contiguous()
    sd_out = sdpa(*sd_a)

    def pair():
        return torch.autograd.grad(fa.AreaAttention.apply(qk_a, v_a, heads), (qk_a, v_a), do)

    row(f"K4 AreaAttention forward + backward G={g} N={n} C={c} h={heads}", pair,
        lambda: torch.autograd.grad(sdpa(*sd_a), sd_a, sd_do))
    row(f"K4 area_attention_bwd(q, k, v, dO) G={g} N={n} C={c} h={heads}",
        lambda: fa.area_attention_bwd(q, k, v, do, heads),
        lambda: torch.autograd.grad(sd_out, sd_a, sd_do, retain_graph=True))
    if "lse" in inspect.signature(fa.area_attention_bwd).parameters:
        stats = fa.area_attention(q, k, v, heads, return_lse=True)
        row(f"K4 area_attention_bwd with the forward's out, lse G={g} N={n} C={c} h={heads}",
            lambda: fa.area_attention_bwd(q, k, v, do, heads, *stats),
            lambda: torch.autograd.grad(sd_out, sd_a, sd_do, retain_graph=True))

    na, c, heads, hid = 400, 384, 12, 576

    def w(cin, cout):
        return (torch.randn((cin, cout), generator=gen, device=dev) / cin ** 0.5).to(
            torch.bfloat16)

    def bias(cout):
        return 0.1 * torch.randn((1, cout), generator=gen, device=dev)

    for g in (32, 8):
        x, vv, pe = (torch.randn((g, na, c), generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(3))
        weights = [w(c, 2 * c), bias(2 * c), w(c, c), bias(c), w(c, hid), bias(hid), w(hid, c),
                   bias(c)]
        k2 = lambda: fused_ablock(x, vv, pe, weights, 1, heads)  # noqa: E731
        label = f"K2 G={g} na=400 C=384 h=12 hidden=576"
        row(label, k2)
        rows[label]["device_ms_by_kernel"] = {
            name[:60]: t for name, t in smoke.device_times(k2)[1].items()}

    for bh, n, d, dtype in ((16, 8192, 64, torch.bfloat16), (384, 400, 32, torch.bfloat16),
                            (16, 2048, 64, torch.float32)):
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        sd = [t[None] for t in (q, k, v)]
        row(f"K5 BH={bh} N={n} D={d} {str(dtype)[6:]}", lambda: fa.flash_attention(q, k, v),
            lambda: sdpa(*sd))

    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA's f32 yardstick in full f32
    g, n, c, heads = 1024, 256, 384, 6
    q, k, v = (torch.randn((g, n, c), generator=gen, device=dev) for _ in range(3))
    sd = [t.reshape(g, n, heads, c // heads).transpose(1, 2).contiguous() for t in (q, k, v)]
    row(f"K3 f32 G={g} N={n} C={c} h={heads}", lambda: fa.area_attention(q, k, v, heads),
        lambda: sdpa(*sd))
    g = 16
    q, k, v, do = (torch.randn((g, n, c), generator=gen, device=dev) for _ in range(4))
    out, lse, _ = fa.area_attention(q, k, v, heads, return_lse=True)
    row(f"K3 f32 with lse G={g} N={n} C={c} h={heads}",
        lambda: fa.area_attention(q, k, v, heads, return_lse=True))
    sd_a = [t.reshape(g, n, heads, c // heads).transpose(1, 2).contiguous().requires_grad_()
            for t in (q, k, v)]
    sd_do = do.reshape(g, n, heads, c // heads).transpose(1, 2).contiguous()
    sd_out = sdpa(*sd_a)
    k4 = lambda: fa.area_attention_bwd(q, k, v, do, heads, out, lse)  # noqa: E731
    label = f"K4 f32 with the forward's out, lse G={g} N={n} C={c} h={heads}"
    row(label, k4, lambda: torch.autograd.grad(sd_out, sd_a, sd_do, retain_graph=True))
    rows[label]["device_ms_by_kernel"] = {
        name[:60]: t for name, t in smoke.device_times(k4)[1].items()}

    from kuzu_torch.ops.fused_c3k2 import fused_c3k2

    for node, hw, cin, c, hid, c2 in ((2, 160, 192, 96, 48, 384), (4, 80, 384, 192, 96, 768),
                                      (20, 20, 1536, 384, 192, 768)):
        shapes = [(cin, 2 * c)]
        for _ in range(2):  # per C3k: cv1, four 3x3, cv2, cv3
            shapes += [(c, hid)] + [(9 * hid, hid)] * 4 + [(c, hid), (2 * hid, c)]
        shapes.append((4 * c, c2))
        weights = [t for ci, co in shapes for t in (w(ci, co), bias(co))]
        x = torch.randn((8, hw, hw, cin), generator=gen, device=dev).to(torch.bfloat16)
        k6 = lambda: fused_c3k2(x, weights)  # noqa: E731
        label = f"K6 node {node} x (8, {hw}, {hw}, {cin}) c={c} hid={hid} c2={c2}"
        row(label, k6)
        rows[label]["device_ms_by_kernel"] = {
            name[:60]: t for name, t in smoke.device_times(k6)[1].items()}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout")
    ap.add_argument("--out", default="chiprun_out/attention_ab.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)))
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("attention_ab: needs a CUDA device and another checkout", file=sys.stderr)
        return 1
    card = _smoke().card_line()
    runs = []
    for label, tree in (("other", args.other), ("this", str(HERE)), ("this", str(HERE)),
                        ("other", args.other)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree],
                             capture_output=True, text=True, timeout=900,
                             env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append((label, json.loads(lines[-1][7:])))
    print(f"card: {card}")
    summary = {}
    names = list(dict.fromkeys(name for _, r in runs for name in r))  # rows of either tree
    for name in names:
        summary[name] = {}
        for label in ("other", "this"):
            rs = [r[name] for lb, r in runs if lb == label and name in r]
            if not rs:
                continue
            summary[name][label] = {key: [r[key] for r in rs] for key in rs[0]
                                    if key != "device_ms_by_kernel"}
            summary[name][label]["device_ms_by_kernel"] = [r.get("device_ms_by_kernel")
                                                           for r in rs]
        sides = summary[name]
        lib = [t for side in sides.values() for t in side.get("library_device_ms", [])]
        print(f"{name}: " + "; ".join(
            f"{lb} device_ms {side['device_ms']} ms {side['ms']}" for lb, side in sides.items())
            + (f"; library device {statistics.median(lib):.4f}" if lib else ""))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "order": [lb for lb, _ in runs],
                                          "runs": [r for _, r in runs],
                                          "summary": summary}, indent=1))
    print(json.dumps({"card": card, "summary": {
        n: {lb: {"device_ms": s[lb]["device_ms"], "ms": s[lb]["ms"]} for lb in s}
        for n, s in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
