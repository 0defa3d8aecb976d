#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure:

1. device line (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. build of every kernel in ``kuzu_torch/csrc`` (one nvcc per source, in
   parallel), with the build seconds and ptxas' register / spill lines;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: error against a stated tolerance, and CUDA-event times of
   the kernel, the plain version and, where one exists, one PyTorch call
   computing the same function (a yardstick the port never calls);
4. slice check: yolov12n@640, batch 2, seeded weights, infer -> decode ->
   NMS on the card (kernels) and on the CPU (plain versions), compared
   under the CPU tests' rules; the kernels' launch counts are checked;
5. full width: yolov12x@640, batch 8, bf16, conf 0.001, launch counts,
   finite outputs and the end-to-end time per image;
6. the ``kernels`` JSON line, then the card's name and power limit;
7. last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is unavailable.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM at 700 W (NVIDIA data sheet, dense).
PEAK_BYTES = 3.35e12       # HBM bytes/s
PEAK_BF16 = 989e12         # tensor-core bf16 FLOP/s
PEAK_F32 = 67e12           # f32 FLOP/s outside the tensor cores
CONF = 0.001               # random-init scores are ~sigmoid(-4.6) ~ 0.01


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 3


def nms_inputs(dev, b: int = 8, k: int = 2048, seed: int = 0):
    """Score-sorted boxes with class offsets: random boxes plus dense
    clusters, some invalid, scores rounded so that many tie."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (b, k, 2))
    wh = rng.uniform(4, 120, (b, k, 2))
    cl = rng.random((b, k)) < 0.4  # 40% of boxes around 12 cluster centres
    centres = rng.uniform(50, 550, (b, 12, 2))
    pick = rng.integers(0, 12, (b, k))
    xy[cl] = np.take_along_axis(centres, pick[..., None], 1)[cl] + rng.normal(0, 3, (cl.sum(), 2))
    wh[cl] = 40 + rng.normal(0, 2, (cl.sum(), 2))
    scores = np.round(rng.uniform(0, 1, (b, k)) * 32) / 32
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    classes = rng.integers(0, 4, (b, k))
    boxes += (classes * 7680.0)[..., None].astype(np.float32)
    valid = rng.random((b, k)) > 0.1
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))


def kernel_phase(dev) -> dict:
    from kuzu_torch.ops.flash_attention import area_attention, area_attention_plain
    from kuzu_torch.ops.fused_ablock import fused_ablock, fused_ablock_plain
    from kuzu_torch.ops.nms_kernel import batched_suppress, suppress_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain references run with allow_tf32=False for matmul and cuDNN "
          "(full f32 products)")
    res = {}

    # K1: greedy NMS, B=8, K=2048
    boxes, valid = nms_inputs(dev)
    thr = 0.45
    keep = batched_suppress(boxes, valid, thr)
    ref = suppress_reference(boxes, valid, thr)
    keep_cpu = suppress_reference(boxes.cpu(), valid.cpu(), thr)
    torch.cuda.synchronize()
    mism = int((keep != ref).sum()) + int((keep.cpu() != keep_cpu).sum())
    print(f"K1 nms B=8 K=2048: kept {int(keep.sum())}, keep mismatches {mism} (must be 0)")
    require(mism == 0, "K1 keeps identical to the plain recurrence")
    nv = valid.sum(1).double()
    pairs = float((nv * (nv - 1) / 2).sum())
    bnd, by = bound(boxes.numel() * 4 + 2 * valid.numel(), 14 * pairs, PEAK_F32)
    res["nms"] = dict(
        max_abs_err=float(mism),
        ms=time_ms(lambda: batched_suppress(boxes, valid, thr)),
        plain_ms=time_ms(lambda: suppress_reference(boxes, valid, thr), reps=3, warmup=1),
        bound_ms=bnd, bound_by=by, library_ms=None)

    # K3: area attention, G=32, N=400, C=64, 2 heads
    g, n, c, heads = 32, 400, 64, 2
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((g, n, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = area_attention(q, k, v, heads)
    refo = area_attention_plain(q, k, v, heads, (c // heads) ** -0.5)
    err = (out.float() - refo.float()).abs()
    tol = 1e-2 + 1e-2 * refo.float().abs()  # one bf16 rounding (2^-8 relative) apart
    print(f"K3 area_attention G=32 N=400 C=64 h=2: max_abs_err {float(err.max()):.3e}, "
          f"over tolerance (1e-2 + 1e-2|ref|): {int((err > tol).sum())}")
    require(bool((err <= tol).all()), "K3 within tolerance")
    hd = c // heads
    sd = [t.reshape(g, n, heads, hd).transpose(1, 2).contiguous() for t in (q, k, v)]
    bnd, by = bound(4 * g * n * c * 2, 4 * g * n * n * c, PEAK_BF16)
    res["area_attention"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: area_attention(q, k, v, heads)),
        plain_ms=time_ms(lambda: area_attention_plain(q, k, v, heads, hd ** -0.5)),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*sd)))

    # K2: fused ABlock, G=32 chunks of na=400, C=384, 12 heads, hidden 576
    g, na, c, heads, hid = 32, 400, 384, 12, 576
    x, vv, pe = (torch.randn((g, na, c), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(3))

    def w(cin, cout):
        return (torch.randn((cin, cout), generator=gen, device=dev) / cin ** 0.5).to(
            torch.bfloat16)

    def bias(cout):
        return 0.1 * torch.randn((1, cout), generator=gen, device=dev)

    weights = [w(c, 2 * c), bias(2 * c), w(c, c), bias(c), w(c, hid), bias(hid),
               w(hid, c), bias(c)]
    out = fused_ablock(x, vv, pe, weights, 1, heads)
    refo = fused_ablock_plain(x, vv, pe, weights, 1, heads)
    err = (out.float() - refo.float()).abs()
    tol = 0.08 + 0.02 * refo.float().abs()
    close = float((err <= 0.02 + 0.01 * refo.float().abs()).float().mean())
    print(f"K2 fused_ablock G=32 na=400 C=384 h=12 hidden=576: max_abs_err "
          f"{float(err.max()):.3e}, over tolerance (0.08 + 0.02|ref|): "
          f"{int((err > tol).sum())}, share within 0.02 + 0.01|ref|: {close:.5f} (> 0.999)")
    require(bool((err <= tol).all()) and close > 0.999, "K2 within tolerance")
    m = g * na
    flops = 2 * m * c * (2 * c + c + 2 * hid) + 4 * g * na * na * c
    nbytes = 4 * m * c * 2 + sum(t.numel() * t.element_size() for t in weights)
    bnd, by = bound(nbytes, flops, PEAK_BF16)
    res["fused_ablock"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: fused_ablock(x, vv, pe, weights, 1, heads)),
        plain_ms=time_ms(lambda: fused_ablock_plain(x, vv, pe, weights, 1, heads)),
        bound_ms=bnd, bound_by=by, library_ms=None)
    for name, r in res.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return res


# ------------------------------------------------------------- phases 4, 5

COUNTERS = ("nms", "area_attention", "fused_ablock")


def counters():
    from kuzu_torch.ops.flash_attention import area_attention
    from kuzu_torch.ops.fused_ablock import fused_ablock
    from kuzu_torch.ops.nms_kernel import batched_suppress

    return dict(zip(COUNTERS, (batched_suppress, area_attention, fused_ablock)))


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        fn.plain_calls = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def pipeline(det, imgs):
    from kuzu_torch.ops.nms import non_max_suppression

    maps = det.infer(imgs)
    pred = det.decode(maps)
    return maps, pred, non_max_suppression(pred, conf_thres=CONF)


def slice_check(dev, launches: dict) -> None:
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.ops.nms import non_max_suppression
    from kuzu_torch.testing import detections_match, maps_agreement, maps_match

    imgs = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 640, 640, 3), dtype=np.uint8))
    gpu = YoloDetector("yolov12n", nc=80, imgsz=640, device=dev).init(0)
    cpu = YoloDetector("yolov12n", nc=80, imgsz=640, device="cpu").init(0)
    zero_counts()
    gmaps, gpred, gdets = pipeline(gpu, imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    t0 = time.perf_counter()
    cmaps, cpred, cdets = pipeline(cpu, imgs)
    print(f"yolov12n@640 b2 launches on the card: {counts} (want nms 1, "
          f"area_attention 4, fused_ablock 4); CPU run {time.perf_counter() - t0:.1f} s")
    require(counts == {"nms": 1, "area_attention": 4, "fused_ablock": 4},
            "yolov12n launch counts")
    for name, n in counts.items():
        launches[name] += n
    for lvl, (cm, gm) in enumerate(zip(cmaps, gmaps)):
        rel, share = maps_agreement(cm, gm)
        print(f"  level {lvl} {tuple(gm.shape)}: max rel err {rel:.4f} (< 0.05), "
              f"share close {share:.5f} (> 0.999)")
        require(maps_match(cm, gm), f"card vs CPU raw maps, level {lvl}")
    dbox = float((gpred[:, :4].cpu() - cpred[:, :4]).abs().max())
    dscore = float((gpred[:, 4:].cpu() - cpred[:, 4:]).abs().max())
    print(f"  decode: max box diff {dbox:.4f} px (<= 2), max score diff {dscore:.2e} (<= 2e-4)")
    require(dbox <= 2.0 and dscore <= 2e-4, "card vs CPU decode")
    same = non_max_suppression(cpred.to(dev), conf_thres=CONF)
    for key in cdets:
        require(torch.equal(same[key].cpu(), cdets[key]), f"NMS on one tensor: {key}")
    print("  NMS of the CPU-decoded tensor on the card: identical to the CPU")
    nc, ng = cdets["valid"].sum(1), gdets["valid"].sum(1)
    m1, m2 = detections_match(cdets, gdets), detections_match(gdets, cdets)
    print(f"  detections: valid {nc.tolist()} CPU vs {ng.tolist()} card, matched "
          f"{m1:.4f} / {m2:.4f} (>= 0.9, same class, IoU >= 0.5)")
    require(bool(((nc - ng.cpu()).abs() <= 0.1 * nc).all()) and m1 >= 0.9 and m2 >= 0.9,
            "card vs CPU detections")


def full_width(dev, launches: dict) -> dict:
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector("yolov12x", nc=80, imgsz=640, device=dev).init(0)
    imgs = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (8, 640, 640, 3), dtype=np.uint8)).to(dev)
    pipeline(det, imgs)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    zero_counts()
    maps, pred, dets = pipeline(det, imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"yolov12x@640 b8 launches: {counts} (want nms 1, area_attention 0, "
          f"fused_ablock 16)")
    require(counts == {"nms": 1, "area_attention": 0, "fused_ablock": 16},
            "yolov12x launch counts")
    for name, n in counts.items():
        launches[name] += n
    require(all(bool(torch.isfinite(m).all()) for m in maps), "finite maps")
    require(bool(torch.isfinite(pred).all()), "finite decode")
    nvalid = dets["valid"].sum(1).tolist()
    require(min(nvalid) > 0, "every image has detections")
    print(f"  maps {[tuple(m.shape) for m in maps]}, pred {tuple(pred.shape)}, "
          f"valid per image {nvalid}, params {det.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    e2e = time_ms(lambda: pipeline(det, imgs), reps=10, warmup=2)
    infer = time_ms(lambda: det.infer(imgs), reps=10, warmup=1)
    decode = time_ms(lambda: det.decode(maps), reps=10, warmup=1)
    from kuzu_torch.ops.nms import non_max_suppression

    nms = time_ms(lambda: non_max_suppression(pred, conf_thres=CONF), reps=10, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = dict(e2e_ms=e2e, ms_per_img=e2e / 8, infer_ms=infer, decode_ms=decode,
             nms_ms=nms, peak_gib=peak)
    print(f"  end to end {e2e:.3f} ms/batch = {e2e / 8:.4f} ms/img (infer {infer:.3f}, "
          f"decode {decode:.3f}, nms {nms:.3f} ms/batch), peak memory {peak:.2f} GiB")
    r["breakdown"] = device_breakdown(lambda: pipeline(det, imgs))
    return r


def device_breakdown(fn) -> dict:
    """Kernel time of one call by group (torch.profiler, CUDA activity) and the
    device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        name = evt.key
        kernels.append((us / 1e3, evt.count, name[:70]))
        if "qk_gemm_kernel" in name or "mlp_kernel" in name:
            group = "K2 fused_ablock: qk GEMM, projection + MLP"
        elif "attention_kernel" in name:  # K2's attention; K3 launches the same kernel
            group = "attention_kernel (K2, K3)"
        elif "nms_" in name:
            group = "K1 nms"
        elif any(s in name.lower() for s in ("conv", "xmma", "implicit", "cudnn", "gemm")):
            group = "convolutions (cuDNN)"
        else:
            group = "other (elementwise, copies, sort)"
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    out = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms,
               groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))
    print(f"  profile of one call: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms, "
          f"device idle share {out['idle_share']:.3f}")
    for group, ms in out["groups_ms"].items():
        print(f"    {group}: {ms:.3f} ms")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        print(f"    top kernel {ms:.3f} ms x{count}: {name}")
    return out


# ------------------------------------------------------------------- main

KERNELS = {
    "nms": ("kuzu_torch/csrc/nms.cu", "kuzu/ops/pallas_nms.py:314"),
    "area_attention": ("kuzu_torch/csrc/area_attention.cu", "kuzu/ops/flash_attention.py:148"),
    "fused_ablock": ("kuzu_torch/csrc/fused_ablock.cu", "kuzu/ops/fused_ablock.py:117"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from kuzu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    _check_smem_formulas()

    res = kernel_phase(dev)
    launches = dict.fromkeys(COUNTERS, 0)
    slice_check(dev, launches)
    e2e = full_width(dev, launches)

    kernels = [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], **res[name])
        for name in COUNTERS
    ]
    print(json.dumps({"e2e_yolov12x_640_b8": e2e, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _check_smem_formulas() -> None:
    """The Python gates' shared-memory sizes equal the kernels' own."""
    import ctypes

    from kuzu_torch import _build
    from kuzu_torch.ops.flash_attention import attn_smem_bytes
    from kuzu_torch.ops.fused_ablock import ablock_smem_bytes

    fa = _build.library("area_attention").kuzu_area_attention_smem
    fb = _build.library("fused_ablock").kuzu_fused_ablock_smem
    fa.restype = fb.restype = ctypes.c_size_t
    fa.argtypes = [ctypes.c_int] * 2
    fb.argtypes = [ctypes.c_int] * 4
    for n, hd in ((400, 32), (16, 32), (256, 64)):
        require(fa(n, hd) == attn_smem_bytes(n, hd), f"attention smem n={n} hd={hd}")
    for na, c, h, hid in ((400, 384, 12, 576), (400, 128, 4, 256), (16, 128, 4, 256)):
        require(fb(na, c, h, hid) == ablock_smem_bytes(na, c, h, hid), f"ablock smem {na}")


if __name__ == "__main__":
    sys.exit(main())
