#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py 10   # the build and phase 10 alone, no result line
                               # (likewise 5, 16, 17, 18, 19 and 20)

The second form times the training step of one checkout on its own, so
that two commits can be compared in one call on one card.

Phases, each raising on failure:

1. device line (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. build of every kernel in ``kuzu_torch/csrc`` (one nvcc per source, in
   parallel), with the build seconds and ptxas' register / spill lines;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (K1's keeps at B=8, K=2048 and on the cases that hold its
   chunked sweep: a ragged K at B=1, a suppression chain across the 64-box
   chunks, all boxes disjoint, one dense cluster, K = 128 and K = 65, with
   its two launches' device times; K3 at C=64 and at the training shape C=384, each with
   planted faults that its tolerance must reject; K4 at G=32, N=400,
   C=384 in both call forms, with planted faults, a determinism check,
   every head width at N = 16, 80 and 400 and N=1024, and the
   AreaAttention pair's gradients against autograd through the plain
   forward; K3's f32 route (3xTF32) at the TrOCR encoder's shape G=1024,
   N=256, C=384, 6 heads with planted faults (plain TF32 among them), and at
   every head width at N = 16, 256 and 400, with SDPA in f32 (TF32 off)
   beside it; K3's f32 training route (output and lse) and K4's f32 route at
   the TrOCR training shape G=16, N=256, C=384, 6 heads with planted faults
   (plain TF32 among them) and a determinism check,
   at every head width at N = 16 and 256 and at G=12000 (72,000 heads x
   groups), with SDPA's f32 backward beside it; K3 + K4 bf16 at the TrOCR
   training shape on separate q/k/v and ``area_attention_trainable``'s
   gradients in both dtypes; K2 at G=32 and G=8
   with planted faults in its epilogues, each
   launch's device time and torch.matmul on its four GEMM shapes beside
   them): error against a stated tolerance, and times of the
   kernel, the plain version and, where one exists, one PyTorch call
   computing the same function (a yardstick the port never calls): ``ms``,
   CUDA events around the call (what a caller sees, the wrapper's host time
   included), and ``device_ms``, the call's own device time from a
   torch.profiler trace (:func:`device_times`);
4. inference slice check: yolov12n@640, batch 2, seeded weights, infer ->
   decode -> NMS on the card (kernels) and on the CPU (plain versions),
   compared under the CPU tests' rules; the kernels' launch counts are
   checked;
5. inference at full width: yolov12x@640, batch 8, bf16, conf 0.001,
   launch counts, finite outputs and the end-to-end time per image;
6. the fused C3k2 (K6) at the phase-5 detector, before the training phases
   so that their peak memory counts training alone: the NHWC inputs of
   nodes 2, 4 and 20 captured from one forward, the kernel against its
   plain version and both against the executor's node output, with the
   kernel's, the plain version's and the executor's times, each node's
   bound, the conv launches per call (14) and their device time per launch
   by kind (1x1, merged 1x1, 3x3); then the same nodes with random
   BatchNorm statistics and x ~ N(0, 1), kernel against plain;
7. flash attention (K5) through its entry points: the kernel against its
   plain version at BH=16, N=8192, D=64 bf16 (``flash_attention_auto``'s
   crossover), BH=384, N=400, D=32 bf16 (yolov12x node 6's area attention
   with the heads folded, the short regime), BH=16, N=2048, D=64 f32,
   logits scaled by 30 in both dtypes, and every head width it is built
   for at N=256 and 400 in both dtypes; planted faults against the bf16
   tolerance at the crossover; ``flash_attention_auto`` launches K5 once
   at N=8192 and never at N=4096; times beside SDPA's forward (before the
   training phases: after them the profiler's sessions come back empty);
8. the page -> text cascade (``KuzushijiPipeline.process_pages``, ship-once
   tiled path, CTC recognizer): (a) card against CPU at a small size with
   the same seeded weights and pages (columns matched both ways, texts of
   matched columns, crops within one level, CRNN logits on identical
   crops); (b) the production configuration: 16 pages of 1280, yolov12s
   columns at 1280 (reg_max 32), yolov12-p2x characters on 2 x 2 tiles of
   640, the CRNN on [1024, 64] crops with 4,788 classes, conf 0.001 and
   column max_det 32 (random weights): K1 and K2 launches per call, the
   counts per page, every K1 and K2 call of one ``process_pages`` held
   against its plain version on the inputs the path gave it (K1 at B=16
   K=2048, B=64 K=2048 and B=16 K=16384 on every image; K2 at G=256 and
   G=64), with each shape's times and bound, pages/s (CUDA events, median
   of 6 after 2 warm-up), peak memory, and one profiled call: each stage's
   host time and the device time of the kernels it launched (the
   pipeline's ``cascade/<stage>`` ranges), the idle share; (c, run before
   b) K1 at the cross-tile shape B=16, K=16384 on synthetic boxes against
   the plain recurrence on every image, with its times and bound; (d, run
   after a) a TrOCR at production widths, 2 + 2 layers, on [256, 64] crops,
   card (encoder through K3's f32 route) against CPU: memory, logits,
   greedy tokens; (e, after b, on b's pipeline and pages) the TrOCR
   recognizer at its defaults (encoder 384 / 6 / 6, decoder 256 / 4 / 8,
   max_len 128, [1024, 64] crops, 4,788 classes) greedy over every crop:
   launches (K3 f32 6 a call), no plain call, every K3 f32 call held
   against its plain version on the path's inputs, pages/s, peak memory,
   the stages of one profiled call, the recognizer's encode and decode
   times and steps; (f) ``decode="beam"`` and ``"beam_lm"`` (a CharMLM
   256 / 6 / 8 reranking the 4-best and annotating) over the first two
   pages, and the LM annotation's time;
11. (after 8) the recognizer family's training: (a) K3's bf16 inference
   route at every head width after K5's launches of the same kernel
   instantiations (each library keeps its own shared-memory attribute);
   (b) one ``RecognizeTrainer``
   step at the production widths cut to 2 + 2 layers on [256, 64] crops,
   card (K3 + K4) against CPU (their plain versions) in f32 (loss, CTC
   term, gradients, the weights after AdamW) and bf16 (the loss against
   the CPU's own bf16-vs-f32 difference); (c) ``LMTrainer`` at the
   production LM widths (CharMLM 256 / 6 / 8, 4,788 classes, batch 64,
   bf16) over a seeded corpus, then ``RecognizeTrainer`` at the production
   recognizer widths (batch 16, bf16, ``decoder_init`` that LM run,
   ``ctc_weight`` 0.3, ``ss_prob`` 0.25, augment on) for 11 steps and one
   validation batch (6 K3 + 6 K4 launches a step, no plain call; ms/step,
   a profiled step, peak memory), then two steps in f32 (6 K3 f32 + 6 K4
   f32); (d) the cascade from the two run dirs against the same weights
   in memory;
12. (inside 11's temporary root) the CTC recognizer's training and the
   training engine's parts: (a) one ``CTCTrainer`` step at the production
   widths (CRNN 64 / 128 / 256 / 256, hidden 256, 4,788 classes, [1024, 64]
   crops, box head, batch 2) card against CPU in f32 with the same jitter
   draws, under adamw and under radam (loss, box term, gradient norm within
   ``REC_STEP_TOL``, the gradient and update cosines, the weights after the
   update); (b) the production CTC run (``CTC_RUN``: bf16, batch 16, adamw
   lr0 3e-4, warmup 1 epoch) for 2 epochs of 8 steps on seeded crops, with
   validation and the run dir: ms/step, a profiled step's device time and
   idle share, peak memory, CER; (c) the cascade with ``recognizer=<b's run
   dir>`` over 8b's 16 pages and detectors against the same cascade over
   b's EMA weights in memory (columns, characters and texts equal; K1 3 +
   K2 16 launches a call; pages/s); (d) ``lora_rank=8`` fine-tuning 11c's
   bf16 recognize run (``pretrained=``) for 2 steps: base bit-equal,
   adapters moved, K3 + K4 bf16 launches, the LoRA run dir decodes as the
   merge in memory; (e) ``DetectValidator`` over a yolov12n@320 run dir
   against the trainer's own validation;
9. training slice check: one train step of yolov12n@128, batch 2, bf16, on
   the card and on the CPU: loss (the bf16 bound read from the CPU's bf16
   loss against its f32 loss), gradients, BatchNorm statistics and the
   launch counts (8 K3 + 8 K4); then the same step on the card with
   ``remat=True`` against it: loss, gradients, equal BatchNorm statistics,
   16 K3 launches (the recomputed forward) + 8 K4, peak memory of both;
10. training at full width: ``DetectTrainer(cfg).train()`` for
   yolov12-p2x@640, batch 8, bf16 over synthetic pages: 16 K3 + 16 K4
   launches per step, validation through K2/K1, finite losses, EMA and
   BatchNorm statistics moved, ``last`` restores; ms/step, images/s, peak
   memory and a profiled step's breakdown; then three steps of the same
   model with and without ``remat``: ms/step, peak memory, launch counts;
13. (after 8, on 8b's seeded weights) serving from image files: (a) the
   image layer (``kuzu_torch/data/image_io.py``: cv2's INTER_LINEAR and
   INTER_AREA, PIL's BILINEAR, cv2's RGB2YCrCb, in torch integers) on the
   card against the CPU, byte for byte, at the path's shapes (a 3868 x 2422
   and a 3508 x 2480 page to the 1280 letterbox, column windows to [1024,
   64] and to 640), with a planted fault (the vertical fraction clamped)
   that must differ, and the letterbox's device time; (b) the yolov12s@1280
   column predictor over 8 PNG pages of 3868 x 2422 (one Paeth-filtered)
   through ``DetectPredictor.__call__`` from a directory, a glob and the
   decoded arrays (equal ``Results``, K1 once a group), frames/s, the PNG
   decode per page; (c) ``process_page(path)`` with ``tile_grid=0``
   (characters inside each column crop, the CRNN on [1024, 64] crops) and
   ``process_pages`` over 4 pages of two shapes (the host path): launches,
   times, a profiled call's stages, card against CPU by phase 8a's criteria
   (the detectors' f32 forwards; 8 columns a page, the character detector
   at depth 0.33 to keep the CPU's runs short; the f32 runs also reported
   against the card's f64 runs); (d) ``pack_yc`` /
   ``unpack_yc`` card against CPU on 8b's 16 pages and the ``yc``
   cascade's columns and texts beside the RGB cascade's; (e) the ship-once
   route against the host path on 4 of those pages (reported, not held);
14. (inside 11's temporary root, after 12) training from image files: (a)
   the augmentations' cv2 ops of ``image_io`` (warpAffine / warpPerspective
   of a 1280 mosaic canvas to 640, the HSV round trip with its LUTs,
   remap, filter2D) on the card against the CPU, byte for byte, with a
   planted fault and the warp's device time; (b) the production character
   detector (``Model("yolov12-p2x", task="detect").train``, bf16, 640, b8,
   mosaic on) from a PNG folder of 64 + 8 tiles of 2224 x 1393: launches
   a step and a validation, ms/step, images/s, a profiled step, peak
   memory, the loader's own samples/s and a sample's split, then
   ``Model(run_dir).val`` equal to the last validation and
   ``evaluate_detector``; (c) the production CTC run from a
   ``column_info.csv`` of 160 PNG column crops: ms/step, CER, the loader's
   rate; (d) the recognize trainer from a one-line folder at the
   production widths (K3 + K4 a step) and ``evaluate_recognizer``;
15. (last, after 10) the rest of the detect zoo: (a) yolov8n, yolo11n,
   yolov10n and yolov9c at 128, batch 2, seeded weights, card against CPU
   under phase 4's criteria (raw maps, yolov10's of its one2one head;
   decode; the selection of one decoded tensor; detections); (b) yolo11x, yolov8x, yolov9c and
   yolov10x at 640, batch 8, bf16: ``infer`` -> ``decode`` -> NMS on K1
   (yolov10x: ``nms_free_select``, equal to the CPU's on the same tensor),
   every K1 call held against the plain recurrence on its inputs, ms/img,
   device ms and idle share of a profiled call, peak memory; (c)
   ``DetectTrainer`` at 640, batch 8, bf16 for yolo11x (the v8 loss,
   C2PSA) and yolov10x (the E2E loss): launches, finite losses, ms/step, a
   profiled step, peak memory, validation through K1 or NMS-free, the run
   dir in ``DetectPredictor`` equal to the EMA weights; one yolo11x step
   with ``remat`` against the plain step (phase 9's criteria);
16. (after 15) the Segment, Pose, OBB and Classify heads: (a)
   yolov8n-seg, -pose, -obb and -cls at 128, batch 2, bf16, card against
   CPU (raw maps and the extra outputs; the selection of one set of
   outputs, K1 or the rotated keeps; masks >= 99% of pixels, keypoints
   within 0.05 px; classify logits within 1e-3 of the largest, top-1);
   (b) yolov8x-seg / -pose @640 b8, -obb @1024 b4, -cls @224 b64 through
   their predictors' forwards: ms/img, device ms, idle share, K1's share,
   peak memory; (c) the same four trained through ``Model(...).train``
   from PNG files written in the phase (3 + 5 steps): ms/step, a profiled
   step, peak memory, finite losses, the run dir's predictor equal to the
   EMA weights. ``python3 chip_smoke.py 16`` runs the build and phase 16
   alone (no result line);
17. (after 16) YOLO-NAS, the TrOCR's other encoders, SimpleViT and the
   open ends: (a) YOLO-NAS-L (channels 64-768, nc 80, seeded): f32 maps
   card against CPU at 320 b2 at torch's default TF32 setting, the card's
   fused forward against its unfused one, the NMS of one decoded tensor
   on both devices; ``NASPredictor`` at 640 b8 f32 (the re-parameterised
   forward, decode, NMS on K1): ms/img, device ms, idle share, K1's share,
   peak memory; ``NASTrainer`` at 640 b8 in the config's dtype (bf16) on
   synthetic pages: launches, finite losses, ms/step, a profiled step,
   peak memory, the validation through K1; (b) the TrOCR with the
   ``unet`` and the ``csa`` encoder at the production widths on 8 crops
   of [1024, 64], f32: the memory card against CPU, the greedy tokens
   identical, encode and greedy ms; (c) SimpleViT at 128 px b64, one
   channel, 4,783 classes, f32 through ``ClassifyPredictor.probs``:
   logits card against CPU, top-1, ms/img, idle share; (d) ``nms_padded``
   (K1) and ``letterbox`` / ``resize_keep_aspect`` card against CPU.
   ``python3 chip_smoke.py 17`` runs the build and phase 17 alone;
18. (after 17) the TPU layout options as math options and the SAM family:
   (a) yolov12x@640 b8 bf16 with the plain, ``stem_s2d`` and
   ``stem_packed`` stems (K2 and K1 on the path): maps against the plain
   stem's (relative 0.02), decoded class argmax and boxes, NMS keeps that
   differ, ms/img of each; yolov12n@320 b2 card against CPU with each
   stem; one f32 yolov12n@128 training step with ``conv_impl="s2d"``
   against native (loss and gradients within 1e-4); (b) SAM at JAX's
   defaults (256 px, dim 256, 6 layers, 8 heads, 3 masks) b8, seeded: f32
   card against CPU, ``attn_impl="flash"`` (K3 f32 and bf16) and
   ``"flash_train"`` (K3 with its statistics and K4) against einsum, every
   kernel call held against its plain version on the path's inputs;
   ``Model(task="sam").train`` (f32, einsum, AdamW) on PNG pages written
   here: ms/step, a profiled step, peak memory, the validation's mIoU; (c)
   the TinyViT SAM card against CPU and its encode ms; (d)
   ``SAMPredictor`` point, box and ``everything`` prompts card against CPU,
   encode and ``everything`` ms; (e) FastSAM over yolov8n-seg@128 card
   against CPU (the selections of one set of outputs identical), and
   FastSAM-x (yolov8x-seg, nc 1) at 1024: everything mode (K1), box and
   point prompts, ms/img. ``python3 chip_smoke.py 18`` runs the build and
   phase 18 alone;
19. (after 18) the last model families and tracking: (a) SAM2 at JAX's
   defaults (256 px, dim 256, mem_dim 64, 6 + 2 layers, 8 + 8 heads, a 4 +
   4 ring), seeded, f32: ``track`` of 4 objects over 10 frames with
   ``attn_impl="flash"`` (K3 f32, 60 launches, each held against its plain
   version) against the CPU's einsum route, ms a frame, a profiled call;
   one ``forward(train=True)`` and backward under ``"flash_train"`` (K3
   and K4, each held against its plain version) against einsum; (b) the
   ViT patch detector at its defaults (1024 x 64, dim 256, depth 8), b32:
   the forward and one ``vit_detector_loss`` step card against CPU; (c)
   DETR ``base`` at 512 b8: the forward, the matching cost, one
   ``detr_loss`` step card against CPU, the host's Hungarian time; (d) the
   CVAE (b64) and StackGAN (b32, ``base_ch`` 256) at 128 px: one
   ``cvae_loss`` step, one ``d_step`` + ``g_step`` card against CPU with
   the draws fixed; (e) ``Model(run_dir).track`` of a calibrated seeded
   yolov12x over 8 frames of 640 px with ByteTrack (K1 and K2, each call
   held against its plain version), ids on every ``Results`` and ids that
   follow persisting boxes, ``ObjectCounter`` and ``Heatmap`` (card
   against CPU), ms a frame, whether cv2 imports (without it, BoT-SORT's
   error names cv2); in (d), a CVAE forward with neither noise nor a
   generator copies no noise from the host. ``python3 chip_smoke.py 19``
   runs the build and phase 19 alone;
20. (after 19) the deployable artifact and the facade's tools: (a) each
   ``kuzu_torch::`` operator (K1, K2, K3's forward in bf16 and f32) on
   CUDA tensors at phase 3's shapes: ``torch.library.opcheck``, against
   its plain version, its fake implementation's shape and dtype, and the
   operator boundary's host cost a call; (b) TRACK's run dir exported
   through ``Model.export`` (yolov12x@640 b8, NMS in) and reloaded by
   ``AutoBackend``: export and reload seconds, the ``.pt2``'s size, its
   operator nodes (K1 1, K2 16), one call's launches by the counters and
   the profiler, its detections equal to the eager predictor's, ms/img of
   both and the idle share of one profiled call; (c) yolov12n@640 b8 in
   f32 through ``AutoBackend``, equal to the eager f32 path with TF32
   off; (d) ``Model("yolov12x").benchmark`` at b1 and b8; (e)
   ``Model("yolov12n").tune(iterations=2)`` at 128 on a seeded YOLO
   folder; (f) ``Results.plot`` / ``save`` of one (b) frame, and the cv2
   build's video backends. ``python3 chip_smoke.py 20`` runs the build and
   phase 20 alone, ``python3 chip_smoke.py 5`` phase 5;
21. the ``kernels`` JSON line, then the card's name and power limit;
22. last line: ``{"ok": true, "device": {...}}``.

Phase 3's plain references run with TF32 off for cuBLAS and cuDNN
(``full_f32_references``); every later phase runs at torch's defaults,
the setting a user of the library gets.

It exits non-zero, printing no result, where CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import json
import re
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
PEAK_TF32 = 495e12         # tensor-core TF32 FLOP/s; f32-accurate work as 3xTF32 takes 3 x
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


LAUNCHES = ("LaunchKernel", "Memcpy", "Memset")  # host API calls that start device work


def _session_calls(fn, reps: int) -> list[dict]:
    """CUDA activity (kernels, copies, sets) of ``reps`` calls of ``fn`` in
    one torch.profiler session, each call under a ``record_function`` range
    of its own (a synchronize ends it), and one uncounted call after them:
    one {name: ms} per call whose every host launch has its device record
    (the profiler drops such records at times; such a call is left out)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"device_times_call_{i}"):
                fn()
                torch.cuda.synchronize()
        # one call more, outside every range: the records of a session's last
        # call have come back incomplete (a K6 call of 18 launches, five
        # sessions running), so no counted call is the last
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("device_times_call_"))
    launched: list[set] = [set() for _ in spans]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (corr is None or e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or not any(w in e.get("name", "") for w in LAUNCHES)):
            continue
        for k, (t0, t1) in enumerate(spans):
            if t0 <= float(e["ts"]) <= t1:
                launched[k].add(corr)
    owner = {corr: k for k, corrs in enumerate(launched) for corr in corrs}
    per_call: list[dict] = [{} for _ in spans]
    seen: list[set] = [set() for _ in spans]
    for e in events:
        k = owner.get(e.get("args", {}).get("correlation"))
        if k is not None and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            seen[k].add(e["args"]["correlation"])
            name = e.get("name", "?")
            per_call[k][name] = per_call[k].get(name, 0.0) + float(e["dur"]) / 1e3
    return [c for c, l, sn in zip(per_call, launched, seen) if l and sn == l]


def device_times(fn, reps: int = 10, warmup: int = 3,
                 least: int | None = None) -> tuple[float, dict]:
    """The device's own time per call: ``reps`` calls in one torch.profiler
    session, each call's CUDA activity (kernels, copies, sets) summed.
    Returns the median of the calls' sums in ms and, per kernel name, the
    median of its time per call. Unlike :func:`time_ms` this leaves out the
    host's time in the wrapper and any idle time of the device within a
    call. Calls whose trace misses a launch's activity are left out and
    more are taken, ``reps`` calls in each of up to seven more sessions
    (late in a long process the profiler drops records of most calls in a
    session), and the count of extra sessions is printed; with ``least``,
    that many complete calls will do (the median is then over fewer, as
    printed). Few sessions: a process that opens hundreds of them gets
    empty traces from the profiler on this card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls: list[dict] = []
    sessions = 0
    while len(calls) < reps and sessions < 8:
        calls += _session_calls(fn, reps)
        sessions += 1
    calls = calls[:reps]
    if sessions > 1:
        print(f"    (device_times: {sessions - 1} more profiler sessions for calls whose "
              f"trace missed a launch's activity)")
    if len(calls) < reps:
        print(f"    (device_times: complete traces of {len(calls)} of {reps} calls)")
    require(len(calls) >= (reps if least is None else least),
            f"device_times: complete traces of {len(calls)} of {reps} calls")
    names = {n for c in calls for n in c}
    per_name = {n: statistics.median(c.get(n, 0.0) for c in calls) for n in names}
    return statistics.median(sum(c.values()) for c in calls), per_name


def device_ms(fn, reps: int = 10) -> float:
    return device_times(fn, reps)[0]


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


def _strip(x0: np.ndarray, w: float, h: float = 10.0) -> np.ndarray:
    """Boxes of width w and height h at the x offsets x0, one row."""
    x0 = x0.astype(np.float32)[:, None]
    return np.concatenate([x0, np.zeros_like(x0), x0 + w, np.full_like(x0, h)], -1)


def nms_cases(dev) -> dict:
    """K1's cases, (boxes, valid, threshold) on the card: the main shape; a
    ragged K at B=1; a chain across the 64-box chunks (box r + 1 overlaps
    box r above the threshold, box r + 2 does not, so the keeps alternate
    and a sweep that ORed in rows that were not kept loses half of them);
    all boxes disjoint (all kept, the OR pass's most work); one dense
    cluster (almost all suppressed); K a multiple of 64, and K = 65."""
    from kuzu_torch.ops.nms_kernel import suppress_reference

    rng = np.random.default_rng(7)

    def one(b):
        return (torch.from_numpy(b[None]).to(dev),
                torch.ones((1, b.shape[0]), dtype=torch.bool, device=dev))

    centre = rng.uniform(50, 550, 2)
    cluster = np.concatenate([centre + rng.normal(0, 2, (2048, 2)),
                              centre + 40 + rng.normal(0, 2, (2048, 2))], -1).astype(np.float32)
    cases = {"B=8 K=2048": (*nms_inputs(dev), 0.45)}
    b, v = nms_inputs(dev, 1, 2000, seed=1)
    cases["B=1 K=2000"] = (b, v, 0.45)
    cases["chain K=2048"] = (*one(_strip(np.arange(2048) * 4.0, 10.0)), 0.3)
    cases["disjoint K=2048"] = (*one(_strip(np.arange(2048) * 20.0, 10.0)), 0.45)
    cases["dense cluster K=2048"] = (*one(cluster), 0.45)
    for b_, k in ((3, 128), (2, 65)):
        cases[f"B={b_} K={k}"] = (*nms_inputs(dev, b_, k, seed=k), 0.45)
    chain = cases["chain K=2048"]
    keep = suppress_reference(chain[0].cpu(), chain[1].cpu(), 0.3)[0]
    require(bool((keep == (torch.arange(2048) % 2 == 0)).all()), "the chain case alternates")
    return cases


@contextlib.contextmanager
def full_f32_references():
    """TF32 off for cuBLAS and cuDNN inside the block, the previous settings
    restored after it: phase 3's plain references in full f32. Every later
    phase runs at torch's defaults, the setting a user of the library gets
    (its f32 models switch TF32 off themselves, ``f32_products``)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def kernel_phase(dev) -> dict:
    """Phase 3 inside :func:`full_f32_references`."""
    with full_f32_references():
        print("phase 3's plain references run with allow_tf32=False for matmul and cuDNN "
              "(full f32 products); later phases at torch's defaults")
        return _kernel_checks(dev)


def _kernel_checks(dev) -> dict:
    from kuzu_torch.ops.flash_attention import area_attention, area_attention_plain
    from kuzu_torch.ops.nms_kernel import batched_suppress, suppress_reference
    from kuzu_torch.testing import ATTN_TOL, attention_over

    res = {}

    # K1: greedy NMS, B=8, K=2048 (the kernels line), then the cases that
    # hold the chunked sweep: keeps bit-identical on the card and on the CPU
    thr = 0.45
    mismatches = 0  # over every case: the kernels line's max_abs_err
    for label, (boxes, valid, t) in nms_cases(dev).items():
        keep = batched_suppress(boxes, valid, t)
        ref = suppress_reference(boxes, valid, t)
        keep_cpu = suppress_reference(boxes.cpu(), valid.cpu(), t)
        torch.cuda.synchronize()
        mism = int((keep != ref).sum()) + int((keep.cpu() != keep_cpu).sum())
        print(f"K1 nms {label}: kept {int(keep.sum())} of {int(valid.sum())} valid, keep "
              f"mismatches {mism} (must be 0)")
        require(mism == 0, f"K1 keeps identical to the plain recurrence: {label}")
        mismatches += mism
    require(mismatches == 0, "K1 keeps identical to the plain recurrence on every case")
    boxes, valid = nms_inputs(dev)
    nv = valid.sum(1).double()
    pairs = float((nv * (nv - 1) / 2).sum())
    bnd, by = bound(boxes.numel() * 4 + 2 * valid.numel(), 14 * pairs, PEAK_F32)
    dev_total, dev_split = device_times(lambda: batched_suppress(boxes, valid, thr))
    launch_ms = {kind: sum(t for name, t in dev_split.items() if f"nms_{kind}_kernel" in name)
                 for kind in ("mask", "sweep")}
    res["nms"] = dict(
        max_abs_err=float(mismatches),
        ms=time_ms(lambda: batched_suppress(boxes, valid, thr)),
        device_ms=dev_total, mask_device_ms=launch_ms["mask"],
        sweep_device_ms=launch_ms["sweep"],
        plain_ms=time_ms(lambda: suppress_reference(boxes, valid, thr), reps=3, warmup=1),
        bound_ms=bnd, bound_by=by, library_ms=None, library_device_ms=None)
    print(f"  K1 B=8 K=2048: {res['nms']['ms']:.4f} ms, device {dev_total:.4f} (mask kernel "
          f"{launch_ms['mask']:.4f}, sweep {launch_ms['sweep']:.4f}; plain "
          f"{res['nms']['plain_ms']:.4f}, bound {bnd:.5f} by {by})")

    # K3: area attention at the inference shape of yolov12n@640 node 6
    # (G=32, N=400, C=64, 2 heads) and at the training shape of yolov12-p2x
    # (C=384, 12 heads, q and k column slices of one qk tensor as the
    # training route passes them); the kernels line carries the latter
    gen = torch.Generator(device=dev).manual_seed(3)
    k3_shapes = {}
    for g, n, c, heads in ((32, 400, 64, 2), (32, 400, 384, 12)):
        qk, v = (torch.randn((g, n, w), generator=gen, device=dev).to(torch.bfloat16)
                 for w in (2 * c, c))
        q, k = qk[..., :c], qk[..., c:]
        out = area_attention(q, k, v, heads)
        refo = area_attention_plain(q, k, v, heads, (c // heads) ** -0.5)
        torch.cuda.synchronize()
        err, n_over, total = attention_over(out, refo)
        print(f"K3 area_attention G={g} N={n} C={c} h={heads}: max_abs_err {err:.3e} (max|ref| "
              f"{float(refo.float().abs().max()):.3e}), over tolerance ({ATTN_TOL}): {n_over}")
        require(n_over == 0 and bool(torch.isfinite(out.float()).all()),
                f"K3 within tolerance at C={c}")
        k3_faults(q, k, v, heads, refo)
        hd = c // heads
        sd = [t.reshape(g, n, heads, hd).transpose(1, 2).contiguous() for t in (q, k, v)]
        bnd, by = bound(4 * g * n * c * 2, 4 * g * n * n * c, PEAK_BF16)
        r = dict(
            max_abs_err=err,
            ms=time_ms(lambda: area_attention(q, k, v, heads)),
            device_ms=device_ms(lambda: area_attention(q, k, v, heads)),
            plain_ms=time_ms(lambda: area_attention_plain(q, k, v, heads, hd ** -0.5)),
            bound_ms=bnd, bound_by=by,
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*sd)),
            library_device_ms=device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(*sd)))
        print(f"  K3 at C={c}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by {by}, SDPA "
              f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f})")
        k3_shapes[f"G={g} N={n} C={c} h={heads}"] = r
    res["area_attention"] = dict(r, shapes=k3_shapes)
    res["area_attention_f32"] = k3_f32_check(dev, gen)
    res["area_attention_bwd"] = k4_check(dev, gen, qk, v, heads)
    res["area_attention_bwd_f32"] = k4_f32_check(dev, gen)
    res["area_attention_bwd"]["trocr_shape"] = trocr_bf16_train_check(dev, gen)

    # K2: fused ABlock at yolov12x@640 b8 node 6 (G=32 chunks of na=400,
    # C=384, 12 heads, hidden 576; the kernels line) and node 8 (G=8)
    res["fused_ablock"] = k2_check(dev, gen, 32)
    k2_check(dev, gen, 8)
    k2_check(dev, gen, 2, hid=1536)  # an MLP twice as wide as the old kernel took
    for name, r in res.items():
        print(f"  {name}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
              f"{r['library_ms']}, device {r['library_device_ms']})")
    return res


def k2_check(dev, gen, g: int, hid: int = 576) -> dict | None:
    """K2 at G chunks of na=400, C=384, 12 heads, hidden ``hid`` against its
    plain version; at hidden 576 also planted faults in its epilogues, each
    launch's device time, and torch.matmul on the same four GEMM shapes (a
    printed yardstick the port never calls)."""
    from kuzu_torch.ops.fused_ablock import fused_ablock, fused_ablock_plain
    from kuzu_torch.testing import ABLOCK_TOL, ablock_faults, ablock_over

    na, c, heads = 400, 384, 12
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
    torch.cuda.synchronize()
    err, over, close = ablock_over(out, refo)
    print(f"K2 fused_ablock G={g} na={na} C={c} h={heads} hidden={hid}: max_abs_err {err:.3e}, "
          f"over 0.08 + 0.02|ref|: {over}, share within 0.02 + 0.01|ref|: {close:.5f} (> 0.999)")
    require(over == 0 and close > 0.999 and bool(torch.isfinite(out.float()).all()),
            f"K2 within tolerance at G={g}, hidden {hid}")
    if hid != 576:
        return None
    for name, bad in ablock_faults(x, vv, pe, weights, 1, heads).items():
        e, o, cl = ablock_over(bad, refo)
        print(f"  planted fault, {name}: over {o}, share close {cl:.5f} (must fail {ABLOCK_TOL})")
        require(o > 0 or cl <= 0.999, f"K2's tolerance rejects the fault: {name}")
    m = g * na
    flops = 2 * m * c * (2 * c + c + 2 * hid) + 4 * g * na * na * c
    nbytes = 4 * m * c * 2 + sum(t.numel() * t.element_size() for t in weights)
    bnd, by = bound(nbytes, flops, PEAK_BF16)
    dev_total, dev_split = device_times(lambda: fused_ablock(x, vv, pe, weights, 1, heads))
    r = dict(max_abs_err=err, ms=time_ms(lambda: fused_ablock(x, vv, pe, weights, 1, heads)),
             device_ms=dev_total,
             plain_ms=time_ms(lambda: fused_ablock_plain(x, vv, pe, weights, 1, heads)),
             bound_ms=bnd, bound_by=by, library_ms=None, library_device_ms=None)
    print(f"  K2 at G={g}: {r['ms']:.4f} ms, device {dev_total:.4f} (plain {r['plain_ms']:.4f}, "
          f"bound {bnd:.5f} by {by}); device time per launch: "
          + ", ".join(f"{name[:48]} {t:.4f} ms" for name, t in sorted(dev_split.items())))
    x2, h2 = x.reshape(m, c), torch.randn((m, hid), device=dev).to(torch.bfloat16)
    mats = {"qk (m x 384 x 768)": (x2, weights[0]), "proj (m x 384 x 384)": (x2, weights[2]),
            "mlp1 (m x 384 x 576)": (x2, weights[4]), "mlp2 (m x 576 x 384)": (h2, weights[6])}
    lib = {name: device_ms(lambda a=a, b=b: torch.matmul(a, b)) for name, (a, b) in mats.items()}
    print(f"  torch.matmul (cuBLAS) device time on the four GEMM shapes, m={m} (yardstick, not "
          f"called by the port): " + ", ".join(f"{nm} {t:.4f} ms" for nm, t in lib.items())
          + f"; sum {sum(lib.values()):.4f}")
    r["matmul_device_ms"] = lib
    return r


TROCR_K3 = (1024, 256, 384, 6)  # (G, N, C, heads): the TrOCR encoder on a bucket of 1024 crops


def f32_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of f32-accurate work on this card: the bytes against
    the operations done as 3xTF32, three TF32 products each, on the tensor
    cores (67 TFLOP/s of the CUDA cores would take 2.5 times as long)."""
    return bound(nbytes, 3 * flops, PEAK_TF32)


def k3_f32_bound(g: int, n: int, c: int, heads: int) -> tuple[float, str]:
    """K3 f32's least time: q, k, v read once and o written once in f32
    against 4 G heads N^2 hd operations as 3xTF32 (:func:`f32_bound`)."""
    return f32_bound(4 * g * n * c * 4, 4 * g * n * n * c)


def k3_f32_times(q, k, v, heads: int) -> dict:
    """K3 f32's times on (q, k, v): the kernel (``ms``, ``device_ms``), the
    plain version, the bound, and SDPA in f32 with TF32 off on the same
    heads (a yardstick the port never calls)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from kuzu_torch.ops.flash_attention import area_attention, area_attention_plain

    g, n, c = q.shape
    hd = c // heads
    sd = [t.reshape(g, n, heads, hd).transpose(1, 2).contiguous() for t in (q, k, v)]
    bnd, by = k3_f32_bound(g, n, c, heads)
    ref = area_attention_plain(q, k, v, heads, hd ** -0.5)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(*sd)

    sdpa_err = float((sdpa().transpose(1, 2).reshape(g, n, c) - ref).abs().max())
    r = dict(ms=time_ms(lambda: area_attention(q, k, v, heads), reps=10),
             device_ms=device_times(lambda: area_attention(q, k, v, heads), least=5)[0],
             plain_ms=time_ms(lambda: area_attention_plain(q, k, v, heads, hd ** -0.5),
                              reps=3, warmup=1),
             bound_ms=bnd, bound_by=by, library_ms=time_ms(sdpa, reps=10),
             library_device_ms=device_times(sdpa, least=5)[0], library_max_abs_err=sdpa_err)
    with sdpa_kernel(SDPBackend.MATH):  # the materialised route: full f32 products
        r["library_math_ms"] = time_ms(sdpa, reps=5)
    return r


def k3_f32_check(dev, gen) -> dict:
    """K3's f32 route (the TrOCR encoder's self-attention) against its plain
    version: at the TrOCR shape (G=1024 crops, N=256 patches, C=384, 6
    heads) with planted faults, at every head width at N = 16 (the parity
    tests' encoder), 256 and 400 (a ragged last key tile), under
    ``ATTN_F32_TOL`` (TF32 off on the plain side); then its times beside
    the bound and SDPA in f32."""
    from kuzu_torch.ops.flash_attention import FWD_DS, area_attention, area_attention_plain
    from kuzu_torch.testing import (
        ATTN_F32_TOL,
        attention_f32_over,
        attention_faults,
        attention_tf32,
    )

    g, n, c, heads = TROCR_K3
    q, k, v = (torch.randn((g, n, c), generator=gen, device=dev) for _ in range(3))
    out = area_attention(q, k, v, heads)
    ref = area_attention_plain(q, k, v, heads, (c // heads) ** -0.5)
    torch.cuda.synchronize()
    err, n_over, total = attention_f32_over(out, ref)
    print(f"K3 f32 area_attention G={g} N={n} C={c} h={heads}: max_abs_err {err:.3e} (max|ref| "
          f"{float(ref.abs().max()):.3e}), over tolerance ({ATTN_F32_TOL}): {n_over} of {total}")
    require(out.dtype == torch.float32 and n_over == 0 and bool(torch.isfinite(out).all()),
            "K3 f32 within tolerance at the TrOCR shape")
    for name, bad in attention_faults(q[:64], k[:64], v[:64], heads).items():
        e, o, tot = attention_f32_over(bad, ref[:64])
        print(f"  planted fault, {name}: max_abs_err {e:.3e}, over tolerance {o} of {tot} "
              f"(must be > 0)")
        require(o > 0, f"K3 f32's tolerance rejects the fault: {name}")
    # plain TF32, the lo parts dropped (hi x hi alone): the kernel's lo terms
    # must reach its result, so the tolerance rejects this one too
    e, o, tot = attention_f32_over(attention_tf32(q[:64], k[:64], v[:64], heads, passes=1)[0],
                                   ref[:64])
    print(f"  planted fault, 1xTF32 (the lo terms dropped): max_abs_err {e:.3e}, over tolerance "
          f"{o} of {tot} (must be > 0)")
    require(o > 0, "K3 f32's tolerance rejects the fault: 1xTF32")
    worst = err
    for hd in FWD_DS:
        for nn_ in (16, 256, 400):
            qq, kk, vv = (torch.randn((4, nn_, 2 * hd), generator=gen, device=dev)
                          for _ in range(3))
            e, o, _ = attention_f32_over(area_attention(qq, kk, vv, 2),
                                         area_attention_plain(qq, kk, vv, 2, hd ** -0.5))
            require(o == 0, f"K3 f32 within tolerance at hd={hd} N={nn_}")
            worst = max(worst, e)
    print(f"K3 f32 at G=4, 2 heads, N in (16, 256, 400), hd in {FWD_DS}: every case within "
          f"tolerance; max_abs_err {worst:.3e}")
    # more than 65535 heads * groups (a crop bucket past 10922 at 6 heads):
    # the grid is one-dimensional, so every group is computed
    big_g, big_heads = 12000, 6
    qq, kk, vv = (torch.randn((big_g, 16, 16 * big_heads), generator=gen, device=dev)
                  for _ in range(3))
    e, o, tot = attention_f32_over(area_attention(qq, kk, vv, big_heads),
                                   area_attention_plain(qq, kk, vv, big_heads, 0.25))
    print(f"K3 f32 at G={big_g}, N=16, {big_heads} heads (heads * G = {big_g * big_heads}): "
          f"max_abs_err {e:.3e}, over tolerance {o} of {tot}")
    require(o == 0, "K3 f32 within tolerance past 65535 heads * groups")
    worst = max(worst, e)
    # a head width the kernel is not built for raises on the card; the
    # encoder's attention does not leave the kernel for the plain version
    from kuzu_torch.models.layers import MultiHeadAttention
    mha = MultiHeadAttention(16, 2, attn_impl="flash").to(dev).eval()
    try:
        with torch.no_grad():
            mha(torch.randn((2, 16, 16), generator=gen, device=dev))
        raised = False
    except ValueError as exc:
        raised = True
        print(f"K3 f32 route at hd=8 raises on the card: {exc}")
    require(raised, "the kernel route raises on the card for a head width K3 f32 cannot take")
    r = dict(max_abs_err=worst, **k3_f32_times(q, k, v, heads))
    print(f"  K3 f32 at the TrOCR shape: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
          f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by {r['bound_by']}; SDPA f32, TF32 "
          f"off, its default route {r['library_ms']:.4f}, device {r['library_device_ms']:.4f}, "
          f"max_abs_err {r['library_max_abs_err']:.2e}; its math route {r['library_math_ms']:.4f})")
    return r


def k3_faults(q, k, v, heads, ref) -> None:
    """K3's tolerance against faults the kernel could have (each computed
    exactly in f32 and rounded once): every one must exceed it. P entering
    P V as one bf16 part, which the kernel does, is reported beside them."""
    from kuzu_torch.testing import attention_exact, attention_faults, attention_over

    scale = (q.shape[-1] // heads) ** -0.5
    err, n_over, total = attention_over(attention_exact(q, k, v, heads, scale, p_bf16=True), ref)
    print(f"  P as one bf16 part (what the kernel does): max_abs_err {err:.3e}, over "
          f"tolerance {n_over} of {total}")
    for name, out in attention_faults(q, k, v, heads).items():
        err, n_over, total = attention_over(out, ref)
        print(f"  planted fault, {name}: max_abs_err {err:.3e}, over tolerance {n_over} of "
              f"{total} (must be > 0)")
        require(n_over > 0, f"K3's tolerance rejects the fault: {name}")


def k4_check(dev, gen, qk, v, heads) -> dict:
    """K4 (the backward kernels) against its plain version at G=32, N=400,
    C=384 given the forward's output in two parts and lse (the training
    route's call) and without them (the standalone call, which runs K3
    first), planted faults and two other designs against the tolerance,
    whether two runs agree bit for bit, every head width at N = 16, 80, 400
    and N=1024, and the AreaAttention pair's gradients against autograd
    through the plain forward. Times of both call forms beside SDPA's
    backward."""
    from kuzu_torch.ops.flash_attention import (
        FWD_DS,
        AreaAttention,
        area_attention,
        area_attention_bwd,
        area_attention_bwd_plain,
        area_attention_plain,
    )
    from kuzu_torch.testing import (
        BWD_TOL,
        attention_bwd_exact,
        attention_bwd_faults,
        bwd_over,
    )

    g, n, c = v.shape
    hd = c // heads
    scale = hd ** -0.5
    q, k = qk[..., :c], qk[..., c:]
    do = torch.randn((g, n, c), generator=gen, device=dev).to(torch.bfloat16)
    stats = area_attention(q, k, v, heads, return_lse=True)  # (out, lse, out_lo)
    lse = stats[1]
    got = area_attention_bwd(q, k, v, do, heads, *stats)
    ref = area_attention_bwd_plain(q, k, v, do, heads, scale, *stats)
    torch.cuda.synchronize()

    def check(name, a, b):
        err, over = bwd_over(a, b)
        print(f"  {name}: max_abs_err {err:.3e} (max|ref| {float(b.float().abs().max()):.3e}), "
              f"over tolerance ({BWD_TOL}) {over}, identical share "
              f"{float((a == b).float().mean()):.4f}")
        require(over == 0 and bool(torch.isfinite(a.float()).all()), f"{name} within tolerance")
        return err

    print(f"K4 area_attention_bwd G={g} N={n} C={c} h={heads}, q/k column slices, the "
          f"forward's out, lse and out_lo given:")
    errs = [check(nm, a, b) for nm, a, b in zip(("dq", "dk", "dv"), got, ref)]
    again = area_attention_bwd(q, k, v, do, heads, *stats)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  two runs bit-identical: {same}")
    require(same, "K4 is deterministic (no atomics)")
    print("K4 standalone (out, lse, out_lo from a K3 launch inside the call):")
    for nm, a, b in zip(("dq", "dk", "dv"), area_attention_bwd(q, k, v, do, heads),
                        area_attention_bwd_plain(q, k, v, do, heads, scale)):
        check(nm, a, b)
    exact = attention_bwd_exact(q, k, v, do, heads)
    print("  plain version vs the exact function (f32 softmax, no lse): max_abs_err "
          + ", ".join(f"{nm} {bwd_over(a, b)[0]:.3e} over {bwd_over(a, b)[1]}"
                      for nm, a, b in zip(("dq", "dk", "dv"), ref, exact)))
    for name, outs in attention_bwd_faults(q, k, v, do, heads, lse).items():
        overs = [bwd_over(a, b)[1] for a, b in zip(outs, ref)]
        print(f"  planted fault, {name}: over tolerance dq/dk/dv {overs} of {ref[0].numel()} "
              f"each (must be > 0 in one)")
        require(max(overs) > 0, f"K4's tolerance rejects the fault: {name}")
    for label, flag in (("P and dS as one bf16 part", "one_part"),
                        ("D from the bf16 output without its low part", "d_from_out")):
        outs = attention_bwd_exact(q, k, v, do, heads, lse, **{flag: True})
        print(f"  other design, {label} (not used): over tolerance dq/dk/dv "
              f"{[bwd_over(a, b)[1] for a, b in zip(outs, ref)]}")

    # every head width at N = 16 (yolov12n@128), 80 (ragged), 400, and N=1024
    cases = [(4, nn, d) for d in FWD_DS for nn in (16, 80, 400)] + [(2, 1024, 32)]
    worst, other = 0.0, {"P and dS as one bf16 part": 0,
                         "D from the bf16 output without its low part": 0}
    for gs, ns, d in cases:
        cs = 2 * d  # two heads
        qks = torch.randn((gs, ns, 2 * cs), generator=gen, device=dev).to(torch.bfloat16)
        vs, dos = (torch.randn((gs, ns, cs), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))
        qs, ks = qks[..., :cs], qks[..., cs:]
        st = area_attention(qs, ks, vs, 2, return_lse=True)
        refs = area_attention_bwd_plain(qs, ks, vs, dos, 2, d ** -0.5, *st)
        for nm, a, b in zip(("dq", "dk", "dv"), area_attention_bwd(qs, ks, vs, dos, 2, *st), refs):
            err, over = bwd_over(a, b)
            require(over == 0 and bool(torch.isfinite(a.float()).all()),
                    f"K4 {nm} within tolerance at hd={d} N={ns}: {over} over, max {err:.3e}")
            worst = max(worst, err)
        for label, flag in (("P and dS as one bf16 part", "one_part"),
                            ("D from the bf16 output without its low part", "d_from_out")):
            outs = attention_bwd_exact(qs, ks, vs, dos, 2, st[1], **{flag: True})
            other[label] += sum(bwd_over(a, b)[1] for a, b in zip(outs, refs))
    print(f"K4 at hd in {FWD_DS} x N in (16, 80, 400), and hd=32 N=1024 (2 heads): every case "
          f"within tolerance, max_abs_err {worst:.3e}; other designs over tolerance in all "
          f"these cases: {other}")

    # the autograd pair (K3 forward with lse, K4 backward) against autograd
    # through the plain forward, same tolerance
    qk_a = qk.detach().clone().requires_grad_()
    v_a = v.detach().clone().requires_grad_()
    grads = torch.autograd.grad(AreaAttention.apply(qk_a, v_a, heads), (qk_a, v_a), do)
    qk_p = qk.detach().clone().requires_grad_()
    v_p = v.detach().clone().requires_grad_()
    out_p = area_attention_plain(qk_p[..., :c], qk_p[..., c:], v_p, heads, scale)
    grads_p = torch.autograd.grad(out_p, (qk_p, v_p), do)
    print("AreaAttention pair vs autograd through area_attention_plain:")
    check("d(qk)", grads[0], grads_p[0])
    check("dv", grads[1], grads_p[1])

    def heads_split(t):
        return t.reshape(g, n, heads, hd).transpose(1, 2).contiguous()

    sd = [heads_split(t).requires_grad_() for t in (q, k, v)]
    sd_out = torch.nn.functional.scaled_dot_product_attention(*sd)
    sd_do = heads_split(do)
    bnd, by = bound(7 * g * n * c * 2, 10 * g * n * n * c, PEAK_BF16)
    r = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: area_attention_bwd(q, k, v, do, heads, *stats)),
        device_ms=device_ms(lambda: area_attention_bwd(q, k, v, do, heads, *stats)),
        plain_ms=time_ms(lambda: area_attention_bwd_plain(q, k, v, do, heads, scale, *stats)),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(
            lambda: torch.autograd.grad(sd_out, sd, sd_do, retain_graph=True)),
        library_device_ms=device_ms(
            lambda: torch.autograd.grad(sd_out, sd, sd_do, retain_graph=True)))
    standalone_ms = time_ms(lambda: area_attention_bwd(q, k, v, do, heads))
    standalone_dev, split = device_times(lambda: area_attention_bwd(q, k, v, do, heads))
    print(f"  K4 (training route, the forward's out, lse, out_lo given): {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
          f"(plain {r['plain_ms']:.4f}, bound {bnd:.5f} by {by}, SDPA backward "
          f"{r['library_ms']:.4f}, device {r['library_device_ms']:.4f})")
    print(f"  K4 standalone (K3 for out, lse, out_lo, then K4): {standalone_ms:.4f} ms, device "
          f"{standalone_dev:.4f}; by kernel: "
          + ", ".join(f"{nm[:40]} {t:.4f}" for nm, t in sorted(split.items())))
    r["standalone_ms"], r["standalone_device_ms"] = standalone_ms, standalone_dev
    return r


TROCR_TRAIN = (16, 256, 384, 6)  # (G, N, C, heads): the TrOCR encoder in a training step, batch 16


def k4_f32_bound(g: int, n: int, c: int, heads: int) -> tuple[float, str]:
    """K4 f32's least time: q, k, v, o, dO and lse read once, dq, dk, dv
    written once, in f32, against its five products of 2 N^2 hd per head
    as 3xTF32 (:func:`f32_bound`)."""
    return f32_bound(8 * g * n * c * 4 + g * heads * n * 4, 10 * g * n * n * c)


def k4_f32_check(dev, gen) -> dict:
    """K3's f32 training route (the output and each row's base-2 lse) and
    K4's f32 route against their plain versions: at the TrOCR training
    shape (G=16 crops, N=256, C=384, 6 heads) with planted faults and a
    determinism check, every head width at N = 16 and 256, and G=12000 at
    N=16, 6 heads (72,000 heads x groups); ``ATTN_F32_TOL`` for the forward
    and the lse, ``BWD_F32_TOL`` for each gradient. Then K4 f32's times
    beside its bound and SDPA's f32 backward (TF32 off)."""
    from kuzu_torch.ops.flash_attention import (
        FWD_DS,
        area_attention,
        area_attention_bwd,
        area_attention_bwd_plain,
        area_attention_plain,
    )
    from kuzu_torch.testing import (
        ATTN_F32_TOL,
        BWD_F32_TOL,
        attention_bwd_faults,
        attention_bwd_tf32,
        attention_f32_over,
        bwd_f32_over,
    )

    def case(g, n, c, heads, faults=False):
        scale = (c // heads) ** -0.5
        q, k, v, do = (torch.randn((g, n, c), generator=gen, device=dev) for _ in range(4))
        out, lse, lo = area_attention(q, k, v, heads, return_lse=True)
        ref_o, ref_l, _ = area_attention_plain(q, k, v, heads, scale, return_lse=True)
        got = area_attention_bwd(q, k, v, do, heads, out, lse)
        ref = area_attention_bwd_plain(q, k, v, do, heads, scale, ref_o, ref_l)
        torch.cuda.synchronize()
        fwd = [attention_f32_over(out, ref_o), attention_f32_over(lse, ref_l)]
        bwd = [bwd_f32_over(a, b) for a, b in zip(got, ref)]
        require(lo is None and all(x[1] == 0 for x in fwd) and all(x[1] == 0 for x in bwd)
                and all(bool(torch.isfinite(t).all()) for t in got),
                f"K3 f32 with lse and K4 f32 within tolerance at G={g} N={n} C={c} h={heads}: "
                f"fwd {fwd}, bwd {bwd}")
        if faults:
            again = area_attention_bwd(q, k, v, do, heads, out, lse)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    "K4 f32 is deterministic (no atomics)")
            for name, outs in attention_bwd_faults(q, k, v, do, heads, lse).items():
                overs = [bwd_f32_over(a, b)[1] for a, b in zip(outs, ref)]
                print(f"  planted fault, {name}: over {BWD_F32_TOL} dq/dk/dv {overs} of "
                      f"{ref[0].numel()} each (must be > 0 in one)")
                require(max(overs) > 0, f"K4 f32's tolerance rejects the fault: {name}")
            # plain TF32 in all five products: every gradient over
            overs = [bwd_f32_over(a, b)[1]
                     for a, b in zip(attention_bwd_tf32(q, k, v, do, heads, passes=1), ref)]
            print(f"  planted fault, 1xTF32 (the lo terms dropped): over {BWD_F32_TOL} dq/dk/dv "
                  f"{overs} of {ref[0].numel()} each (must be > 0 in each)")
            require(min(overs) > 0, "K4 f32's tolerance rejects the fault: 1xTF32")
        return max(x[0] for x in fwd), max(x[0] for x in bwd), (q, k, v, do, out, lse)

    g, n, c, heads = TROCR_TRAIN
    f_err, b_err, (q, k, v, do, out, lse) = case(g, n, c, heads, faults=True)
    print(f"K3 f32 training route + K4 f32 at G={g} N={n} C={c} h={heads}: forward and lse "
          f"max_abs_err {f_err:.3e} (within {ATTN_F32_TOL}), dq/dk/dv {b_err:.3e} (within "
          f"{BWD_F32_TOL}); two runs bit-identical")
    worst_f, worst_b = f_err, b_err
    for hd in FWD_DS:
        for nn_ in (16, 256):
            e_f, e_b, _ = case(4, nn_, 2 * hd, 2)
            worst_f, worst_b = max(worst_f, e_f), max(worst_b, e_b)
    e_f, e_b, _ = case(12000, 16, 96, 6)
    worst_f, worst_b = max(worst_f, e_f), max(worst_b, e_b)
    print(f"K3 f32 + K4 f32 at G=4, 2 heads, N in (16, 256), hd in {FWD_DS}, and G=12000, "
          f"N=16, 6 heads (72,000 heads x groups): every case within tolerance; max_abs_err "
          f"forward {worst_f:.3e}, backward {worst_b:.3e}")
    hd = c // heads
    scale = hd ** -0.5

    def split(t):
        return t.reshape(g, n, heads, hd).transpose(1, 2).contiguous()

    sd = [split(t).requires_grad_() for t in (q, k, v)]
    sd_out = torch.nn.functional.scaled_dot_product_attention(*sd)
    sd_do = split(do)
    bnd, by = k4_f32_bound(g, n, c, heads)
    dev_total, dev_split = device_times(lambda: area_attention_bwd(q, k, v, do, heads, out, lse),
                                        least=5)
    r = dict(
        max_abs_err=worst_b, ms=time_ms(lambda: area_attention_bwd(q, k, v, do, heads, out, lse)),
        device_ms=dev_total,
        plain_ms=time_ms(lambda: area_attention_bwd_plain(q, k, v, do, heads, scale, out, lse),
                         reps=5, warmup=1),
        bound_ms=bnd, bound_by=by,
        library_ms=time_ms(lambda: torch.autograd.grad(sd_out, sd, sd_do, retain_graph=True)),
        library_device_ms=device_times(
            lambda: torch.autograd.grad(sd_out, sd, sd_do, retain_graph=True), least=5)[0],
        forward_lse_ms=time_ms(lambda: area_attention(q, k, v, heads, return_lse=True)),
        forward_lse_device_ms=device_times(
            lambda: area_attention(q, k, v, heads, return_lse=True), least=5)[0],
        forward_bound_ms=k3_f32_bound(g, n, c, heads)[0])
    print(f"  K4 f32 at the TrOCR training shape: {r['ms']:.4f} ms, device {dev_total:.4f} "
          f"(dQ and dK/dV: " + ", ".join(f"{nm[:24]} {t:.4f}" for nm, t in sorted(
              dev_split.items())) + f"; plain {r['plain_ms']:.4f}, bound {bnd:.5f} by {by}, "
          f"SDPA f32 backward {r['library_ms']:.4f}, device {r['library_device_ms']:.4f}); "
          f"K3 f32 with lse {r['forward_lse_ms']:.4f} ms, device "
          f"{r['forward_lse_device_ms']:.4f} (bound {r['forward_bound_ms']:.5f})")
    return r


def trocr_bf16_train_check(dev, gen) -> dict:
    """K3 bf16 with lse and K4 bf16 at the TrOCR training shape on separate
    q, k, v (three Dense outputs; YOLO passes q and k as halves of one
    tensor) against their plain versions (``ATTN_TOL``, ``BWD_TOL``); the
    ``area_attention_trainable`` pair's gradients against autograd through
    the plain forward in bf16 and f32; the pair's times at that shape."""
    from kuzu_torch.ops.flash_attention import (
        area_attention,
        area_attention_bwd,
        area_attention_bwd_plain,
        area_attention_plain,
        area_attention_trainable,
    )
    from kuzu_torch.testing import attention_over, bwd_f32_over, bwd_over

    g, n, c, heads = TROCR_TRAIN
    scale = (c // heads) ** -0.5
    q, k, v, do = (torch.randn((g, n, c), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    out, lse, lo = area_attention(q, k, v, heads, return_lse=True)
    ref_o, ref_l, ref_lo = area_attention_plain(q, k, v, heads, scale, return_lse=True)
    got = area_attention_bwd(q, k, v, do, heads, out, lse, lo)
    ref = area_attention_bwd_plain(q, k, v, do, heads, scale, out, lse, lo)
    torch.cuda.synchronize()
    fo = attention_over(out, ref_o)
    bo = [bwd_over(a, b) for a, b in zip(got, ref)]
    print(f"K3 bf16 (training route) + K4 bf16 at G={g} N={n} C={c} h={heads}, separate q/k/v: "
          f"output max_abs_err {fo[0]:.3e} over {fo[1]}, dq/dk/dv "
          + ", ".join(f"{e:.3e} over {o}" for e, o in bo))
    require(fo[1] == 0 and all(o == 0 for _, o in bo), "K3/K4 bf16 at the TrOCR shape")
    for dt, over in ((torch.bfloat16, bwd_over), (torch.float32, bwd_f32_over)):
        leaves = [t.to(dt).detach().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(area_attention_trainable(*leaves, heads), leaves, do.to(dt))
        plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
        grads_p = torch.autograd.grad(area_attention_plain(*plain, heads, scale), plain,
                                      do.float())
        errs = [over(a, b) for a, b in zip(grads, grads_p)]
        print(f"  area_attention_trainable {str(dt)[6:]} vs autograd through the plain forward: "
              f"dq/dk/dv " + ", ".join(f"{e:.3e} over {o}" for e, o in errs))
        require(all(o == 0 for _, o in errs), f"area_attention_trainable {dt} gradients")
    r = dict(
        k3_ms=time_ms(lambda: area_attention(q, k, v, heads, return_lse=True)),
        k3_device_ms=device_ms(lambda: area_attention(q, k, v, heads, return_lse=True)),
        k3_bound_ms=bound(4 * g * n * c * 2 + g * heads * n * 4, 4 * g * n * n * c,
                          PEAK_BF16)[0],
        k4_ms=time_ms(lambda: area_attention_bwd(q, k, v, do, heads, out, lse, lo)),
        k4_device_ms=device_ms(lambda: area_attention_bwd(q, k, v, do, heads, out, lse, lo)),
        k4_bound_ms=bound(9 * g * n * c * 2 + g * heads * n * 4, 10 * g * n * n * c,
                          PEAK_BF16)[0])
    print(f"  at the TrOCR training shape: K3 bf16 with lse {r['k3_ms']:.4f} ms, device "
          f"{r['k3_device_ms']:.4f} (bound {r['k3_bound_ms']:.5f}); K4 bf16 {r['k4_ms']:.4f} ms, "
          f"device {r['k4_device_ms']:.4f} (bound {r['k4_bound_ms']:.5f})")
    return r


# ------------------------------------------------------------- phases 4, 5

COUNTERS = ("nms", "area_attention", "fused_ablock", "area_attention_bwd", "flash_attention",
            "fused_c3k2", "area_attention_f32", "area_attention_bwd_f32")


def counters() -> dict:
    """Each kernel's wrapper and the attribute that counts its launches
    (K3's and K4's wrappers count their bf16 and f32 kernels apart)."""
    from kuzu_torch.ops.flash_attention import (
        area_attention,
        area_attention_bwd,
        flash_attention,
    )
    from kuzu_torch.ops.fused_ablock import fused_ablock
    from kuzu_torch.ops.fused_c3k2 import fused_c3k2
    from kuzu_torch.ops.nms_kernel import batched_suppress

    fns = (batched_suppress, area_attention, fused_ablock, area_attention_bwd, flash_attention,
           fused_c3k2, area_attention, area_attention_bwd)
    attrs = ("launches",) * 6 + ("f32_launches",) * 2
    return {name: (fn, attr) for name, fn, attr in zip(COUNTERS, fns, attrs)}


def want(**counts) -> dict:
    """Expected launch counts: the ones named, 0 for every other kernel."""
    return {name: counts.get(name, 0) for name in COUNTERS}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
        fn.plain_calls = 0


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def plain_counts() -> dict:
    """Calls of each wrapper that ran its plain version (a CPU tensor)."""
    return {name: fn.plain_calls for name, (fn, _) in counters().items()}


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
    require(counts == want(nms=1, area_attention=4, fused_ablock=4), "yolov12n launch counts")
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


def full_width(dev, launches: dict):
    """Phase 5; returns its results, the detector and the images, which
    phase 6 reuses."""
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
    require(counts == want(nms=1, fused_ablock=16), "yolov12x launch counts")
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
    return r, det, imgs


# ----------------------------------------------------------- phases 9, 10


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else float(torch.equal(a, b))


def train_slice_check(dev, launches: dict) -> None:
    """One train step of yolov12n@128, batch 2, seeded weights, on the card
    and on the CPU, compared: in bf16 (the card through K3/K4, the CPU
    through their plain versions; launches counted) and in f32 (the card's
    materialised attention, since the kernels take bf16: the whole step's
    arithmetic held across devices).

    The step runs with grad_clip 0 here so that the gradients it leaves are
    the raw ones; clipping is held against JAX on the CPU."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
    from kuzu_torch.ops.detect_loss import detection_loss
    from kuzu_torch.testing import SyntheticDetectionDataset

    path, scale = resolve_model_spec("yolov12n")
    spec = parse_model_yaml(path, scale=scale, nc=3)
    ds = SyntheticDetectionDataset(2, 128, max_boxes=24, nc=3, seed=5)
    batch = default_collate([ds[0], ds[1]])
    cfg = load_config(overrides=dict(warmup_epochs=0, epochs=1, grad_clip=0))

    def run(d, dtype, remat=False):
        graph = YoloGraph(spec, dtype=dtype, remat=remat)
        graph.reset_parameters(torch.Generator().manual_seed(0))
        graph.to(d)
        tx = build_optimizer(cfg, graph, 1)
        state = TrainState(graph, tx)

        def loss_fn(model, b):
            return detection_loss(model(b["image"]), b["gt_labels"], b["gt_boxes"],
                                  b["mask_gt"], nc=3, imgsz=128, strides=spec.strides,
                                  reg_max=spec.reg_max)

        grads = {}
        update = tx.step

        def snapshot_then_step(count, grad_norm):
            # the gradients as the step hands them to the optimizer (torch's
            # foreach SGD may update .grad in place)
            grads.update({n: p.grad.detach().double().cpu()
                          for n, p in graph.named_parameters()})
            update(count, grad_norm)

        tx.step = snapshot_then_step
        step = make_train_step(loss_fn, tx)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        metrics = step(state, b)
        peak = 0.0
        if d.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**20
        return dict(
            peak_mib=peak,
            counts=launch_counts(), metrics={k: float(v) for k, v in metrics.items()},
            grads=grads, stats={n: t.detach().float().cpu() for n, t in graph.named_buffers()
                                if "running" in n})

    cpu = torch.device("cpu")
    r = {(d.type, str(dt)[6:]): run(d, dt) for dt in (torch.bfloat16, torch.float32)
         for d in (dev, cpu)}
    counts = r["cuda", "bfloat16"]["counts"]
    print(f"train step yolov12n@128 b2: card launches in bf16 {counts} (want "
          f"area_attention 8, area_attention_bwd 8), in f32 {r['cuda', 'float32']['counts']}")
    require(counts == want(area_attention=8, area_attention_bwd=8),
            "yolov12n train-step launch counts")
    for name, n in counts.items():
        launches[name] += n
    names = list(r["cpu", "float32"]["grads"])

    def whole(a, b):
        return _cos(torch.cat([r[a]["grads"][n].flatten() for n in names]),
                    torch.cat([r[b]["grads"][n].flatten() for n in names]))

    def stats_rel(a, b):  # batch means of activations: max |diff| / max(|ref|, 1)
        return max(float(((r[a]["stats"][n] - t).abs() / t.abs().clamp(min=1.0)).max())
                   for n, t in r[b]["stats"].items())

    # f32: the same arithmetic on both devices up to the order of sums
    # (TF32 off): loss within 1e-4, the whole gradient cosine >= 0.9999, every
    # leaf whose norm is above 1e-3 of the largest (BatchNorm biases ahead of
    # a conv + BatchNorm have gradients that are zero but for rounding)
    # cosine >= 0.999, running statistics within 1e-3
    g32, c32 = r["cuda", "float32"], r["cpu", "float32"]
    rel = abs(g32["metrics"]["loss"] - c32["metrics"]["loss"]) / abs(c32["metrics"]["loss"])
    top = max(float(t.norm()) for t in c32["grads"].values())
    leaf = min(_cos(g32["grads"][n], c32["grads"][n]) for n in names
               if float(c32["grads"][n].norm()) > 1e-3 * top)
    w32, s32 = whole(("cuda", "float32"), ("cpu", "float32")), stats_rel(("cuda", "float32"),
                                                                        ("cpu", "float32"))
    print(f"  f32: loss rel {rel:.2e} (<= 1e-4), whole-gradient cosine {w32:.7f} (>= 0.9999), "
          f"worst leaf cosine {leaf:.5f} (>= 0.999), BN statistics {s32:.2e} (<= 1e-3)")
    require(rel <= 1e-4 and w32 >= 0.9999 and leaf >= 0.999 and s32 <= 1e-3,
            "card vs CPU f32 train step")
    # bf16: at random init the bf16 gradients are noisy (BatchNorm's backward
    # cancels over every position, each layer rounding to bf16): on one card
    # the bf16 and f32 gradients have cosine ~0.8, and the kernels against
    # their plain versions ~0.97 (one-ulp output changes). So: the card's
    # bf16 loss no farther from the CPU's bf16 loss than bf16 rounding moves
    # the loss at all, read on the same weights and batch as the CPU's bf16
    # loss against its f32 loss (with flax's Detect biases the class loss
    # dominates and bf16 moves the loss by ~6%, not the <2% of the zero
    # biases, which a fixed 2e-2 assumed); card vs CPU whole cosine >= 0.8,
    # the card's bf16 gradient no farther from the f32 one than the CPU's
    # bf16 gradient is (by 0.1), and the running statistics within 5%
    gb, cb = r["cuda", "bfloat16"], r["cpu", "bfloat16"]
    rel = abs(gb["metrics"]["loss"] - cb["metrics"]["loss"]) / abs(cb["metrics"]["loss"])
    loss_bound = (abs(cb["metrics"]["loss"] - c32["metrics"]["loss"])
                  / abs(c32["metrics"]["loss"]))
    wb = whole(("cuda", "bfloat16"), ("cpu", "bfloat16"))
    card_f32 = whole(("cuda", "bfloat16"), ("cpu", "float32"))
    cpu_f32 = whole(("cpu", "bfloat16"), ("cpu", "float32"))
    sb = stats_rel(("cuda", "bfloat16"), ("cpu", "bfloat16"))
    print(f"  bf16: loss card {gb['metrics']['loss']:.5f} CPU {cb['metrics']['loss']:.5f} "
          f"(rel {rel:.2e}; bound: the CPU's bf16 loss against its f32 loss "
          f"{c32['metrics']['loss']:.5f}, rel {loss_bound:.2e}); whole-gradient cosine card vs "
          f"CPU {wb:.4f} (>= 0.8); against the f32 gradient: card {card_f32:.4f}, CPU "
          f"{cpu_f32:.4f} (card >= CPU - 0.1); BN statistics {sb:.4f} (< 0.05)")
    require(rel <= loss_bound and wb >= 0.8 and card_f32 >= cpu_f32 - 0.1 and sb < 0.05,
            "card vs CPU bf16 train step")
    # remat: the same bf16 step on the card with every C3k2 and A2C2f block
    # checkpointed. Its forward is the same arithmetic, so the loss and the
    # BatchNorm statistics are equal; the backward recomputes each block (K3
    # launches again, K4 once), its gradient sums may come in another order
    # (cuDNN's weight gradients), so the gradients are held to the f32
    # criteria above, far inside this phase's bf16 card criteria
    rm = run(dev, torch.bfloat16, remat=True)
    print(f"  remat: card launches {rm['counts']} (want area_attention 16: the recomputed "
          f"forward launches K3 again, area_attention_bwd 8)")
    require(rm["counts"] == want(area_attention=16, area_attention_bwd=8),
            "yolov12n remat train-step launch counts")
    for name, n in rm["counts"].items():
        launches[name] += n
    rrel = abs(rm["metrics"]["loss"] - gb["metrics"]["loss"]) / abs(gb["metrics"]["loss"])
    rwhole = _cos(torch.cat([rm["grads"][n].flatten() for n in names]),
                  torch.cat([gb["grads"][n].flatten() for n in names]))
    gtop = max(float(t.norm()) for t in gb["grads"].values())
    rleaf = min(_cos(rm["grads"][n], gb["grads"][n]) for n in names
                if float(gb["grads"][n].norm()) > 1e-3 * gtop)
    stats_equal = all(torch.equal(rm["stats"][n], t) for n, t in gb["stats"].items())
    print(f"  remat vs not: loss rel {rrel:.2e} (<= 1e-4), whole-gradient cosine {rwhole:.7f} "
          f"(>= 0.9999), worst leaf cosine {rleaf:.5f} (>= 0.999), BN statistics equal "
          f"{stats_equal}; peak memory {rm['peak_mib']:.1f} MiB with remat, "
          f"{gb['peak_mib']:.1f} without")
    require(rrel <= 1e-4 and rwhole >= 0.9999 and rleaf >= 0.999 and stats_equal,
            "remat train step equals the plain one on the card")


class StepRecorder:
    """Trainer callbacks: CUDA events and launch counts per step, metrics,
    launch counts of the validation pass, the initial weights."""

    def __init__(self):
        self.events, self.counts, self.metrics = [], [], []
        self.val_counts = None

    def start(self, trainer):
        m = trainer.state.model
        self.p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
        self.b0 = {n: t.detach().clone() for n, t in m.named_buffers() if "running" in n}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        self._event()

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)

    def step(self, trainer, metrics):
        self._event()
        self.counts.append(launch_counts())
        self.metrics.append(metrics)
        zero_counts()

    def val_start(self, trainer):
        self.peak = torch.cuda.max_memory_allocated()
        zero_counts()

    def val_end(self, trainer, metrics):
        self.val_counts = launch_counts()
        self.val_metrics = metrics
        zero_counts()  # the next epoch's first step counts its own launches


WARM_STEPS, TIMED_STEPS = 3, 8


def train_full_width(dev, launches: dict) -> dict:
    """``DetectTrainer(cfg).train()`` for yolov12-p2x@640, batch 8, bf16,
    nc=1, max_boxes 400, remat off, default hyperparameters (the character
    detector of ``kuzu/tools/production.py:512-524``): one epoch of a few
    steps over the synthetic pages, one validation batch, checkpoints saved."""
    import tempfile

    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import trainer_for
    from kuzu_torch.testing import SyntheticDetectionDataset

    steps = WARM_STEPS + TIMED_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(overrides=dict(
            model="yolov12-p2x", imgsz=640, batch=8, dtype="bfloat16", remat=False,
            epochs=1, workers=2, project=tmp, name="p2x", exist_ok=True, save=True))
        train_ds = SyntheticDetectionDataset(8 * steps, 640, max_boxes=400, nc=1, seed=0)
        val_ds = SyntheticDetectionDataset(8, 640, max_boxes=400, nc=1, seed=1)
        trainer = trainer_for((train_ds, val_ds, 1))(cfg, device=dev)
        rec = StepRecorder()
        for ev, fn in (("on_train_start", rec.start), ("on_step_end", rec.step),
                       ("on_val_start", rec.val_start), ("on_val_end", rec.val_end)):
            trainer.callbacks.add(ev, fn)
        t0 = time.perf_counter()
        final = trainer.train()
        wall = time.perf_counter() - t0
        state = trainer.state
        print(f"yolov12-p2x@640 b8 bf16 DetectTrainer.train(): {len(rec.counts)} steps + "
              f"validation in {wall:.1f} s, {sum(p.numel() for p in state.model.parameters())} "
              f"params; final {final}")
        require(len(rec.counts) == steps, "step count")
        per_step = want(area_attention=16, area_attention_bwd=16)
        require(all(c == per_step for c in rec.counts), f"per-step launches {rec.counts[0]} "
                f"(want {per_step})")
        print(f"  launches per step: {rec.counts[0]} (every step); validation: "
              f"{rec.val_counts} (want fused_ablock 16, area_attention 0, nms 1)")
        require(rec.val_counts == want(nms=1, fused_ablock=16), "validation launches")
        for c in rec.counts + [rec.val_counts]:
            for name, n in c.items():
                launches[name] += n
        losses = [float(m["loss"]) for m in rec.metrics]
        norms = [float(m["grad_norm"]) for m in rec.metrics]
        print(f"  losses {[round(x, 3) for x in losses]}\n  grad norms "
              f"{[round(x, 2) for x in norms]}")
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)), "finite losses")
        m = state.model
        ema_moved = max(float((state.ema[n] - p).abs().max()) for n, p in rec.p0.items())
        bn_moved = max(float((t - rec.b0[n]).abs().max())
                       for n, t in m.named_buffers() if "running" in n)
        print(f"  EMA max move {ema_moved:.3e}, BN statistics max move {bn_moved:.3e}, "
              f"val {rec.val_metrics}")
        require(ema_moved > 0 and bn_moved > 0, "EMA and BatchNorm statistics moved")
        sd = trainer.ckpt.restore("last")
        live = m.state_dict()
        same = sd["step"] == state.step and all(
            torch.equal(sd["model"][k], live[k].cpu()) for k in live)
        trainer.ckpt.restore("last", like=state)
        print(f"  last checkpoint: step {sd['step']}, restores equal: {same}; best exists "
              f"{trainer.ckpt.exists('best')}")
        require(same and trainer.ckpt.exists("best"), "last checkpoint restores")

        times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
        timed = times[WARM_STEPS:]
        ms = statistics.median(timed)
        r = dict(ms_per_step=ms, images_per_s=8 / ms * 1e3, step_ms=timed,
                 warmup_ms=times[:WARM_STEPS], peak_gib=rec.peak / 2**30,
                 train_wall_s=wall)
        print(f"  ms/step {ms:.3f} (median of {len(timed)} after {WARM_STEPS} warm-up; "
              f"steps {[round(t, 2) for t in timed]}), {r['images_per_s']:.2f} images/s, "
              f"peak memory {r['peak_gib']:.2f} GiB")
        r["breakdown"] = train_step_breakdown(trainer, train_ds)
    return r


def remat_full_width(dev, launches: dict) -> dict:
    """What ``remat`` buys at the production character detector's width:
    yolov12-p2x@640, batch 8, bf16, nc=1, three train steps (after one
    warm-up) with and without it: ms/step (CUDA events), peak memory, and
    the launch counts (remat: K3 twice per attention call, K4 once)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
    from kuzu_torch.ops.detect_loss import detection_loss
    from kuzu_torch.testing import SyntheticDetectionDataset

    path, scale = resolve_model_spec("yolov12-p2x")
    spec = parse_model_yaml(path, scale=scale, nc=1)
    ds = SyntheticDetectionDataset(8, 640, max_boxes=400, nc=1, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in default_collate([ds[i] for i in range(8)]).items()}
    cfg = load_config(overrides=dict(warmup_epochs=0, epochs=1))
    out = {}
    for remat in (False, True):
        graph = YoloGraph(spec, dtype=torch.bfloat16, remat=remat)
        graph.reset_parameters(torch.Generator().manual_seed(0))
        graph.to(dev)
        tx = build_optimizer(cfg, graph, 1)
        state = TrainState(graph, tx)
        step = make_train_step(lambda model, b: detection_loss(
            model(b["image"]), b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=1, imgsz=640,
            strides=spec.strides, reg_max=spec.reg_max), tx)
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            zero_counts()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            metrics = step(state, batch)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        counts = launch_counts()
        for name, n in counts.items():
            launches[name] += 3 * n
        k3 = 32 if remat else 16
        require(counts == want(area_attention=k3, area_attention_bwd=16),
                f"p2x remat={remat} launch counts {counts}")
        require(bool(np.isfinite(float(metrics["loss"]))), "finite loss")
        out["remat" if remat else "plain"] = dict(
            ms_per_step=statistics.median(times), step_ms=times,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del graph, tx, state, step
        torch.cuda.empty_cache()
    print(f"yolov12-p2x@640 b8 bf16 train step, remat off / on: ms/step "
          f"{out['plain']['ms_per_step']:.3f} / {out['remat']['ms_per_step']:.3f}, peak memory "
          f"{out['plain']['peak_gib']:.2f} / {out['remat']['peak_gib']:.2f} GiB (K3 16 / 32, "
          f"K4 16 / 16 launches per step)")
    return out


def train_step_breakdown(trainer, ds, n: int = 8) -> dict:
    """One training step on ``n`` samples of ``ds`` taken apart: CUDA events
    between its phases (forward, assigner + loss, backward, optimizer +
    EMA) and, under torch.profiler, kernel time by group, with the device's
    idle share."""
    from torch.profiler import ProfilerActivity, profile

    from kuzu_torch.core.train import ema_decay_at, ema_update, global_norm
    from kuzu_torch.data.loader import default_collate

    dev = trainer.device
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in default_collate([ds[i] for i in range(n)]).items()}
    state, model, tx = trainer.state, trainer.state.model, trainer.state.optimizer
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    def step():
        ev[0].record()
        tx.zero_grad()
        feats = model(b["image"])
        ev[1].record()
        loss, _ = trainer.loss_fn(lambda _: feats, b)
        ev[2].record()
        loss.backward()
        ev[3].record()
        grad_norm = global_norm([p.grad for p in tx.params()])
        tx.step(state.step, grad_norm)
        state.step += 1
        ema_update(state.ema, model, ema_decay_at(state.step, 0.9999, 2000.0))
        ev[4].record()

    step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    phases = dict(zip(("forward", "assigner + loss", "backward", "optimizer + EMA"),
                      (a.elapsed_time(c) for a, c in zip(ev[:-1], ev[1:]))))
    groups: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        name = evt.key
        kernels.append((us / 1e3, evt.count, name[:70]))
        low = name.lower()
        if "attn_bwd_" in name:
            group = "K4 area_attention_bwd"
        elif "attention_fwd_kernel" in name:
            group = "K3 area_attention"
        elif "batchnorm" in low or "batch_norm" in low or "welford" in low:
            group = "BatchNorm normalisation (f32)"
        elif any(t in low for t in ("conv", "xmma", "implicit", "cudnn", "gemm", "dgrad",
                                    "wgrad", "nchw", "nhwc")):
            group = "convolutions (cuDNN)"
        elif "foreach" in low or "multi_tensor" in low:
            group = "optimizer + EMA (foreach)"
        else:
            group = "other (elementwise, reductions, copies)"
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    out = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms,
               phases_ms=phases, groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))
    print(f"  profile of one step: wall {wall_ms:.3f} ms, kernels {busy:.3f} ms, device idle "
          f"share {out['idle_share']:.3f}; phases (CUDA events) "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    for group, ms in out["groups_ms"].items():
        print(f"    {group}: {ms:.3f} ms")
    for ms, count, name in sorted(kernels, reverse=True)[:10]:
        print(f"    top kernel {ms:.3f} ms x{count}: {name}")
    return out


RANGES = ("cascade/", "trocr/")  # the port's record_function ranges


def device_breakdown(fn, ranges: str | None = None) -> dict:
    """Kernel time of one call by group (torch.profiler, CUDA activity) and the
    device's idle share of the call's wall time. With ``ranges``, a prefix of
    ``record_function`` names, the host activity is traced too, and each such
    range gives its host time and the device time of the kernels launched
    inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    torch.cuda.synchronize()
    for _ in range(4):  # a session whose trace came back without kernels is taken again
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any((getattr(e, "self_device_time_total", 0) or 0) > 0 for e in prof.key_averages()):
            break
    groups: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us <= 0 or (ranges and evt.device_type == DeviceType.CPU):  # a range's launches
            continue
        if evt.key.startswith(RANGES):  # a range's span on the device, not a kernel
            continue
        name = evt.key
        kernels.append((us / 1e3, evt.count, name[:70]))
        if "gemm::gemm_kernel" in name:  # K2's products (K6 is on no model's path)
            group = "K2 fused_ablock: GEMMs (qk, proj, mlp1, mlp2)"
        elif "attention_fwd_kernel" in name:  # K2's attention; K3 launches the same kernel
            group = "attention_fwd_kernel (K2, K3)"
        elif "attn_f32_fwd_kernel" in name:
            group = "K3 f32 attn_f32_fwd_kernel"
        elif "f32bwd::" in name:
            group = "K4 f32 (dq_kernel, dkdv_kernel)"
        elif "attn_bwd_" in name:
            group = "K4 bf16 (attn_bwd_dq_kernel, attn_bwd_dkdv_kernel)"
        elif "nms_" in name:
            group = "K1 nms"
        elif any(s in name.lower() for s in ("rnn", "lstm")):
            group = "LSTM (cuDNN)"
        elif any(s in name.lower() for s in ("conv", "xmma", "implicit", "cudnn", "gemm")):
            group = "convolutions and products (cuDNN, cuBLAS)"
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
    if ranges:
        stages: dict[str, dict] = {}
        for e in sorted(prof.events(), key=lambda e: e.time_range.start):
            if e.device_type == DeviceType.CPU and e.name.startswith(ranges):
                st = stages.setdefault(e.name[len(ranges):], dict(host_ms=0.0, device_ms=0.0))
                st["host_ms"] += e.time_range.elapsed_us() / 1e3
                st["device_ms"] += e.device_time_total / 1e3
        out["stages"] = stages
        out["host_outside_ranges_ms"] = wall_ms - sum(st["host_ms"] for st in stages.values())
        print(f"  ranges {ranges}*: host ms / device ms of the kernels each launched: "
              + ", ".join(f"{n} {st['host_ms']:.2f} / {st['device_ms']:.2f}"
                          for n, st in stages.items())
              + f"; host time outside them {out['host_outside_ranges_ms']:.2f} ms")
    return out



# ------------------------------------------------------------ phases 6, 7


def flash_phase(dev, launches: dict) -> dict:
    """K5: the kernel against its plain version at the shapes of its entry
    points and over every head width it is built for, planted faults
    against the same tolerance, the entry points' routing, and times beside
    SDPA's forward (a yardstick the port never calls)."""
    from kuzu_torch.ops.flash_attention import (
        FLASH_DS,
        flash_attention,
        flash_attention_auto,
        flash_attention_plain,
        xla_attention,
    )
    from kuzu_torch.testing import ATTN_TOL, attention_over

    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(bh, n, d, dtype, q_scale=1.0):
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev) for _ in range(3))
        return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)

    def over(out, ref, large_logits=False):
        """(max abs error, entries over the tolerance, its name)."""
        if ref.dtype == bf16:  # the attention kernels' shared bf16 tolerance
            err, n_over, _ = attention_over(out, ref)
            return err, n_over, ATTN_TOL
        # 3xTF32 products summed in another order (TF32 off on the plain
        # side); the JAX
        # tests' 2e-5, and 1e-4 with logits scaled by 30
        a = 1e-4 if large_logits else 2e-5
        e = (out.float() - ref.float()).abs()
        return float(e.max()), int((e > a).sum()), f"{a:g}"

    # (label, BH, N, D, dtype, q scale); the first is the kernels line's shape
    cases = [("crossover", 16, 8192, 64, bf16, 1.0), ("area node 6", 384, 400, 32, bf16, 1.0),
             ("f32", 16, 2048, 64, f32, 1.0), ("large logits bf16", 16, 1024, 64, bf16, 30.0),
             ("large logits f32", 2, 128, 64, f32, 30.0)]
    rows, errs = {}, []
    for label, bh, n, d, dtype, q_scale in cases:
        q, k, v = qkv(bh, n, d, dtype, q_scale)
        out = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err, n_over, what = over(out, ref, q_scale != 1.0)
        finite = bool(torch.isfinite(out.float()).all())
        print(f"K5 flash_attention {label} BH={bh} N={n} D={d} {str(dtype)[6:]}: max_abs_err "
              f"{err:.3e} (max|ref| {float(ref.float().abs().max()):.3e}), over "
              f"tolerance ({what}): {n_over}, finite {finite}")
        require(finite and n_over == 0, f"K5 within tolerance, {label}")
        errs.append(err)
        if label == "crossover":
            planted_faults(q, k, v, ref)
        if q_scale != 1.0:
            continue
        # q, k, v read once, o written once; 4 N^2 D operations per head (f32:
        # as 3xTF32)
        if dtype == bf16:
            bnd, by = bound(4 * bh * n * d * 2, 4 * bh * n * n * d, PEAK_BF16)
        else:
            bnd, by = f32_bound(4 * bh * n * d * 4, 4 * bh * n * n * d)
        sd = [t[None] for t in (q, k, v)]  # (1, BH, N, D)
        r = dict(ms=time_ms(lambda: flash_attention(q, k, v)),
                 device_ms=device_ms(lambda: flash_attention(q, k, v)),
                 plain_ms=time_ms(lambda: flash_attention_plain(q, k, v), reps=5, warmup=1),
                 bound_ms=bnd, bound_by=by,
                 library_ms=time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(*sd)),
                 library_device_ms=device_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(*sd)))
        print(f"  {label}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, bound {bnd:.5f} by {by}, SDPA {r['library_ms']:.4f}, "
              f"device {r['library_device_ms']:.4f})")
        rows[label] = r

    # every head width the kernel is built for, in both dtypes, in both
    # regimes: streamed (N=256) and one ragged block (N=400)
    worst = {}
    for dtype in (bf16, f32):
        for d in FLASH_DS:
            for n in (256, 400):
                q, k, v = qkv(4, n, d, dtype)
                err, n_over, what = over(flash_attention(q, k, v), flash_attention_plain(q, k, v))
                require(n_over == 0, f"K5 within tolerance at D={d} N={n} {dtype}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"K5 at BH=4, N in (256, 400), D in {FLASH_DS}: every case within tolerance; "
          f"max_abs_err bf16 {worst[bf16]:.3e}, f32 {worst[f32]:.3e}")

    # the entry point: the kernel exactly once at N=8192, never at N=4096
    q, k, v = qkv(16, 8192, 64, bf16)
    q4, k4, v4 = qkv(16, 4096, 64, bf16)
    zero_counts()
    out = flash_attention_auto(q, k, v)
    torch.cuda.synchronize()
    at_8192 = launch_counts()
    zero_counts()
    out4 = flash_attention_auto(q4, k4, v4)
    torch.cuda.synchronize()
    at_4096 = launch_counts()
    print(f"flash_attention_auto launches: N=8192 {at_8192['flash_attention']} (want 1), "
          f"N=4096 {at_4096['flash_attention']} (want 0)")
    require(at_8192 == want(flash_attention=1) and at_4096 == want(),
            "flash_attention_auto routing")
    require(torch.equal(out, flash_attention(q, k, v)), "auto at N=8192 is the kernel")
    require(torch.equal(out4, xla_attention(q4, k4, v4)), "auto at N=4096 is xla_attention")
    launches["flash_attention"] += at_8192["flash_attention"]
    res = dict(rows["crossover"], max_abs_err=max(errs))
    res["shapes"] = rows
    return res


def planted_faults(q, k, v, ref) -> None:
    """K5's tolerance against faults the kernel could have, each computed
    exactly in f32 and rounded to q's dtype (``kuzu_torch.testing``, shared
    with K3): the last key tile skipped and the scale of the TPU's padded D
    (128^-1/2) must exceed it; P entering P V as one bf16 part, which the
    kernel does, is reported beside them."""
    from kuzu_torch.testing import attention_exact, attention_faults, attention_over

    err, n_over, total = attention_over(
        attention_exact(q, k, v, 1, q.shape[-1] ** -0.5, p_bf16=True), ref)
    print(f"  P as one bf16 part (what the kernel does): max_abs_err {err:.3e}, over "
          f"tolerance {n_over} of {total}")
    for name, out in attention_faults(q, k, v, 1).items():
        err, n_over, total = attention_over(out, ref)
        print(f"  planted fault, {name}: max_abs_err {err:.3e}, over tolerance {n_over} of "
              f"{total} (must be > 0)")
        require(n_over > 0, f"K5's tolerance rejects the fault: {name}")


def k6_against_plain(label: str, o: torch.Tensor, r: torch.Tensor) -> float:
    """K6's output against its plain version's (both f32 views of bf16)."""
    torch.cuda.synchronize()
    err = (o - r).abs()
    # the same rounding points; an f32 sum landing on a bf16 rounding edge
    # flips one ulp and the flip travels down the 16 convs. Random init
    # leaves the activations of deep nodes small, so the tolerance scales
    # with the output: one bf16 ulp of the largest value (2^-7 max|ref|)
    # plus two ulps of the value itself (2^-6 |ref|)
    top = float(r.abs().max())
    tol = 2.0**-7 * top + 2.0**-6 * r.abs()
    ulp = float((err <= 2.0**-7 * r.abs() + 2.0**-9 * top).float().mean())
    same = float((o == r).float().mean())
    print(f"K6 {label}: kernel vs plain max_abs_err {float(err.max()):.3e} (max|ref| "
          f"{top:.3e}), over 2^-7 max|ref| + 2^-6|ref|: {int((err > tol).sum())}, within "
          f"one ulp: {ulp:.6f}, identical {same:.4f}")
    require(top > 0 and bool(torch.isfinite(o).all()) and bool((err <= tol).all()),
            f"K6 {label} within tolerance of its plain version")
    return float(err.max())


C3K2_NODES = (2, 4, 20)  # yolov12x's C3k2 nodes, all c3k=True with n=2
K6_KINDS = {"1x1": 4, "merged 1x1": 2, "3x3": 8}  # K6's conv launches per call, by kind


def k6_launch_times(per_name: dict) -> dict:
    """K6's device time per launch by conv kind, from device_times' per-name
    medians (a call's sum over that kind's launches, over their number)."""
    sums = dict.fromkeys(K6_KINDS, 0.0)
    for name, t in per_name.items():
        if "conv3x3_kernel" in name:
            sums["3x3"] += t
        elif "gemm_kernel<" in name:  # csrc/gemm.cuh's Epi: kConv = 4, kConvMerged = 5
            epi = name.split("gemm_kernel<")[1].split(">")[0].split(",")[1].strip()
            sums["merged 1x1" if epi == "5" else "1x1"] += t
    return {k: sums[k] / n for k, n in K6_KINDS.items()}


def kernel_launch_counts(fn) -> dict:
    """Device kernels launched by one call of fn: {name: count}. A session
    whose trace holds fewer device records than the host made kernel
    launches (the profiler drops records at times, late in a long process
    whole sessions) is taken again, up to eight times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        counts = {e.key: e.count for e in events if e.device_type == DeviceType.CUDA}
        host = sum(e.count for e in events
                   if e.device_type == DeviceType.CPU and "LaunchKernel" in e.key)
        if counts and sum(counts.values()) >= host:
            break
    return counts


def c3k2_phase(dev, det, imgs, launches: dict) -> dict:
    """K6 on the NHWC inputs of yolov12x's C3k2 nodes, captured from one
    forward of the phase-5 detector: the kernel against its plain version
    and both against the executor's node output; times of all three; then
    the same nodes with random BatchNorm statistics, kernel against plain."""
    from kuzu_torch.models.yolo import infer
    from kuzu_torch.ops.fused_c3k2 import (
        N_LAUNCHES,
        c3k2_weights,
        fused_c3k2,
        fused_c3k2_fits,
        fused_c3k2_plain,
    )

    seen = {}
    executor_c3k2 = infer.c3k2

    def capture(p, x, n, c3k_flag, shortcut=True):
        y = executor_c3k2(p, x, n, c3k_flag, shortcut)
        seen[p.path] = (p, x, y, n, c3k_flag)
        return y

    infer.c3k2 = capture
    try:
        det.infer(imgs)
    finally:
        infer.c3k2 = executor_c3k2
    torch.cuda.synchronize()
    nodes = {}
    for idx in C3K2_NODES:
        path = f"n{idx}_C3k2"
        p, x, y, n, flag = seen[path]
        require(flag and n == 2, f"node {idx} is a C3k2 with c3k=True, n=2")
        w = c3k2_weights(det.graph.get_submodule(path))
        xh = x.permute(0, 2, 3, 1)  # channels_last NCHW is contiguous NHWC
        cin, c, hid, c2 = xh.shape[-1], w[0].shape[1] // 2, w[2].shape[1], w[-2].shape[1]
        fits = fused_c3k2_fits(cin, c, hid, c2)
        print(f"K6 node {idx}: x {tuple(xh.shape)} contiguous {xh.is_contiguous()}, c {c}, "
              f"hid {hid}, c2 {c2}: kernel takes it: {fits}")
        if fits:
            nodes[idx] = (p, x, xh.contiguous(), y, w)
    require(len(nodes) > 0, "the kernel takes a yolov12x node")

    zero_counts()
    outs = {idx: fused_c3k2(xh, w) for idx, (_, _, xh, _, w) in nodes.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"fused_c3k2 on nodes {list(nodes)}: launches {counts['fused_c3k2']} "
          f"(want {len(nodes)})")
    require(counts == want(fused_c3k2=len(nodes)), "fused_c3k2 launch counts")
    launches["fused_c3k2"] += counts["fused_c3k2"]

    res, errs = {}, []
    for idx, (p, x, xh, y, w) in nodes.items():
        out = outs[idx]
        plain = fused_c3k2_plain(xh, w)
        execd = y.permute(0, 2, 3, 1)
        o, r = out.float(), plain.float()
        err = k6_against_plain(f"node {idx}", o, r)
        for name, t in (("kernel", o), ("plain", r)):
            # the JAX test's tolerance (tests/test_yolo_infer.py:101-103) and,
            # since it is loose where activations are small, the largest error
            # against the largest output: the executor rounds each conv before
            # its bf16 bias, a few bf16 ulps of the top value (2^-5)
            e = execd.float()
            d = (t - e).abs()
            ok_all = bool((d <= 0.08 + 0.08 * e.abs()).all())
            share = float((d <= 0.05 + 0.05 * e.abs()).float().mean())
            rel_top = float(d.max()) / float(e.abs().max())
            print(f"  {name} vs executor: max_abs_err {float(d.max()):.3e}, within 0.08 + "
                  f"0.08|ref|: {ok_all}, within 0.05 + 0.05|ref|: {share:.6f} (> 0.999), max "
                  f"err / max|ref| {rel_top:.2e} (<= 2^-5)")
            require(ok_all and share > 0.999 and rel_top <= 2.0**-5,
                    f"K6 node {idx}: {name} vs executor")
        errs.append(err)
        m = xh.shape[0] * xh.shape[1] * xh.shape[2]
        flops = 2 * m * sum(t.shape[0] * t.shape[1] for t in w[0::2])
        nbytes = (xh.numel() + out.numel()) * 2 + sum(t.numel() * t.element_size() for t in w)
        bnd, by = bound(nbytes, flops, PEAK_BF16)
        dev_total, dev_split = device_times(lambda: fused_c3k2(xh, w))
        per_launch = k6_launch_times(dev_split)
        counts = kernel_launch_counts(lambda: fused_c3k2(xh, w))
        n_conv = sum(n for name, n in counts.items() if "gemm_kernel" in name
                     or "conv3x3_kernel" in name)
        print(f"  node {idx}: conv launches per call {n_conv} (want {N_LAUNCHES}); device time "
              f"per launch: " + ", ".join(f"{k} {t:.4f} ms" for k, t in per_launch.items()))
        require(n_conv == N_LAUNCHES, f"K6 node {idx}: {N_LAUNCHES} conv launches per call")
        with torch.no_grad():
            r = dict(ms=time_ms(lambda: fused_c3k2(xh, w)),
                     device_ms=dev_total, launch_device_ms=per_launch, conv_launches=n_conv,
                     plain_ms=time_ms(lambda: fused_c3k2_plain(xh, w), reps=3, warmup=1),
                     bound_ms=bnd, bound_by=by, library_ms=None, library_device_ms=None,
                     executor_ms=time_ms(lambda: executor_c3k2(p, x, 2, True)),
                     executor_device_ms=device_ms(lambda: executor_c3k2(p, x, 2, True)))
        print(f"  node {idx}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, executor {r['executor_ms']:.4f}, device "
              f"{r['executor_device_ms']:.4f}, bound {bnd:.5f} by {by})")
        res[idx] = r
    # the same nodes with random BatchNorm statistics and x ~ N(0, 1): the
    # seeded detector's BatchNorm is the identity, so its activations shrink
    # with depth to where SiLU is nearly linear; here each conv's running
    # variance is its output variance for unit inputs (times 0.5-2), so
    # activations stay O(1) through all 16 convs
    import copy

    from kuzu_torch.models.yolo.modules import Conv

    g = torch.Generator().manual_seed(9)
    for idx, (_, _, xh, _, _) in nodes.items():
        mod = copy.deepcopy(det.graph.get_submodule(f"n{idx}_C3k2"))
        with torch.no_grad():
            for conv in (m for m in mod.modules() if isinstance(m, Conv)):
                bn, co = conv.bn, conv.bn.num_features
                w2 = conv.conv.weight.float().pow(2).sum((1, 2, 3)).cpu()
                bn.running_var.copy_(w2 * (0.5 + 1.5 * torch.rand(co, generator=g)))
                bn.running_mean.copy_(0.1 * torch.randn(co, generator=g) * w2.sqrt())
                bn.weight.copy_(0.5 + torch.rand(co, generator=g))
                bn.bias.copy_(0.5 * torch.randn(co, generator=g))
        w = c3k2_weights(mod)
        xr = torch.randn(xh.shape, generator=g).to(dev, torch.bfloat16)
        errs.append(k6_against_plain(f"node {idx}, random BN, x ~ N(0, 1)",
                                     fused_c3k2(xr, w).float(),
                                     fused_c3k2_plain(xr, w).float()))
    first = min(nodes)
    out = dict(res[first], max_abs_err=max(errs),
               device_ms_by_node={i: r["device_ms"] for i, r in res.items()},
               bound_ms_by_node={i: r["bound_ms"] for i, r in res.items()})
    out["nodes"] = res
    return out

# ------------------------------------------------------------------ phase 8

VOCAB = 4783  # characters of the production vocabulary (kuzu/tools/production.py:47-52)
PAGE = 1280  # production page side (kuzu/tools/production.py:41)
CROP = (1024, 64)  # CRNN crop (H, W) of the production CTC run
COL_MAX_DET = 32  # random column heads emit up to 300 a page; ~a dense page's count
# CRNN logits, card against CPU on identical crops, f32 with TF32 off: the
# convs' and the LSTM's sums run in another order (cuDNN, oneDNN) through 8
# convs and 2 x T recurrent steps: 1e-4 of the largest logit
CRNN_TOL = 1e-4


def synthetic_tokenizer(n: int = VOCAB):
    """A tokenizer of the production vocabulary's size: ``n`` CJK ideographs
    from U+4E00, plus the five specials (ids 0-4; blank = pad = 0)."""
    from kuzu_torch.data.tokenizer import CharTokenizer

    return CharTokenizer.train(["".join(chr(0x4E00 + i) for i in range(n))])


def column_windows(n_pages: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """(page index, xyxy window) of one window per column pitch of
    ``column_pages``: crops to calibrate the CRNN's BatchNorm on."""
    pitch = max(size // 16, 12)
    xs = np.arange(size - pitch, pitch // 2, -pitch)
    boxes = np.array([[x - pitch, size // 32, x + 2, size - size // 32] for x in xs], np.float32)
    idx = np.repeat(np.arange(n_pages, dtype=np.int32), len(boxes))
    return idx, np.tile(boxes, (n_pages, 1))


def seeded_crnn(dev, pages: torch.Tensor, crop: tuple[int, int], num_classes: int, seed: int):
    """The production CRNN (dims 64-256, hidden 256, time on the height) on
    ``dev`` with seeded weights (drawn on the CPU), its BatchNorm calibrated
    on 32 column crops of ``pages`` (``calibrate_batch_norm``)."""
    from kuzu_torch.models.crnn import CRNN
    from kuzu_torch.pipeline.device_pages import device_crops
    from kuzu_torch.testing import calibrate_batch_norm

    model = CRNN(num_classes).reset_parameters(torch.Generator().manual_seed(seed)).to(dev)
    idx, boxes = column_windows(min(len(pages), 2), pages.shape[1])
    crops = device_crops(pages.to(dev), torch.from_numpy(idx).to(dev),
                         torch.from_numpy(boxes).to(dev), out_h=crop[0], out_w=crop[1])
    calibrate_batch_norm(model, crops[:32])
    return model


def cascade_pipeline(dev, col, char, crnn, tok, crop, col_max_det: int):
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor
    from kuzu_torch.tasks.detect import DetectPredictor

    return KuzushijiPipeline(
        column_model=DetectPredictor.from_detector(col, conf=CONF, iou=0.7, max_det=col_max_det),
        char_model=DetectPredictor.from_detector(char, conf=CONF, iou=0.7, max_det=2000),
        recognizer=CTCPredictor.from_model(crnn, tok, crop, device=dev),
        tile_grid=2, tile_overlap=0.15, max_det=2000, device=dev)


def _as_dets(results: list[dict]) -> dict:
    """Result columns as padded detections for ``detections_match``."""
    n = max(max(len(r["columns"]) for r in results), 1)
    boxes = np.zeros((len(results), n, 4), np.float32)
    valid = np.zeros((len(results), n), bool)
    for i, r in enumerate(results):
        b = np.asarray([c["box"] for c in r["columns"]], np.float32).reshape(-1, 4)
        boxes[i, :len(b)], valid[i, :len(b)] = b, True
    return {"boxes": boxes, "valid": valid, "classes": np.zeros(valid.shape, np.int32)}


def cascade_card_vs_cpu(dev) -> dict:
    """Phase 8a: the cascade on the card and on the CPU at a small size, the
    same seeded weights and pages: yolov12n columns at 256 (reg_max 32),
    yolov12-p2n characters on 160 px tiles, the production CRNN and
    vocabulary on [256, 32] crops, four 384 px pages. The detectors stay at
    init with ``box_head``'s biases (boxes shaped into columns and
    characters; every anchor scores sigmoid(-4.6), so both devices keep the
    same index-ordered candidates)."""
    import copy

    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.device_pages import device_crops
    from kuzu_torch.testing import box_head, column_pages, detections_match, iou_matrix

    pages = torch.from_numpy(column_pages(4, 384, seed=3))
    crop = (256, 32)
    tok = synthetic_tokenizer()
    crnn_cpu = seeded_crnn("cpu", pages, crop, len(tok), seed=2)
    pipes = {}
    for d, crnn in ((dev, copy.deepcopy(crnn_cpu)), ("cpu", crnn_cpu)):
        col = box_head(YoloDetector("yolov12n", nc=1, imgsz=256, device=d, reg_max=32).init(0),
                       (1, 6, 1, 6))
        char = box_head(YoloDetector("yolov12-p2n", nc=1, imgsz=160, device=d).init(1),
                        (1, 1, 1, 1))
        pipes[d] = cascade_pipeline(d, col, char, crnn, tok, crop, 300)
    card = pipes[dev].process_pages(pages)
    t0 = time.perf_counter()
    cpu = pipes["cpu"].process_pages(pages)
    cpu_s = time.perf_counter() - t0
    cd, gd = _as_dets(cpu), _as_dets(card)
    m1, m2 = detections_match(cd, gd), detections_match(gd, cd)
    ncols = [len(r["columns"]) for r in cpu]
    print(f"cascade card vs CPU (4 pages of 384, CPU run {cpu_s:.1f} s): columns per page "
          f"{ncols} CPU vs {[len(r['columns']) for r in card]} card, matched {m1:.4f} / "
          f"{m2:.4f} (>= 0.9 both ways)")
    require(min(ncols) > 0 and m1 >= 0.9 and m2 >= 0.9, "cascade columns card vs CPU")
    same = total = 0
    for c, g in zip(cpu, card):
        if not c["columns"] or not g["columns"]:
            continue
        iou = iou_matrix(np.asarray([x["box"] for x in c["columns"]], np.float32),
                         np.asarray([x["box"] for x in g["columns"]], np.float32))
        for i, j in enumerate(iou.argmax(1)):
            if iou[i, j] >= 0.5:
                total += 1
                same += c["columns"][i]["text"] == g["columns"][j]["text"]
    share = same / max(total, 1)
    print(f"  texts: {same} of {total} matched columns read the same (>= 0.95); e.g. "
          f"{[len(x['text']) for x in cpu[0]['columns'][:6]]} characters")
    require(total > 0 and share >= 0.95, "cascade texts card vs CPU")
    nch = [len(r["characters"]["boxes"]) for r in cpu]
    gch = [len(r["characters"]["boxes"]) for r in card]
    print(f"  characters per page {nch} CPU vs {gch} card")
    require(min(nch) > 0, "characters found")
    # crops of the CPU run's column windows, on both devices
    idx, win = [], []
    for pi, r in enumerate(cpu):
        b = pipes["cpu"]._column_bounds(tuple(pages.shape[1:3]),
                                        np.asarray([x["box"] for x in r["columns"]]))
        idx += [pi] * len(b)
        win += b
    idx_t, win_t = torch.tensor(idx, dtype=torch.int32), torch.tensor(win, dtype=torch.float32)
    ccrops = device_crops(pages, idx_t, win_t, out_h=crop[0], out_w=crop[1])
    gcrops = device_crops(pages.to(dev), idx_t.to(dev), win_t.to(dev), out_h=crop[0],
                          out_w=crop[1])
    diff = (gcrops.cpu().short() - ccrops.short()).abs()
    exact = float((diff == 0).float().mean())
    print(f"  crops {tuple(ccrops.shape)}: max level difference {int(diff.max())} (<= 1), "
          f"exact share {exact:.6f} (>= 0.999)")
    require(int(diff.max()) <= 1 and exact >= 0.999, "cascade crops card vs CPU")
    with torch.no_grad():
        ref = crnn_cpu(ccrops)[0]
        out = pipes[dev].recognizer.model(ccrops.to(dev))[0].cpu()
    err, top = float((out - ref).abs().max()), float(ref.abs().max())
    print(f"  CRNN logits on identical crops: max abs err {err:.3e} (<= {CRNN_TOL:g} x max|ref| "
          f"= {CRNN_TOL * top:.3e})")
    require(err <= CRNN_TOL * top, "CRNN logits card vs CPU")
    return dict(columns_matched=[m1, m2], texts_same=share, crops_exact=exact, crnn_err=err)


@contextlib.contextmanager
def spy(module, name: str, check):
    """Inside the block, calls of ``module.name`` go to ``check(fn, *args)``
    with the original function ``fn``."""
    fn = getattr(module, name)
    setattr(module, name, lambda *args: check(fn, *args))
    try:
        yield
    finally:
        setattr(module, name, fn)


def k1_keep_mismatches(keep, boxes, valid, thr) -> int:
    """Keep mismatches of ``keep`` against the plain recurrence on every
    image, a few images at a time: its (B, K, K) f32 IoU is 1 GiB an image
    at K=16384."""
    from kuzu_torch.ops.nms_kernel import suppress_reference

    b, k = valid.shape
    step = max(1, 2**31 // (k * k * 4))
    return sum(int((keep[i:i + step] != suppress_reference(boxes[i:i + step], valid[i:i + step],
                                                            thr)).sum())
               for i in range(0, b, step))


def k1_bound(boxes, valid) -> tuple[float, str]:
    """K1's bound on these inputs: boxes and mask read once, keeps written,
    14 operations per pair of valid boxes."""
    nv = valid.sum(1).double()
    return bound(boxes.numel() * 4 + 2 * valid.numel(), 14 * float((nv * (nv - 1) / 2).sum()),
                 PEAK_F32)


def k2_bound(x, weights, area: int) -> tuple[float, str]:
    """K2's bound: x, v, pe read and the output written once, the weights
    read once; the four products and the area attention's two over
    G = B * area chunks of na = N / area tokens."""
    b, n, c = x.shape
    g, na = b * area, n // area
    hid, m = weights[4].shape[1], b * n
    flops = 2 * m * c * (2 * c + c + 2 * hid) + 4 * g * na * na * c
    return bound(4 * m * c * 2 + sum(t.numel() * t.element_size() for t in weights), flops,
                 PEAK_BF16)


def path_kernel_checks(run, shapes: tuple[int, int] = (3, 2), where: str = "the cascade") -> dict:
    """Every K1 and K2 call of one ``run()`` (phase 8b: one
    ``process_pages``) held against its plain version on the inputs the
    path gave it (K1: keeps on every image; K2: ``ablock_over``), then each
    shape's times and bound on the first call's inputs; ``shapes``: the
    number of K1 and K2 shapes the path must show. Launches made here are
    not counted."""
    import kuzu_torch.models.yolo.infer as yolo_infer
    import kuzu_torch.ops.nms as nms_module
    from kuzu_torch.ops.fused_ablock import fused_ablock, fused_ablock_plain
    from kuzu_torch.ops.nms_kernel import batched_suppress, suppress_reference
    from kuzu_torch.testing import ABLOCK_SCALED_TOL, ablock_exact, ablock_faults, ablock_over

    k1: dict[str, dict] = {}
    k2: dict[str, dict] = {}

    def nms_check(fn, boxes, valid, thr):
        keep = fn(boxes, valid, thr)
        key = "B={} K={}".format(*valid.shape)
        if key not in k1:
            k1[key] = dict(calls=0, keep_mismatches=0, valid_per_image_max=0,
                           inputs=(boxes.clone(), valid.clone(), thr))
        r = k1[key]
        r["calls"] += 1
        r["keep_mismatches"] += k1_keep_mismatches(keep, boxes, valid, thr)
        r["valid_per_image_max"] = max(r["valid_per_image_max"], int(valid.sum(1).max()))
        return keep

    def ablock_check(fn, x, v, pe, weights, area, heads):
        out = fn(x, v, pe, weights, area, heads)
        ref = fused_ablock_plain(x, v, pe, weights, area, heads)
        err, over, close = ablock_over(out, ref)
        scale = ablock_exact(x, v, pe, weights, area, heads, scale=True)
        over_scaled = ablock_over(out, ref, scale)[1]
        # the entries over ABLOCK_TOL, their error in bf16 ulps of s
        e, r_ = (out.float() - ref.float()).abs(), ref.float().abs()
        past = e > 0.08 + 0.02 * r_
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0**-126))) - 7)
        key = (f"G={x.shape[0] * area} na={x.shape[1] // area} C={x.shape[2]} h={heads} "
               f"hidden={weights[4].shape[1]}")
        if key not in k2:
            k2[key] = dict(calls=0, max_abs_err=0.0, over=0, over_scaled=0, max_ulps_of_s=0.0,
                           max_s_over_ref=0.0, min_share_close=1.0, max_abs_ref=0.0,
                           inputs=(x.clone(), v.clone(), pe.clone(), weights, area, heads))
        r = k2[key]
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["over"] += over
        r["over_scaled"] += over_scaled
        if over:
            r["max_ulps_of_s"] = max(r["max_ulps_of_s"], float((e / ulp)[past].max()))
            r["max_s_over_ref"] = max(r["max_s_over_ref"],
                                      float((scale / r_.clamp(min=1e-3))[past].max()))
        r["min_share_close"] = min(r["min_share_close"], close)
        r["max_abs_ref"] = max(r["max_abs_ref"], float(out.float().abs().max()))
        require(bool(torch.isfinite(out.float()).all()), f"K2 finite on {where}: {key}")
        return out

    with spy(nms_module, "batched_suppress", nms_check), \
            spy(yolo_infer, "fused_ablock", ablock_check):
        run()
    torch.cuda.synchronize()
    for key, r in k1.items():
        boxes, valid, thr = r.pop("inputs")
        print(f"K1 on {where}, {key}: {r['calls']} call(s), up to {r['valid_per_image_max']} "
              f"valid boxes an image, keep mismatches on every image {r['keep_mismatches']} "
              f"(must be 0)")
        require(r["keep_mismatches"] == 0, f"K1 keeps on {where} at {key}")
        r["bound_ms"], r["bound_by"] = k1_bound(boxes, valid)
        r["device_ms"], _ = device_times(lambda: batched_suppress(boxes, valid, thr), least=5)
        r["ms"] = time_ms(lambda: batched_suppress(boxes, valid, thr), reps=10)
        r["plain_ms"] = time_ms(lambda: suppress_reference(boxes[:2], valid[:2], thr), reps=1,
                                warmup=0)
        print(f"  {r['ms']:.4f} ms, device {r['device_ms']:.4f}, bound {r['bound_ms']:.5f} by "
              f"{r['bound_by']}; plain on 2 images {r['plain_ms']:.2f} ms")
    for key, r in k2.items():
        x, v, pe, weights, area, heads = r.pop("inputs")
        print(f"K2 on {where}, {key}: {r['calls']} call(s), max_abs_err {r['max_abs_err']:.3e}"
              f" (max|out| {r['max_abs_ref']:.3e}), over 0.08 + 0.02|ref|: {r['over']} (their "
              f"error at most {r['max_ulps_of_s']:.2f} bf16 ulps of s, s up to "
              f"{r['max_s_over_ref']:.1f} |ref|), over {ABLOCK_SCALED_TOL}: {r['over_scaled']} "
              f"(must be 0), least share within 0.02 + 0.01|ref|: {r['min_share_close']:.5f} "
              f"(> 0.999)")
        require(r["over_scaled"] == 0 and r["min_share_close"] > 0.999,
                f"K2 on {where} at {key}")
        ref = fused_ablock_plain(x, v, pe, weights, area, heads)
        scale = ablock_exact(x, v, pe, weights, area, heads, scale=True)
        for name, bad in ablock_faults(x, v, pe, weights, area, heads).items():
            _, o, _ = ablock_over(bad, ref, scale)
            _, _, cl = ablock_over(bad, ref)
            print(f"  planted fault on these inputs, {name}: over {o}, share close {cl:.5f} "
                  f"(must fail {ABLOCK_SCALED_TOL})")
            require(o > 0 or cl <= 0.999, f"K2's path tolerance rejects the fault: {name}")
        del ref, scale
        r["bound_ms"], r["bound_by"] = k2_bound(x, weights, area)
        r["device_ms"], _ = device_times(lambda: fused_ablock(x, v, pe, weights, area, heads),
                                         least=5)
        r["ms"] = time_ms(lambda: fused_ablock(x, v, pe, weights, area, heads))
        r["plain_ms"] = time_ms(lambda: fused_ablock_plain(x, v, pe, weights, area, heads),
                                reps=5)
        print(f"  {r['ms']:.4f} ms, device {r['device_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}")
    require((len(k1), len(k2)) == shapes, f"the K1 and K2 shapes on {where}")
    torch.cuda.empty_cache()
    return dict(nms=k1, fused_ablock=k2)


def k1_cross_tile(dev) -> dict:
    """Phase 8c: K1 at the cross-tile NMS shape, B=16 pages, K=16384 (the
    largest candidate bucket of ``tiling._nms_bucket``) on synthetic boxes:
    keeps against the plain recurrence on every image, times and bound."""
    from kuzu_torch.ops.nms_kernel import batched_suppress, suppress_reference

    b, k, thr = 16, 16384, 0.55
    boxes, valid = nms_inputs(dev, b, k, seed=16)
    keep = batched_suppress(boxes, valid, thr)
    mism = k1_keep_mismatches(keep, boxes, valid, thr)
    print(f"K1 nms at the cross-tile shape B={b} K={k}: kept {keep.sum(1)[:4].tolist()}... of "
          f"{valid.sum(1)[:4].tolist()}..., keep mismatches on all {b} images {mism} (must be 0)")
    require(mism == 0, "K1 keeps at K=16384")
    bnd, by = k1_bound(boxes, valid)
    dev_total, split = device_times(lambda: batched_suppress(boxes, valid, thr), least=5)
    r = dict(B=b, K=k, max_abs_err=float(mism),
             ms=time_ms(lambda: batched_suppress(boxes, valid, thr), reps=10),
             device_ms=dev_total,
             mask_device_ms=sum(t for n, t in split.items() if "nms_mask_kernel" in n),
             sweep_device_ms=sum(t for n, t in split.items() if "nms_sweep_kernel" in n),
             plain_ms_2_images=time_ms(lambda: suppress_reference(boxes[:2], valid[:2], thr),
                                       reps=1, warmup=0),
             bound_ms=bnd, bound_by=by)
    print(f"  {r['ms']:.4f} ms, device {dev_total:.4f} (mask {r['mask_device_ms']:.4f}, sweep "
          f"{r['sweep_device_ms']:.4f}), bound {bnd:.4f} by {by}; plain on 2 images "
          f"{r['plain_ms_2_images']:.1f} ms")
    return r


def production_pages() -> torch.Tensor:
    """Phase 8b's 16 seeded pages of 1280 (uint8, on the CPU)."""
    from kuzu_torch.testing import column_pages

    return torch.from_numpy(column_pages(16, PAGE, seed=5))


def production_detectors(dev, pages: torch.Tensor):
    """Phase 8b's detectors: yolov12s columns at 1280 (reg_max 32) and
    yolov12-p2x characters at 640, seeded, BatchNorm calibrated on the first
    pages, box heads biased to tall thin columns and small characters."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.device_pages import device_letterbox, device_tiles
    from kuzu_torch.testing import box_head, calibrate_batch_norm

    on_card = pages[:2].to(dev)
    col = YoloDetector("yolov12s", nc=1, imgsz=PAGE, device=dev, reg_max=32).init(0)
    char = YoloDetector("yolov12-p2x", nc=1, imgsz=640, device=dev).init(1)
    calibrate_batch_norm(col.graph, device_letterbox(on_card, PAGE)[0])
    calibrate_batch_norm(char.graph, device_tiles(on_card[:1], 2, 0.15, 640)[0])
    box_head(col, (1, 6, 1, 6))  # refolds
    box_head(char, (1, 1, 1, 1))
    return col, char


def cascade_full_width(dev, launches: dict) -> dict:
    """Phase 8b: ``process_pages`` at the production configuration: 16 pages
    of 1280 x 1280, yolov12s columns at 1280 (reg_max 32), yolov12-p2x
    characters on 2 x 2 tiles of 640 (max_det 2000, cross-tile NMS iou
    0.55), the CRNN on [1024, 64] crops with 4,788 classes; conf 0.001 for
    both detectors and column max_det 32 (random weights). Seeded weights,
    BatchNorm calibrated on the pages so that detections spread over them,
    box heads biased to tall thin columns and small characters."""
    from kuzu_torch.data.loader import next_bucket
    from kuzu_torch.pipeline.tiling import _nms_bucket

    n_pages = 16
    pages = production_pages()
    tok = synthetic_tokenizer()
    col, char = production_detectors(dev, pages)
    crnn = seeded_crnn(dev, pages, CROP, len(tok), seed=2)
    pipe = cascade_pipeline(dev, col, char, crnn, tok, CROP, COL_MAX_DET)
    for _ in range(2):  # warm-up: cuDNN plans, the allocator
        pipe.process_pages(pages)
    torch.cuda.synchronize()
    zero_counts()
    res = pipe.process_pages(pages)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"cascade at full width, {n_pages} pages of {PAGE}: launches per call {counts} (want "
          f"nms 3: column, tile and cross-tile NMS; fused_ablock 16: p2x's A2C2f blocks at "
          f"640; area_attention 0: yolov12s's attention at 1280 has N = 1600, over both gates)")
    require(counts == want(nms=3, fused_ablock=16), "cascade launch counts")
    for name, n in counts.items():
        launches[name] += n
    ncol = [len(r["columns"]) for r in res]
    nchar = [len(r["characters"]["boxes"]) for r in res]
    ncrop = sum(ncol)
    cand = pipe._detect_tiles_device(pages.to(dev))[0]["valid"].reshape(n_pages, 4, -1).sum((1, 2))
    for r in res:
        b = np.asarray([c["box"] for c in r["columns"]], np.float64).reshape(-1, 4)
        require(bool(np.isfinite(b).all()) and (b >= 0).all() and (b <= PAGE).all(),
                "column boxes inside the page")
        require(all(isinstance(c["text"], str) and "chars" in c for c in r["columns"]),
                "every column has a text and its characters")
    require(min(ncol) > 0 and min(nchar) > 0 and max(nchar) <= 2000,
            "columns and characters on every page")
    stats = dict(columns_per_page=ncol, chars_per_page=nchar,
                 crop_bucket=next_bucket(ncrop, 8),
                 cross_tile_candidates_per_page=cand.tolist(),
                 cross_tile_k=_nms_bucket(int(cand.max())), launches_per_call=counts,
                 text_chars_per_page=[sum(len(c["text"]) for c in r["columns"]) for r in res])
    print(f"  per page: columns (one crop each) {ncol}, characters {nchar}; crops {ncrop} in a "
          f"bucket of "
          f"{stats['crop_bucket']}; cross-tile candidates {stats['cross_tile_candidates_per_page']}"
          f" -> K={stats['cross_tile_k']}")
    stats["path_kernels"] = path_kernel_checks(lambda: pipe.process_pages(pages))
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.process_pages(pages)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    torch.cuda.reset_peak_memory_stats()
    pipe.process_pages(pages)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(stats, ms_per_call=ms, ms_per_call_all=times, pages_per_s=n_pages / ms * 1e3,
               peak_gib=peak)
    print(f"  process_pages: {ms:.2f} ms per {n_pages} pages (median of {len(times)} after 2 "
          f"warm-up: {', '.join(f'{t:.1f}' for t in times)}), {out['pages_per_s']:.2f} pages/s, "
          f"peak memory {peak:.2f} GiB")
    from kuzu_torch.pipeline.cascade import STAGES

    out["breakdown"] = device_breakdown(lambda: pipe.process_pages(pages), ranges="cascade/")
    require(list(out["breakdown"]["stages"]) == list(STAGES), "every cascade stage profiled")
    del crnn
    pipe.recognizer = None
    torch.cuda.empty_cache()
    out["trocr"] = trocr_full_width(dev, pipe, pages, tok, launches)
    return out


# ------------------------------------------------------- phase 8: TrOCR

# TrOCR memory and logits, card against CPU on identical crops, f32 with
# TF32 off: the kernel's online softmax and cuBLAS' sums against the einsum
# path and oneDNN's, through the encoder and decoder: 1e-4 of the largest
# value, as the CRNN's logits
TROCR_TOL = 1e-4


def seeded_trocr(dev, vocab: int, image_size=CROP, enc_depth: int = 6, dec_depth: int = 4,
                 max_len: int = 128, seed: int = 4, decoding: bool = False,
                 encoder_type: str = "vit"):
    """The production TrOCR (encoder 384 wide, 6 heads; decoder 256 wide,
    8 heads; patch 16) at the depths given, seeded (``flax_init_``, drawn on
    the CPU). With ``decoding``, the weights the parity tests shape for
    decoding (``tests/torch_parity.py::jax_trocr_variables``): lm_head x10,
    pos_embed x5, memory_proj x10, EOS a copy of token 18's row 0.5 above,
    so tokens depend on the crop and rows end at different steps."""
    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.trocr import TrOCR

    model = flax_init_(TrOCR(vocab, image_size, enc_depth=enc_depth, dec_depth=dec_depth,
                             max_len=max_len, encoder_type=encoder_type),
                       torch.Generator().manual_seed(seed))
    if decoding:
        dec = model.decoder
        with torch.no_grad():
            dec.lm_head.weight.mul_(10)
            dec.pos_embed.mul_(5)
            dec.memory_proj.weight.mul_(10)
            dec.lm_head.weight[3] = dec.lm_head.weight[18]
            dec.lm_head.bias[3] = dec.lm_head.bias[18] + 0.5
    return model.to(dev).eval()


def trocr_card_vs_cpu(dev, launches: dict) -> dict:
    """Phase 8d: a TrOCR at production widths, 2 + 2 layers, on [256, 64]
    crops (N = 64 patches), max_len 32, with the decoding weights of
    ``seeded_trocr``: the same 16 crops of ``column_pages`` on the card
    (encoder attention through K3's f32 route) and on the CPU (the einsum
    path, as ``attn_impl="auto"`` resolves there): memory, logits and
    greedy tokens. A vocabulary of 64 ids: among 4,788 random classes the
    argmax's lead over the runner-up falls to ~5e-4, inside the logits'
    tolerance, where exact tokens would test rounding; the margin is
    checked."""
    import copy

    from kuzu_torch.models.trocr import greedy_generate
    from kuzu_torch.pipeline.device_pages import device_crops
    from kuzu_torch.testing import column_pages

    tok = synthetic_tokenizer(59)
    cpu = seeded_trocr("cpu", len(tok), (256, 64), 2, 2, max_len=32, decoding=True)
    card = copy.deepcopy(cpu).to(dev)
    pages = torch.from_numpy(column_pages(2, 384, seed=3))
    idx, boxes = column_windows(2, 384)
    crops = device_crops(pages, torch.from_numpy(idx), torch.from_numpy(boxes), out_h=256,
                         out_w=64)[:16]
    zero_counts()
    with torch.no_grad():
        mem_g = card.encode(crops.to(dev))
        torch.cuda.synchronize()
        counts, plain = launch_counts(), plain_counts()
        mem_c = cpu.encode(crops)
    print(f"TrOCR card vs CPU (2 + 2 layers, [256, 64] crops, N = 64, 16 crops): encode "
          f"launches {counts} (want area_attention_f32 2), plain calls on the card "
          f"{sum(plain.values())} (want 0)")
    require(counts == want(area_attention_f32=2) and sum(plain.values()) == 0,
            "TrOCR encoder through K3's f32 route")
    launches["area_attention_f32"] += counts["area_attention_f32"]
    err_m, top_m = float((mem_g.cpu() - mem_c).abs().max()), float(mem_c.abs().max())
    out_c = greedy_generate(cpu, crops, max_len=32)
    steps_c = greedy_generate.steps
    zero_counts()
    out_g = greedy_generate(card, crops.to(dev), max_len=32)
    torch.cuda.synchronize()
    launches["area_attention_f32"] += launch_counts()["area_attention_f32"]
    prev = torch.cat([torch.full((16, 1), tok.bos_id, dtype=torch.long), out_c[:, :-1].long()],
                     1)
    with torch.no_grad():
        lg_c = cpu.decode_tokens(prev, mem_c)
        lg_g = card.decode_tokens(prev.to(dev), mem_g).cpu()
    err_l, top_l = float((lg_g - lg_c).abs().max()), float(lg_c.abs().max())
    ends = [int(np.argmax(r == tok.eos_id)) if (r == tok.eos_id).any() else 32
            for r in out_c.numpy()]
    live = torch.arange(32)[None] <= torch.tensor(ends)[:, None]
    top2 = lg_c.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1])[live].min())
    same = bool(torch.equal(out_g.cpu(), out_c))
    texts = tok.batch_decode(out_c.numpy())
    print(f"  memory max abs err {err_m:.3e} (<= {TROCR_TOL:g} x max|ref| = "
          f"{TROCR_TOL * top_m:.3e}); logits {err_l:.3e} (<= {TROCR_TOL * top_l:.3e}); "
          f"greedy tokens equal {same} (steps {steps_c} CPU, {greedy_generate.steps} card; "
          f"rows end at {ends}; smallest argmax margin {margin:.3e}); text lengths "
          f"{[len(t) for t in texts]}")
    require(err_m <= TROCR_TOL * top_m and err_l <= TROCR_TOL * top_l, "TrOCR card vs CPU")
    require(margin > 10 * TROCR_TOL * top_l, "argmax margins far above the logits' tolerance")
    require(same and greedy_generate.steps == steps_c, "TrOCR greedy tokens card vs CPU")
    return dict(memory_err=err_m, logits_err=err_l, tokens_equal=same, steps=steps_c,
                margin=margin)


def trocr_path_check(pipe, pages) -> dict:
    """Every K3 f32 call of one ``process_pages`` held against its plain
    version on the inputs the path gave it (``ATTN_F32_TOL``), then its times
    at that shape. Launches made here are not counted."""
    import kuzu_torch.models.layers as layers
    from kuzu_torch.ops.flash_attention import area_attention_plain
    from kuzu_torch.testing import ATTN_F32_TOL, attention_f32_over

    calls = []

    def check(fn, q, k, v, heads):
        out = fn(q, k, v, heads)
        ref = area_attention_plain(q, k, v, heads, (q.shape[-1] // heads) ** -0.5)
        err, over, total = attention_f32_over(out, ref)
        calls.append(dict(shape=tuple(q.shape), heads=heads, err=err, over=over,
                          max_ref=float(ref.abs().max())))
        if len(calls) == 1:
            calls[0]["inputs"] = (q.clone(), k.clone(), v.clone())
        return out

    with spy(layers, "area_attention", check):
        pipe.process_pages(pages)
    torch.cuda.synchronize()
    require(len(calls) == 6 and all(c["over"] == 0 for c in calls),
            f"K3 f32 on the path's own inputs within {ATTN_F32_TOL}")
    q, k, v = calls[0].pop("inputs")
    g, n, c = q.shape
    r = dict(calls=calls, **k3_f32_times(q, k, v, calls[0]["heads"]))
    print(f"  K3 f32 on the path's inputs: {len(calls)} calls at {calls[0]['shape']}, "
          f"{calls[0]['heads']} heads, max_abs_err {max(x['err'] for x in calls):.3e} (max|ref| "
          f"up to {max(x['max_ref'] for x in calls):.3e}, over {ATTN_F32_TOL}: 0); "
          f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain {r['plain_ms']:.4f}, bound "
          f"{r['bound_ms']:.5f} by {r['bound_by']}, SDPA f32 {r['library_ms']:.4f}, device "
          f"{r['library_device_ms']:.4f})")
    return r


def trocr_full_width(dev, pipe, pages, tok, launches: dict) -> dict:
    """Phase 8e: the 8b cascade with the TrOCR recognizer at its defaults
    (encoder 384 / 6 layers / 6 heads, decoder 256 / 4 / 8, max_len 128,
    [1024, 64] crops, 4,788 classes, seeded), greedy over every crop: launch
    counts (K3 f32 6 per call: one encode), no plain call, K3 f32 held on the
    path's own inputs, pages/s, peak memory, the stages of one profiled
    call, and the recognizer's encode and decode times with the steps taken
    (random weights never emit EOS: every row runs all 128 steps, the
    decode's upper bound). Then (8f) ``decode="beam"`` and ``"beam_lm"``
    (a seeded CharMLM 256 / 6 / 8 reranking the 4-best, then annotating)
    over the first two pages' crops."""
    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.lm import CharMLM
    from kuzu_torch.models.trocr import beam_generate, greedy_generate
    from kuzu_torch.pipeline.cascade import LM_STAGE, STAGES
    from kuzu_torch.tasks.lm import LMPredictor
    from kuzu_torch.tasks.recognize import RecognizePredictor

    model = seeded_trocr(dev, len(tok))
    pipe.recognizer = RecognizePredictor.from_model(model, tok, CROP, device=dev)
    pipe.rec_task, pipe.decode, pipe.lm = "recognize", "greedy", None
    n_pages = len(pages)
    pipe.process_pages(pages)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    res = pipe.process_pages(pages)
    torch.cuda.synchronize()
    counts, plain = launch_counts(), plain_counts()
    steps = greedy_generate.steps
    print(f"cascade with the TrOCR recognizer, {n_pages} pages of {PAGE}: launches per call "
          f"{counts} (want nms 3, fused_ablock 16, area_attention_f32 6: the encoder's six "
          f"layers), plain calls {sum(plain.values())} (want 0); greedy steps {steps}")
    require(counts == want(nms=3, fused_ablock=16, area_attention_f32=6)
            and sum(plain.values()) == 0, "TrOCR cascade launch counts")
    for name, n in counts.items():
        launches[name] += n
    texts = [c["text"] for r in res for c in r["columns"]]
    require(all(isinstance(t, str) for t in texts) and len(texts) > 0, "a text per column")
    out = dict(launches_per_call=counts, steps=steps, crops=len(texts),
               text_chars_per_page=[sum(len(c["text"]) for c in r["columns"]) for r in res])
    out["path_k3_f32"] = trocr_path_check(pipe, pages)
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.process_pages(pages)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    torch.cuda.reset_peak_memory_stats()
    pipe.process_pages(pages)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out.update(ms_per_call=ms, ms_per_call_all=times, pages_per_s=n_pages / ms * 1e3,
               peak_gib=peak)
    print(f"  process_pages: {ms:.2f} ms per {n_pages} pages (median of 3 after a warm-up: "
          f"{', '.join(f'{t:.1f}' for t in times)}), {out['pages_per_s']:.2f} pages/s, peak "
          f"memory {peak:.2f} GiB")
    out["breakdown"] = device_breakdown(lambda: pipe.process_pages(pages), ranges="cascade/")
    require(list(out["breakdown"]["stages"]) == list(STAGES), "every cascade stage profiled")
    # the recognizer alone on the call's crop batch: encode, then the decode loop
    crops = []
    with spy(pipe, "_decode_crop_batch", lambda fn, images, n: (crops.append(images),
                                                                fn(images, n))[1]):
        pipe.process_pages(pages)
    batch = crops[0]
    encode = torch.no_grad()(model.encode)  # inference: K3 without its row statistics
    enc_ms = time_ms(lambda: encode(batch), reps=3, warmup=1)
    gen_ms = time_ms(lambda: greedy_generate(model, batch, max_len=model.max_len), reps=3,
                     warmup=1)
    out.update(crop_bucket=len(batch), encode_ms=enc_ms, decode_ms=gen_ms - enc_ms,
               decode_ms_per_step=(gen_ms - enc_ms) / greedy_generate.steps)
    print(f"  recognizer on the call's {len(batch)} crops: encode {enc_ms:.2f} ms, decode "
          f"{gen_ms - enc_ms:.2f} ms for {greedy_generate.steps} steps "
          f"({out['decode_ms_per_step']:.3f} ms a step)")
    out["recognizer_breakdown"] = device_breakdown(
        lambda: greedy_generate(model, batch, max_len=model.max_len), ranges="trocr/")

    # 8f: beam and beam_lm over the first two pages' crops
    lm = flax_init_(CharMLM(len(tok)), torch.Generator().manual_seed(6))
    pipe.lm = LMPredictor.from_model(lm, tok, max_len=128, device=dev)
    sub = pages[:2]
    beams = {}
    for decode, lm_mode in (("beam", "off"), ("beam_lm", "annotate")):
        pipe.decode, pipe.lm_mode = decode, lm_mode
        pipe.process_pages(sub)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        r = pipe.process_pages(sub)
        end.record()
        end.synchronize()
        counts = launch_counts()
        require(counts == want(nms=3, fused_ablock=16, area_attention_f32=6),
                f"{decode} cascade launch counts")
        for name, n in counts.items():
            launches[name] += n
        cols = [c for x in r for c in x["columns"]]
        require(all(isinstance(c["text"], str) for c in cols), f"{decode}: a text per column")
        if lm_mode == "annotate":
            require(all(np.isfinite(c["lm_score"]) for c in cols), f"{decode}: lm scores")
        beams[decode] = dict(ms_per_call=start.elapsed_time(end), crops=len(cols),
                             steps=beam_generate.steps, launches_per_call=counts)
        print(f"  {decode} over {len(sub)} pages ({len(cols)} crops, 4 beams): "
              f"{beams[decode]['ms_per_call']:.2f} ms a call, {beam_generate.steps} steps, "
              f"launches {counts}")
    texts = [c["text"] for x in r for c in x["columns"]]
    beams["lm_annotate_ms"] = time_ms(lambda: pipe.rescore_texts(texts), reps=2, warmup=1)
    print(f"  LM annotation ({LM_STAGE} stage) of those {len(texts)} texts: "
          f"{beams['lm_annotate_ms']:.2f} ms")
    out["beam_subset"] = beams
    pipe.lm, pipe.decode = None, "greedy"
    return out


# ------------------------------------------------- phase 11: recognizer training

# Card against CPU, one f32 recognize step, TF32 off: the kernels' sums and
# cuBLAS' against the plain versions' and oneDNN's through 2 + 2 layers,
# the CE, the CTC recursion and the backward: the loss, the CTC term and the
# gradient norm within 1e-4 relative
REC_STEP_TOL = 1e-4
# Phase 12a, card against CPU, f32: each side's encoder gradients are 3e-4
# to 5e-4 from an f64 step's, from the f32 log-space CTC recursion at T =
# 256 and 4,788 classes (with the CTC term in f64, 3e-6 to 9e-6). The
# encoder's gradients within CTC_GRAD_TOL relative: sound 1.77e-4, the
# card's step with TF32 on 1.74e-3 (NVIDIA H100, PR 11)
CTC_GRAD_TOL = 5e-4
CHARS = "".join(chr(0x4E00 + i) for i in range(VOCAB))  # synthetic_tokenizer's characters
# the production LM and recognizer runs (kuzu/tools/production.py:526-538,
# 556-580); epochs, data and the run dirs are the phase's own
LM_RUN = dict(max_length=128, dim=256, depth=6, heads=8, batch=64, lr0=3e-4,
              optimizer="adamw", dtype="bfloat16")
REC_RUN = dict(imgsz=list(CROP), patch=16, enc_dim=384, enc_depth=6, enc_heads=6, dec_dim=256,
               dec_depth=4, dec_heads=8, max_label_length=128, batch=16, optimizer="adamw",
               lr0=3e-4, warmup_epochs=1.0, ctc_weight=0.3, ss_prob=0.25, augment=True,
               dtype="bfloat16")
REC_TEXT_CHARS = (5, 60)  # characters a synthetic crop holds (a column's, under its 64 CTC frames)


def _scale_decoder(model) -> None:
    """``seeded_trocr``'s decoding weights (lm_head x10, pos_embed x5,
    memory_proj x10): argmax margins far above the logits' tolerance, so
    scheduled sampling picks the same tokens on both devices."""
    dec = model.decoder
    with torch.no_grad():
        dec.lm_head.weight.mul_(10)
        dec.pos_embed.mul_(5)
        dec.memory_proj.weight.mul_(10)


def _flat(d: dict) -> torch.Tensor:
    return torch.cat([t.double().flatten() for t in d.values()])


def recognize_card_vs_cpu(dev, launches: dict) -> dict:
    """Phase 11b: one ``RecognizeTrainer`` step at the production widths cut
    to 2 + 2 layers on [256, 64] crops (N = 64 patches, 16 CTC frames), 64
    ids, max_label_length 32, batch 4 (one label with no CTC alignment),
    ``ctc_weight`` 0.3, ``ss_prob`` 0.25 with the same replacement draws on
    both devices, augment off (the devices' generators differ), AdamW: in
    f32 on the card (K3 f32 with lse + K4 f32, 2 + 2 launches) and on the
    CPU (their plain versions on the same route): loss, CTC term, gradient
    norm, gradients and the weights after the update. In bf16 (K3 + K4
    bf16; no replacement on either side, since bf16 rounding may flip an
    argmax): the card's loss no farther from the CPU's bf16 loss than the
    CPU's bf16 loss is from its f32 loss on the same step."""
    import tempfile

    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.layers import MultiHeadAttention
    from kuzu_torch.tasks.recognize import RecognizeTrainer
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    tok = synthetic_tokenizer(59)
    texts = synthetic_texts(3, CHARS[:59], 14, seed=7) + [CHARS[:20]]  # 20 > 16 frames
    ds = SyntheticLineDataset(texts, tok, (256, 64), 32, seed=3)
    batch = default_collate([ds[i] for i in range(4)])
    over = dict(task="recognize", imgsz=[256, 64], patch=16, enc_dim=384, enc_depth=2,
                enc_heads=6, dec_dim=256, dec_depth=2, dec_heads=8, max_label_length=32,
                ctc_weight=0.3, ss_prob=0.25, augment=False, dropout=0.0, optimizer="adamw",
                lr0=3e-4, warmup_epochs=0.0, epochs=1, seed=0, save=False, verbose=False)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = torch.rand((4, 31), generator=torch.Generator().manual_seed(4))
    no_draws = torch.ones((4, 31))  # nothing replaced
    cpu = torch.device("cpu")

    def run(d, dtype, ss, tmp):
        cfg = load_config(overrides={**over, "dtype": dtype, "project": tmp,
                                     "name": f"{d.type}-{dtype}", "exist_ok": True})
        tr = RecognizeTrainer(cfg, device=d)
        tr.tokenizer = tok
        model = tr.build_model()
        _scale_decoder(model)
        if d.type == "cpu":  # the kernel route's plain versions
            for m in model.encoder.modules():
                if isinstance(m, MultiHeadAttention):
                    m.attn_impl = "flash_interpret"
        tr.ss_draws = lambda shape, _rng: ss.to(d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        out = {}
        if dtype == "float32" and ss is draws:  # the first pass's picks and their margins
            with torch.no_grad():
                lg = model.decode_tokens(b["tokens"][:, :-1].long(), model.encode(b["image"]),
                                         train=False).cpu()
            rep = ((ss < 0.25) & (torch.arange(31)[None] > 0)
                   & (batch_t["tokens"][:, :-1] != tok.pad_id))[:, 1:]
            top2 = lg.topk(2, dim=-1)
            out["picks"] = top2.indices[..., 0][:, :-1][rep]
            out["margin"] = float((top2.values[..., 0] - top2.values[..., 1])[:, :-1][rep].min())
        tx = build_optimizer(cfg, model, 1)
        state = TrainState(model, tx)
        p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
        grads = {}
        update = tx.step

        def snapshot_then_step(count, grad_norm):
            grads.update({n: p.grad.detach().double().cpu() for n, p in model.named_parameters()})
            update(count, grad_norm)

        tx.step = snapshot_then_step
        zero_counts()
        metrics = make_train_step(tr.loss_fn, tx)(state, b, torch.Generator(device=d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        out.update(counts=launch_counts(), plain=plain_counts(), grads=grads, p0=p0,
                   p1={n: p.detach().double().cpu() for n, p in model.named_parameters()},
                   metrics={k: float(v) for k, v in metrics.items()},
                   wd=float(cfg.get("weight_decay", 0.0)), clip=float(cfg.get("grad_clip", 10.0)))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        g32, c32 = run(dev, "float32", draws, tmp), run(cpu, "float32", draws, tmp)
        gb, cb, c32n = (run(dev, "bfloat16", no_draws, tmp), run(cpu, "bfloat16", no_draws, tmp),
                        run(cpu, "float32", no_draws, tmp))
    print(f"recognize step card vs CPU (2 + 2 layers, [256, 64] crops, batch 4): card "
          f"launches f32 {g32['counts']}, bf16 {gb['counts']} (want 2 + 2 each), plain calls "
          f"on the card {sum(g32['plain'].values()) + sum(gb['plain'].values())} (want 0), on "
          f"the CPU {c32['plain']}")
    require(g32["counts"] == want(area_attention_f32=2, area_attention_bwd_f32=2)
            and gb["counts"] == want(area_attention=2, area_attention_bwd=2)
            and sum(g32["plain"].values()) + sum(gb["plain"].values()) == 0,
            "recognize step launches on the card")
    require(c32["plain"]["area_attention"] == 2 and c32["plain"]["area_attention_bwd"] == 2,
            "the CPU step takes the kernel route's plain versions")
    for c in (g32["counts"], gb["counts"]):
        for name, n in c.items():
            launches[name] += n
    require(len(c32["picks"]) > 0 and torch.equal(g32["picks"], c32["picks"]),
            "scheduled sampling replaces with the same predictions on both devices")
    gm, cm = g32["metrics"], c32["metrics"]
    rel = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in ("loss", "ctc_loss", "grad_norm")}
    names = list(c32["grads"])
    gcos = _cos(_flat(g32["grads"]), _flat(c32["grads"]))
    # the weights after AdamW: where the step's direction is decided (the
    # clipped gradient plus the decay term |g| >= 1e-4) within 1e-3 of the
    # lr plus 1e-6 of the weight; elsewhere rounding may turn it (within 2 lr)
    lr, factor = over["lr0"], min(1.0, c32["clip"] / cm["grad_norm"])
    worst_decided = worst_any = 0.0
    undecided = total = 0
    for n in names:
        p0, gcpu = c32["p0"][n], c32["grads"][n]
        geff = gcpu * factor + (c32["wd"] * p0 if p0.dim() >= 2 else 0.0)
        ok = geff.abs() >= 1e-4
        diff = (g32["p1"][n] - c32["p1"][n]).abs()
        worst_decided = max(worst_decided, float((diff - 1e-6 * c32["p1"][n].abs())[ok].max())
                            if bool(ok.any()) else 0.0)
        worst_any = max(worst_any, float(diff.max()))
        undecided += int((~ok).sum())
        total += ok.numel()
    ucos = _cos(_flat(g32["p1"]) - _flat(g32["p0"]), _flat(c32["p1"]) - _flat(c32["p0"]))
    print(f"  f32: loss {gm['loss']:.6f} card / {cm['loss']:.6f} CPU, relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (<= {REC_STEP_TOL:g}); whole-gradient cosine {gcos:.7f}; the weights after "
          f"AdamW: decided entries max |diff| - 1e-6|w| {worst_decided:.3e} (<= 1e-3 lr = "
          f"{1e-3 * lr:.1e}), any entry {worst_any:.3e} (<= 2 lr), undecided "
          f"{undecided} of {total}; update cosine {ucos:.7f}; {len(c32['picks'])} inputs "
          f"replaced by the same predictions, smallest argmax margin {c32['margin']:.3e} (CPU), "
          f"{g32['margin']:.3e} (card)")
    require(all(v <= REC_STEP_TOL for v in rel.values()) and worst_decided <= 1e-3 * lr
            and worst_any <= 2 * lr * (1 + 1e-6) and gcos >= 0.9999,
            "card vs CPU f32 recognize step")
    brel = abs(gb["metrics"]["loss"] - cb["metrics"]["loss"]) / abs(cb["metrics"]["loss"])
    bound_ = abs(cb["metrics"]["loss"] - c32n["metrics"]["loss"]) / abs(c32n["metrics"]["loss"])
    print(f"  bf16 (teacher forcing): loss card {gb['metrics']['loss']:.5f}, CPU "
          f"{cb['metrics']['loss']:.5f} (rel {brel:.2e}; bound: the CPU's bf16 loss against "
          f"its f32 loss {c32n['metrics']['loss']:.5f}, rel {bound_:.2e})")
    require(brel <= bound_ and np.isfinite(gb["metrics"]["grad_norm"]),
            "card vs CPU bf16 recognize step")
    return dict(f32_rel=rel, grad_cos=gcos, update_cos=ucos, weights_decided_err=worst_decided,
                weights_any_err=worst_any, bf16_loss_rel=brel, bf16_bound=bound_,
                margin=c32["margin"])


class TrainRecorder(StepRecorder):
    """``StepRecorder`` that also records each step's plain-version calls."""

    def __init__(self):
        super().__init__()
        self.plain = []

    def step(self, trainer, metrics):
        self.plain.append(plain_counts())
        super().step(trainer, metrics)


def _record(trainer) -> "TrainRecorder":
    rec = TrainRecorder()
    for ev, fn in (("on_train_start", rec.start), ("on_step_end", rec.step),
                   ("on_val_start", rec.val_start), ("on_val_end", rec.val_end)):
        trainer.callbacks.add(ev, fn)
    return rec


def _step_times(rec, warm: int) -> dict:
    times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
    return dict(ms_per_step=statistics.median(times[warm:]), step_ms=times[warm:],
                warmup_ms=times[:warm])


def lm_full_width(dev, root) -> dict:
    """Phase 11c, first half: ``LMTrainer(cfg).train()`` at the production
    LM widths (``kuzu/tools/production.py:526-538``: CharMLM 256 / 6 / 8,
    max_length 128, batch 64, AdamW lr0 3e-4, bf16) over a seeded synthetic
    corpus of the 4,788-class vocabulary written to ``root``: 4 steps and
    one validation batch, the run dir written."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.lm import LMTrainer
    from kuzu_torch.testing import synthetic_texts

    tok = synthetic_tokenizer()
    tok.save(root / "tokenizer.json")
    corpus = root / "corpus"
    corpus.mkdir()
    batch, chars = LM_RUN["batch"], LM_RUN["max_length"] - 2
    (corpus / "train.txt").write_text("\n".join(synthetic_texts(batch * 4, CHARS, chars, seed=1,
                                                                min_chars=chars // 6)))
    (corpus / "val.txt").write_text("\n".join(synthetic_texts(batch, CHARS, chars, seed=2,
                                                              min_chars=chars // 6)))
    cfg = load_config(overrides=dict(
        task="lm", data=str(corpus), tokenizer=str(root / "tokenizer.json"), epochs=1,
        workers=2, project=str(root / "runs"), name="lm", exist_ok=True, val_batches=1,
        verbose=False, **LM_RUN))
    trainer = LMTrainer(cfg, device=dev)
    rec = _record(trainer)
    t0 = time.perf_counter()
    final = trainer.train()
    wall = time.perf_counter() - t0
    losses = [float(m["loss"]) for m in rec.metrics]
    r = dict(final=final, losses=losses, wall_s=wall, peak_gib=rec.peak / 2**30,
             **_step_times(rec, 1))
    print(f"LMTrainer CharMLM 256/6/8, 4,788 classes, max_length 128, batch 64, bf16: "
          f"{len(rec.counts)} steps + validation in {wall:.1f} s; ms/step "
          f"{r['ms_per_step']:.3f} (median after a warm-up: {[round(t, 2) for t in r['step_ms']]}), "
          f"peak {r['peak_gib']:.2f} GiB; losses {[round(x, 4) for x in losses]}; final {final}")
    require(len(rec.counts) == 4 and all(np.isfinite(losses))
            and np.isfinite(final.get("masked_acc", np.nan)), "LM trainer steps and validation")
    require(all((trainer.save_dir / f).exists() for f in
                ("args.yaml", "tokenizer.json", "weights/last/state.pt")), "LM run dir")
    r["save_dir"], r["trainer"] = trainer.save_dir, trainer
    return r


def recognize_full_width(dev, root, lm_dir, launches: dict, dtype: str = "bfloat16",
                         steps: int = WARM_STEPS + TIMED_STEPS) -> dict:
    """Phase 11c, second half: ``RecognizeTrainer`` at the production
    recognizer widths (``kuzu/tools/production.py:556-580``: encoder 384 / 6
    / 6 heads, decoder 256 / 4 / 8, max_label_length 128, [1024, 64] crops,
    batch 16, AdamW lr0 3e-4, warmup 1 epoch, ``ctc_weight`` 0.3,
    ``ss_prob`` 0.25, augment on, ``decoder_init`` the LM run) over seeded
    crops of 5-60 characters: ``steps`` steps, then (bf16) one validation
    batch; K3 + K4 launches a step (6 + 6: one per encoder layer) and no
    plain call, ms/step, one profiled step's device time and idle share,
    peak memory; in f32 the same with K3 f32 + K4 f32 and no validation."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.recognize import trainer_for
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    tok = CharTokenizer.load(lm_dir / "tokenizer.json")
    batch, crop, max_len = REC_RUN["batch"], tuple(REC_RUN["imgsz"]), REC_RUN["max_label_length"]
    lo, hi = REC_TEXT_CHARS
    train_ds = SyntheticLineDataset(synthetic_texts(batch * steps, CHARS, hi, seed=3,
                                                    min_chars=lo), tok, crop, max_len, seed=0)
    val_ds = SyntheticLineDataset(synthetic_texts(batch, CHARS, hi, seed=4, min_chars=lo), tok,
                                  crop, max_len, seed=1)
    f32 = dtype == "float32"
    cfg = load_config(overrides=dict(
        REC_RUN, task="recognize", dtype=dtype, epochs=1, decoder_init=str(lm_dir), workers=2,
        project=str(root / "runs"), name=f"rec-{dtype}", exist_ok=True, val=not f32,
        save=not f32, val_batches=1, val_gen_batches=1, verbose=False))
    trainer = trainer_for((train_ds, val_ds, tok))(cfg, device=dev)
    rec = _record(trainer)
    t0 = time.perf_counter()
    final = trainer.train()
    wall = time.perf_counter() - t0
    # the run's weights as its checkpoint holds them (the profiled step below
    # moves the live state on)
    ema = {k: v.detach().clone() for k, v in trainer.state.ema_state_dict().items()}
    depth = REC_RUN["enc_depth"]
    per_step = (want(area_attention_f32=depth, area_attention_bwd_f32=depth) if f32
                else want(area_attention=depth, area_attention_bwd=depth))
    print(f"RecognizeTrainer {dtype} (encoder 384/6/6, decoder 256/4/8, [1024, 64] crops, "
          f"batch 16, decoder_init from the LM run): {len(rec.counts)} steps"
          f"{'' if f32 else ' + validation'} in {wall:.1f} s; launches per step "
          f"{rec.counts[0]} (want {per_step}), plain calls {sum(sum(p.values()) for p in rec.plain)} "
          f"(want 0); final {final}")
    require(len(rec.counts) == steps and all(c == per_step for c in rec.counts)
            and all(sum(p.values()) == 0 for p in rec.plain),
            f"recognize {dtype} per-step launches {rec.counts[0]}")
    for c in rec.counts + ([rec.val_counts] if rec.val_counts else []):
        for name, n in c.items():
            launches[name] += n
    losses = [float(m["loss"]) for m in rec.metrics]
    ctc = [float(m["ctc_loss"]) for m in rec.metrics]
    require(all(np.isfinite(losses)) and all(np.isfinite(ctc)), f"finite {dtype} losses")
    r = dict(final=final, losses=losses, ctc_losses=ctc, wall_s=wall, launches_per_step=per_step,
             **_step_times(rec, WARM_STEPS if steps > WARM_STEPS else 0))
    if not f32:
        require(rec.val_counts == want(area_attention=2 * depth), f"validation launches "
                f"{rec.val_counts} (the teacher-forced pass and the greedy encode)")
        require(all(k in final for k in ("cer", "tf_acc")) and trainer.ckpt.exists("best"),
                "recognize validation and run dir")
        r["peak_gib"] = rec.peak / 2**30
        r["val_launches"] = rec.val_counts
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in default_collate([train_ds[i] for i in range(batch)]).items()}
    r["breakdown"] = device_breakdown(
        lambda: trainer._step(trainer.state, b, trainer.step_rng(trainer.state.step)))
    print(f"  losses {[round(x, 4) for x in losses]}, CTC terms {[round(x, 3) for x in ctc]}; "
          f"ms/step {r['ms_per_step']:.3f} (steps {[round(t, 2) for t in r['step_ms']]}), "
          f"peak {r.get('peak_gib', float('nan')):.2f} GiB")
    r.update(save_dir=trainer.save_dir, trainer=trainer, val_ds=val_ds, ema=ema)
    return r


def run_dirs_cascade(dev, lm, rec, launches: dict) -> dict:
    """Phase 11d: ``KuzushijiPipeline(recognizer=<11c's recognize run dir>,
    lm=<11c's LM run dir>)`` over four synthetic pages of 384 with 8a's
    detectors (yolov12n columns, yolov12-p2n characters at init, boxes
    shaped): greedy texts and LM annotations equal to a pipeline over the
    same weights built in memory (the runs' EMA as trained: one epoch, so
    best is last), and so are the recognizers' teacher-forced logits on
    crops and the LMs' scores of texts with characters; K3 f32 6 launches
    a call (the predictor's TrOCR is f32)."""
    from kuzu_torch.models.lm import CharMLM
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.tasks.lm import LMPredictor
    from kuzu_torch.tasks.recognize import RecognizePredictor, build_trocr
    from kuzu_torch.testing import box_head, column_pages

    pages = torch.from_numpy(column_pages(4, 384, seed=3))
    col = box_head(YoloDetector("yolov12n", nc=1, imgsz=256, device=dev, reg_max=32).init(0),
                   (1, 6, 1, 6))
    char = box_head(YoloDetector("yolov12-p2n", nc=1, imgsz=160, device=dev).init(1),
                    (1, 1, 1, 1))
    dets = dict(column_model=DetectPredictor.from_detector(col, conf=CONF, max_det=300),
                char_model=DetectPredictor.from_detector(char, conf=CONF, max_det=2000),
                tile_grid=2, max_det=2000, device=dev)
    rt, lt = rec["trainer"], lm["trainer"]
    trocr = build_trocr(rt.cfg, len(rt.tokenizer))
    trocr.load_state_dict(rec["ema"])
    charlm = CharMLM(len(lt.tokenizer), max_len=LM_RUN["max_length"], dim=LM_RUN["dim"],
                     depth=LM_RUN["depth"], num_heads=LM_RUN["heads"])
    charlm.load_state_dict(lt.state.ema_state_dict())
    pipes = {
        "run dirs": KuzushijiPipeline(recognizer=rec["save_dir"], lm=lm["save_dir"], **dets),
        "memory": KuzushijiPipeline(
            recognizer=RecognizePredictor.from_model(trocr, rt.tokenizer,
                                                     tuple(REC_RUN["imgsz"]), device=dev),
            lm=LMPredictor.from_model(charlm, lt.tokenizer, max_len=LM_RUN["max_length"],
                                      device=dev), **dets)}
    # beside the cascade's texts (a briefly trained decoder may end every
    # row at once), the loaded weights themselves: teacher-forced logits on
    # crops of the pages and the LM's scores of texts with characters
    val = [rec["val_ds"][i] for i in range(min(8, len(rec["val_ds"])))]
    crops = torch.stack([torch.from_numpy(x["image"]) for x in val]).to(dev)
    tokens = torch.stack([torch.from_numpy(x["tokens"]) for x in val])
    tokens = tokens[:, :-1].long().to(dev)
    texts = [rt.tokenizer.decode(t) for t in tokens.tolist()]
    out, logits, scores = {}, {}, {}
    for label, pipe in pipes.items():
        zero_counts()
        res = pipe.process_pages(pages)
        torch.cuda.synchronize()
        counts = launch_counts()
        require(counts["area_attention_f32"] == REC_RUN["enc_depth"]
                and sum(plain_counts().values()) == 0,
                f"cascade with the {label}: K3 f32 launches {counts}")
        for name, n in counts.items():
            launches[name] += n
        out[label] = [(c["text"], c["lm_score"]) for r in res for c in r["columns"]]
        model = pipe.recognizer.model
        with torch.no_grad():
            logits[label] = model.decode_tokens(tokens, model.encode(crops), train=False).cpu()
        scores[label] = pipe.rescore_texts(texts)
    same = out["run dirs"] == out["memory"]
    same_logits = torch.equal(logits["run dirs"], logits["memory"])
    same_scores = scores["run dirs"] == scores["memory"]
    n_chars = [len(t) for t, _ in out["memory"]]
    print(f"cascade from the run dirs (4 pages of 384): {len(out['memory'])} columns, texts "
          f"and LM scores equal to the in-memory weights' {same}; text lengths "
          f"{n_chars[:12]}...; the recognizers' teacher-forced logits on {len(val)} crops equal "
          f"{same_logits} (max |logit| {float(logits['memory'].abs().max()):.3f}), the LMs' "
          f"scores of {len(texts)} texts of {min(len(t) for t in texts)}-{max(len(t) for t in texts)} "
          f"characters equal {same_scores} ({[round(x, 3) for x in scores['memory'][:4]]})")
    require(len(out["memory"]) > 0 and same and same_logits and same_scores
            and all(np.isfinite(x) for _, x in out["memory"]), "cascade from the run dirs")
    return dict(columns=len(out["memory"]), texts_equal=same, text_chars=n_chars,
                logits_equal=same_logits, lm_scores_equal=same_scores)


def k3_after_k5_check(dev) -> None:
    """Phase 11a: K3's bf16 inference route (the recognizer's validation and
    serving in bf16) at every head width, after K5 (phase 7) launched the
    same ``attention_fwd_kernel<D, kPlain>`` instantiations from its own
    library: each library keeps its own shared-memory attribute (the
    header's internal linkage), against the plain version."""
    from kuzu_torch.ops.flash_attention import FWD_DS, area_attention, area_attention_plain
    from kuzu_torch.testing import attention_over

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for hd in FWD_DS:
        q, k, v = (torch.randn((16, 256, 6 * hd), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        err, over, _ = attention_over(area_attention(q, k, v, 6),
                                      area_attention_plain(q, k, v, 6, hd ** -0.5))
        require(over == 0, f"K3 bf16 inference route at hd={hd} after K5")
        worst = max(worst, err)
    print(f"K3 bf16 inference route after K5's launches, G=16 N=256 6 heads, hd in {FWD_DS}: "
          f"every case within tolerance, max_abs_err {worst:.3e}")


def recognizer_training_phase(dev, launches: dict) -> dict:
    """Phase 11: a, b, c (the LM, then the recognizer in bf16 and two f32
    steps), d; then phases 12 and 14 in the same temporary root (12d
    fine-tunes 11c's bf16 recognize run)."""
    import tempfile
    from pathlib import Path

    k3_after_k5_check(dev)
    out = dict(card_vs_cpu=recognize_card_vs_cpu(dev, launches))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        lm = lm_full_width(dev, root)
        rec = recognize_full_width(dev, root, lm["save_dir"], launches)
        rec32 = recognize_full_width(dev, root, lm["save_dir"], launches, dtype="float32",
                                     steps=2)
        out["run_dirs_cascade"] = run_dirs_cascade(dev, lm, rec, launches)
        torch.cuda.empty_cache()
        out["ctc_training"] = ctc_training_phase(dev, root, rec["save_dir"], launches)
        torch.cuda.empty_cache()
        out["image_file_training"] = image_file_training_phase(
            dev, root, out["ctc_training"]["production_run"], launches)
        for r in (lm, rec, rec32):
            for key in ("trainer", "val_ds", "ema"):
                r.pop(key, None)
            r["save_dir"] = str(r["save_dir"])
    out.update(lm=lm, recognize_bf16=rec, recognize_f32=rec32)
    return out


# ------------------------------------------------------ phase 12: CTC training

# the production CTC run (kuzu/tools/production.py:539-555); epochs, data and
# the run dir are the phase's own
CTC_RUN = dict(imgsz=list(CROP), batch=16, max_label_length=128, dtype="bfloat16",
               optimizer="adamw", lr0=3e-4, warmup_epochs=1.0)
CTC_TEXT_CHARS = (10, 120)  # a column's characters: under the 256 CTC frames with repeats
CTC_EPOCHS, CTC_STEPS = 2, 8  # steps an epoch


def _ctc_trainer(dev, root, name: str, over: dict, data=None):
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.ctc import CTCTrainer, trainer_for

    cfg = load_config(overrides=dict(task="ctc", project=str(root / "runs"), name=name,
                                     exist_ok=True, workers=2, verbose=False, **over))
    return (trainer_for(data) if data else CTCTrainer)(cfg, device=dev)


@contextlib.contextmanager
def _tf32_products():
    """The planted fault of phase 12a: TF32 on for cuBLAS and cuDNN where
    the port asks for full f32 products."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def _planted_tf32():
    """The CRNN's forward and the train step's backward run under
    ``_tf32_products`` instead of ``f32_products``."""
    import kuzu_torch.core.train as ktrain
    import kuzu_torch.models.crnn as kcrnn

    saved = ktrain.f32_products, kcrnn.f32_products
    ktrain.f32_products = kcrnn.f32_products = _tf32_products
    try:
        yield
    finally:
        ktrain.f32_products, kcrnn.f32_products = saved


@contextlib.contextmanager
def _ctc_in_f64():
    """The CTC trainer's loss computes its CTC term in f64 (phase 12a's
    attribution of the f32 gradients' rounding)."""
    import kuzu_torch.tasks.ctc as kctc

    saved = kctc.ctc_loss
    kctc.ctc_loss = lambda logits, *a, **k: saved(logits.double(), *a, **k)
    try:
        yield
    finally:
        kctc.ctc_loss = saved


def _ulp32(w: torch.Tensor) -> torch.Tensor:
    """One f32 ulp of each weight: the spacing above |w|."""
    a = w.float().abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def _update_err(a: dict, b: dict, net: bool = True) -> float:
    """The weights after the update, a against b: max |p1_a - p1_b| over
    the largest entry of b's update; ``net`` of one f32 ulp of each weight
    (the rounding of the update into f32 storage)."""
    pa, pb = _flat(a["p1"]), _flat(b["p1"])
    d = (pa - pb).abs()
    if net:
        d = (d - _ulp32(pb)).clamp(min=0.0)
    return float(d.max() / (pb - _flat(b["p0"])).abs().max())


def _largest_update_diff(a: dict, b: dict) -> str:
    """Where the weights after the update differ most: the tensor, the
    weight, the difference in f32 ulps of the weight."""
    pa, pb = _flat(a["p1"]), _flat(b["p1"])
    i = int((pa - pb).abs().argmax())
    for name, t in b["p1"].items():
        if i < t.numel():
            w = t.flatten()[i]
            diff = (a["p1"][name].flatten()[i] - w).abs()
            return f"{name} weight {float(w):.4e}, {float(diff / _ulp32(w)):.2f} ulp"
        i -= t.numel()
    raise AssertionError("index past the weights")


def _grad_err(a: dict, b: dict, names) -> float:
    """|g_a - g_b| / |g_b| over the gradients ``names``."""
    ga, gb = _flat({n: a["grads"][n] for n in names}), _flat({n: b["grads"][n] for n in names})
    return float((ga - gb).norm() / gb.norm())


def ctc_step_card_vs_cpu(dev, root) -> dict:
    """Phase 12a: one ``CTCTrainer`` step at the production widths (CRNN
    64 / 128 / 256 / 256, hidden 256, 4,788 classes, [1024, 64] crops) with
    the box head (4 boxes), batch 2, on the card and on the CPU from the
    same seeded weights and the same jitter draws (drawn on the CPU, handed
    to both).

    f32, once with ``optimizer=adamw`` and once with ``radam``: the loss,
    the box term and the gradient norm within ``REC_STEP_TOL`` relative, the
    whole-gradient cosine (11b's gates), the encoder's gradients within
    ``CTC_GRAD_TOL``; adamw's weights where the step's direction is decided
    within 1e-3 of the lr plus 1e-6 of the weight, elsewhere within 2 lr;
    radam's first update (lr times the clipped, decayed gradient, so it
    carries the f32 gradients' rounding): the weights after it within
    ``REC_STEP_TOL`` of the update's largest entry, net of one f32 ulp of
    each weight (their storage). The radam pass reads both sides against the same step in
    f64 on the CPU (the truth), finds where their f32 rounding comes from
    (the CTC loss alone in f32 against f64; the step with the CTC term in
    f64 on both sides), and runs a planted fault (the card's step with TF32
    on where the port asks for full f32 products), which must read above
    both bounds.

    bf16 (the production dtype), adamw: the card's loss no farther from the
    CPU's bf16 loss than the CPU's bf16 loss is from its f32 loss (11b's
    gate), and a finite gradient norm."""
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.crnn import ctc_frames
    from kuzu_torch.ops.ctc import ctc_loss, pack_labels
    from kuzu_torch.ops.images import from_uint8, photometric_draws, photometric_from_draws
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    tok = synthetic_tokenizer()
    ds = SyntheticLineDataset(synthetic_texts(2, CHARS, 120, seed=8, min_chars=60), tok, CROP,
                              128, seed=2, max_boxes=4)
    batch = default_collate([ds[i] for i in range(2)])
    x = from_uint8(torch.from_numpy(batch["image"]))
    draws = photometric_draws(x, torch.Generator().manual_seed(9))
    cpu = torch.device("cpu")
    seconds = {}

    def run(d, optimizer, dtype="float32", f64=False):
        tag = "f64" if f64 else dtype
        tr = _ctc_trainer(d, root, f"step-{d.type}-{optimizer}-{tag}", dict(
            imgsz=list(CROP), max_boxes=4, max_label_length=128, dtype=dtype,
            optimizer=optimizer, lr0=3e-4, warmup_epochs=0.0, epochs=1, save=False))
        tr.tokenizer = tok
        model = tr.build_model()
        if f64:  # the same step in f64 arithmetic, from the same f32 weights and crops
            model.double()
            model.dtype = model.encoder.dtype = torch.float64
        dd = [t.to(d) for t in draws]
        tr.aug_images = lambda images, rng: (photometric_from_draws(from_uint8(images), *dd)
                                             - 0.5) / 0.5
        tx = build_optimizer(tr.cfg, model, 1)
        state = TrainState(model, tx)
        p0 = {n: p.detach().double().cpu().clone() for n, p in model.named_parameters()}
        grads = {}
        update = tx.step

        def snapshot_then_step(count, grad_norm):  # clipping scales .grad in place
            grads.update({n: p.grad.detach().double().cpu().clone()
                          for n, p in model.named_parameters() if p.grad is not None})
            update(count, grad_norm)

        tx.step = snapshot_then_step
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        metrics = make_train_step(tr.loss_fn, tx)(state, b, torch.Generator(device=d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        seconds[f"{d.type} {optimizer} {tag}"] = time.perf_counter() - t0
        return dict(p0=p0, grads=grads, metrics={k: float(v) for k, v in metrics.items()},
                    p1={n: p.detach().double().cpu().clone() for n, p in model.named_parameters()},
                    wd=float(tr.cfg.get("weight_decay", 0.0)),
                    clip=float(tr.cfg.get("grad_clip", 10.0)), lr=float(tr.cfg.lr0))

    def ctc_rounding(d) -> float:
        """F.ctc_loss alone (``ops/ctc.py::ctc_loss``) on seeded near-uniform
        logits of the step's shape and the batch's labels: the gradient's
        f32 distance from its f64 gradient, relative."""
        labels, lens = pack_labels(torch.from_numpy(batch["tokens"]).long())
        t = ctc_frames(CROP[0])
        logits = torch.randn((2, t, len(tok)), generator=torch.Generator().manual_seed(10),
                             dtype=torch.float64) * 0.1
        g = []
        for dt in (torch.float32, torch.float64):
            z = logits.to(d, dt).requires_grad_()
            ctc_loss(z, labels.to(d), torch.full_like(lens, t).to(d), lens.to(d),
                     reduction="none").sum().backward()
            g.append(z.grad.double().cpu())
        return float((g[0] - g[1]).norm() / g[1].norm())

    out = {}
    f32_cpu = {}
    for optimizer in ("adamw", "radam"):
        g, c = run(dev, optimizer), run(cpu, optimizer)
        f32_cpu[optimizer] = c
        gm, cm = g["metrics"], c["metrics"]
        rel = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in ("loss", "box_loss", "grad_norm")}
        gcos = _cos(_flat(g["grads"]), _flat(c["grads"]))
        conv = [n for n in c["grads"] if n.startswith("encoder.")]
        groups = (("encoder", conv), ("LSTM and heads", [n for n in c["grads"]
                                                         if n not in conv]))
        group_diff = {k: _grad_err(g, c, ns) for k, ns in groups}
        ucos = _cos(_flat(g["p1"]) - _flat(g["p0"]), _flat(c["p1"]) - _flat(c["p0"]))
        lr, factor = c["lr"], min(1.0, c["clip"] / cm["grad_norm"])
        r = dict(rel=rel, grad_diff=group_diff, grad_cos=gcos, update_cos=ucos)
        if optimizer == "adamw":
            worst = worst_any = 0.0
            for n in c["grads"]:
                p0 = c["p0"][n]
                geff = c["grads"][n] * factor + (c["wd"] * p0 if p0.dim() >= 2 else 0.0)
                ok = geff.abs() >= 1e-4
                diff = (g["p1"][n] - c["p1"][n]).abs()
                if bool(ok.any()):
                    worst = max(worst, float((diff - 1e-6 * c["p1"][n].abs())[ok].max()))
                worst_any = max(worst_any, float(diff.max()))
            weights_ok = worst <= 1e-3 * lr and worst_any <= 2 * lr * (1 + 1e-6)
            detail = (f"decided entries max |diff| - 1e-6|w| {worst:.3e} (<= {1e-3 * lr:.1e}), "
                      f"any {worst_any:.3e} (<= 2 lr)")
        else:
            t = run(cpu, optimizer, f64=True)
            with _planted_tf32():
                fault = run(dev, optimizer)
            with _ctc_in_f64():
                g64, c64 = run(dev, optimizer), run(cpu, optimizer)
            worst, fault_err = _update_err(g, c), _update_err(fault, c)
            raw = _update_err(g, c, net=False)
            fault_diff = {k: _grad_err(fault, c, ns) for k, ns in groups}
            truth = {side: dict({k: _grad_err(a, t, ns) for k, ns in groups},
                                update=_update_err(a, t))
                     for side, a in (("card", g), ("CPU", c), ("card, TF32", fault),
                                     ("card, CTC in f64", g64), ("CPU, CTC in f64", c64))}
            ctc_f32 = {"card": ctc_rounding(dev), "CPU": ctc_rounding(cpu)}
            ctc64_diff = {k: _grad_err(g64, c64, ns) for k, ns in groups}
            weights_ok = (worst <= REC_STEP_TOL < fault_err
                          and CTC_GRAD_TOL < fault_diff["encoder"])
            detail = (f"weights after the update: max |diff| net of 1 ulp {worst:.3e} of the "
                      f"update's largest entry (<= {REC_STEP_TOL:g}); without the ulp {raw:.3e} "
                      f"(at {_largest_update_diff(g, c)})"
                      f"\n  the truth, an f64 CPU step: |g - g64| / |g64| by group, the "
                      f"weights after the update (net of 1 ulp): " + "; ".join(
                          f"{side} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
                          for side, e in truth.items())
                      + "\n  the source: the CTC loss alone (seeded logits of the step's shape), "
                      "its logits' gradient f32 against f64: "
                      + ", ".join(f"{k} {v:.2e}" for k, v in ctc_f32.items())
                      + "; the step with the CTC loss in f64 on both sides: |g_card - g_cpu| / "
                      "|g_cpu| " + ", ".join(f"{k} {v:.2e}" for k, v in ctc64_diff.items())
                      + f"\n  planted fault (TF32 on in the card's step): encoder "
                      f"{fault_diff['encoder']:.2e} (> {CTC_GRAD_TOL:g}), LSTM and heads "
                      f"{fault_diff['LSTM and heads']:.2e}, update {fault_err:.3e} (> "
                      f"{REC_STEP_TOL:g})")
            r.update(fault_err=fault_err, raw_update_err=raw, fault_grad_diff=fault_diff, f64=truth,
                     ctc_f32=ctc_f32, ctc_f64_grad_diff=ctc64_diff)
        r["weights_err"] = worst
        print(f"CTC step card vs CPU ({optimizer}, f32, production widths, [1024, 64] crops, "
              f"batch 2, box head): loss {gm['loss']:.6f} / {cm['loss']:.6f}, relative "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (<= {REC_STEP_TOL:g}); gradient cosine {gcos:.7f} (>= 0.9999), "
              f"|g_card - g_cpu| / |g_cpu| by group "
              + ", ".join(f"{k} {v:.2e}" for k, v in group_diff.items())
              + f" (encoder <= {CTC_GRAD_TOL:g}); update cosine {ucos:.7f}; {detail}")
        require(all(v <= REC_STEP_TOL for v in rel.values()) and gcos >= 0.9999 and weights_ok
                and group_diff["encoder"] <= CTC_GRAD_TOL and ucos >= 0.9999,
                f"card vs CPU f32 CTC step ({optimizer})")
        out[optimizer] = r
    gb, cb = run(dev, "adamw", "bfloat16"), run(cpu, "adamw", "bfloat16")
    c32 = f32_cpu["adamw"]["metrics"]["loss"]
    brel = abs(gb["metrics"]["loss"] - cb["metrics"]["loss"]) / abs(cb["metrics"]["loss"])
    bound_ = abs(cb["metrics"]["loss"] - c32) / abs(c32)
    bcos = _cos(_flat(gb["grads"]), _flat(cb["grads"]))
    print(f"CTC step card vs CPU (adamw, bf16): loss card {gb['metrics']['loss']:.6f}, CPU "
          f"{cb['metrics']['loss']:.6f} (rel {brel:.2e}; bound: the CPU's bf16 loss against its "
          f"f32 loss {c32:.6f}, rel {bound_:.2e}); gradient norm card "
          f"{gb['metrics']['grad_norm']:.4e}, CPU {cb['metrics']['grad_norm']:.4e}; gradient "
          f"cosine {bcos:.6f}")
    require(brel <= bound_ and np.isfinite(gb["metrics"]["grad_norm"]),
            "card vs CPU bf16 CTC step")
    out["bf16"] = dict(loss_rel=brel, bound=bound_, grad_cos=bcos)
    print("  phase 12a step seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    out["seconds"] = seconds
    return out


def ctc_full_width(dev, root) -> dict:
    """Phase 12b: the production CTC run on the card (``CTC_RUN``: bf16,
    [1024, 64] crops, batch 16, max_label_length 128, adamw lr0 3e-4,
    warmup 1 epoch; the CRNN 64-256 / 256 with 4,788 classes) over seeded
    crops of 10-120 characters: 2 epochs of 8 steps, validation each epoch
    (16 crops), the run dir written. ms/step, one profiled step's device
    time and idle share, peak memory, CER. No kernel of the port is on this
    path: the launch counts are all zero."""
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    tok = synthetic_tokenizer()
    batch, lo, hi = CTC_RUN["batch"], *CTC_TEXT_CHARS
    train_ds = SyntheticLineDataset(synthetic_texts(batch * CTC_STEPS, CHARS, hi, seed=5,
                                                    min_chars=lo), tok, CROP, 128, seed=3)
    val_ds = SyntheticLineDataset(synthetic_texts(batch, CHARS, hi, seed=6, min_chars=lo), tok,
                                  CROP, 128, seed=4)
    trainer = _ctc_trainer(dev, root, "ctc", dict(CTC_RUN, epochs=CTC_EPOCHS, val_batches=1),
                           (train_ds, val_ds, tok))
    rec = _record(trainer)
    emas, fits = [], []  # each epoch's EMA and fitness: the run dir's best is the last best
    trainer.callbacks.add("on_checkpoint_save", lambda t: emas.append(
        {k: v.detach().clone() for k, v in t.state.ema_state_dict().items()}))
    trainer.callbacks.add("on_val_end", lambda t, m: fits.append(m.get("fitness")))
    t0 = time.perf_counter()
    final = trainer.train()
    wall = time.perf_counter() - t0
    steps = CTC_EPOCHS * CTC_STEPS
    losses = [float(m["loss"]) for m in rec.metrics]
    require(len(rec.counts) == steps and all(np.isfinite(losses))
            and all(sum(c.values()) == 0 for c in rec.counts)
            and all(sum(p.values()) == 0 for p in rec.plain), "CTC trainer steps")
    require(all(k in final for k in ("cer", "fitness")) and trainer.ckpt.exists("best")
            and (trainer.save_dir / "tokenizer.json").exists(), "CTC validation and run dir")
    best = max(range(len(fits)), key=lambda i: (fits[i], i))  # ties: the later, as the save
    r = dict(final=final, losses=losses, wall_s=wall, peak_gib=rec.peak / 2**30,
             fitness_per_epoch=fits, **_step_times(rec, WARM_STEPS))
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in default_collate([train_ds[i] for i in range(batch)]).items()}
    r["breakdown"] = device_breakdown(
        lambda: trainer._step(trainer.state, b, trainer.step_rng(trainer.state.step)))
    print(f"CTCTrainer, the production run (bf16, CRNN 64-256 / 256, 4,788 classes, "
          f"[1024, 64] crops, batch 16, adamw lr0 3e-4, warmup 1 epoch): {steps} steps + "
          f"{CTC_EPOCHS} validations in {wall:.1f} s; ms/step {r['ms_per_step']:.3f} (median "
          f"after {WARM_STEPS} warm-up: {[round(t, 2) for t in r['step_ms']]}), peak "
          f"{r['peak_gib']:.2f} GiB; losses {[round(x, 3) for x in losses]}; CER per epoch "
          f"{[round(1 - f, 4) for f in fits]}; final {final}")
    r.update(save_dir=trainer.save_dir, trainer=trainer, ema=emas[best], val_ds=val_ds)
    return r


def ctc_run_dir_cascade(dev, ctc: dict, launches: dict) -> dict:
    """Phase 12c: ``KuzushijiPipeline(recognizer=<12b's run dir>)`` over
    phase 8b's 16 pages of 1280 with 8b's detectors, against the same
    cascade with ``CTCPredictor.from_model`` over 12b's best EMA weights in
    memory (an f32 CRNN, as the predictor builds it): the same columns,
    characters and texts, and the two CRNNs' logits on 8 crops; K1 3 + K2
    16 launches a call; pages/s."""
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor, build_crnn
    from kuzu_torch.tasks.detect import DetectPredictor

    pages = production_pages()
    col, char = production_detectors(dev, pages)
    tr = ctc["trainer"]
    crnn = build_crnn(tr.cfg, len(tr.tokenizer))
    crnn.load_state_dict(ctc["ema"])
    dets = dict(column_model=DetectPredictor.from_detector(col, conf=CONF, iou=0.7,
                                                           max_det=COL_MAX_DET),
                char_model=DetectPredictor.from_detector(char, conf=CONF, iou=0.7, max_det=2000),
                tile_grid=2, tile_overlap=0.15, max_det=2000, device=dev)
    pipes = {"run dir": KuzushijiPipeline(recognizer=ctc["save_dir"], **dets),
             "memory": KuzushijiPipeline(recognizer=CTCPredictor.from_model(
                 crnn, tr.tokenizer, CROP, device=dev), **dets)}
    val = ctc["val_ds"]
    crops = torch.stack([torch.from_numpy(val[i]["image"])
                         for i in range(min(8, len(val)))]).to(dev)
    out, ms, logits = {}, {}, {}
    for label, pipe in pipes.items():
        pipe.process_pages(pages)  # warm-up (and the run dir's load)
        with torch.no_grad():  # beside the texts (a briefly trained CRNN emits blanks)
            logits[label] = pipe.recognizer.model(crops)[0]
        torch.cuda.synchronize()
        zero_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = pipe.process_pages(pages)
        end.record()
        end.synchronize()
        ms[label] = start.elapsed_time(end)
        counts = launch_counts()
        require(counts == want(nms=3, fused_ablock=16) and sum(plain_counts().values()) == 0,
                f"cascade with the CTC {label}: launches {counts}")
        for name, n in counts.items():
            launches[name] += n
        out[label] = [(r["columns"], r["characters"]) for r in res]
    require(pipes["run dir"].rec_task == "ctc", "the run dir routes to the CTC predictor")

    def flat(res):
        cols = [(tuple(np.round(c["box"], 4)), c["text"]) for r in res for c in r[0]]
        chars = [np.asarray(r[1]["boxes"]).tobytes() for r in res]
        return cols, chars

    same = flat(out["run dir"]) == flat(out["memory"])
    same_logits = torch.equal(logits["run dir"], logits["memory"])
    n_cols = sum(len(r[0]) for r in out["memory"])
    text_chars = sum(len(c["text"]) for r in out["memory"] for c in r[0])
    pps = {k: 16 / v * 1e3 for k, v in ms.items()}
    print(f"cascade with the CTC run dir (16 pages of 1280): {n_cols} columns, {text_chars} "
          f"characters of text; columns, characters and texts equal to the in-memory "
          f"weights' {same}, the CRNNs' logits on {len(crops)} crops equal {same_logits} "
          f"(max |logit| "
          f"{float(logits['memory'].abs().max()):.3f}); {ms['run dir']:.1f} / "
          f"{ms['memory']:.1f} ms a call, pages/s {pps['run dir']:.2f} / {pps['memory']:.2f} "
          f"(run dir / memory, one call each)")
    require(same and same_logits and n_cols > 0, "cascade from the CTC run dir")
    return dict(columns=n_cols, text_chars=text_chars, equal=same, logits_equal=same_logits,
                ms_per_call=ms, pages_per_s=pps)


def lora_recognize(dev, root, rec_dir, launches: dict) -> dict:
    """Phase 12d: ``RecognizeTrainer`` with ``pretrained=<phase 11's bf16
    recognize run>`` and ``lora_rank=8`` (REC_RUN's widths, bf16) for 2
    steps: every base weight bit-equal to the pretrained one, every adapter
    moved, K3 + K4 bf16 6 + 6 launches a step (the training route); the
    LoRA run dir in ``RecognizePredictor`` decodes the tokens of the merged
    EMA built in memory (K3 f32 in both: the predictor is f32)."""
    from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.lora import LoRAModel
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.recognize import RecognizePredictor, build_trocr, trainer_for
    from kuzu_torch.testing import SyntheticLineDataset, synthetic_texts

    tok = CharTokenizer.load(rec_dir / "tokenizer.json")
    batch, max_len = REC_RUN["batch"], REC_RUN["max_label_length"]
    lo, hi = REC_TEXT_CHARS
    ds = SyntheticLineDataset(synthetic_texts(batch * 2, CHARS, hi, seed=9, min_chars=lo), tok,
                              CROP, max_len, seed=5)
    cfg = load_config(overrides=dict(
        REC_RUN, task="recognize", epochs=1, pretrained=str(rec_dir), lora_rank=8, workers=2,
        project=str(root / "runs"), name="rec-lora", exist_ok=True, val=False, verbose=False))
    trainer = trainer_for((ds, ds, tok))(cfg, device=dev)
    rec = _record(trainer)
    trainer.train()
    model = trainer.state.model
    require(isinstance(model, LoRAModel) and len(rec.counts) == 2, "LoRA recognize run")
    depth = REC_RUN["enc_depth"]
    per_step = want(area_attention=depth, area_attention_bwd=depth)
    require(all(c == per_step for c in rec.counts) and all(sum(p.values()) == 0
                                                            for p in rec.plain),
            f"LoRA step launches {rec.counts}")
    for c in rec.counts:
        for name, n in c.items():
            launches[name] += n
    pre = load_inference_params(CheckpointManager(rec_dir / "weights"))
    base_equal = all(torch.equal(p, rec.p0[f"base.{n}"]) and torch.equal(p.cpu(), pre[n])
                     for n, p in model.base.named_parameters())
    moved = [not torch.equal(m.a, rec.p0[f"lora.{k}.a"]) and not torch.equal(
        m.b, rec.p0[f"lora.{k}.b"]) for k, m in model.lora.items()]
    trocr = build_trocr(cfg, len(tok))
    trocr.load_state_dict(trainer.state.ema_state_dict())
    crops = torch.stack([torch.from_numpy(ds[i]["image"]) for i in range(8)]).to(dev)
    mem = RecognizePredictor.from_model(trocr, tok, CROP, device=dev)._fwd(crops)
    run = RecognizePredictor(load_config(overrides={"model": str(trainer.save_dir)}),
                             device=dev)._fwd(crops)
    same = torch.equal(mem, run)
    print(f"LoRA fine-tune of the bf16 recognize run (rank 8, alpha 16, {len(moved)} adapted "
          f"kernels, bf16): launches per step {rec.counts[0]}, base weights bit-equal to the "
          f"pretrained run's {base_equal}, adapters moved {sum(moved)} of {len(moved)}; the "
          f"LoRA run dir decodes the merged weights' tokens {same}; losses "
          f"{[round(float(m['loss']), 4) for m in rec.metrics]}")
    require(base_equal and all(moved) and same, "LoRA fine-tune")
    return dict(adapted=len(moved), base_equal=base_equal, tokens_equal=same,
                losses=[float(m["loss"]) for m in rec.metrics])


def detect_validator(dev, root, launches: dict) -> dict:
    """Phase 12e: a yolov12n@320 detector run (bf16, batch 4, one epoch of 2
    steps over synthetic pages), then ``DetectValidator`` over its run dir
    (the trainer class a ``trainer_for`` one): the metrics of the trainer's
    own ``validate`` on its final state (best is last), the validation on
    the run's EMA weights (a seeded detector after 2 steps scores 0 mAP, so
    the weights are compared too)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectValidator, trainer_for
    from kuzu_torch.testing import SyntheticDetectionDataset

    train_ds = SyntheticDetectionDataset(8, 320, max_boxes=64, nc=1, seed=0)
    val_ds = SyntheticDetectionDataset(4, 320, max_boxes=64, nc=1, seed=1)
    cls = trainer_for((train_ds, val_ds, 1))
    cfg = load_config(overrides=dict(model="yolov12n", imgsz=320, batch=4, epochs=1, workers=2,
                                     dtype="bfloat16", project=str(root / "runs"), name="det",
                                     exist_ok=True, verbose=False))
    trainer = cls(cfg, device=dev)
    zero_counts()
    trainer.train()
    want_ = trainer.validate(trainer.state)
    seen = {}

    class Seen(cls):  # the weights the validator's validate folds
        def validate(self, state):
            seen.update(state.ema_state_dict())
            return super().validate(state)

    validator = DetectValidator(load_config(overrides={"model": str(trainer.save_dir)}),
                                device=dev)
    validator.trainer_cls = Seen
    got = validator.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, n in counts.items():
        launches[name] += n
    ema = trainer.state.ema_state_dict()
    same_weights = sorted(seen) == sorted(ema) and all(torch.equal(seen[k], ema[k]) for k in ema)
    print(f"DetectValidator over a yolov12n@320 run dir (2 steps): {got}; equal to the "
          f"trainer's validate {got == want_}, on the run's EMA weights {same_weights}; "
          f"launches in the phase {counts}")
    require(got == want_ and same_weights and {"map50", "map", "fitness"} <= set(got),
            "DetectValidator")
    return dict(metrics=got, weights_equal=same_weights, launches=counts)


def ctc_training_phase(dev, root, rec_dir, launches: dict) -> dict:
    """Phase 12: a, b, c, d (on phase 11's bf16 recognize run dir), e."""
    out = dict(card_vs_cpu=ctc_step_card_vs_cpu(dev, root))
    ctc = ctc_full_width(dev, root)
    out["run_dir_cascade"] = ctc_run_dir_cascade(dev, ctc, launches)
    for key in ("trainer", "ema", "val_ds"):
        ctc.pop(key)
    ctc["save_dir"] = str(ctc["save_dir"])
    out["production_run"] = ctc
    torch.cuda.empty_cache()
    out["lora"] = lora_recognize(dev, root, rec_dir, launches)
    out["detect_validator"] = detect_validator(dev, root, launches)
    return out


# --------------------------------------------- phase 14: training from image files

TILE_HW = (2224, 1393)  # a 3868 x 2422 page's tile on the 2 x 2 grid at 0.15 overlap
TILE_SPLITS = {"train": 64, "val": 8}
TILE_GLYPHS, GLYPH_PX = (150, 300), (30, 120)  # glyph boxes a tile, their side in px
# the production character-detector run (kuzu/tools/production.py:512-524);
# epochs and the data are the phase's own. Production passes no ``augment``,
# and the config's default ``augment: false`` (a predict key the detect
# trainer also reads, in both packages) trains it on the letterbox route;
# 14b trains the recipe's mosaic route (``augment=True``, ``close_mosaic=0``)
# and times the production route's loader beside it
DET_FILE_RUN = dict(imgsz=640, batch=8, dtype="bfloat16", remat=False, max_boxes=400,
                    max_det=2000, conf=0.25, workers=2, cache_images="ram", epochs=1,
                    augment=True, close_mosaic=0)
COL_CROP_HW = ((600, 1200), (56, 72))  # a column crop's height and width ranges
COL_CROPS = 160  # 14c's column_info.csv rows (80 / 10 / 10 split)
LINE_SPLITS = {"train": 32, "val": 16, "test": 16}  # 14d's one-line crops


@contextlib.contextmanager
def _recording(cls):
    """Every ``cls`` built in the block records its steps (``_record``);
    yields the recorders, for trainers a facade builds."""
    recs = []
    own = cls.__dict__.get("__init__")
    init = cls.__init__

    def recorded(self, *a, **k):
        init(self, *a, **k)
        recs.append(_record(self))

    cls.__init__ = recorded
    try:
        yield recs
    finally:
        if own is None:
            del cls.__init__
        else:
            cls.__init__ = own


def image_ops_card_vs_cpu(dev) -> dict:
    """Phase 14a: the training augmentations' cv2 ops of ``image_io`` on the
    card against the CPU, byte for byte, at the folder dataset's shapes: a
    1280 x 1280 mosaic canvas to 640 by ``warp_affine_u8`` (the mosaic's
    scale + translate, and a rotation with shear) and ``warp_perspective_u8``;
    the HSV round trip with its LUTs on a 640 image; ``remap_linear_u8`` over
    a grid distortion's maps; ``filter2d_u8`` with a 7-tap line kernel. A
    planted fault (the source coordinates on the 1/32-pixel grid of cv2's
    older fixed-point warp) must differ. The device time of the 1280 -> 640
    warp."""
    from kuzu_torch.data import image_io as io
    from kuzu_torch.testing import glyph_page

    rng = np.random.default_rng(40)
    canvas = glyph_page(rng, (1280, 1280), (400, 800), (16, 60))[0]
    canvas[:, :300] = 114  # the mosaic's fill beside the images
    img = glyph_page(rng, (640, 640), (100, 300), (8, 40))[0]
    shift = np.array([[0.62, 0, -85.3], [0, 0.62, -101.7]])  # 2S -> S: scale, translate
    c = np.eye(3)
    c[:2, 2] = -640
    r = np.eye(3)
    r[:2] = io.rotation_matrix_2d((0.0, 0.0), 17.3, 0.58)
    sh = np.eye(3)
    sh[0, 1], sh[1, 0] = 0.09, -0.05
    t = np.eye(3)
    t[:2, 2] = 330, 305
    rot = (t @ sh @ r @ c)[:2]
    p = np.eye(3)
    p[2, :2] = 4e-4, -3e-4
    persp = t @ sh @ r @ p @ c
    xs, ys = np.linspace(0, 640, 6), np.linspace(0, 640, 6)
    jx = xs + rng.uniform(-0.3, 0.3, 6) * 128
    jy = ys + rng.uniform(-0.3, 0.3, 6) * 128
    jx[0], jx[-1], jy[0], jy[-1] = 0, 640, 0, 640
    mx = np.tile(np.interp(np.arange(640), xs, jx).astype(np.float32), (640, 1))
    my = np.tile(np.interp(np.arange(640), ys, jy).astype(np.float32)[:, None], (1, 640))
    luts = np.stack([((np.arange(256) * 1.01) % 180), np.clip(np.arange(256) * 0.6, 0, 255),
                     np.clip(np.arange(256) * 1.3, 0, 255)], 1).astype(np.uint8)
    kernel = np.zeros((7, 7), np.float32)
    kernel[3, :] = 1 / 7
    fill = (114,) * 3
    cases = {
        "warpAffine 1280 -> 640, scale + translate":
            (canvas, lambda x: io.warp_affine_u8(x, shift, (640, 640), fill)),
        "warpAffine 1280 -> 640, rotation + shear":
            (canvas, lambda x: io.warp_affine_u8(x, rot, (640, 640), fill)),
        "warpPerspective 1280 -> 640": (canvas, lambda x: io.warp_perspective_u8(
            x, persp, (640, 640), fill)),
        "HSV round trip + LUT 640": (img, lambda x: io.hsv_to_rgb_u8(io.lut_u8(
            io.rgb_to_hsv_u8(x), luts))),
        "remap grid distortion 640": (img, lambda x: io.remap_linear_u8(x, mx, my)),
        "filter2D 7-tap 640": (img, lambda x: io.filter2d_u8(x, kernel)),
    }
    off = {}
    for name, (x, fn) in cases.items():
        off[name] = _bytes_off(fn(torch.from_numpy(x).to(dev)), fn(x))
    worst = max(off.values())
    print(f"augmentation ops card vs CPU: {len(off)} cases, differing bytes at most {worst} "
          f"(must be 0): {off}")
    require(worst == 0, "augmentation ops card vs CPU byte for byte")
    canvas_dev = torch.from_numpy(canvas).to(dev)
    ref = io.warp_affine_u8(canvas, rot, (640, 640), fill)
    exact = io._bilinear_u8
    io._bilinear_u8 = lambda x, sx, sy, *a: exact(x, (sx * 32).floor() / 32,
                                                    (sy * 32).floor() / 32, *a)
    try:
        fault = _bytes_off(io.warp_affine_u8(canvas_dev, rot, (640, 640), fill), ref)
    finally:
        io._bilinear_u8 = exact
    print(f"  planted fault (coordinates on the 1/32-pixel grid): {fault} bytes differ "
          f"(must differ)")
    require(fault > 0, "the planted warp fault is caught")
    warp_dev, _ = device_times(lambda: io.warp_affine_u8(canvas_dev, rot, (640, 640), fill),
                               reps=10)
    t0 = time.perf_counter()
    for _ in range(3):
        io.warp_affine_u8(canvas, rot, (640, 640), fill)
    warp_cpu = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  warpAffine 1280 -> 640: card {warp_dev:.4f} ms device, host CPU {warp_cpu:.1f} ms")
    return dict(bytes_off=off, planted_fault_bytes=fault, warp_device_ms=warp_dev,
                warp_cpu_ms=warp_cpu)


def _loader_rate(ds, batch: int, workers: int) -> float:
    """Samples/s of one pass of the threaded loader over ``ds`` (no model)."""
    from kuzu_torch.data.loader import DataLoader

    loader = DataLoader(ds, batch, shuffle=True, seed=0, num_workers=workers)
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    return n / (time.perf_counter() - t0)


@contextlib.contextmanager
def _default_threads():
    """The loader without its one-intra-op-thread rule: torch's
    ``set_num_threads`` a no-op for the block (the workers' initializer and
    ``loader.one_thread`` both call it), so samples run on torch's
    default threads."""
    saved = torch.set_num_threads
    torch.set_num_threads = lambda n: None
    try:
        yield
    finally:
        torch.set_num_threads = saved


def _sample_split(ds, n: int) -> dict:
    """Per-sample host ms of ``n`` samples of a cold folder dataset in this
    thread, split into the decode, the mosaic's resizes, the warp (with the
    box rewrite), the HSV jitter and the rest (the draws, copies, flips,
    padding), by timing the module functions the sample calls."""
    import kuzu_torch.data.yolo_dataset as yd
    from kuzu_torch.data import image_io as io

    spent = dict.fromkeys(("decode", "mosaic resize", "warp", "HSV"), 0.0)
    saved = {}

    def timed(mod, attr, key):
        fn = getattr(mod, attr)
        saved[(mod, attr)] = fn

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0

        setattr(mod, attr, wrapper)

    timed(io, "imread_rgb", "decode")
    timed(yd, "resize_linear_u8", "mosaic resize")
    timed(yd, "random_affine", "warp")
    timed(yd, "hsv_jitter", "HSV")
    n = min(n, len(ds))
    try:
        t0 = time.perf_counter()
        for i in range(n):
            ds[i]
        total = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    out = {k: v / n * 1e3 for k, v in spent.items()}
    out["rest"] = total / n * 1e3 - sum(out.values())
    out["total"] = total / n * 1e3
    return out


def detector_training_from_files(dev, root, launches: dict) -> dict:
    """Phase 14b: the production character-detector stage from a PNG folder:
    ``Model("yolov12-p2x", task="detect").train(data=<yaml>, ...)`` with
    ``DET_FILE_RUN`` over 64 train and 8 val tiles of 2224 x 1393 with 150-300
    glyph boxes each (the mosaic route); 16 K3 + 16 K4 launches every step,
    K2 16 + K1 1 in validation, finite losses, EMA and BatchNorm statistics
    moved, ms/step and images/s, a profiled step, peak memory; the loader's
    own rate (cache warm and cold, 2 and 8 workers, and 2 workers on torch's
    default intra-op threads) and a sample's split;
    ``Model(run_dir).val(data=...)`` equal to the trainer's last validation;
    ``evaluate_detector`` over the val split."""
    from pathlib import Path

    from kuzu_torch.api.model import Model
    from kuzu_torch.data.yolo_dataset import YoloDetectionDataset
    from kuzu_torch.tasks.detect import DetectTrainer
    from kuzu_torch.testing import write_yolo_folder
    from kuzu_torch.tools.evaluation import evaluate_detector

    t0 = time.perf_counter()
    data = write_yolo_folder(root / "tiles", TILE_SPLITS, hw=TILE_HW, n_boxes=TILE_GLYPHS,
                             size=GLYPH_PX, nc=1, seed=41, workers=8)
    write_s = time.perf_counter() - t0
    with _recording(DetectTrainer) as recs:
        model = Model("yolov12-p2x", task="detect", device=dev)
        t0 = time.perf_counter()
        final = model.train(data=str(data), project=str(root / "runs"), name="p2x-files",
                            exist_ok=True, verbose=False, **DET_FILE_RUN)
        wall = time.perf_counter() - t0
    rec, trainer = recs[0], model._trainer
    steps = TILE_SPLITS["train"] // DET_FILE_RUN["batch"]
    per_step = want(area_attention=16, area_attention_bwd=16)
    print(f"yolov12-p2x@640 b8 bf16 from a PNG folder ({TILE_SPLITS} tiles of {TILE_HW[1]} x "
          f"{TILE_HW[0]}, written in {write_s:.1f} s): Model.train in {wall:.1f} s, "
          f"{len(rec.counts)} steps; launches per step {rec.counts[0]} (want {per_step}); "
          f"validation {rec.val_counts}; final {final}")
    require(len(rec.counts) == steps and all(c == per_step for c in rec.counts)
            and all(sum(p.values()) == 0 for p in rec.plain), "p2x from files: per-step launches")
    require(rec.val_counts == want(nms=1, fused_ablock=16), "p2x from files: validation launches")
    for c in rec.counts + [rec.val_counts]:
        for name, n in c.items():
            launches[name] += n
    losses = [float(m["loss"]) for m in rec.metrics]
    state = trainer.state
    ema_moved = max(float((state.ema[n] - p).abs().max()) for n, p in rec.p0.items())
    bn_moved = max(float((t - rec.b0[n]).abs().max())
                   for n, t in state.model.named_buffers() if "running" in n)
    require(all(np.isfinite(losses)) and ema_moved > 0 and bn_moved > 0,
            "p2x from files: finite losses, EMA and BatchNorm statistics moved")
    r = dict(final=final, losses=losses, wall_s=wall, write_s=write_s, peak_gib=rec.peak / 2**30,
             **_step_times(rec, WARM_STEPS))
    r["images_per_s"] = DET_FILE_RUN["batch"] / r["ms_per_step"] * 1e3
    print(f"  losses {[round(x, 3) for x in losses]}; EMA moved {ema_moved:.3e}, BN statistics "
          f"{bn_moved:.3e}; ms/step {r['ms_per_step']:.3f} (after {WARM_STEPS} warm-up: "
          f"{[round(t, 2) for t in r['step_ms']]}), {r['images_per_s']:.2f} images/s, peak "
          f"{r['peak_gib']:.2f} GiB")
    r["breakdown"] = train_step_breakdown(trainer, trainer.train_ds)
    require(trainer.train_ds.augment and trainer.train_ds.hyp["mosaic"] == 1.0,
            "p2x from files: the mosaic route")
    warm = {w: _loader_rate(trainer.train_ds, 8, w) for w in (2, 8)}
    with _default_threads():
        warm_default = _loader_rate(trainer.train_ds, 8, 2)
    cold_ds = lambda **k: YoloDetectionDataset(data, imgsz=640, max_boxes=400,
                                               cache_images="ram", **k)
    cold = _loader_rate(cold_ds(), 8, 2)
    split = _sample_split(cold_ds(), 16)
    letterbox = cold_ds(augment=False)  # production's route (no augment key)
    lb_cold = _loader_rate(letterbox, 8, 2)
    lb_warm = _loader_rate(letterbox, 8, 2)
    r["loader"] = dict(samples_per_s_warm=warm, samples_per_s_cold_2_workers=cold,
                       samples_per_s_warm_2_workers_default_threads=warm_default,
                       sample_ms=split, letterbox_route_2_workers=dict(cold=lb_cold, warm=lb_warm),
                       step_samples_per_s=r["images_per_s"])
    print(f"  loader alone (no model), mosaic route, samples/s: cache warm {warm} (by "
          f"workers; {warm_default:.2f} at 2 workers on torch's default intra-op threads), "
          f"cold {cold:.2f} (2 workers); the letterbox route (production's "
          f"default) cold {lb_cold:.2f}, warm {lb_warm:.2f} (2 workers); the step consumed "
          f"{r['images_per_s']:.2f}; a cold mosaic sample in one thread (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    run_dir = trainer.save_dir
    zero_counts()
    val = Model(str(run_dir), device=dev).val(data=str(data), project=str(root / "runs"),
                                              name="p2x-val")
    vc = launch_counts()
    last = rec.val_metrics
    print(f"  Model(run_dir).val: {val}; the trainer's last validation {last}; launches {vc}")
    require(val == last, "Model.val equals the trainer's last validation")
    zero_counts()
    ev = evaluate_detector(run_dir, data, split="val", device=dev)
    ec = launch_counts()
    n_val = TILE_SPLITS["val"]
    require(ec == want(nms=n_val, fused_ablock=16 * n_val), f"evaluate_detector launches {ec}")
    for c in (vc, ec):
        for name, n in c.items():
            launches[name] += n
    r["val"] = val
    r["evaluate_detector"] = {k: v for k, v in ev.items() if k != "per_image"}
    print(f"  evaluate_detector(val): map50 {ev['map50']:.4f}, map {ev['map']:.4f}, fitness "
          f"{ev['fitness']:.4f}, worst {[Path(p).name for p in ev['worst_images'][:3]]}; "
          f"launches {ec}")
    return r


def ctc_from_files(dev, root, ctc_run: dict) -> dict:
    """Phase 14c: the production CTC stage from a ``column_info.csv`` of 160
    PNG column crops (600-1200 x 56-72 px, 10-120 characters of the 4,788-class
    vocabulary): ``Model("crnn", task="ctc").train(data=<csv>, ...)`` with 12b's
    ``CTC_RUN``, workers 2, the RAM cache, 2 epochs; ms/step beside 12b's, CER,
    the loader's samples/s."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.tasks.ctc import CTCTrainer
    from kuzu_torch.testing import synthetic_texts, write_column_csv

    tok = synthetic_tokenizer()
    tok.save(root / "ctc_tokenizer.json")
    lo, hi = CTC_TEXT_CHARS
    csv_path = write_column_csv(root / "columns", synthetic_texts(
        COL_CROPS, CHARS, hi, seed=42, min_chars=lo), hw=COL_CROP_HW, seed=43)
    with _recording(CTCTrainer) as recs:
        model = Model("crnn", task="ctc", device=dev)
        t0 = time.perf_counter()
        final = model.train(data=str(csv_path), tokenizer=str(root / "ctc_tokenizer.json"),
                            project=str(root / "runs"), name="ctc-files", exist_ok=True,
                            verbose=False, **dict(CTC_RUN, workers=2, cache_images="ram",
                                                  epochs=2))
        wall = time.perf_counter() - t0
    rec, trainer = recs[0], model._trainer
    losses = [float(m["loss"]) for m in rec.metrics]
    require(len(rec.counts) == 2 * (int(COL_CROPS * 0.8) // CTC_RUN["batch"])
            and all(np.isfinite(losses)) and "cer" in final, "CTC from files: steps and CER")
    r = dict(final=final, losses=losses, wall_s=wall, **_step_times(rec, WARM_STEPS))
    r["loader_samples_per_s"] = _loader_rate(trainer.train_ds, CTC_RUN["batch"], 2)
    print(f"CTC from a column_info.csv ({COL_CROPS} PNG crops): {len(rec.counts)} steps in "
          f"{wall:.1f} s; ms/step {r['ms_per_step']:.3f} (12b on decoded crops: "
          f"{ctc_run['ms_per_step']:.3f}), CER {final['cer']:.4f}; loader alone "
          f"{r['loader_samples_per_s']:.1f} samples/s (2 workers, cache warm)")
    return r


def recognize_from_files(dev, root, launches: dict) -> dict:
    """Phase 14d: ``Model("trocr", task="recognize").train(data=<one-line
    folder>, ...)`` at the production widths (``REC_RUN``, bf16, augment on)
    for 4 steps over PNG crops: K3 + K4 launches (6 + 6) a step, no plain
    call; then ``evaluate_recognizer`` over its test split, whose CER equals
    ``character_error_rate`` over the run's predictor's own readings."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.metrics import character_error_rate
    from kuzu_torch.data.ocr_datasets import OneLineDataset
    from kuzu_torch.tasks.recognize import RecognizePredictor, RecognizeTrainer
    from kuzu_torch.testing import synthetic_texts, write_oneline_folder
    from kuzu_torch.tools.evaluation import evaluate_recognizer

    lo, hi = REC_TEXT_CHARS
    texts = synthetic_texts(sum(LINE_SPLITS.values()), CHARS, hi, seed=44, min_chars=lo)
    splits, at = {}, 0
    for split, n in LINE_SPLITS.items():
        splits[split], at = texts[at:at + n], at + n
    lines = write_oneline_folder(root / "lines", splits, hw=COL_CROP_HW, seed=45)
    with _recording(RecognizeTrainer) as recs:
        model = Model("trocr", task="recognize", device=dev)
        final = model.train(data=str(lines), tokenizer=str(root / "ctc_tokenizer.json"),
                            project=str(root / "runs"), name="rec-files", exist_ok=True,
                            verbose=False, val_batches=1, val_gen_batches=1, workers=2,
                            **dict(REC_RUN, epochs=2))
    rec, trainer = recs[0], model._trainer
    depth = REC_RUN["enc_depth"]
    per_step = want(area_attention=depth, area_attention_bwd=depth)
    steps = 2 * (LINE_SPLITS["train"] // REC_RUN["batch"])
    require(len(rec.counts) == steps and all(c == per_step for c in rec.counts)
            and all(sum(p.values()) == 0 for p in rec.plain),
            f"recognize from files: launches per step {rec.counts[:1]}")
    for c in rec.counts + ([rec.val_counts] if rec.val_counts else []):
        for name, n in c.items():
            launches[name] += n
    run_dir = trainer.save_dir
    zero_counts()
    ev = evaluate_recognizer(run_dir, lines, split="test", device=dev)
    pred = RecognizePredictor(load_config(overrides={"model": str(run_dir)}), device=dev)
    items = OneLineDataset(lines, None, split="test").items
    reads = pred([p for p, _, _ in items])
    cer = character_error_rate(reads, [t for _, t, _ in items])
    for name, n in launch_counts().items():
        launches[name] += n
    r = dict(final=final, evaluate=ev, cer_of_reads=cer, **_step_times(rec, 0))
    print(f"RecognizeTrainer from a one-line folder (production widths, bf16, augment): "
          f"{steps} steps, launches per step {rec.counts[0]}, ms/step {r['ms_per_step']:.3f}; "
          f"evaluate_recognizer(test) {ev}; CER of the predictor's readings {cer:.4f}")
    require(ev["n"] == LINE_SPLITS["test"] and ev["cer"] == cer,
            "evaluate_recognizer's CER equals the predictor's")
    return r


def image_file_training_phase(dev, root, ctc_run: dict, launches: dict) -> dict:
    """Phase 14: a, b, c, d."""
    out = dict(ops_card_vs_cpu=image_ops_card_vs_cpu(dev))
    out["detector"] = detector_training_from_files(dev, root, launches)
    torch.cuda.empty_cache()
    out["ctc"] = ctc_from_files(dev, root, ctc_run)
    out["recognize"] = recognize_from_files(dev, root, launches)
    return out


# ------------------------------------------------------ phase 13: image files

PAGE_HW = (3868, 2422)  # the real page's size (data/real_page/sample_gt.json)
A4_HW = (3508, 2480)  # an A4 scan at 300 dpi
N_FILES = 8  # pages of 13b
CPU_COL_MAX_DET = 8  # columns of 13c's process_page held card vs CPU (a p2x@640 forward each on the CPU)
CMP_DEPTH = 0.33  # 13c's card-vs-CPU character detector: the 'n' scales' depth multiple
COL_MODEL, CHAR_MODEL, CHAR_IMGSZ = "yolov12s", "yolov12-p2x", 640  # 8b's detectors


def _bytes_off(a, b) -> int:
    """Differing bytes of two uint8 images (tensors on any device or arrays)."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    require(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    return int((a != b).sum())


def _page_windows(hw) -> list[tuple[int, int, int, int]]:
    """Column-like windows (xa, ya, xb, yb) of a page: 150 px wide, most of its
    height, one every 500 px from the right."""
    h, w = hw
    return [(x - 150, h // 30, x, h - h // 30) for x in range(w - 40, 200, -500)]


def image_layer_card_vs_cpu(dev) -> dict:
    """Phase 13a: the image layer on the card against the CPU, byte for byte,
    at the serving path's shapes: a 3868 x 2422 and a 3508 x 2480 page
    letterboxed to 1280 (``letterbox_np``, cv2's INTER_LINEAR); column
    windows cropped to [1024, 64] (the cascade's crop letterbox, truncated
    sizes), letterboxed to 640 (the per-column character detector) and
    resized by PIL's BILINEAR (``load_letterboxed``); cv2's RGB2YCrCb and
    the 4 x 4 INTER_AREA pooling of ``pack_yc``. A planted fault (cv2's
    vertical fraction clamped at the borders, as the horizontal one is) must
    differ."""
    from kuzu_torch.data import image_io
    from kuzu_torch.data.yolo_dataset import letterbox_np
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.testing import mixed_pages

    pages = mixed_pages([PAGE_HW, A4_HW], seed=30)
    off: dict[str, int] = {}
    for pg in pages:
        tag = "x".join(map(str, pg.shape[:2]))
        on_card = torch.from_numpy(pg).to(dev)
        off[f"letterbox 1280 {tag}"] = _bytes_off(letterbox_np(on_card, PAGE)[0],
                                                  letterbox_np(pg, PAGE)[0])
        for xa, ya, xb, yb in _page_windows(pg.shape[:2])[:3]:
            crop, crop_card = pg[ya:yb, xa:xb], on_card[ya:yb, xa:xb]
            key = f"{tag} window x{xa}"
            off[f"crop [1024, 64] {key}"] = _bytes_off(
                KuzushijiPipeline._letterbox_crop(crop_card, CROP),
                KuzushijiPipeline._letterbox_crop(torch.from_numpy(crop), CROP))
            off[f"letterbox {CHAR_IMGSZ} {key}"] = _bytes_off(
                letterbox_np(crop_card, CHAR_IMGSZ)[0], letterbox_np(crop, CHAR_IMGSZ)[0])
            nh, nw = 1024, max(int(round(crop.shape[1] * 1024 / crop.shape[0])), 1)
            off[f"PIL bilinear {key}"] = _bytes_off(
                image_io.resize_pil_bilinear_u8(crop_card, (nh, nw)),
                image_io.resize_pil_bilinear_u8(crop, (nh, nw)))
        h4, w4 = pg.shape[0] // 4 * 4, pg.shape[1] // 4 * 4
        ycc_cpu = image_io.rgb_to_ycrcb_u8(pg[:h4, :w4])
        ycc_card = image_io.rgb_to_ycrcb_u8(on_card[:h4, :w4])
        off[f"RGB2YCrCb {tag}"] = _bytes_off(ycc_card, ycc_cpu)
        off[f"INTER_AREA 4 {tag}"] = _bytes_off(image_io.resize_area_u8(ycc_card[..., 1:], 4),
                                                image_io.resize_area_u8(ycc_cpu[..., 1:], 4))
    worst = max(off.values())
    print(f"image layer card vs CPU: {len(off)} cases, differing bytes at most {worst} "
          f"(must be 0)")
    for key, n in off.items():
        if n:
            print(f"  {key}: {n} bytes differ")
    require(worst == 0, "image layer card vs CPU byte for byte")
    on_card = torch.from_numpy(pages[0]).to(dev)
    w = pages[0].shape[1]
    crop = np.ascontiguousarray(pages[0][100:300, w // 2:w // 2 + 40])  # an upscale
    ref_lb, ref_up = letterbox_np(pages[0], PAGE)[0], image_io.resize_linear_u8(crop, (1024, 205))
    table = image_io._cv2_linear_table
    image_io._cv2_linear_table = lambda s, d, clamp: table(s, d, True)
    try:
        fault = _bytes_off(letterbox_np(on_card, PAGE)[0], ref_lb)
        fault_up = _bytes_off(
            image_io.resize_linear_u8(torch.from_numpy(crop).to(dev), (1024, 205)), ref_up)
    finally:
        image_io._cv2_linear_table = table
    print(f"  planted fault (vertical fraction clamped): letterbox 1280 {fault} bytes differ, "
          f"a 200 x 40 crop up to 1024 x 205 {fault_up} (must differ)")
    require(fault_up > 0, "the planted resize fault is caught")
    lb_dev, _ = device_times(lambda: letterbox_np(on_card, PAGE), reps=10)
    t0 = time.perf_counter()
    for _ in range(3):
        letterbox_np(pages[0], PAGE)
    lb_cpu = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  letterbox of a {PAGE_HW[0]} x {PAGE_HW[1]} page to {PAGE}: card {lb_dev:.4f} ms "
          f"device ({time_ms(lambda: letterbox_np(on_card, PAGE), reps=10):.4f} ms), host CPU "
          f"{lb_cpu:.1f} ms")
    return dict(cases=len(off), max_bytes_off=worst, fault_bytes_off=[fault, fault_up],
                letterbox_device_ms=lb_dev, letterbox_cpu_ms=lb_cpu)


def detector_from_files(dev, root, col, launches: dict) -> dict:
    """Phase 13b: the yolov12s@1280 column predictor of 8b (seeded,
    calibrated) over ``N_FILES`` PNG pages of 3868 x 2422 (one Paeth-filtered)
    through ``DetectPredictor.__call__``: from the directory, from a glob and
    from the decoded arrays, equal ``Results``; K1 once a group of 8; frames/s
    with and without the decode, the decode per page, the letterbox's device
    time."""
    from kuzu_torch.data.image_io import imread_rgb
    from kuzu_torch.data.yolo_dataset import letterbox_np
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import mixed_pages, page_files

    t0 = time.perf_counter()
    paths = page_files(root, mixed_pages([PAGE_HW] * N_FILES, seed=40), paeth=(3,))
    write_s = time.perf_counter() - t0
    decode_ms = []
    for p in paths:
        t0 = time.perf_counter()
        imread_rgb(p)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    decoded = [imread_rgb(p) for p in paths]
    pred = DetectPredictor.from_detector(col, conf=CONF, iou=0.7, max_det=COL_MAX_DET)
    pred.cfg["batch"] = N_FILES
    pred(decoded)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    by_dir = pred(str(root))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"detector from files: {N_FILES} PNG pages of {PAGE_HW[0]} x {PAGE_HW[1]} (written in "
          f"{write_s:.1f} s), launches {counts} (want nms 1: one group of {N_FILES})")
    require(counts == want(nms=1), "DetectPredictor launch counts")
    for name, n in counts.items():
        launches[name] += n
    by_glob = pred(str(root / "*.png"))
    by_arrays = pred(decoded)
    for other, what in ((by_glob, "glob"), (by_arrays, "arrays")):
        for a, b in zip(by_dir, other, strict=True):
            require(a.boxes.orig_shape == b.boxes.orig_shape == PAGE_HW
                    and np.array_equal(a.boxes.xyxy, b.boxes.xyxy)
                    and np.array_equal(a.boxes.conf, b.boxes.conf)
                    and np.array_equal(a.boxes.cls, b.boxes.cls), f"directory == {what}")
    require(by_dir[0].path == str(paths[0]) and by_arrays[0].path == "", "paths")
    nbox = [len(r) for r in by_dir]
    for r in by_dir:
        b = r.boxes.xyxy
        require(len(b) > 0 and bool(np.isfinite(b).all()) and (b[:, [0, 2]] <= PAGE_HW[1]).all()
                and (b[:, [1, 3]] <= PAGE_HW[0]).all(), "boxes inside the page")
    times = {}
    for what, src in (("directory", str(root)), ("arrays", decoded)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred(src)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[what] = statistics.median(ts)
    on_card = torch.from_numpy(decoded[0]).to(dev)
    lb_dev, _ = device_times(lambda: letterbox_np(on_card, PAGE), reps=10)
    out = dict(boxes_per_page=nbox, frames_per_s_from_files=N_FILES / times["directory"],
               frames_per_s_from_arrays=N_FILES / times["arrays"],
               decode_ms_per_page=decode_ms, decode_ms_paeth_page=decode_ms[3],
               letterbox_device_ms=lb_dev, launches=counts)
    sub = [t for i, t in enumerate(decode_ms) if i != 3]
    print(f"  directory == glob == arrays for every page (boxes {nbox}); "
          f"{out['frames_per_s_from_files']:.2f} frames/s from the files, "
          f"{out['frames_per_s_from_arrays']:.2f} from decoded arrays (median of 3); PNG decode "
          f"on the host {statistics.median(sub):.1f} ms a Sub page, {decode_ms[3]:.1f} ms the "
          f"Paeth page; letterbox to {PAGE} {lb_dev:.4f} ms device")
    return out


def _chars_as_dets(results: list[dict]) -> dict:
    """Result characters of positive area as padded detections for
    ``detections_match`` (a character clipped to its column crop's edge has
    none, and no IoU can match it)."""
    chars = []
    for r in results:
        b = np.asarray(r["characters"]["boxes"], np.float32).reshape(-1, 4)
        chars.append(b[(b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])])
    n = max(max(len(b) for b in chars), 1)
    boxes = np.zeros((len(results), n, 4), np.float32)
    valid = np.zeros((len(results), n), bool)
    for i, b in enumerate(chars):
        boxes[i, :len(b)], valid[i, :len(b)] = b, True
    return {"boxes": boxes, "valid": valid, "classes": np.zeros(valid.shape, np.int32)}


def _agreement(ref: list[dict], out: list[dict]) -> dict:
    """Two cascade runs' results: columns per page, columns matched both
    ways (``detections_match``), the texts of matched columns (IoU >= 0.5)
    that are the same, and characters matched both ways."""
    from kuzu_torch.testing import detections_match, iou_matrix

    rd, od = _as_dets(ref), _as_dets(out)
    same = total = 0
    for r, o in zip(ref, out):
        if not r["columns"] or not o["columns"]:
            continue
        iou = iou_matrix(np.asarray([x["box"] for x in r["columns"]], np.float32),
                         np.asarray([x["box"] for x in o["columns"]], np.float32))
        for i, j in enumerate(iou.argmax(1)):
            if iou[i, j] >= 0.5:
                total += 1
                same += r["columns"][i]["text"] == o["columns"][j]["text"]
    rc, oc = _chars_as_dets(ref), _chars_as_dets(out)
    return dict(columns=[[len(r["columns"]) for r in ref], [len(r["columns"]) for r in out]],
                matched=[detections_match(rd, od), detections_match(od, rd)],
                texts=[same, total], texts_same=same / max(total, 1),
                characters_matched=[detections_match(rc, oc), detections_match(oc, rc)])


def _agreement_line(a: dict) -> str:
    return (f"columns per page {a['columns'][0]} vs {a['columns'][1]}, matched "
            f"{a['matched'][0]:.4f} / {a['matched'][1]:.4f}, texts of matched columns "
            f"{a['texts'][0]} of {a['texts'][1]} the same, characters matched "
            f"{a['characters_matched'][0]:.4f} / {a['characters_matched'][1]:.4f}")


def _compare_results(card: list[dict], cpu: list[dict], what: str) -> dict:
    """Phase 8a's criteria on two runs' results: the same column counts,
    columns matched both ways (>= 0.9) and the texts of matched columns
    (>= 0.95)."""
    a = _agreement(cpu, card)
    print(f"  {what} card vs CPU: {_agreement_line(a)} (CPU first; counts equal, matched >= "
          f"0.9 both ways, texts >= 0.95)")
    ncpu, ncard = a["columns"]
    require(ncpu == ncard and min(ncpu) > 0 and min(a["matched"]) >= 0.9,
            f"{what}: columns card vs CPU")
    require(a["texts"][1] > 0 and a["texts_same"] >= 0.95, f"{what}: texts card vs CPU")
    return a


def cut_depth_char_detector(dev, full):
    """13c's character detector for the card-against-CPU runs: 8b's
    yolov12-p2x (its widths, yaml and nc) at the depth multiple CMP_DEPTH
    (the A2C2f and C3k2 repeats 4 -> 1, 2 -> 1), seeded, BatchNorm
    calibrated on phase 8b's first page's tiles and its box head set as
    8b's: both devices run the same weights, and the CPU's f64 and f32
    forwards over 8 crops and 8 tiles take about half the time."""
    import yaml

    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.models.yolo.graph import parse_model_yaml, resolve_model_spec
    from kuzu_torch.pipeline.device_pages import device_tiles
    from kuzu_torch.testing import box_head, calibrate_batch_norm

    path, scale = resolve_model_spec(CHAR_MODEL)
    d = yaml.safe_load(path.read_text())
    d["scales"][scale] = [CMP_DEPTH, *d["scales"][scale][1:]]
    spec = parse_model_yaml(d, scale=scale, nc=full.nc)
    char = YoloDetector(spec, imgsz=CHAR_IMGSZ, device=dev).init(1)
    pages = production_pages()[:1].to(dev)
    calibrate_batch_norm(char.graph, device_tiles(pages, 2, 0.15, CHAR_IMGSZ)[0])
    box_head(char, (1, 1, 1, 1))
    print(f"  13c card vs CPU: {CHAR_MODEL} at depth {CMP_DEPTH}, {char.param_count()} params "
          f"({full.param_count()} at full depth)")
    return char


def _reference_pipeline(d, col, char, crnn, tok, dtype, col_max_det: int):
    """13c's pipeline for card against CPU: the detectors' weights (``col``,
    ``char``: YoloDetectors, their specs and sizes) on ``d``, their unfolded
    graphs (eval mode) and the CRNN in ``dtype`` (f64 or f32); an f64
    detector's decoded output goes to the NMS in f32, as the main path's
    does. The main path runs the bf16 executor with its kernels:
    a calibrated seeded detector amplifies bf16 rounding, so two bf16
    executors part by design."""
    import copy

    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor
    from kuzu_torch.tasks.detect import DetectPredictor

    def detector(src):
        det = YoloDetector(src.spec, imgsz=src.imgsz, device=d).load_state_dict(
            src.graph.state_dict())
        det.graph.eval()  # a new module trains: its BatchNorms would take each batch's statistics
        if dtype == torch.float64:
            det.graph.double()
            det.graph.dtype = torch.float64
            det.decode = lambda feats, f=det.decode: f(feats).float()
        det.infer = lambda images, g=det.graph: g(images)
        return det

    rec = copy.deepcopy(crnn).to(d)
    if dtype == torch.float64:
        rec.double()
        rec.dtype = rec.encoder.dtype = torch.float64
    return KuzushijiPipeline(
        column_model=DetectPredictor.from_detector(detector(col), conf=CONF, iou=0.7,
                                                   max_det=col_max_det),
        char_model=DetectPredictor.from_detector(detector(char), conf=CONF, iou=0.7,
                                                 max_det=2000),
        recognizer=CTCPredictor.from_model(rec, tok, CROP, device=d),
        tile_grid=0, tile_overlap=0.15, max_det=2000, device=d)


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _map_error(p32, p64, image) -> dict:
    """Each detector's raw maps in f32 (on ``p32``'s device) against f64
    (on ``p64``'s): max |d| / max |f64| over the maps, the column detector
    on the page's 1280 letterbox (and at the output of each of its graph's
    nodes, where the two part), the character detector on its first 640
    tile."""
    from kuzu_torch.data.yolo_dataset import letterbox_np
    from kuzu_torch.pipeline.tiling import tile_image

    page = torch.from_numpy(image)
    inputs = dict(columns=letterbox_np(page, PAGE)[0][None],
                  characters=tile_image(page, grid=2, overlap=0.15, tile_size=CHAR_IMGSZ)[0][:1])
    nodes: dict[str, dict] = {}
    hooks = [m.register_forward_hook(
                 lambda m, i, o, n=n, tag=tag: nodes.setdefault(n, {}).__setitem__(tag, o))
             for tag, g in (("f32", p32.column_det.detector.graph),
                            ("f64", p64.column_det.detector.graph))
             for n, m in g.named_children()]
    out = {}
    try:
        for key, a, b in (("columns", p32.column_det, p64.column_det),
                          ("characters", p32.char_det, p64.char_det)):
            with torch.no_grad():
                m32 = a.detector.infer(inputs[key].to(p32.device))
                m64 = b.detector.infer(inputs[key].to(p64.device))
            out[key] = max(_rel_err(x, y) for x, y in zip(m32, m64))
    finally:
        for h in hooks:
            h.remove()
    out["column_nodes"] = {n.split("_")[0]: _rel_err(o["f32"], o["f64"]) for n, o in nodes.items()
                           if isinstance(o.get("f32"), torch.Tensor)}
    return out


def flat_cascade(dev, root, col, char, crnn, tok, launches: dict) -> dict:
    """Phase 13c: the reference-shaped cascade from files at full width:
    ``process_page(path)`` with ``tile_grid=0`` (yolov12s@1280 columns,
    yolov12-p2x@640 characters inside each column crop, the CRNN on [1024,
    64] crops; 8b's seeded weights) on a 3868 x 2422 page, then
    ``process_pages`` over 4 pages of two shapes (3868 x 2422, 3508 x 2480)
    with ``tile_grid=2``, which takes the host path; launches, times, the
    stages of a profiled call, pages/s.

    Card against CPU by phase 8a's criteria (equal column counts, columns
    matched >= 0.9 both ways, texts of matched columns >= 0.95, end to end)
    on the same weights, with the detectors' unfolded graphs (eval mode)
    and the CRNN in f32, as phase 8 compares: ``process_page`` with
    ``CPU_COL_MAX_DET`` columns in f32, and the host path on 2 pages of the
    two shapes with ``col_refine`` on (the default) and ``COL_MAX_DET``
    columns in f32; the f64 runs of both on the card alone (the CPU's f64
    runs, the longest of its runs, are cut). Each device's f32 run is also
    reported against the card's f64 run, with
    each device's f32 map error against the card's f64 maps (per node for
    the column detector): near-equal candidates in NMS and the snapping of
    columns to their characters turn rounding into moved columns, so these
    say how far f32 is from the exact answer on each side."""
    from kuzu_torch.data.image_io import imread_rgb
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import mixed_pages, page_files

    def build(d, c, ch, rec, col_max_det):
        return KuzushijiPipeline(
            column_model=DetectPredictor.from_detector(c, conf=CONF, iou=0.7,
                                                       max_det=col_max_det),
            char_model=DetectPredictor.from_detector(ch, conf=CONF, iou=0.7, max_det=2000),
            recognizer=CTCPredictor.from_model(rec, tok, CROP, device=d),
            tile_grid=0, tile_overlap=0.15, max_det=2000, device=d)

    page = page_files(root / "flat", mixed_pages([PAGE_HW], seed=50))[0]
    shapes = [PAGE_HW, A4_HW, PAGE_HW, A4_HW]
    mixed = page_files(root / "mixed", mixed_pages(shapes, seed=60))
    pipe = build(dev, col, char, crnn, COL_MAX_DET)
    pipe.process_page(page)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    res = pipe.process_page(page)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"flat cascade (tile_grid=0) on a {PAGE_HW[0]} x {PAGE_HW[1]} page from a file: "
          f"launches {counts} (want nms 2: columns and the characters of every column crop; "
          f"fused_ablock 16: one p2x@640 forward over the crops)")
    require(counts == want(nms=2, fused_ablock=16), "flat cascade launch counts")
    for name, n in counts.items():
        launches[name] += n
    ncol = len(res["columns"])
    require(ncol > 0 and all(isinstance(c["text"], str) and "chars" in c for c in res["columns"]),
            "every column has a text and its characters")
    page_ms = statistics.median(
        [(lambda t0: (pipe.process_page(page), time.perf_counter() - t0)[1])(time.perf_counter())
         for _ in range(3)]) * 1e3
    print(f"  {ncol} columns, {len(res['characters']['boxes'])} characters; process_page "
          f"{page_ms:.1f} ms (median of 3, decode included)")
    flat_breakdown = device_breakdown(lambda: pipe.process_page(page), ranges="cascade/")
    require(set(flat_breakdown["stages"]) == {"decode", "columns", "crops", "characters",
                                              "recognizer"}, "every tile_grid=0 stage profiled")

    pipe.tile_grid = 2
    pipe.process_pages(mixed)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    res4 = pipe.process_pages(mixed)
    torch.cuda.synchronize()
    counts4 = launch_counts()
    print(f"host path (mixed shapes, tile_grid=2), 4 pages of {shapes[:2]}: launches {counts4} "
          f"(want nms 3: columns, tiles, cross-tile; fused_ablock 16: one p2x forward over 16 "
          f"tiles)")
    require(counts4 == want(nms=3, fused_ablock=16), "host path launch counts")
    for name, n in counts4.items():
        launches[name] += n
    for r, hw in zip(res4, shapes):
        b = np.asarray([c["box"] for c in r["columns"]], np.float64).reshape(-1, 4)
        require(len(b) > 0 and (b >= 0).all() and (b[:, [1, 3]] <= hw[0]).all()
                and (b[:, [0, 2]] <= hw[1]).all(), "host path columns inside their page")
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.process_pages(mixed)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ms4 = statistics.median(ts) * 1e3
    print(f"  columns per page {[len(r['columns']) for r in res4]}; process_pages {ms4:.1f} ms "
          f"per 4 pages (median of 3: {', '.join(f'{t * 1e3:.1f}' for t in ts)}), "
          f"{4e3 / ms4:.2f} pages/s")
    breakdown = device_breakdown(lambda: pipe.process_pages(mixed), ranges="cascade/")
    require(list(breakdown["stages"]) == ["decode", "columns", "tiles", "cross-tile NMS",
                                          "geometry", "crops", "recognizer"],
            "every host-path stage profiled")

    # card against CPU on the same weights, in f64 and in f32 forwards; the
    # character detector at CMP_DEPTH (its own seeded, calibrated weights)
    t0 = time.perf_counter()
    char = cut_depth_char_detector(dev, char)
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    flat_cmp, seconds = {}, {}

    def timed(key, fn):
        t = time.perf_counter()
        r = fn()
        seconds[key] = time.perf_counter() - t
        return r

    # process_page card vs CPU in f32; its f64 run on the card alone, each
    # device's f32 run reported against it (the CPU's f64 run is cut, as
    # the host path's is below)
    flat = {(d, name): _reference_pipeline(d, col, char, crnn, tok, dtypes[name],
                                           CPU_COL_MAX_DET)
            for d, name in ((dev, "f64"), (dev, "f32"), ("cpu", "f32"))}
    one = {key: [timed(f"process_page {key[1]} {torch.device(key[0]).type}",
                       lambda p=p: p.process_page(page))] for key, p in flat.items()}
    flat_cmp["f32"] = _compare_results(one[dev, "f32"], one["cpu", "f32"],
                                       "process_page (tile_grid=0), f32 forwards")
    flat_cmp["f32 against the card's f64 run"] = {
        side: _agreement(one[dev, "f64"], one[d, "f32"]) for side, d in (("card", dev),
                                                                       ("CPU", "cpu"))}
    for side, a in flat_cmp["f32 against the card's f64 run"].items():
        print(f"    process_page {side} f32 against the card's f64 run (reported): "
              f"{_agreement_line(a)}")
    del flat
    host = {(d, name): _reference_pipeline(d, col, char, crnn, tok, dtypes[name], COL_MAX_DET)
            for d, name in ((dev, "f64"), (dev, "f32"), ("cpu", "f32"))}
    two = {}
    for key, p in host.items():
        p.tile_grid = 2
        two[key] = timed(f"host path {key[1]} {torch.device(key[0]).type}",
                         lambda p=p: p.process_pages(mixed[:2]))
    print("  13c card-vs-CPU runs, seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    host_cmp = {"f32": _compare_results(
        two[dev, "f32"], two["cpu", "f32"],
        "process_pages host path (col_refine on), 2 shapes, f32 forwards")}
    host_cmp["f32 against the card's f64 run"] = {
        side: _agreement(two[dev, "f64"], two[d, "f32"]) for side, d in (("card", dev),
                                                                       ("CPU", "cpu"))}
    for side, a in host_cmp["f32 against the card's f64 run"].items():
        print(f"    {side} f32 against the card's f64 run (reported): {_agreement_line(a)}")
    image = imread_rgb(mixed[0])
    map_err = {side: _map_error(host[d, "f32"], host[dev, "f64"], image)
               for side, d in (("card", dev), ("CPU", "cpu"))}
    print(f"    detector maps f32 against f64 on each device, max |d| / max |f64|: columns "
          f"card {map_err['card']['columns']:.3e}, CPU {map_err['CPU']['columns']:.3e}; "
          f"characters card {map_err['card']['characters']:.3e}, CPU "
          f"{map_err['CPU']['characters']:.3e} (reported)")
    for side, e in map_err.items():
        print(f"      column detector's nodes on the {side}: " + ", ".join(
            f"{n} {v:.1e}" for n, v in e["column_nodes"].items()))
    print(f"  card vs CPU took {time.perf_counter() - t0:.1f} s (CPU runs included)")
    del host
    torch.cuda.empty_cache()
    return dict(flat_columns=ncol, flat_page_ms=page_ms, flat_launches=counts,
                flat_breakdown=flat_breakdown,
                host_launches=counts4, host_ms_per_4_pages=ms4, host_pages_per_s=4e3 / ms4,
                host_columns=[len(r["columns"]) for r in res4], breakdown=breakdown,
                card_vs_cpu=dict(flat=flat_cmp, host=host_cmp, f32_map_error=map_err))


def yc_transport(dev, pipe, pages) -> dict:
    """Phase 13d: the chroma-subsampled transport on 8b's 16 pages:
    ``pack_yc`` card against CPU (bytes), ``unpack_yc`` on the card against
    the CPU (one level at most, 99.9% exact: the bilinear chroma upsample in
    f32 on each device), and the yc cascade's columns and texts beside the RGB
    cascade's on the same pipeline."""
    from kuzu_torch.pipeline.device_pages import pack_yc, unpack_yc

    y, c = pack_yc(pages)
    yg, cg = pack_yc(pages.to(dev))
    packed_off = _bytes_off(yg, y) + _bytes_off(cg, c)
    cpu_rgb = unpack_yc(y, c)
    card_rgb = unpack_yc(y.to(dev), c.to(dev)).cpu()
    diff = (card_rgb.short() - cpu_rgb.short()).abs()
    exact = float((diff == 0).float().mean())
    print(f"yc transport, 16 pages of {PAGE}: pack_yc card vs CPU {packed_off} bytes differ "
          f"(must be 0); unpack_yc card vs CPU max level difference {int(diff.max())} (<= 1), "
          f"exact share {exact:.6f} (>= 0.999); bytes shipped {y.numel() + c.numel()} of "
          f"{pages.numel()} ({(y.numel() + c.numel()) / pages.numel():.3f})")
    require(packed_off == 0 and int(diff.max()) <= 1 and exact >= 0.999, "yc card vs CPU")
    rgb = pipe.process_pages(pages)
    pipe.transport = "yc"
    try:
        yc = pipe.process_pages(pages)
    finally:
        pipe.transport = "rgb"
    same = sum(a["text"] == b["text"] for r, s in zip(rgb, yc)
               for a, b in zip(r["columns"], s["columns"]))
    n_rgb = [len(r["columns"]) for r in rgb]
    n_yc = [len(r["columns"]) for r in yc]
    print(f"  columns per page RGB {n_rgb} / yc {n_yc}; texts equal in {same} of "
          f"{sum(min(a, b) for a, b in zip(n_rgb, n_yc))} column pairs in order")
    require(min(n_yc) > 0, "the yc cascade finds columns")
    return dict(packed_bytes_off=packed_off, unpack_max_level=int(diff.max()),
                unpack_exact_share=exact, columns_rgb=n_rgb, columns_yc=n_yc, texts_same=same)


def ship_once_vs_host(pipe, pages) -> dict:
    """Phase 13e: the ship-once route against the host path
    (``ship_once=False``) on 4 of 8b's equal-shape pages: the largest box
    difference of matched columns and the text agreement, reported and not
    held (the JAX package's own test of this pair,
    tests/test_cascade_e2e.py::test_ship_once_matches_host_path, finds its
    two paths 27.5 px apart)."""
    from kuzu_torch.testing import iou_matrix

    sub = pages[:4]
    once = pipe.process_pages(sub)
    pipe.ship_once = False
    try:
        host = pipe.process_pages(sub)
    finally:
        pipe.ship_once = True
    worst = 0.0
    same = total = unmatched = 0
    for a, b in zip(once, host):
        ba = np.asarray([c["box"] for c in a["columns"]], np.float32).reshape(-1, 4)
        bb = np.asarray([c["box"] for c in b["columns"]], np.float32).reshape(-1, 4)
        if not len(ba) or not len(bb):
            unmatched += len(ba) + len(bb)
            continue
        iou = iou_matrix(ba, bb)
        for i, j in enumerate(iou.argmax(1)):
            if iou[i, j] >= 0.5:
                total += 1
                worst = max(worst, float(np.abs(ba[i] - bb[j]).max()))
                same += a["columns"][i]["text"] == b["columns"][j]["text"]
            else:
                unmatched += 1
    print(f"ship-once vs host path, 4 pages of {PAGE}: columns {[len(r['columns']) for r in once]}"
          f" vs {[len(r['columns']) for r in host]}, {total} matched (IoU >= 0.5), {unmatched} "
          f"not; largest box difference {worst:.2f} px; texts equal {same} of {total} (reported, "
          f"not held)")
    return dict(columns_ship_once=[len(r["columns"]) for r in once],
                columns_host=[len(r["columns"]) for r in host], matched=total,
                unmatched=unmatched, max_box_diff_px=worst, texts_same=same)


def image_files_phase(dev, launches: dict) -> dict:
    """Phase 13: serving from image files (13a-e) on 8b's seeded, calibrated
    detectors and CRNN, inside a temporary directory."""
    import tempfile
    from pathlib import Path

    out = dict(card_vs_cpu=image_layer_card_vs_cpu(dev))
    pages = production_pages()
    tok = synthetic_tokenizer()
    col, char = production_detectors(dev, pages)
    crnn = seeded_crnn(dev, pages, CROP, len(tok), seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out["detector_from_files"] = detector_from_files(dev, root / "pages", col, launches)
        out["flat_and_host"] = flat_cascade(dev, root, col, char, crnn, tok, launches)
    pipe = cascade_pipeline(dev, col, char, crnn, tok, CROP, COL_MAX_DET)
    out["yc"] = yc_transport(dev, pipe, pages)
    out["ship_once_vs_host"] = ship_once_vs_host(pipe, pages)
    del pipe, col, char, crnn
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 15

ZOO_SMALL = ("yolov8n", "yolo11n", "yolov10n", "yolov9c")  # 15a: card against CPU at 128
ZOO_FULL = ("yolo11x", "yolov8x", "yolov9c", "yolov10x")  # 15b: inference at 640, b8
ZOO_TRAIN = ("yolo11x", "yolov10x")  # 15c: the v8 loss with C2PSA, and the E2E loss
ZOO_REMAT = "yolo11x"  # 15c's remat step
ZOO_WARM, ZOO_TIMED = 2, 4  # 15c's steps
ZOO_IMGSZ, ZOO_BATCH = 640, 8  # 15b and 15c


def zoo_selection(det, pred) -> dict:
    """The family's selection, as the port's predictor runs it: NMS on K1,
    or yolov10's NMS-free top-k."""
    return det.select(pred, CONF, 0.7, 300)


def zoo_card_vs_cpu(dev, launches: dict) -> dict:
    """15a: each family's n scale (yolov9c) at 128 px, batch 2, nc 80,
    seeded weights, infer -> decode -> selection on the card and on the CPU
    under phase 4's criteria: raw maps (every head) by ``maps_match``,
    decode within 2 px and 2e-4, the selection of one decoded tensor on the
    card identical to the CPU's, detections matched both ways."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.testing import detections_match, maps_agreement, maps_match

    imgs = torch.from_numpy(
        np.random.default_rng(15).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8))
    out = {}
    for name in ZOO_SMALL:
        gpu = YoloDetector(name, nc=80, imgsz=128, device=dev).init(0)
        cpu = YoloDetector(name, nc=80, imgsz=128, device="cpu").init(0)
        zero_counts()
        gmaps = gpu.infer(imgs)
        gpred = gpu.decode(gmaps)
        gdets = zoo_selection(gpu, gpred)
        torch.cuda.synchronize()
        counts = launch_counts()
        end2end = gpu.spec.end2end
        require(counts == want(nms=0 if end2end else 1), f"{name} launch counts {counts}")
        for k, c in counts.items():
            launches[k] += c
        cmaps = cpu.infer(imgs)
        cpred = cpu.decode(cmaps)
        cdets = zoo_selection(cpu, cpred)
        heads = ("one2one",) if end2end else ("",)
        worst = (0.0, 1.0)
        for head in heads:
            cm = cmaps[head] if head else cmaps
            gm = gmaps[head] if head else gmaps
            for lvl, (c, g) in enumerate(zip(cm, gm)):
                rel, share = maps_agreement(c, g)
                worst = (max(worst[0], rel), min(worst[1], share))
                require(maps_match(c, g), f"{name} card vs CPU raw maps {head} level {lvl}")
        dbox = float((gpred[:, :4].cpu() - cpred[:, :4]).abs().max())
        dscore = float((gpred[:, 4:].cpu() - cpred[:, 4:]).abs().max())
        require(dbox <= 2.0 and dscore <= 2e-4, f"{name} card vs CPU decode")
        same = zoo_selection(gpu, cpred.to(dev))
        for key in cdets:
            require(torch.equal(same[key].cpu(), cdets[key]),
                    f"{name}: selection of one decoded tensor, card vs CPU: {key}")
        nc_, ng = cdets["valid"].sum(1), gdets["valid"].sum(1).cpu()
        m1, m2 = detections_match(cdets, gdets), detections_match(gdets, cdets)
        print(f"15a {name}@128 b2: launches {counts}; maps worst rel {worst[0]:.4f} (< 0.05), "
              f"least share close {worst[1]:.5f} (> 0.999); decode box {dbox:.4f} px, score "
              f"{dscore:.2e}; {'NMS-free selection' if end2end else 'NMS (K1)'} of the CPU's "
              f"decoded tensor on the card identical; valid {nc_.tolist()} CPU vs "
              f"{ng.tolist()} card, matched {m1:.4f} / {m2:.4f} (>= 0.9)")
        require(bool(((nc_ - ng).abs() <= 0.1 * nc_).all()) and m1 >= 0.9 and m2 >= 0.9,
                f"{name} card vs CPU detections")
        out[name] = dict(max_rel=worst[0], min_share=worst[1], box_px=dbox, score=dscore,
                         matched=(m1, m2))
        del gpu, cpu
    torch.cuda.empty_cache()
    return out


def zoo_full_width(dev, launches: dict) -> dict:
    """15b: yolo11x, yolov8x, yolov9c and yolov10x at 640, batch 8, bf16,
    nc 80, seeded weights, conf 0.001: ``YoloDetector.infer`` -> ``decode``
    -> NMS on K1 (yolov10x: ``nms_free_select``). Launch counts, finite
    maps, every K1 call of one call held against the plain recurrence on
    its inputs (0 keep mismatches), yolov10x's selection on the card equal
    to the CPU's on the same tensor; ms/img (median of 10 calls, CUDA
    events), device ms and idle share of one profiled call, peak memory."""
    import kuzu_torch.ops.nms as nms_module
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.ops.nms import nms_free_select

    n, sz = ZOO_BATCH, ZOO_IMGSZ
    imgs = torch.from_numpy(
        np.random.default_rng(16).integers(0, 256, (n, sz, sz, 3), dtype=np.uint8)).to(dev)
    out = {}
    for name in ZOO_FULL:
        det = YoloDetector(name, nc=80, imgsz=sz, device=dev).init(0)

        def run():
            return zoo_selection(det, det.decode(det.infer(imgs)))

        run()  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        k1 = dict(calls=0, keep_mismatches=0, valid_max=0)

        def nms_check(fn, boxes, valid, thr):
            keep = fn(boxes, valid, thr)
            k1["calls"] += 1
            k1["keep_mismatches"] += k1_keep_mismatches(keep, boxes, valid, thr)
            k1["valid_max"] = max(k1["valid_max"], int(valid.sum(1).max()))
            return keep

        zero_counts()
        with spy(nms_module, "batched_suppress", nms_check):
            maps = det.infer(imgs)
            pred = det.decode(maps)
            dets = zoo_selection(det, pred)
            torch.cuda.synchronize()
            counts = launch_counts()
        end2end = det.spec.end2end
        require(counts == want(nms=0 if end2end else 1), f"{name} launch counts {counts}")
        for k, c in counts.items():
            launches[k] += c
        flat = [m for ms in (maps.values() if end2end else [maps]) for m in ms]
        require(all(bool(torch.isfinite(m).all()) for m in flat) and
                bool(torch.isfinite(pred).all()), f"{name} finite maps and decode")
        nvalid = dets["valid"].sum(1).tolist()
        require(min(nvalid) > 0, f"{name}: every image has detections")
        if end2end:
            cpu = nms_free_select(pred.cpu(), conf_thres=CONF, max_det=300)
            equal = all(torch.equal(dets[k].cpu(), cpu[k]) for k in cpu)
            require(equal and k1["calls"] == 0, f"{name}: nms_free_select card vs CPU")
            check = "nms_free_select on the card equal to the CPU's on the same tensor"
        else:
            require(k1["calls"] == 1 and k1["keep_mismatches"] == 0,
                    f"{name}: K1 keeps against the plain recurrence {k1}")
            check = (f"K1 {k1['calls']} call, up to {k1['valid_max']} valid boxes an image, keep "
                     f"mismatches {k1['keep_mismatches']} (must be 0)")
        torch.cuda.reset_peak_memory_stats()
        e2e = time_ms(run, reps=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"15b {name}@{sz} b{n} bf16: {det.param_count()} params, launches {counts}; "
              f"{check}; valid per image {nvalid}; {e2e:.3f} ms/batch = {e2e / n:.4f} ms/img "
              f"(median of 10), peak memory {peak:.2f} GiB")
        bd = device_breakdown(run)
        out[name] = dict(ms_per_img=e2e / n, ms_per_batch=e2e, device_ms=bd["busy_ms"],
                         idle_share=bd["idle_share"], peak_gib=peak, k1_launches=counts["nms"],
                         params=det.param_count(), breakdown=bd)
        del det, maps, pred, dets
        torch.cuda.empty_cache()
    return out


def zoo_train_run(dev, name: str, root, launches: dict) -> dict:
    """15c for one model: ``DetectTrainer`` over decoded synthetic pages
    (``trainer_for``) at 640, batch 8, bf16, nc 1, one epoch of ZOO_WARM +
    ZOO_TIMED steps and one validation batch: launches per step (none: PSA
    attention is materialised) and in the validation (K1 once; yolov10x
    NMS-free, none), finite losses, ms/step, a profiled step's device time
    and idle share, peak memory; and the run dir in ``DetectPredictor``
    against the trainer's EMA weights in memory: equal detections."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.detect import DetectPredictor, trainer_for
    from kuzu_torch.testing import SyntheticDetectionDataset

    steps, n, sz = ZOO_WARM + ZOO_TIMED, ZOO_BATCH, ZOO_IMGSZ
    cfg = load_config(overrides=dict(model=name, imgsz=sz, batch=n, dtype="bfloat16",
                                     epochs=1, workers=2, project=str(root), name=name,
                                     exist_ok=True, save=True, verbose=False))
    train_ds = SyntheticDetectionDataset(n * steps, sz, max_boxes=400, nc=1, seed=0)
    val_ds = SyntheticDetectionDataset(n, sz, max_boxes=400, nc=1, seed=1)
    trainer = trainer_for((train_ds, val_ds, 1))(cfg, device=dev)
    rec = StepRecorder()
    for ev, fn in (("on_train_start", rec.start), ("on_step_end", rec.step),
                   ("on_val_start", rec.val_start), ("on_val_end", rec.val_end)):
        trainer.callbacks.add(ev, fn)
    trainer.train()
    end2end = trainer.spec.end2end
    require(len(rec.counts) == steps and all(c == want() for c in rec.counts),
            f"{name} per-step launches {rec.counts}")
    require(rec.val_counts == want(nms=0 if end2end else 1),
            f"{name} validation launches {rec.val_counts}")
    for k, c in rec.val_counts.items():
        launches[k] += c
    losses = [float(m["loss"]) for m in rec.metrics]
    require(all(np.isfinite(losses)), f"{name} finite losses {losses}")
    times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
    ms = statistics.median(times[ZOO_WARM:])
    print(f"15c {name}@{sz} b{n} bf16 DetectTrainer ({'E2E' if end2end else 'v8'} loss): "
          f"{sum(p.numel() for p in trainer.state.model.parameters())} params; losses "
          f"{[round(x, 3) for x in losses]}; {ms:.3f} ms/step (median of {ZOO_TIMED} after "
          f"{ZOO_WARM}; steps {[round(t, 2) for t in times]}), peak memory "
          f"{rec.peak / 2**30:.2f} GiB; validation launches {rec.val_counts} "
          f"({'NMS-free selection' if end2end else 'K1'}), {rec.val_metrics}")
    r = dict(ms_per_step=ms, step_ms=times, losses=losses, peak_gib=rec.peak / 2**30,
             val_launches=rec.val_counts)
    imgs = torch.from_numpy(np.stack([val_ds[i]["image"] for i in range(n)])).to(dev)
    loaded = DetectPredictor(load_config(overrides={"model": str(trainer.save_dir),
                                                    "conf": CONF}), device=dev)
    mem = DetectPredictor.from_detector(
        YoloDetector(trainer.spec, imgsz=sz, device=dev).load_state_dict(
            trainer.state.ema_state_dict()), conf=CONF)
    a, b = loaded._fwd(imgs), mem._fwd(imgs)
    equal = all(torch.equal(a[k], b[k]) for k in a)
    print(f"  run dir in DetectPredictor against the EMA weights in memory: detections equal "
          f"{equal} ({int(a['valid'].sum())} valid)")
    require(equal, f"{name}: the run dir's detections equal the EMA weights'")
    del loaded, mem
    # after the comparison: the profiled steps move the weights and the EMA
    r["breakdown"] = train_step_breakdown(trainer, train_ds)
    r["device_ms"], r["idle_share"] = r["breakdown"]["busy_ms"], r["breakdown"]["idle_share"]
    del trainer
    torch.cuda.empty_cache()
    return r


def zoo_remat_check(dev) -> dict:
    """15c: one yolo11x@640 b8 bf16 train step with ``remat`` (C3k2 and C2PSA
    checkpointed) against the plain step on the same weights and batch,
    under phase 9's remat criteria: loss within 1e-4, whole-gradient cosine
    >= 0.9999, every leaf above 1e-3 of the largest norm >= 0.999, equal
    BatchNorm statistics; each step's peak memory."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
    from kuzu_torch.ops.detect_loss import detection_loss
    from kuzu_torch.testing import SyntheticDetectionDataset

    path, scale = resolve_model_spec(ZOO_REMAT)
    spec = parse_model_yaml(path, scale=scale, nc=1)
    n, sz = ZOO_BATCH, ZOO_IMGSZ
    ds = SyntheticDetectionDataset(n, sz, max_boxes=400, nc=1, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in default_collate([ds[i] for i in range(n)]).items()}
    cfg = load_config(overrides=dict(warmup_epochs=0, epochs=1, grad_clip=0))
    runs = {}
    for remat in (False, True):
        graph = YoloGraph(spec, dtype=torch.bfloat16, remat=remat)
        graph.reset_parameters(torch.Generator().manual_seed(0))
        graph.to(dev)
        tx = build_optimizer(cfg, graph, 1)
        grads = {}
        update = tx.step

        def snapshot_then_step(count, grad_norm, graph=graph, grads=grads, update=update):
            grads.update({n: p.grad.detach().float().cpu() for n, p in graph.named_parameters()})
            update(count, grad_norm)

        tx.step = snapshot_then_step
        step = make_train_step(lambda model, b: detection_loss(
            model(b["image"]), b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=1, imgsz=sz,
            strides=spec.strides, reg_max=spec.reg_max), tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = step(TrainState(graph, tx), batch)
        torch.cuda.synchronize()
        runs[remat] = dict(loss=float(metrics["loss"]), grads=grads,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           stats={n: t.detach().float().cpu() for n, t in graph.named_buffers()
                                  if "running" in n})
        del graph, tx, step
        torch.cuda.empty_cache()
    plain, rm = runs[False], runs[True]
    names = list(plain["grads"])
    rel = abs(rm["loss"] - plain["loss"]) / abs(plain["loss"])
    whole = _cos(torch.cat([rm["grads"][n].flatten() for n in names]),
                 torch.cat([plain["grads"][n].flatten() for n in names]))
    top = max(float(t.norm()) for t in plain["grads"].values())
    leaf = min(_cos(rm["grads"][n], plain["grads"][n]) for n in names
               if float(plain["grads"][n].norm()) > 1e-3 * top)
    stats_equal = all(torch.equal(rm["stats"][n], t) for n, t in plain["stats"].items())
    print(f"15c {ZOO_REMAT}@{sz} b{n} bf16 step, remat vs plain: loss rel {rel:.2e} (<= 1e-4), "
          f"whole-gradient cosine {whole:.7f} (>= 0.9999), worst leaf cosine {leaf:.5f} "
          f"(>= 0.999), BN statistics equal {stats_equal}; peak memory "
          f"{rm['peak_gib']:.2f} GiB with remat, {plain['peak_gib']:.2f} without")
    require(rel <= 1e-4 and whole >= 0.9999 and leaf >= 0.999 and stats_equal,
            f"{ZOO_REMAT} remat step equals the plain one")
    return dict(loss_rel=rel, whole_cos=whole, leaf_cos=leaf, stats_equal=stats_equal,
                peak_gib_remat=rm["peak_gib"], peak_gib_plain=plain["peak_gib"])


def zoo_phase(dev, launches: dict) -> dict:
    """Phase 15: 15a, 15b, 15c."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    out = dict(card_vs_cpu=zoo_card_vs_cpu(dev, launches),
               inference=zoo_full_width(dev, launches))
    with tempfile.TemporaryDirectory() as tmp:
        out["training"] = {name: zoo_train_run(dev, name, Path(tmp), launches)
                           for name in ZOO_TRAIN}
    out["training"][f"{ZOO_REMAT}_remat"] = zoo_remat_check(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 15: {out['seconds']:.1f} s")
    return out


# ------------------------------------------- phase 16: the other task heads

HEADS_SMALL = ("yolov8n-seg", "yolov8n-pose", "yolov8n-obb", "yolov8n-cls")  # 16a, 128 b2
# 16b / 16c at Ultralytics' published settings: (task, model, imgsz, batch)
HEADS_FULL = (("segment", "yolov8x-seg", 640, 8), ("pose", "yolov8x-pose", 640, 8),
              ("obb", "yolov8x-obb", 1024, 4), ("classify", "yolov8x-cls", 224, 64))
HEADS_WARM, HEADS_TIMED = 3, 5  # 16c's steps
HEADS_NC = {"segment": 80, "pose": 1, "obb": 15}  # the yamls' COCO / COCO-pose / DOTA classes
CLS_CLASSES = 64  # 16c's glyph folder: 64 classes, 8 training images and 1 validation each
MASK_SHARE = 0.99  # 16a: mask pixels equal, card against CPU
KPT_PX = 0.05  # 16a: keypoints, card against CPU
CLS_TOL = 1e-3  # 16a: classify logits (f32, the predictor's dtype), relative to the largest


MASK_COEFF_SCALE = 1e7  # 16a: seeded mask logits are ~1e-7, inside the sigmoid's rounding at 0.5


def scaled_coefficients(outputs: dict) -> dict:
    """A Segment output with its mask coefficients times MASK_COEFF_SCALE.
    Seeded, every mask logit is ~1e-7, where f32 sigmoid rounds to 0.5 or
    to the next float by each library's own formula, so masks would be the
    sign of rounding; scaled, the logits are O(1), as a trained head's, and
    the masks depend on the input (a stand-in, as ``testing.box_head`` is
    for the box heads)."""
    return {**outputs, "coeffs": outputs["coeffs"] * MASK_COEFF_SCALE}


def mask_logits(outputs: dict, sel: dict) -> torch.Tensor:
    """The kept boxes' mask logits (coefficients x prototypes), uncropped."""
    c = torch.gather(outputs["coeffs"], 1,
                     sel["indices"][..., None].expand(-1, -1, outputs["coeffs"].shape[-1]))
    return torch.einsum("bdn,bhwn->bdhw", c, outputs["protos"])


def head_outputs(det, outputs, task: str, sel: dict) -> dict:
    """A head's extras for the selection ``sel`` (its anchor indices):
    segment's masks, pose's keypoints."""
    from kuzu_torch.tasks.pose import decode_keypoints
    from kuzu_torch.tasks.segment import compose_masks

    if task == "segment":
        return {"masks": compose_masks(outputs, sel, det.imgsz)}
    return {"kpts": decode_keypoints(det, outputs, sel)}


def heads_card_vs_cpu(dev, launches: dict) -> dict:
    """16a: each head's n scale at 128 px, batch 2, its yaml's nc, seeded
    weights, bf16, on the card and on the CPU: raw maps and the extra
    outputs by ``maps_match``; the selection of one decoded tensor (the
    CPU's) identical on both devices (K1 against the plain sweep; OBB the
    rotated keeps); on that selection each device's masks (>= 99% of pixels
    equal) and keypoints (within 0.05 px); classify's logits of the module
    tree (eval mode, f32: ``ClassifyPredictor``'s, as JAX's predictor) within
    1e-3 of the largest with identical top-1, bf16's reported."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.models.yolo.graph import YoloGraph
    from kuzu_torch.ops.obb import nms_rotated_padded
    from kuzu_torch.tasks.obb import rotated_candidates
    from kuzu_torch.testing import maps_agreement, maps_match

    imgs = torch.from_numpy(
        np.random.default_rng(16).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8))
    out = {}
    for name in HEADS_SMALL:
        task = {"seg": "segment", "pose": "pose", "obb": "obb", "cls": "classify"}[
            name.split("-")[1]]
        if task == "classify":  # the predictor's route: the module tree, eval, f32
            errs = {}
            for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                logits = []
                for d in (dev, "cpu"):
                    g = YoloGraph(YoloDetector(name, device="cpu").spec, dtype=dt)
                    g.reset_parameters(torch.Generator().manual_seed(0))
                    with torch.no_grad():
                        logits.append(g.to(d).eval()(imgs.to(d)).float().cpu())
                lg, lc = logits
                errs[label] = (float((lg - lc).abs().max() / lc.abs().max()),
                               bool(torch.equal(lg.argmax(-1), lc.argmax(-1))))
            err, top1 = errs["f32"]
            print(f"16a {name}@128 b2 (module tree, eval): logits card vs CPU max |d| / max |CPU| "
                  f"f32 {err:.2e} (<= {CLS_TOL}), top-1 identical {top1}; bf16 (the training "
                  f"dtype, reported) {errs['bf16'][0]:.2e}, top-1 identical {errs['bf16'][1]}")
            require(err <= CLS_TOL and top1, f"{name} card vs CPU logits")
            out[name] = dict(logit_err=err, top1_equal=top1, logit_err_bf16=errs["bf16"][0])
            continue
        gpu = YoloDetector(name, imgsz=128, device=dev).init(0)
        cpu = YoloDetector(name, imgsz=128, device="cpu").init(0)
        zero_counts()
        gout = gpu.infer(imgs)
        torch.cuda.synchronize()
        cout = cpu.infer(imgs)
        worst = (0.0, 1.0)
        for key in gout:
            pairs = zip(cout[key], gout[key]) if key == "det" else [(cout[key], gout[key])]
            for c, g in pairs:
                rel, share = maps_agreement(c, g)
                worst = (max(worst[0], rel), min(worst[1], share))
                require(maps_match(c, g), f"{name} card vs CPU raw maps: {key}")
        if task == "obb":
            cand = rotated_candidates(cpu, cout)
            valid = torch.ones(cand[1].shape, dtype=torch.bool)
            cdets = nms_rotated_padded(*cand, valid, iou_threshold=0.7, score_threshold=CONF)
            same = nms_rotated_padded(*(t.to(dev) for t in (*cand, valid)), iou_threshold=0.7,
                                      score_threshold=CONF)
            extra = ("rotated keeps (probIoU, the batched fixed point) of the CPU's decoded "
                     "candidates")
        else:
            cpred = cpu.decode(cout)
            cdets = cpu.select(cpred, CONF, 0.7, 300, return_indices=True)
            same = gpu.select(cpred.to(dev), CONF, 0.7, 300, return_indices=True)
            extra = "NMS (K1 against the plain sweep) of the CPU's decoded tensor"
        torch.cuda.synchronize()
        counts = launch_counts()
        require(counts == want(nms=0 if task == "obb" else 1), f"{name} launch counts {counts}")
        for k, c in counts.items():
            launches[k] += c
        for key in cdets:
            require(torch.equal(same[key].cpu(), cdets[key]),
                    f"{name}: selection of one set of outputs, card vs CPU: {key}")
        r = dict(max_rel=worst[0], min_share=worst[1], valid=cdets["valid"].sum(1).tolist())
        line = ""
        if task != "obb":
            sel_g = {k: v.to(dev) for k, v in cdets.items()}
            if task == "segment":
                gout, cout = scaled_coefficients(gout), scaled_coefficients(cout)
            eg, ec = head_outputs(gpu, gout, task, sel_g), head_outputs(cpu, cout, task, cdets)
            if task == "segment":
                # the CPU's coefficients and prototypes composed on both
                # devices (f32, TF32 off), as the selection takes one
                # decoded tensor; each device's own forward is reported:
                # its bf16 maps part by up to 5%, which moves the masks of
                # the pixels whose logit lies within that of 0 (the
                # coefficients scaled in both, see scaled_coefficients)
                v = cdets["valid"]
                same = head_outputs(gpu, {k: v_.to(dev) for k, v_ in cout.items()
                                          if k != "det"}, task, sel_g)
                share = float((same["masks"].cpu()[v] == ec["masks"][v]).float().mean())
                own = float((eg["masks"].cpu()[v] == ec["masks"][v]).float().mean())
                scale = float(mask_logits(cout, cdets)[v].abs().max())
                require(share >= MASK_SHARE, f"{name} mask pixels card vs CPU {share}")
                r.update(mask_share=share, mask_share_own_forwards=own, mask_logit_max=scale)
                line = (f"; masks of the kept boxes from the CPU's outputs {share:.5f} of pixels "
                        f"equal (>= {MASK_SHARE}); from each device's own forward {own:.5f} "
                        f"(reported: max |mask logit| {scale:.2e})")
            else:
                v = cdets["valid"]
                dpx = float((eg["kpts"].cpu()[v][..., :2] - ec["kpts"][v][..., :2]).abs().max())
                require(dpx <= KPT_PX, f"{name} keypoints card vs CPU {dpx} px")
                r["kpt_px"] = dpx
                line = f"; keypoints of the kept boxes within {dpx:.4f} px (<= {KPT_PX})"
        print(f"16a {name}@128 b2 bf16: launches {counts}; maps worst rel {worst[0]:.4f} "
              f"(< 0.05), least share close {worst[1]:.5f} (> 0.999); {extra} on the card "
              f"identical; valid {r['valid']}{line}")
        out[name] = r
        del gpu, cpu
    torch.cuda.empty_cache()
    return out


def heads_full_width(dev, launches: dict) -> dict:
    """16b: each head at its published size, seeded weights, bf16, through
    its predictor's forward (segment: infer, decode, NMS on K1 with indices,
    the masks; pose: the keypoints; obb: the rotated decode and NMS;
    classify: ``ClassifyPredictor.probs`` of the module tree): launches,
    finite outputs, ms/img (median of 10), device ms, idle share and K1's
    device ms of one profiled call, peak memory."""
    from kuzu_torch.core.config import Config
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.classify import ClassifyPredictor, build_classifier
    from kuzu_torch.tasks.obb import OBBPredictor
    from kuzu_torch.tasks.pose import PosePredictor
    from kuzu_torch.tasks.segment import SegmentPredictor

    out = {}
    for task, name, sz, n in HEADS_FULL:
        imgs = torch.from_numpy(np.random.default_rng(17).integers(
            0, 256, (n, sz, sz, 3), dtype=np.uint8)).to(dev)
        if task == "classify":
            pred = ClassifyPredictor.__new__(ClassifyPredictor)
            pred.model = build_classifier(Config(model=name), 1000)
            pred.model.reset_parameters(torch.Generator().manual_seed(0))
            pred.model.to(dev).eval()
            pred.ready, pred.device = True, dev
            params = sum(p.numel() for p in pred.model.parameters())
            run = lambda: pred.probs(imgs)  # noqa: E731
        else:
            det = YoloDetector(name, nc=HEADS_NC[task], imgsz=sz, device=dev).init(0)
            cls = {"segment": SegmentPredictor, "pose": PosePredictor, "obb": OBBPredictor}[task]
            pred = cls.from_detector(det, conf=CONF, iou=0.7, max_det=300)
            params = det.param_count()
            run = lambda: pred._fwd(imgs)  # noqa: E731
        run()
        torch.cuda.synchronize()
        zero_counts()
        res = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        k1 = 1 if task in ("segment", "pose") else 0
        require(counts == want(nms=k1), f"{name} launch counts {counts}")
        for k, c in counts.items():
            launches[k] += c
        if task == "classify":
            require(bool(torch.isfinite(res).all()) and tuple(res.shape) == (n, 1000),
                    f"{name} finite probabilities")
            what = f"probabilities {tuple(res.shape)}"
        else:
            valid = res["valid"].sum(1).tolist()
            require(min(valid) > 0 and bool(torch.isfinite(res["boxes"]).all()),
                    f"{name}: finite detections in every image")
            what = f"valid per image {valid}" + (
                f", masks {tuple(res['masks'].shape)}" if task == "segment" else
                f", keypoints {tuple(res['kpts'].shape)}" if task == "pose" else "")
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(run, reps=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        dtype = "f32 (the predictor's, as JAX's)" if task == "classify" else "bf16"
        print(f"16b {name}@{sz} b{n} {dtype}: {params} params, launches {counts}; {what}; "
              f"{ms:.3f} ms/batch = {ms / n:.4f} ms/img (median of 10), peak memory "
              f"{peak:.2f} GiB")
        bd = device_breakdown(run)
        k1_ms = bd["groups_ms"].get("K1 nms", 0.0)
        print(f"  K1: {k1_ms:.4f} ms of {bd['busy_ms']:.3f} ms device")
        out[name] = dict(ms_per_img=ms / n, ms_per_batch=ms, device_ms=bd["busy_ms"],
                         idle_share=bd["idle_share"], k1_device_ms=k1_ms, peak_gib=peak,
                         k1_launches=counts["nms"], params=params, breakdown=bd)
        del pred, imgs
        torch.cuda.empty_cache()
    return out


def head_folder(root, task: str, sz: int, n: int):
    """16c's data: PNG pages written here (``testing.write_head_folder`` /
    ``write_glyph_folder``), enough for HEADS_WARM + HEADS_TIMED batches of
    ``n`` and one validation batch; 3 x 4 pages at ``sz``'s aspect."""
    from kuzu_torch.testing import write_glyph_folder, write_head_folder

    steps = HEADS_WARM + HEADS_TIMED
    if task == "classify":
        per = -(-n * steps // CLS_CLASSES)
        return write_glyph_folder(root / task, {"train": per, "val": 1},
                                  n_classes=CLS_CLASSES, hw=(64, 48))
    return write_head_folder(root / task, task, {"train": n * steps, "val": n},
                             hw=(sz * 3 // 4, sz), n_inst=(4, 12), nc=HEADS_NC.get(task, 1),
                             seed=16)


def train_recorded(model, rec: "StepRecorder", **kw):
    """``model.train(**kw)`` (a ``Model`` facade) with ``rec``'s callbacks
    on its trainer: (the trainer, the final metrics)."""
    trainer_cls = model._component("trainer")
    seen = []

    class Recorded(trainer_cls):
        def train(self):
            for ev, fn in (("on_train_start", rec.start), ("on_step_end", rec.step),
                           ("on_val_start", rec.val_start), ("on_val_end", rec.val_end)):
                self.callbacks.add(ev, fn)
            seen.append(self)
            return super().train()

    model._component = lambda kind: Recorded if kind == "trainer" else trainer_cls
    final = model.train(**kw)
    return seen[0], final


def heads_train_run(dev, task: str, name: str, sz: int, n: int, root, launches: dict) -> dict:
    """16c for one head: ``Model(name, task=...).train`` over PNG files
    written in the phase (the port's own datasets decode them), bf16, one
    epoch of HEADS_WARM + HEADS_TIMED steps and one validation batch:
    launches per step (none) and in the validation (K1 once for segment and
    pose), finite losses, ms/step, a profiled step (kernel ms, idle share),
    peak memory; the run dir in its predictor against the EMA weights in
    memory: equal outputs."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.core.config import Config, load_config
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.classify import ClassifyPredictor, build_classifier
    from kuzu_torch.tasks.obb import OBBPredictor
    from kuzu_torch.tasks.pose import PosePredictor
    from kuzu_torch.tasks.segment import SegmentPredictor

    t0 = time.perf_counter()
    data = head_folder(root, task, sz, n)
    write_s = time.perf_counter() - t0
    model = Model(name, task=task, device=dev)
    rec = StepRecorder()
    trainer, _ = train_recorded(model, rec, data=str(data), imgsz=sz, batch=n,
                                dtype="bfloat16", epochs=1, workers=4,
                                project=str(root / "runs"), name=task, exist_ok=True,
                                verbose=False)
    steps = HEADS_WARM + HEADS_TIMED
    k1 = 1 if task in ("segment", "pose") else 0
    require(len(rec.counts) == steps and all(c == want() for c in rec.counts),
            f"{name} per-step launches {rec.counts}")
    require(rec.val_counts == want(nms=k1), f"{name} validation launches {rec.val_counts}")
    for k, c in rec.val_counts.items():
        launches[k] += c
    losses = [float(m["loss"]) for m in rec.metrics]
    require(all(np.isfinite(losses)), f"{name} finite losses {losses}")
    times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
    ms = statistics.median(times[HEADS_WARM:])
    params = sum(p.numel() for p in trainer.state.model.parameters())
    print(f"16c {name}@{sz} b{n} bf16 {type(trainer).__mro__[1].__name__} from {data.name}'s "
          f"PNG files (written in {write_s:.1f} s): {params} params; losses "
          f"{[round(x, 3) for x in losses]}; {ms:.3f} ms/step (median of {HEADS_TIMED} after "
          f"{HEADS_WARM}; steps {[round(t, 2) for t in times]}), peak memory "
          f"{rec.peak / 2**30:.2f} GiB; validation launches {rec.val_counts}, {rec.val_metrics}")
    r = dict(ms_per_step=ms, step_ms=times, losses=losses, peak_gib=rec.peak / 2**30,
             val_launches=rec.val_counts, params=params)
    run_dir = trainer.save_dir
    ds = trainer.val_ds
    imgs = torch.from_numpy(np.stack([ds[i]["image"] for i in range(min(n, len(ds)))])).to(dev)
    cfg = load_config(overrides={"model": str(run_dir), "conf": CONF})
    if task == "classify":  # the predictor runs f32, as JAX's
        loaded = ClassifyPredictor(cfg, device=dev)
        mem = build_classifier(Config(model=name), trainer.train_ds.num_classes).to(dev).eval()
        mem.load_state_dict(trainer.state.ema_state_dict())
        with torch.no_grad():
            a, b = loaded.probs(imgs), torch.softmax(mem(imgs), -1)
        equal, nvalid = bool(torch.equal(a, b)), len(a)
    else:
        pcls = {"segment": SegmentPredictor, "pose": PosePredictor, "obb": OBBPredictor}[task]
        loaded = pcls(cfg, device=dev)
        mem = pcls.from_detector(YoloDetector(trainer.spec, imgsz=sz, device=dev).load_state_dict(
            trainer.state.ema_state_dict()), conf=CONF)
        a, b = loaded._fwd(imgs), mem._fwd(imgs)
        equal, nvalid = all(torch.equal(a[k], b[k]) for k in a), int(a["valid"].sum())
    print(f"  run dir in {type(loaded).__name__} against the EMA weights in memory: outputs "
          f"equal {equal} ({nvalid} {'images' if task == 'classify' else 'valid'})")
    require(equal, f"{name}: the run dir's outputs equal the EMA weights'")
    del loaded, mem
    r["breakdown"] = train_step_breakdown(trainer, trainer.train_ds, n)
    r["device_ms"], r["idle_share"] = r["breakdown"]["busy_ms"], r["breakdown"]["idle_share"]
    del trainer, model
    torch.cuda.empty_cache()
    return r


def heads_phase(dev, launches: dict) -> dict:
    """Phase 16: 16a, 16b, 16c."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    out = dict(card_vs_cpu=heads_card_vs_cpu(dev, launches),
               inference=heads_full_width(dev, launches))
    with tempfile.TemporaryDirectory() as tmp:
        out["training"] = {name: heads_train_run(dev, task, name, sz, n, Path(tmp), launches)
                           for task, name, sz, n in HEADS_FULL}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 16: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 17

NAS_FULL = ("yolo_nas_l", 640, 8)  # 17a: the full width (SIZES["l"], channels 64-768)
NAS_CMP = (320, 2)  # 17a's card-vs-CPU batch (size, images): the CPU runs the f32 forwards
NAS_NC = 80  # the COCO classes of the reference's pretrained NAS models
NAS_WARM, NAS_TIMED = 2, 4  # 17a's training steps
NAS_F32_TOL = 1e-4  # 17a: f32 maps card vs CPU and fused vs unfused, relative to the largest
ENC_CROPS = 8  # 17b's crops at the production size CROP
ENC_TOL = 1e-4  # 17b: f32 encoder memory card vs CPU, relative to the largest
VIT_BATCH = 64  # 17c: glyphs at 128 px, one channel, VOCAB classes
VIT_TOL = 1e-4  # 17c: f32 logits card vs CPU, relative to the largest
LETTERBOX_TOL = 1e-6  # 17d: canvases card vs CPU (pixels in [0, 1])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def nas_card_vs_cpu(dev, det_gpu, launches: dict) -> dict:
    """17a, first part: YOLO-NAS-L's seeded weights at NAS_CMP on the card and
    on the CPU, f32 at torch's default TF32 setting (the model's forward
    runs inside ``f32_products``): the fused maps within NAS_F32_TOL, the
    card's fused forward against its unfused one within NAS_F32_TOL, and the
    selection of one decoded tensor (the CPU's) identical on both devices
    (K1 against the plain sweep)."""
    from kuzu_torch.models.nas import NASDetector

    cpu = NASDetector(NAS_FULL[0], nc=NAS_NC, imgsz=NAS_FULL[1], device="cpu")
    cpu.load_state_dict(det_gpu.graph.state_dict())
    sz, n = NAS_CMP
    x = torch.from_numpy(np.random.default_rng(17).integers(0, 256, (n, sz, sz, 3),
                                                            dtype=np.uint8))
    tf32 = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    zero_counts()
    g = det_gpu.infer(x)
    torch.cuda.synchronize()
    require(launch_counts() == want(), "17a: the NAS forward launches no kernel")
    t0 = time.perf_counter()
    c = cpu.infer(x)
    cpu_s = time.perf_counter() - t0
    err = max(_rel(a, b) for a, b in zip(g, c))
    fuse_err = max(_rel(a, b) for a, b in zip(g, det_gpu.apply(x)))
    pred = cpu.decode(c)
    zero_counts()
    sg = det_gpu.select(pred.to(dev), CONF, 0.7, 300)
    torch.cuda.synchronize()
    counts = launch_counts()
    sc = cpu.select(pred, CONF, 0.7, 300)
    same = all(torch.equal(sg[k].cpu(), sc[k]) for k in sc)
    nvalid = sc["valid"].sum(1).tolist()
    print(f"17a {NAS_FULL[0]}@{sz} b{n} f32 card vs CPU (cuDNN allow_tf32 {tf32[0]}, matmul "
          f"precision {tf32[1]}: torch's defaults; CPU forward {cpu_s:.1f} s): fused maps max "
          f"|d| / max |CPU| {err:.2e} (<= {NAS_F32_TOL}); card fused vs unfused {fuse_err:.2e} "
          f"(<= {NAS_F32_TOL}); NMS of the CPU's decode: keeps identical {same}, valid "
          f"{nvalid}, launches {counts}")
    require(err <= NAS_F32_TOL and fuse_err <= NAS_F32_TOL, "17a NAS maps card vs CPU, fused")
    require(same and min(nvalid) > 0 and counts == want(nms=1), "17a NAS keeps card vs CPU")
    for k, v in counts.items():
        launches[k] += v
    return dict(map_err=err, fused_vs_unfused=fuse_err, keeps_equal=same, valid=nvalid,
                cpu_s=cpu_s, default_tf32=list(tf32))


def nas_full_width(dev, det, launches: dict) -> dict:
    """17a: ``NASPredictor`` over the seeded YOLO-NAS-L at 640, batch 8, f32
    (the predictor's, as JAX's): the re-parameterised forward, the decode
    and NMS on K1; launches, finite detections, ms/img, device ms, idle
    share, K1's device ms, peak memory."""
    from kuzu_torch.tasks.nas import NASPredictor

    name, sz, n = NAS_FULL
    pred = NASPredictor.from_detector(det, conf=CONF, iou=0.7, max_det=300)
    imgs = torch.from_numpy(np.random.default_rng(18).integers(
        0, 256, (n, sz, sz, 3), dtype=np.uint8)).to(dev)
    run = lambda: pred._fwd(imgs)  # noqa: E731
    run()
    torch.cuda.synchronize()
    zero_counts()
    res = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts == want(nms=1), f"17a {name} launch counts {counts}")
    for k, v in counts.items():
        launches[k] += v
    valid = res["valid"].sum(1).tolist()
    require(min(valid) > 0 and bool(torch.isfinite(res["boxes"]).all()),
            "17a: finite detections in every image")
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17a {name}@{sz} b{n} f32 NASPredictor: {det.param_count()} params, launches "
          f"{counts}; valid per image {valid}; {ms:.3f} ms/batch = {ms / n:.4f} ms/img "
          f"(median of 10), peak memory {peak:.2f} GiB")
    bd = device_breakdown(run)
    k1_ms = bd["groups_ms"].get("K1 nms", 0.0)
    print(f"  K1: {k1_ms:.4f} ms of {bd['busy_ms']:.3f} ms device")
    return dict(ms_per_img=ms / n, ms_per_batch=ms, device_ms=bd["busy_ms"],
                idle_share=bd["idle_share"], k1_device_ms=k1_ms, peak_gib=peak,
                params=det.param_count(), breakdown=bd)


def nas_train_run(dev, launches: dict) -> dict:
    """17a: ``NASTrainer`` at 640, batch 8, in the trainer's default dtype
    (the config's bfloat16), NAS_NC classes, over the synthetic character
    pages: NAS_WARM + NAS_TIMED steps and one validation batch (the
    re-parameterised forward and NMS on K1); launches per step (none) and
    in the validation (K1 once), finite losses, ms/step, a profiled step,
    peak memory."""
    import tempfile

    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import trainer_for
    from kuzu_torch.tasks.nas import NASTrainer
    from kuzu_torch.testing import SyntheticDetectionDataset

    name, sz, n = NAS_FULL
    steps = NAS_WARM + NAS_TIMED
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(overrides=dict(model=name, task="nas", imgsz=sz, batch=n, epochs=1,
                                         workers=2, project=tmp, name="nas", exist_ok=True))
        train_ds = SyntheticDetectionDataset(n * steps, sz, nc=NAS_NC, seed=0)
        val_ds = SyntheticDetectionDataset(n, sz, nc=NAS_NC, seed=1)
        trainer = trainer_for((train_ds, val_ds, NAS_NC), cls=NASTrainer)(cfg, device=dev)
        rec = StepRecorder()
        for ev, fn in (("on_train_start", rec.start), ("on_step_end", rec.step),
                       ("on_val_start", rec.val_start), ("on_val_end", rec.val_end)):
            trainer.callbacks.add(ev, fn)
        final = trainer.train()
        require(len(rec.counts) == steps and all(c == want() for c in rec.counts),
                f"17a NAS per-step launches {rec.counts}")
        require(rec.val_counts == want(nms=1), f"17a NAS validation launches {rec.val_counts}")
        for k, v in rec.val_counts.items():
            launches[k] += v
        losses = [float(m["loss"]) for m in rec.metrics]
        require(all(np.isfinite(losses)), f"17a NAS finite losses {losses}")
        times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
        ms = statistics.median(times[NAS_WARM:])
        dtype = str(cfg.get("dtype"))
        print(f"17a {name}@{sz} b{n} {dtype} NASTrainer: losses "
              f"{[round(x, 3) for x in losses]}; {ms:.3f} ms/step (median of {NAS_TIMED} after "
              f"{NAS_WARM}; steps {[round(t, 2) for t in times]}), peak memory "
              f"{rec.peak / 2**30:.2f} GiB; validation launches {rec.val_counts}, final {final}")
        r = dict(dtype=dtype, ms_per_step=ms, step_ms=times, losses=losses,
                 peak_gib=rec.peak / 2**30, val_launches=rec.val_counts)
        r["breakdown"] = train_step_breakdown(trainer, train_ds, n)
        r["device_ms"], r["idle_share"] = r["breakdown"]["busy_ms"], r["breakdown"]["idle_share"]
        del trainer
    torch.cuda.empty_cache()
    return r


def block_crops(n: int, hw=CROP, seed: int = 0) -> torch.Tensor:
    """(n, H, W, 3) uint8 crops: a light page with 8-24 dark blocks of random
    place, size and colour, so that the encoders' memories and the decoded
    tokens depend on the crop."""
    rng = np.random.default_rng(seed)
    h, w = hw
    out = np.full((n, h, w, 3), 235, np.uint8)
    for i in range(n):
        for _ in range(rng.integers(8, 25)):
            y, bh = rng.integers(0, h - 16), rng.integers(12, 80)
            x, bw = rng.integers(0, w - 8), rng.integers(8, 48)
            out[i, y:y + bh, x:x + bw] = rng.integers(0, 90, 3)
    return torch.from_numpy(out)


def encoders_card_vs_cpu(dev, launches: dict) -> dict:
    """17b: the TrOCR with the ``unet`` and the ``csa`` encoder at the
    production widths (enc_dim 384, 6 layers, 6 heads; decoder 256 wide, 4
    layers) on ENC_CROPS crops of CROP, VOCAB tokens, seeded with
    ``seeded_trocr``'s decoding weights, f32 (the predictor's): the encoder
    memory card vs CPU within ENC_TOL, the greedy tokens (max_len 128)
    identical; no kernel launches (the einsum attention, as JAX's); encode
    and greedy ms on the card."""
    from kuzu_torch.models.trocr import greedy_generate

    crops = block_crops(ENC_CROPS)
    out = {}
    for enc in ("unet", "csa"):
        gpu = seeded_trocr(dev, VOCAB, encoder_type=enc, decoding=True)
        cpu = seeded_trocr("cpu", VOCAB, encoder_type=enc, decoding=True)
        x = crops.to(dev)
        zero_counts()
        with torch.no_grad():
            mg = gpu.encode(x)
        tg = greedy_generate(gpu, x, max_len=128)
        torch.cuda.synchronize()
        counts = launch_counts()
        with torch.no_grad():
            mc = cpu.encode(crops)
        tc = greedy_generate(cpu, crops, max_len=128)
        err = _rel(mg, mc)
        same = bool(torch.equal(tg.cpu(), tc))
        distinct = len({tuple(r) for r in tc.tolist()})
        enc_ms = time_ms(lambda: gpu.encode(x), reps=10, warmup=2)
        dec_ms = time_ms(lambda: greedy_generate(gpu, x, max_len=128), reps=3, warmup=1)
        print(f"17b TrOCR encoder {enc} {tuple(crops.shape[1:3])} x{ENC_CROPS} f32: memory "
              f"{tuple(mg.shape)} card vs CPU {err:.2e} (<= {ENC_TOL}); greedy tokens identical "
              f"{same} ({distinct} distinct rows, {greedy_generate.steps} steps); launches "
              f"{counts}; encode {enc_ms:.3f} ms, greedy {dec_ms:.3f} ms (card)")
        require(err <= ENC_TOL and same and distinct > 1 and counts == want(),
                f"17b {enc} card vs CPU")
        out[enc] = dict(memory_err=err, tokens_equal=same, distinct_rows=distinct,
                        encode_ms=enc_ms, greedy_ms=dec_ms)
        del gpu, cpu
    return out


def simple_vit_card_vs_cpu(dev, launches: dict) -> dict:
    """17c: SimpleViT at the classify task's defaults (128 px, one channel,
    patch 16, dim 256, depth 6, heads 8), VOCAB classes, seeded, f32 (the
    predictor's), batch VIT_BATCH through ``ClassifyPredictor.probs``: the
    logits card vs CPU within VIT_TOL with identical top-1, no kernel
    launches, ms/img, device ms, idle share, peak memory."""
    import copy

    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.simple_vit import SimpleViT
    from kuzu_torch.tasks.classify import ClassifyPredictor

    cpu = flax_init_(SimpleViT(VOCAB, channels=1), torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    imgs = torch.from_numpy(np.random.default_rng(19).integers(
        0, 256, (VIT_BATCH, 128, 128, 1), dtype=np.uint8))
    x = imgs.to(dev)
    zero_counts()
    with torch.no_grad():
        lg = gpu(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    with torch.no_grad():
        lc = cpu(imgs)
    err, top1 = _rel(lg, lc), bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)))
    pred = ClassifyPredictor.__new__(ClassifyPredictor)
    pred.model, pred.ready, pred.device = gpu, True, dev
    run = lambda: pred.probs(x)  # noqa: E731
    run()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17c SimpleViT@128 b{VIT_BATCH} f32, {VOCAB} classes, "
          f"{sum(p.numel() for p in gpu.parameters())} params: logits card vs CPU {err:.2e} "
          f"(<= {VIT_TOL}), top-1 identical {top1}; launches {counts}; {ms:.3f} ms/batch = "
          f"{ms / VIT_BATCH:.4f} ms/img (median of 10), peak memory {peak:.2f} GiB")
    require(err <= VIT_TOL and top1 and counts == want(), "17c SimpleViT card vs CPU")
    bd = device_breakdown(run)
    return dict(logit_err=err, top1_equal=top1, ms_per_img=ms / VIT_BATCH, ms_per_batch=ms,
                device_ms=bd["busy_ms"], idle_share=bd["idle_share"], peak_gib=peak,
                breakdown=bd)


def open_ends_card_vs_cpu(dev, launches: dict) -> dict:
    """17d: ``nms_padded`` over a page's worth of candidates (4000 boxes, 3
    classes, max_nms 2048) on the card (K1) and on the CPU (the plain
    sweep): every output identical; ``letterbox`` (bilinear and nearest,
    centred) and ``resize_keep_aspect`` of a 1000 x 700 f32 image: gain and
    pad identical, canvases within LETTERBOX_TOL."""
    from kuzu_torch.ops import letterbox, nms_padded, resize_keep_aspect

    rng = np.random.default_rng(20)
    n = 4000
    xy = rng.uniform(0, 1200, (n, 2)).astype(np.float32)
    cand = [torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 80, (n, 2)).astype(
        np.float32)], 1)), torch.from_numpy(rng.random(n).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
        torch.from_numpy(rng.random(n) < 0.95)]
    kw = dict(iou_threshold=0.5, score_threshold=0.05, max_det=300, max_nms=2048)
    zero_counts()
    got = nms_padded(*(t.to(dev) for t in cand), **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    ref = nms_padded(*cand, **kw)
    same = all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
    require(same and counts == want(nms=1) and int(ref[3].sum()) > 0,
            f"17d nms_padded card vs CPU (launches {counts})")
    for k, v in counts.items():
        launches[k] += v
    image = torch.from_numpy(rng.random((1000, 700, 3)).astype(np.float32))
    errs = {}
    for label, fn in (("bilinear", lambda im: letterbox(im, 640, 640)),
                      ("nearest", lambda im: letterbox(im, 640, 640, method="nearest")),
                      ("keep_aspect", lambda im: (*resize_keep_aspect(im, 1024, 64), None))):
        g, c = fn(image.to(dev)), fn(image)
        geometry = all(torch.equal(a.cpu(), b) for a, b in zip(g[1:], c[1:]) if b is not None)
        errs[label] = float((g[0].cpu() - c[0]).abs().max())
        require(geometry and errs[label] <= LETTERBOX_TOL, f"17d letterbox {label} card vs CPU")
    print(f"17d nms_padded (K={kw['max_nms']} of {n}): outputs identical {same}, "
          f"{int(ref[3].sum())} kept, launches {counts}; letterbox canvases max |d| card vs "
          f"CPU {errs} (<= {LETTERBOX_TOL}), gain and pad identical")
    return dict(nms_equal=same, kept=int(ref[3].sum()), letterbox_err=errs)


def nas_phase(dev, launches: dict) -> dict:
    """Phase 17: 17a (YOLO-NAS-L: card vs CPU, inference, training), 17b,
    17c, 17d."""
    from kuzu_torch.models.nas import NASDetector

    t0 = time.perf_counter()
    name, sz, _ = NAS_FULL
    det = NASDetector(name, nc=NAS_NC, imgsz=sz, device=dev).init(0)
    out = dict(nas_card_vs_cpu=nas_card_vs_cpu(dev, det, launches),
               nas_inference=nas_full_width(dev, det, launches))
    del det
    torch.cuda.empty_cache()
    out["nas_training"] = nas_train_run(dev, launches)
    out["encoders"] = encoders_card_vs_cpu(dev, launches)
    out["simple_vit"] = simple_vit_card_vs_cpu(dev, launches)
    out["open_ends"] = open_ends_card_vs_cpu(dev, launches)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 18

LAYOUT_FULL = ("yolov12x", 640, 8)  # 18a: the main path's detector, size and batch
LAYOUT_CMP = ("yolov12n", 640, 2)  # 18a: each stem card against CPU (phase 4's slice)
STEMS = {"plain": {}, "s2d": dict(stem_s2d=True), "packed": dict(stem_packed=True)}
STEM_REL = 0.02  # 18a: a stem option's maps against the plain stem's (tests/test_yolo_infer.py)
STEM_BOX_PX = 0.5  # 18a: decoded boxes, a stem option against the plain stem
S2D_STEP = ("yolov12n", 128, 2)  # 18a: the f32 training step, conv_impl="s2d" against native
S2D_LOSS_TOL = 1e-4  # 18a: the s2d step's loss, relative (tests/test_conv_s2d.py's graph 1e-4)
# 18a: its gradients by cosine, phase 9's f32 card-vs-CPU criteria (the same
# arithmetic summed in another order) ten times tighter: the whole vector,
# and every leaf whose norm is above 1e-3 of the largest
S2D_GRAD_COS = (0.99999, 0.9999)
SAM_KW = dict(img_size=256, dim=256, enc_depth=6, enc_heads=8, num_masks=3)  # JAX's defaults
SAM_BATCH = 8  # 18b / 18c
SAM_F32_TOL = 1e-4  # 18b-d: f32 outputs card vs CPU and kernel route vs einsum, relative
SAM_WARM, SAM_TIMED = 2, 4  # 18b's SAMTrainer steps
SAM_GRID = 8  # 18d: everything()'s point lattice, 64 prompts in one decode
FASTSAM = ("yolov8x-seg", 1024, 2)  # 18e: FastSAM-x's architecture (nc 1) at FastSAM's size
FASTSAM_CMP = ("yolov8n-seg", 128, 2)  # 18e: card against CPU


def _stem_rel(ref: torch.Tensor, out: torch.Tensor) -> float:
    """max |ref - out| / max(|ref|, 1), the bound of tests/test_yolo_infer.py."""
    r, o = ref.float().cpu(), out.float().cpu()
    return float(((r - o).abs() / r.abs().clamp(min=1.0)).max())


def _kept(pred: torch.Tensor) -> list[set]:
    """The anchors NMS keeps in each image of a decoded tensor."""
    from kuzu_torch.ops.nms import non_max_suppression

    sel = non_max_suppression(pred, conf_thres=CONF, return_indices=True)
    return [set(i[v].tolist()) for i, v in zip(sel["indices"].cpu(), sel["valid"].cpu())]


@contextlib.contextmanager
def stem_routes(calls: list):
    """The executor's stem rewrites taken inside the block, recorded by name
    (``"s2d"``, ``"packed"``)."""
    from kuzu_torch.models.yolo import infer

    saved = infer.stem_conv_s2d, infer.stem_pair_packed

    def rec(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    infer.stem_conv_s2d, infer.stem_pair_packed = rec("s2d", saved[0]), rec("packed", saved[1])
    try:
        yield
    finally:
        infer.stem_conv_s2d, infer.stem_pair_packed = saved


@torch.no_grad()
def stem_entries_differing(det, imgs) -> dict:
    """(entries that differ, entries) of the stem rewrites' outputs against
    the plain convolutions' on the same images: node 0 by ``stem_s2d``,
    node 1 by ``stem_packed``."""
    from kuzu_torch.models.yolo import infer
    from kuzu_torch.ops.images import from_uint8

    x = from_uint8(imgs, dtype=torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    a = det.spec.nodes[1].args
    p0, p1 = infer._P(det.folded, "n0_Conv"), infer._P(det.folded, "n1_Conv")
    y0 = infer.conv(p0, x, s=2)
    y1 = infer.conv(p1, y0, s=2, g=a[4] if len(a) > 4 else 1)
    z0 = infer.stem_conv_s2d(p0, x)
    z1 = infer.stem_pair_packed(p0, p1, x, g1=a[4] if len(a) > 4 else 1)
    return {"s2d node 0": (int((y0 != z0).sum()), y0.numel()),
            "packed node 1": (int((y1 != z1).sum()), y1.numel())}


def layout_stems(dev, launches: dict) -> dict:
    """18a, inference: yolov12x@640 b8 bf16 through ``run_graph`` with the
    plain, ``stem_s2d`` and ``stem_packed`` stems (infer -> decode -> NMS;
    K2 16 and K1 once a batch): each option's maps against the plain stem's
    within STEM_REL, its decode's class argmax identical wherever the top
    class leads the runner-up by more than the two runs' largest score
    difference (the other flips counted), its boxes within STEM_BOX_PX, the
    NMS keeps that differ counted; ms/img for each stem (two rounds, in
    turn). Then phase 4's slice, yolov12n@640 b2, card against CPU with
    each stem (phase 4's criteria on the maps, K3 4 and K2 4 launches; NMS
    of the CPU's decode identical)."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.ops.nms import non_max_suppression
    from kuzu_torch.testing import maps_agreement, maps_match

    name, sz, n = LAYOUT_FULL
    det = YoloDetector(name, nc=80, imgsz=sz, device=dev).init(0)
    imgs = torch.from_numpy(np.random.default_rng(18).integers(
        0, 256, (n, sz, sz, 3), dtype=np.uint8)).to(dev)

    def use(d, stem):
        d.stem_s2d = STEMS[stem].get("stem_s2d", False)
        d.stem_packed = STEMS[stem].get("stem_packed", False)

    runs = {}
    for stem in STEMS:
        use(det, stem)
        pipeline(det, imgs)
        torch.cuda.synchronize()
        routes = []
        with stem_routes(routes):
            zero_counts()
            maps, pred, _ = pipeline(det, imgs)
            torch.cuda.synchronize()
            counts = launch_counts()
        require(routes == ([] if stem == "plain" else [stem]), f"18a {stem}: stem routes {routes}")
        require(counts == want(nms=1, fused_ablock=16), f"18a {stem} stem launch counts {counts}")
        for k, v in counts.items():
            launches[k] += v
        runs[stem] = (maps, pred)
    out = {}
    stem_diff = stem_entries_differing(det, imgs)
    print(f"18a {name}@{sz} b{n}: stem outputs differing from the plain stem's (bf16 entries): "
          + ", ".join(f"{k} {v[0]} of {v[1]}" for k, v in stem_diff.items()))
    for stem in ("s2d", "packed"):
        rel = max(_stem_rel(r, o) for r, o in zip(runs["plain"][0], runs[stem][0]))
        pr, po = runs["plain"][1], runs[stem][1]
        dscore = float((pr[:, 4:] - po[:, 4:]).abs().max())
        top2 = pr[:, 4:].topk(2, dim=1).values
        decided = (top2[:, 0] - top2[:, 1]) > dscore
        flips = pr[:, 4:].argmax(1) != po[:, 4:].argmax(1)
        dbox = float((pr[:, :4] - po[:, :4]).abs().max())
        kp, ko = _kept(pr), _kept(po)
        keep_diff = sum(len(a ^ b) for a, b in zip(kp, ko))
        print(f"18a {name}@{sz} b{n} stem {stem} against plain: maps max rel {rel:.2e} "
              f"(< {STEM_REL}); decode: class argmax flips {int(flips.sum())} of "
              f"{flips.numel()} anchors, {int((flips & decided).sum())} where decided (top "
              f"class ahead by > the largest score difference {dscore:.2e}); boxes max |d| "
              f"{dbox:.4f} px (<= {STEM_BOX_PX}); NMS keeps differing {keep_diff} of "
              f"{sum(len(a) for a in kp)}")
        require(rel < STEM_REL and not bool((flips & decided).any()) and dbox <= STEM_BOX_PX,
                f"18a {stem} stem against the plain stem")
        out[stem] = dict(maps_rel=rel, argmax_flips=int(flips.sum()), score_diff=dscore,
                         box_px=dbox, keeps_differing=keep_diff, stem_entries_differing=(
                             stem_diff["s2d node 0" if stem == "s2d" else "packed node 1"]))
    times: dict[str, list] = {s: [] for s in STEMS}
    for order in (list(STEMS), list(STEMS)[::-1]):
        for stem in order:
            use(det, stem)
            times[stem].append(time_ms(lambda: pipeline(det, imgs), reps=10, warmup=2))
    for stem, ts in times.items():
        out.setdefault(stem, {})["ms_per_img"] = [t / n for t in ts]
    print(f"18a {name}@{sz} b{n} bf16 end to end, ms/img (two rounds, median of 10 each): "
          + ", ".join(f"{s} {ts[0] / n:.4f} / {ts[1] / n:.4f}" for s, ts in times.items()))
    del det, imgs, runs
    torch.cuda.empty_cache()

    name, sz, n = LAYOUT_CMP
    gpu = YoloDetector(name, nc=80, imgsz=sz, device=dev).init(0)
    cpu = YoloDetector(name, nc=80, imgsz=sz, device="cpu").init(0)
    x = torch.from_numpy(np.random.default_rng(19).integers(0, 256, (n, sz, sz, 3),
                                                            dtype=np.uint8))
    cmp = {}
    for stem in STEMS:
        use(gpu, stem)
        use(cpu, stem)
        zero_counts()
        gmaps = gpu.infer(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        cmaps = cpu.infer(x)
        worst = max(maps_agreement(c, g)[0] for c, g in zip(cmaps, gmaps))
        require(all(maps_match(c, g) for c, g in zip(cmaps, gmaps)),
                f"18a {name} stem {stem}: maps card vs CPU")
        cpred = cpu.decode(cmaps)
        zero_counts()
        same = non_max_suppression(cpred.to(dev), conf_thres=CONF)
        torch.cuda.synchronize()
        nms_counts = launch_counts()
        ref = non_max_suppression(cpred, conf_thres=CONF)
        equal = all(torch.equal(same[k].cpu(), ref[k]) for k in ref)
        require(equal and counts == want(area_attention=4, fused_ablock=4)
                and nms_counts == want(nms=1), f"18a {name} stem {stem}: NMS, launches")
        for c in (counts, nms_counts):
            for k, v in c.items():
                launches[k] += v
        cmp[stem] = dict(maps_rel=worst, nms_equal=equal, launches=counts)
    print(f"18a {name}@{sz} b{n} card vs CPU by stem: maps worst rel "
          + ", ".join(f"{s} {c['maps_rel']:.4f}" for s, c in cmp.items())
          + f" (< 0.05, share > 0.999); NMS of the CPU's decode on the card identical; "
          f"forward launches {cmp['plain']['launches']} with every stem")
    out["card_vs_cpu"] = cmp
    return out


def s2d_train_step(dev, launches: dict) -> dict:
    """18a, training: one f32 step of yolov12n@128 b2 with ``conv_impl="s2d"``
    against the native convolutions on the card, the same seeded weights
    and batch (detection loss, SGD, no clipping): the loss within
    S2D_LOSS_TOL relative, the gradients' cosines within S2D_GRAD_COS; the
    largest difference against the largest gradient entry reported."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec
    from kuzu_torch.ops.detect_loss import detection_loss
    from kuzu_torch.testing import SyntheticDetectionDataset

    name, sz, n = S2D_STEP
    path, scale = resolve_model_spec(name)
    spec = parse_model_yaml(path, scale=scale, nc=3)
    ds = SyntheticDetectionDataset(n, sz, max_boxes=24, nc=3, seed=5)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in default_collate([ds[i] for i in range(n)]).items()}
    cfg = load_config(overrides=dict(warmup_epochs=0, epochs=1, grad_clip=0))
    res = {}
    for impl in ("native", "s2d"):
        graph = YoloGraph(spec, dtype=torch.float32, conv_impl=impl)
        graph.reset_parameters(torch.Generator().manual_seed(0))
        graph.to(dev)
        tx = build_optimizer(cfg, graph, 1)
        grads, update = {}, tx.step

        def snapshot_then_step(count, grad_norm, graph=graph, grads=grads, update=update):
            grads.update({k: p.grad.detach().double().cpu() for k, p in
                          graph.named_parameters()})
            update(count, grad_norm)

        tx.step = snapshot_then_step

        def loss_fn(model, b):
            return detection_loss(model(b["image"]), b["gt_labels"], b["gt_boxes"],
                                  b["mask_gt"], nc=3, imgsz=sz, strides=spec.strides,
                                  reg_max=spec.reg_max)

        zero_counts()
        metrics = make_train_step(loss_fn, tx)(TrainState(graph, tx), batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] += v
        res[impl] = (float(metrics["loss"]), grads, counts)
    (l0, g0, c0), (l1, g1, c1) = res["native"], res["s2d"]
    rel = abs(l1 - l0) / abs(l0)
    top = max(float(t.abs().max()) for t in g0.values())
    worst = max(float((g1[k] - t).abs().max()) for k, t in g0.items()) / top
    cos, leaf = _grad_cos(g1, g0)
    print(f"18a {name}@{sz} b{n} f32 train step, conv_impl s2d against native on the card: "
          f"loss {l1:.6f} vs {l0:.6f} (rel {rel:.2e} <= {S2D_LOSS_TOL}); gradients: whole "
          f"cosine {cos:.8f} (>= {S2D_GRAD_COS[0]}), worst leaf {leaf:.7f} (>= "
          f"{S2D_GRAD_COS[1]}), max |d| / max |g| {worst:.2e} (max |g| {top:.3e}); launches "
          f"{c1} (native {c0})")
    require(rel <= S2D_LOSS_TOL and cos >= S2D_GRAD_COS[0] and leaf >= S2D_GRAD_COS[1]
            and c0 == c1, "18a conv_impl s2d train step against native")
    return dict(loss_rel=rel, grad_cos=cos, grad_leaf_cos=leaf, grad_rel=worst, grad_max=top)


def sam_inputs(n: int, seed: int = 21):
    """(images (n, 256, 256, 3) uint8: light pages with dark blocks, points
    (n, 4, 2) in [0, 1], labels: a foreground point with a box in even rows,
    a foreground and a background point in odd rows)."""
    from kuzu_torch.models.sam import BG, BOX_BR, BOX_TL, FG, PAD

    rng = np.random.default_rng(seed)
    s = SAM_KW["img_size"]
    imgs = np.full((n, s, s, 3), 230, np.uint8)
    for i in range(n):
        for _ in range(rng.integers(6, 14)):
            y, x = rng.integers(0, s - 24, 2)
            h, w = rng.integers(12, 90, 2)
            imgs[i, y:y + h, x:x + w] = rng.integers(0, 120, 3)
    pts = rng.uniform(0.1, 0.9, (n, 4, 2)).astype(np.float32)
    lbl = np.array([[FG, BOX_TL, BOX_BR, PAD] if i % 2 == 0 else [FG, BG, PAD, PAD]
                    for i in range(n)], np.int32)
    return torch.from_numpy(imgs), torch.from_numpy(pts), torch.from_numpy(lbl)


def seeded_sam(dev, dtype=torch.float32, attn_impl: str = "einsum", kind: str = "vit",
               seed: int = 0):
    """SAM at JAX's defaults (SAM_KW), seeded (``init_sam_``, drawn on the
    CPU: every device and dtype gets the same weights), eval mode."""
    from kuzu_torch.models.sam import SAM, init_sam_

    m = init_sam_(SAM(**SAM_KW, encoder_kind=kind), torch.Generator().manual_seed(seed))
    out = SAM(**SAM_KW, dtype=dtype, attn_impl=attn_impl, encoder_kind=kind)
    out.load_state_dict(m.state_dict())
    return out.to(dev).eval()


@contextlib.contextmanager
def attention_spy(calls: list):
    """Every K3 and K4 call of the block recorded as (kind, args, kwargs,
    result): K3 through ``models.layers.area_attention`` (the eval route)
    and ``ops.flash_attention.area_attention`` (the training route's
    forward), K4 through ``ops.flash_attention._bwd``."""
    import importlib

    layers = importlib.import_module("kuzu_torch.models.layers")
    fa = importlib.import_module("kuzu_torch.ops.flash_attention")
    saved = (layers.area_attention, fa.area_attention, fa._bwd)

    def rec(kind, fn):
        def wrapped(*args, **kw):
            r = fn(*args, **kw)
            calls.append((kind, args, kw, r))
            return r
        return wrapped

    layers.area_attention = rec("K3", saved[0])
    fa.area_attention = rec("K3", saved[1])
    fa._bwd = rec("K4", saved[2])
    try:
        yield
    finally:
        layers.area_attention, fa.area_attention, fa._bwd = saved


def attention_calls_against_plain(calls: list) -> dict:
    """Each recorded K3 / K4 call held against its plain version on the
    same inputs (copied to the CPU): K3's output within ``ATTN_F32_TOL`` /
    ``ATTN_TOL`` (f32 / bf16) and its row statistics within
    ``ATTN_F32_TOL``; K4's dq, dk, dv within ``BWD_F32_TOL`` / ``BWD_TOL``,
    or, for an f32 tensor over ``BWD_F32_TOL``, by ``k4_f32_conditioned``.
    Returns the largest error of each kind."""
    import importlib

    from kuzu_torch.testing import attention_f32_over, attention_over, bwd_f32_over, bwd_over

    fa = importlib.import_module("kuzu_torch.ops.flash_attention")

    def cpu(t):
        return t.detach().cpu() if torch.is_tensor(t) else t

    def cpus(items):
        return tuple(tuple(cpu(u) for u in t) if isinstance(t, tuple) else cpu(t)
                     for t in items)

    worst = {}
    for kind, args, kw, got in calls:
        f32 = args[0].dtype == torch.float32
        if kind == "K3":
            ref = fa.area_attention_plain(*cpus(args[:3]), args[3], 1.0 / (
                args[0].shape[2] // args[3]) ** 0.5, kw.get("return_lse", False))
            pairs = [(got, ref)] if torch.is_tensor(got) else [(got[0], ref[0]), (got[1], ref[1])]
            for i, (g, r) in enumerate(pairs):
                over = attention_f32_over if (f32 or i == 1) else attention_over
                err, n_over, _ = over(g.detach().cpu(), r)
                require(n_over == 0, f"{kind} call against its plain version: {n_over} over")
                key = f"K3 {'f32' if f32 else 'bf16'}{' lse' if i else ''}"
                worst[key] = max(worst.get(key, 0.0), err)
        else:
            q, k, v, do, heads, stats = args[:6]
            want_qk = kw.get("want_qk", args[6] if len(args) > 6 else False)
            ref = fa.area_attention_bwd_plain(*cpus((q, k, v, do)), heads,
                                              1.0 / (q.shape[2] // heads) ** 0.5,
                                              *cpus(stats or ()))
            parts = (got[0][..., :q.shape[2]], got[0][..., q.shape[2]:], got[1]) if want_qk \
                else got
            overs = []
            for g, r in zip(parts, ref):
                err, n_over = (bwd_f32_over if f32 else bwd_over)(g.detach().cpu(), r)
                require(n_over == 0 or f32, f"K4 call against its plain version: {n_over} over")
                overs.append(n_over)
                key = f"K4 {'f32' if f32 else 'bf16'}"
                worst[key] = max(worst.get(key, 0.0), err)
            if any(overs):
                k4_f32_conditioned((q, k, v, do), heads, stats, parts, ref, overs)
    return worst


def k4_f32_conditioned(inputs, heads: int, stats, parts, ref, overs) -> None:
    """K4 f32 where a gradient is over ``BWD_F32_TOL`` against the plain f32
    version (``overs``: entries over, for dq, dk, dv): each such tensor held
    against the same arithmetic in f64 (``testing.attention_bwd_f64``), the
    kernel's largest error no more than ``BWD_F32_COND`` times the plain
    version's own; every planted fault of ``attention_bwd_faults`` and plain
    TF32 on these inputs must fail that criterion in one such tensor or
    ``BWD_F32_TOL`` in another."""
    from kuzu_torch.testing import (
        BWD_F32_COND,
        BWD_F32_TOL,
        attention_bwd_f64,
        attention_bwd_faults,
        attention_bwd_tf32,
        bwd_f32_over,
    )

    q, k, v, do = inputs
    out, lse = stats[0], stats[1]
    exact = attention_bwd_f64(*(t.detach().cpu() for t in (q, k, v, do)), heads,
                              out.detach().cpu(), lse.detach().cpu())
    plain_err = [float((r.double() - e).abs().max()) for r, e in zip(ref, exact)]

    def rejected(outs) -> bool:
        for i, (o, r, e) in enumerate(zip(outs, ref, exact)):
            o = o.detach().cpu()
            if overs[i] and float((o.double() - e).abs().max()) > BWD_F32_COND * plain_err[i]:
                return True
            if not overs[i] and bwd_f32_over(o, r)[1] > 0:
                return True
        return False

    for i, name in enumerate(("dq", "dk", "dv")):
        if not overs[i]:
            continue
        top = float(ref[i].abs().max())
        kern = float((parts[i].detach().cpu().double() - exact[i]).abs().max())
        print(f"  K4 f32 {name}: {overs[i]} entries over {BWD_F32_TOL} against the plain f32 "
              f"version; against the same arithmetic in f64 the kernel is off {kern / top:.2e} "
              f"and the plain f32 version {plain_err[i] / top:.2e} of max|ref| (the kernel "
              f"within {BWD_F32_COND} x the plain version's)")
        require(kern <= BWD_F32_COND * plain_err[i], f"K4 f32 {name} against the f64 arithmetic")
    faults = dict(attention_bwd_faults(q, k, v, do, heads, lse))
    faults["plain TF32 (1xTF32)"] = attention_bwd_tf32(q, k, v, do, heads, passes=1)
    for name, outs in faults.items():
        require(rejected(outs), f"K4 f32's conditioned criterion rejects the fault: {name}")
    print(f"  planted faults on these inputs, each rejected: {', '.join(faults)}")


def _grads(model) -> dict:
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
            if p.grad is not None}


def _grad_cos(a: dict, b: dict) -> tuple[float, float]:
    """(whole-gradient cosine, the worst leaf cosine over leaves whose norm
    is above 1e-3 of the largest: an attention key bias's gradient is zero
    but for rounding)."""
    names = list(b)
    top = max(float(b[k].norm()) for k in names)
    whole = _cos(torch.cat([a[k].flatten() for k in names]),
                 torch.cat([b[k].flatten() for k in names]))
    leaf = min(_cos(a[k], b[k]) for k in names if float(b[k].norm()) > 1e-3 * top)
    return whole, leaf


def sam_card_vs_cpu(dev, launches: dict) -> dict:
    """18b: SAM at JAX's defaults, batch SAM_BATCH, seeded: (1) f32 einsum
    card against CPU (mask logits, IoU within SAM_F32_TOL); (2)
    ``attn_impl="flash"`` against einsum on the card in f32 (K3 f32) and
    bf16 (K3): 6 launches a forward, every launch held against its plain
    version on the path's inputs; the model's outputs in f32 within
    SAM_F32_TOL, in bf16 no farther from the f32 einsum outputs than the
    bf16 einsum outputs are (x1.5 + 1e-3 of the largest); (3) a forward
    and backward under ``"flash_train"`` against einsum (K3 with its
    statistics and K4, 6 + 6 launches, each held against its plain
    version): f32 gradients by cosine (whole >= 0.99999, every leaf above
    1e-3 of the largest norm >= 0.9999), bf16 no farther from the f32
    einsum gradients than bf16 einsum's (cosine, less 0.01)."""
    x, pts, lbl = sam_inputs(SAM_BATCH)
    cpu = seeded_sam("cpu")
    gpu = seeded_sam(dev)
    xd, pd, ld = x.to(dev), pts.to(dev), lbl.to(dev)
    zero_counts()
    with torch.no_grad():
        gm, gi = gpu(xd, pd, ld)
    torch.cuda.synchronize()
    counts = launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cm, ci = cpu(x, pts, lbl)
    cpu_s = time.perf_counter() - t0
    err = max(_rel(gm, cm), _rel(gi, ci))
    print(f"18b SAM {SAM_KW} b{SAM_BATCH} f32 einsum: masks {tuple(gm.shape)}, card vs CPU "
          f"{err:.2e} (<= {SAM_F32_TOL}; mask logits max {float(cm.abs().max()):.3e}); launches "
          f"{counts}; CPU forward {cpu_s:.1f} s")
    require(err <= SAM_F32_TOL and counts == want() and bool(torch.isfinite(gm).all()),
            "18b SAM card vs CPU")
    out = dict(card_vs_cpu=err)
    ref32 = (gm, gi)

    def err_to(a, b):
        return max(_rel(a[0], b[0]), _rel(a[1], b[1]))

    for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ein = seeded_sam(dev, dt)
        fl = seeded_sam(dev, dt, "flash")
        with torch.no_grad():
            e_out = ein(xd, pd, ld)
            calls = []
            with attention_spy(calls):
                zero_counts()
                f_out = fl(xd, pd, ld)
                torch.cuda.synchronize()
                counts = launch_counts()
        k3 = "area_attention_f32" if dt == torch.float32 else "area_attention"
        require(counts == want(**{k3: SAM_KW["enc_depth"]}), f"18b flash {label} launches {counts}")
        for k, v in counts.items():
            launches[k] += v
        worst = attention_calls_against_plain(calls)
        if dt == torch.float32:
            e = err_to(f_out, e_out)
            ok, line = e <= SAM_F32_TOL, f"flash vs einsum {e:.2e} (<= {SAM_F32_TOL})"
        else:
            ef, ee = err_to(f_out, ref32), err_to(e_out, ref32)
            ok = ef <= 1.5 * ee + 1e-3
            line = (f"against the f32 einsum outputs: flash {ef:.2e}, einsum {ee:.2e} (flash <= "
                    f"1.5 x einsum + 1e-3)")
        print(f"18b SAM flash {label}: launches {counts}; {len(calls)} K3 calls against the "
              f"plain version: max abs err {worst}; {line}")
        require(ok, f"18b SAM flash {label} against einsum")
        out[f"flash_{label}"] = dict(kernel_err=worst, launches=counts[k3])
        del ein, fl

    grads32 = None
    w = None
    for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        res = {}
        for impl in ("einsum", "flash_train"):
            m = seeded_sam(dev, dt, impl).train()
            calls = []
            with attention_spy(calls):
                zero_counts()
                mask, iou = m(xd, pd, ld, train=True)
                if w is None:
                    w = torch.cos(torch.arange(mask.numel(), device=dev).float()).reshape(
                        mask.shape)
                ((mask * w).mean() + iou.square().sum()).backward()
                torch.cuda.synchronize()
                counts = launch_counts()
            res[impl] = (_grads(m), counts, calls)
        ge, ce, _ = res["einsum"]
        gf, cf, calls = res["flash_train"]
        k3, k4 = (("area_attention_f32", "area_attention_bwd_f32") if dt == torch.float32
                  else ("area_attention", "area_attention_bwd"))
        depth = SAM_KW["enc_depth"]
        require(ce == want() and cf == want(**{k3: depth, k4: depth}),
                f"18b flash_train {label} launches {cf}")
        for k, v in cf.items():
            launches[k] += v
        worst = attention_calls_against_plain(calls)
        if dt == torch.float32:
            grads32 = ge
            whole, leaf = _grad_cos(gf, ge)
            ok = whole >= 0.99999 and leaf >= 0.9999
            line = (f"gradients against einsum: whole cosine {whole:.8f} (>= 0.99999), worst "
                    f"leaf {leaf:.6f} (>= 0.9999)")
        else:
            cf32, ce32 = _grad_cos(gf, grads32)[0], _grad_cos(ge, grads32)[0]
            ok = cf32 >= ce32 - 0.01
            line = (f"whole-gradient cosine against the f32 einsum gradients: flash_train "
                    f"{cf32:.6f}, einsum {ce32:.6f} (flash_train >= einsum - 0.01)")
        print(f"18b SAM flash_train {label} forward + backward: launches {cf}; {len(calls)} K3 / "
              f"K4 calls against the plain versions: max abs err {worst}; {line}")
        require(ok, f"18b SAM flash_train {label} gradients")
        out[f"flash_train_{label}"] = dict(kernel_err=worst)
        del res
    del cpu, gpu
    torch.cuda.empty_cache()
    return out


def sam_train_run(dev, root, launches: dict) -> dict:
    """18b: ``Model(task="sam").train`` at the task's model defaults (SAM_KW,
    f32, einsum attention, AdamW) on YOLO-seg PNG pages and polygons written
    here, batch SAM_BATCH, SAM_WARM + SAM_TIMED steps and one validation
    (``miou`` on the EMA weights): launches (none: einsum), finite losses,
    ms/step, a profiled step (device ms, idle share), peak memory."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.data.loader import default_collate
    from kuzu_torch.testing import write_head_folder

    n, steps = SAM_BATCH, SAM_WARM + SAM_TIMED
    data = write_head_folder(root / "sam_data", "segment", {"train": n * steps, "val": n},
                             hw=(192, 256), n_inst=(3, 8), nc=1, seed=22)
    model = Model("sam", task="sam", device=dev)
    rec = StepRecorder()
    trainer, final = train_recorded(model, rec, data=str(data), imgsz=SAM_KW["img_size"],
                                    batch=n, dtype="float32", epochs=1, workers=4,
                                    project=str(root / "runs"), name="sam", exist_ok=True,
                                    verbose=False)
    require(len(rec.counts) == steps and all(c == want() for c in rec.counts)
            and rec.val_counts == want(), f"18b SAMTrainer launches {rec.counts}")
    losses = [float(m["loss"]) for m in rec.metrics]
    require(all(np.isfinite(losses)) and np.isfinite(final["miou"]),
            f"18b SAMTrainer finite losses {losses}")
    times = [a.elapsed_time(b) for a, b in zip(rec.events[:-1], rec.events[1:])]
    ms = statistics.median(times[SAM_WARM:])
    params = sum(p.numel() for p in trainer.state.model.parameters())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             default_collate([trainer.train_ds[i] for i in range(n)]).items()}
    step = trainer._step
    bd = device_breakdown(lambda: step(trainer.state, batch, trainer.step_rng(0)))
    print(f"18b SAMTrainer {SAM_KW} b{n} f32 (einsum, AdamW) from PNG files: {params} params; "
          f"losses {[round(x, 4) for x in losses]}; {ms:.3f} ms/step (median of {SAM_TIMED} "
          f"after {SAM_WARM}; steps {[round(t, 2) for t in times]}), peak memory "
          f"{rec.peak / 2**30:.2f} GiB; validation {rec.val_metrics}")
    r = dict(ms_per_step=ms, step_ms=times, losses=losses, peak_gib=rec.peak / 2**30,
             params=params, miou=final["miou"], device_ms=bd["busy_ms"],
             idle_share=bd["idle_share"], breakdown=bd, run_dir=str(trainer.save_dir))
    del trainer, model
    torch.cuda.empty_cache()
    return r


def tiny_sam_card_vs_cpu(dev) -> dict:
    """18c: SAM with the TinyViT encoder (``encoder="tiny"``, JAX's defaults),
    seeded, f32, batch SAM_BATCH: the memory and the outputs card vs CPU
    within SAM_F32_TOL; the encode's ms on the card."""
    x, pts, lbl = sam_inputs(SAM_BATCH, seed=23)
    cpu, gpu = seeded_sam("cpu", kind="tiny"), seeded_sam(dev, kind="tiny")
    xd = x.to(dev)
    with torch.no_grad():
        gmem, (gm, gi) = gpu.encode(xd), gpu(xd, pts.to(dev), lbl.to(dev))
        cmem, (cm, ci) = cpu.encode(x), cpu(x, pts, lbl)
    err = max(_rel(gmem, cmem), _rel(gm, cm), _rel(gi, ci))
    ms = time_ms(lambda: gpu.encode(xd), reps=10, warmup=2)
    params = sum(p.numel() for p in gpu.encoder.parameters())
    print(f"18c TinyViT SAM b{SAM_BATCH} f32: encoder {params} params, memory "
          f"{tuple(gmem.shape)}; memory, masks and IoU card vs CPU {err:.2e} (<= {SAM_F32_TOL}); "
          f"encode {ms:.3f} ms a batch (median of 10)")
    require(err <= SAM_F32_TOL, "18c TinyViT SAM card vs CPU")
    return dict(err=err, encode_ms=ms, encoder_params=params)


def sam_predictor_card_vs_cpu(dev, image_path) -> dict:
    """18d: ``SAMPredictor`` over the seeded f32 SAM on both devices, one
    PNG page: ``__call__`` with point (foreground and background) and box
    prompts, and ``everything(grid=SAM_GRID)`` (64 prompts in one decode;
    no quality floor: seeded IoU predictions lie far below the default
    0.7): IoU predictions within SAM_F32_TOL of the largest, masks identical
    but at pixels whose logit lies within the two devices' largest logit
    difference of 0 (counted); encode and ``everything`` ms on the card."""
    from kuzu_torch.tasks.sam import SAMPredictor

    preds = {d: SAMPredictor.from_model(seeded_sam(d)) for d in (dev, "cpu")}
    seen = {d: [] for d in preds}
    for d, p in preds.items():
        decode = p.decode

        def recording(*a, decode=decode, log=seen[d]):
            logits, iou = decode(*a)
            log.append(logits[np.arange(len(iou)), iou.argmax(1)])
            return logits, iou

        p.decode = recording
    calls = [dict(points=[[60, 50], [180, 120]], labels=[1, 0]), dict(bboxes=[[20, 30, 200, 160]]),
             dict(points=[[128, 96]], bboxes=[[10, 10, 240, 180]])]
    flips = iou_err = logit_diff = 0.0
    for kw in calls:
        (gm, gi), (cm, ci) = preds[dev](image_path, **kw), preds["cpu"](image_path, **kw)
        lg, lc = seen[dev][-1], seen["cpu"][-1]
        diff = float(np.abs(lg - lc).max())
        iou_err = max(iou_err, float(np.abs(gi - ci).max() / np.abs(ci).max()))
        bad = (gm != cm) & (np.abs(lc) > diff)
        require(not bad.any() and gm.any(), f"18d SAMPredictor masks {kw}")
        flips += int((gm != cm).sum())
        logit_diff = max(logit_diff, diff / float(np.abs(lc).max()))
    ev = {d: p.everything(image_path, grid=SAM_GRID, iou_thresh=-np.inf) for d, p in preds.items()}
    (gm, gq), (cm, cq) = ev[dev], ev["cpu"]
    lg, lc = seen[dev][-1], seen["cpu"][-1]
    diff = float(np.abs(lg - lc).max())
    require(gm.shape == cm.shape and len(cm) > 1, f"18d everything: {gm.shape} vs {cm.shape}")
    iou_err = max(iou_err, float(np.abs(gq - cq).max() / np.abs(cq).max()))
    near = np.abs(lc).min(0) <= diff  # a pixel some prompt's mask could flip
    require(not ((gm != cm) & ~near[None]).any(), "18d everything masks")
    flips += int((gm != cm).sum())
    logit_diff = max(logit_diff, diff / float(np.abs(lc).max()))
    require(iou_err <= SAM_F32_TOL and logit_diff <= SAM_F32_TOL, "18d SAMPredictor IoU, logits")
    p = preds[dev]
    canvas, _ = p._load(image_path)
    enc_ms = time_ms(lambda: p.encode(canvas), reps=10, warmup=2)
    ev_ms = time_ms(lambda: p.everything(image_path, grid=SAM_GRID, iou_thresh=-np.inf),
                    reps=5, warmup=1)
    print(f"18d SAMPredictor f32 on {image_path.name}: prompts {len(calls)} calls, everything "
          f"{len(cm)} masks of {SAM_GRID * SAM_GRID} prompts; IoU card vs CPU {iou_err:.2e}, "
          f"logits {logit_diff:.2e} (<= {SAM_F32_TOL}); mask pixels differing {int(flips)} (each "
          f"within the largest logit difference of 0); encode {enc_ms:.3f} ms, everything "
          f"{ev_ms:.3f} ms (card)")
    return dict(iou_err=iou_err, logit_err=logit_diff, mask_pixels_differing=int(flips),
                everything_masks=len(cm), encode_ms=enc_ms, everything_ms=ev_ms)


def fastsam_card_vs_cpu(dev, launches: dict) -> dict:
    """18e, first part: ``FastSAMPredictor`` over yolov8n-seg (nc 1) at 128
    b2 on both devices from one set of outputs: the CPU's forward (mask
    coefficients scaled as 16a's), its decoded tensor selected on each
    device (K1 on the card), masks composed on each; then the same box and
    point prompts: the selected instances identical."""
    from kuzu_torch.models.fastsam import FastSAMPredictor
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.segment import SegmentPredictor, compose_masks
    from kuzu_torch.testing import head_sample

    name, sz, n = FASTSAM_CMP
    rng = np.random.default_rng(24)
    imgs = [head_sample(rng, "segment", (sz, sz), (3, 6))[0] for _ in range(n)]
    cdet = YoloDetector(name, nc=1, imgsz=sz, device="cpu").init(0)
    cout = scaled_coefficients(cdet.infer(torch.from_numpy(np.stack(imgs))))
    cpred = cdet.decode(cout)
    prompts = [dict(bboxes=[[10, 10, 70, 90], [60, 20, 120, 110]]),
               dict(points=[[30, 40], [90, 60]], labels=[1, 0]),
               dict(points=[[64, 64]], labels=[0])]
    res = {}
    for d in (dev, "cpu"):
        det = YoloDetector(name, nc=1, imgsz=sz, device=d).init(0)
        seg = SegmentPredictor.from_detector(det, conf=CONF, iou=0.9, max_det=300)

        def fwd(images, det=det, d=d):
            o = {k: [t.to(d) for t in v] if isinstance(v, list) else v.to(d)
                 for k, v in cout.items()}
            sel = det.select(cpred.to(d), CONF, 0.9, 300, return_indices=True)
            sel["masks"] = compose_masks(o, sel, sz)
            return sel

        seg._fwd = fwd
        fs = FastSAMPredictor.from_segment_predictor(seg)
        zero_counts()
        res[d] = [fs(imgs, **kw) for kw in prompts]
        if d == dev:
            torch.cuda.synchronize()
            counts = launch_counts()
    require(counts == want(nms=len(prompts)), f"18e FastSAM card launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    picked = 0
    for g, c in zip(res[dev], res["cpu"]):
        for rg, rc in zip(g, c):
            require(np.array_equal(rg.boxes.xyxy, rc.boxes.xyxy), "18e FastSAM selections")
            picked += len(rc)
    require(picked > 0, "18e FastSAM: prompts select instances")
    print(f"18e FastSAM {name}@{sz} b{n} card vs CPU (one set of outputs): {picked} instances "
          f"selected by {len(prompts)} prompts, identical; launches {counts}")
    return dict(selected=picked, equal=True)


def fastsam_full_width(dev, launches: dict) -> dict:
    """18e: FastSAM-x (yolov8x-seg, nc 1, seeded; its mask coefficients'
    leaves scaled by MASK_COEFF_SCALE, as 16a scales them, so that masks
    depend on the page) at 1024, b2 pages of polygons: everything mode
    (``conf`` CONF: seeded scores lie near 0.01, under FastSAM's default
    0.25; IoU 0.9, 300 detections; NMS on K1), then a box and point prompt;
    launches, instances, ms/img of everything mode and of the prompts'
    selection."""
    from kuzu_torch.models.fastsam import FastSAMPredictor
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.segment import SegmentPredictor
    from kuzu_torch.testing import head_sample

    name, sz, n = FASTSAM
    rng = np.random.default_rng(25)
    imgs = [head_sample(rng, "segment", (sz, sz), (8, 20))[0] for _ in range(n)]
    det = YoloDetector(name, nc=1, imgsz=sz, device=dev).init(0)
    for key, (w, b) in list(det.folded.items()):  # the mask coefficients' leaves, as 16a
        if re.search(r"_Segment\.m\d+_2$", key):
            det.folded[key] = (w * MASK_COEFF_SCALE, b * MASK_COEFF_SCALE)
    fs = FastSAMPredictor.from_segment_predictor(
        SegmentPredictor.from_detector(det, conf=CONF, iou=0.9, max_det=300))
    fs(imgs)
    torch.cuda.synchronize()
    zero_counts()
    every = fs(imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts == want(nms=1) and all(len(r) > 0 for r in every),
            f"18e FastSAM-x everything: launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    t0 = time.perf_counter()
    boxed = fs.prompt(every, bboxes=[[sz // 5, sz // 5, sz * 7 // 10, sz * 4 // 5]])
    pointed = fs.prompt(every, points=[[sz // 2, sz // 2], [sz // 10, sz * 9 // 10]],
                        labels=[1, 0])
    sel_ms = (time.perf_counter() - t0) * 1e3 / n
    require([len(r) for r in boxed] == [1] * n, "18e FastSAM-x box prompt selects one")
    ms = time_ms(lambda: fs(imgs), reps=5, warmup=1)
    print(f"18e FastSAM-x ({name}, nc 1, {det.param_count()} params)@{sz} b{n}: everything "
          f"{[len(r) for r in every]} instances, launches {counts}; box prompt "
          f"{[len(r) for r in boxed]}, points {[len(r) for r in pointed]}; everything "
          f"{ms / n:.3f} ms/img (median of 5, host letterbox and mask readback included), "
          f"prompt selection {sel_ms:.1f} ms/img (host numpy over full-frame masks)")
    return dict(ms_per_img=ms / n, select_ms_per_img=sel_ms,
                instances=[len(r) for r in every], params=det.param_count())


def sam_phase(dev, launches: dict) -> dict:
    """Phase 18: 18a (the layout options), 18b (SAM, its kernel routes and
    trainer), 18c (TinyViT SAM), 18d (``SAMPredictor``), 18e (FastSAM)."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    out = dict(stems=layout_stems(dev, launches), s2d_step=s2d_train_step(dev, launches),
               sam=sam_card_vs_cpu(dev, launches))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out["sam_training"] = sam_train_run(dev, root, launches)
        out["tiny_sam"] = tiny_sam_card_vs_cpu(dev)
        page = sorted((root / "sam_data" / "images" / "val").glob("*.png"))[0]
        out["sam_predictor"] = sam_predictor_card_vs_cpu(dev, page)
    out["fastsam_card_vs_cpu"] = fastsam_card_vs_cpu(dev, launches)
    out["fastsam"] = fastsam_full_width(dev, launches)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 19

SAM2_KW = dict(img_size=256, dim=256, mem_dim=64, enc_depth=6, enc_heads=8, dec_heads=8,
               mem_depth=2, num_masks=3, mem_frames=4, max_ptrs=4)  # JAX's defaults
SAM2_CLIP = (4, 10)  # 19a: objects (batch lanes) and frames: the 4 + 4 ring wraps twice
# 19a: f32 masks and IoU, the card's kernel route against the CPU's einsum
# route over ten frames of memory feedback, relative to the largest entry
SAM2_TOL = 1e-3
VIT_DET = dict(num_classes=VOCAB, image_size=CROP, dim=256, depth=8, num_heads=8)  # JAX's defaults
VIT_DET_BATCH = 32
DETR_RUN = ("base", 512, 8, 32)  # 19c: size, image side, batch, ground-truth slots an image
GAN_CVAE_BATCH, GAN_BATCH, GAN_BASE_CH = 64, 32, 256  # 19d
GEN_LR = 0.01  # 19b-d: the SGD step held card against CPU
STEP_TOL = 1e-4  # 19b-d: f32 losses card vs CPU, relative
STEP_COS = (0.9999, 0.999)  # 19b-d: gradients / updates card vs CPU: whole, worst leaf
TRACK = ("yolov12x", 640, 8)  # 19e: the main path's detector, frame size, frames (one batch)
TRACK_MAX_DET = 100
TRACK_IOU_HIGH = 0.9  # 19e: a box and its best match in the previous frame count as one object
HEAT_TOL = 1e-5  # 19e: the heat map card vs CPU, relative to its largest entry


def _step_cos(a: dict, b: dict) -> tuple[float, float]:
    """:func:`_grad_cos` of two dicts of tensors (gradients or updates)."""
    return _grad_cos({k: v.double().cpu() for k, v in a.items()},
                     {k: v.double().cpu() for k, v in b.items()})


def seeded_sam2(dev, attn_impl: str = "einsum", seed: int = 0):
    """SAM2 at JAX's defaults (SAM2_KW), seeded (``init_sam2_``, drawn on the
    CPU: every device gets the same weights), f32, eval mode."""
    from kuzu_torch.models.sam2 import SAM2, init_sam2_

    m = init_sam2_(SAM2(**SAM2_KW), torch.Generator().manual_seed(seed))
    out = SAM2(**SAM2_KW, attn_impl=attn_impl)
    out.load_state_dict(m.state_dict())
    return out.to(dev).eval()


def sam2_clip():
    """(frames (B, T, 256, 256, 3) uint8: 18b's pages drifting 2 px down and
    3 px right a frame, frame-0 points and labels) for SAM2_CLIP."""
    b, t = SAM2_CLIP
    x, pts, lbl = sam_inputs(b, seed=26)
    frames = torch.stack([torch.roll(x, (2 * i, 3 * i), dims=(1, 2)) for i in range(t)], dim=1)
    return frames, pts, lbl


def sam2_video(dev, launches: dict) -> dict:
    """19a: SAM2 at JAX's defaults, seeded, f32: ``track`` of SAM2_CLIP's
    objects and frames with ``attn_impl="flash"`` on the card (K3 f32, 6
    launches a frame, each held against its plain version on the path's
    inputs) against the CPU's einsum route (masks, IoU within SAM2_TOL);
    ms a frame (flash and einsum on the card), a profiled call; then one
    forward and backward of ``forward(train=True)`` under ``"flash_train"``
    at B = 4 (K3 with its statistics and K4, 6 + 6 launches, each held
    against its plain version) against einsum on the card (18b's gradient
    criteria)."""
    frames, pts, lbl = sam2_clip()
    b, t = SAM2_CLIP
    depth = SAM2_KW["enc_depth"]
    gpu, cpu = seeded_sam2(dev, "flash"), seeded_sam2("cpu")
    fd, pd, ld = frames.to(dev), pts.to(dev), lbl.to(dev)
    calls = []
    with torch.no_grad(), attention_spy(calls):
        zero_counts()
        gm, gi = gpu.track(fd, pd, ld)
        torch.cuda.synchronize()
        counts = launch_counts()
    require(counts == want(area_attention_f32=depth * t), f"19a SAM2 track launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    worst = attention_calls_against_plain(calls)
    t0 = time.perf_counter()
    with torch.no_grad():
        cm, ci = cpu.track(frames, pts, lbl)
    cpu_s = time.perf_counter() - t0
    err = max(_rel(gm, cm), _rel(gi, ci))
    finite = bool(torch.isfinite(gm).all() and torch.isfinite(gi).all())
    print(f"19a SAM2 {SAM2_KW} f32, {b} objects x {t} frames: masks {tuple(gm.shape)}, IoU "
          f"{tuple(gi.shape)}; flash on the card vs einsum on the CPU {err:.2e} (<= {SAM2_TOL}; "
          f"mask logits max {float(cm.abs().max()):.3e}); launches {counts}; {len(calls)} K3 calls "
          f"against the plain version: max abs err {worst}; CPU track {cpu_s:.1f} s")
    s4 = SAM2_KW["img_size"] // 4
    require(err <= SAM2_TOL and finite and gm.shape == (b, t, s4, s4), "19a SAM2 card vs CPU")
    ein = seeded_sam2(dev)

    def track(m):
        with torch.no_grad():
            return m.track(fd, pd, ld)

    ms = {name: time_ms(lambda m=m: track(m), reps=5, warmup=1) / t
          for name, m in (("flash", gpu), ("einsum", ein))}
    print(f"19a SAM2 track on the card: flash {ms['flash']:.3f} ms a frame, einsum "
          f"{ms['einsum']:.3f} ms a frame ({b} objects; median of 5 clips of {t} frames)")
    bd = device_breakdown(lambda: track(gpu))
    out = dict(card_vs_cpu=err, k3_err=worst, k3_calls=len(calls), ms_per_frame=ms["flash"],
               einsum_ms_per_frame=ms["einsum"], device_ms=bd["busy_ms"],
               idle_share=bd["idle_share"], breakdown=bd, cpu_s=cpu_s)
    del cpu, ein

    res = {}
    w = None
    for impl in ("einsum", "flash_train"):
        m = seeded_sam2(dev, impl).train()
        calls = []
        with attention_spy(calls):
            zero_counts()
            mask, iou = m(fd[:, 0], pd, ld, train=True)
            if w is None:
                w = torch.cos(torch.arange(mask.numel(), device=dev).float()).reshape(mask.shape)
            ((mask * w).mean() + iou.square().sum()).backward()
            torch.cuda.synchronize()
            counts = launch_counts()
        res[impl] = (_grads(m), counts, calls)
    (ge, ce, _), (gf, cf, calls) = res["einsum"], res["flash_train"]
    require(ce == want() and cf == want(area_attention_f32=depth, area_attention_bwd_f32=depth),
            f"19a SAM2 flash_train launches {cf}")
    for k, v in cf.items():
        launches[k] += v
    worst = attention_calls_against_plain(calls)
    whole, leaf = _grad_cos(gf, ge)
    print(f"19a SAM2 forward(train=True) + backward, flash_train at B={b}: launches {cf}; "
          f"{len(calls)} K3 / K4 calls against the plain versions: max abs err {worst}; gradients "
          f"against einsum: whole cosine {whole:.8f} (>= 0.99999), worst leaf {leaf:.6f} (>= 0.9999)")
    require(whole >= 0.99999 and leaf >= 0.9999, "19a SAM2 flash_train gradients")
    out["flash_train"] = dict(kernel_err=worst, grad_cos=whole, grad_leaf_cos=leaf)
    del gpu, res
    torch.cuda.empty_cache()
    return out


def sgd(model) -> "Optimizer":
    """The trainers' ``Optimizer`` over plain SGD at GEN_LR, no clipping."""
    from kuzu_torch.core.train import Optimizer

    return Optimizer(torch.optim.SGD(model.parameters(), lr=GEN_LR), lambda c: GEN_LR, 0.0)


def card_vs_cpu_step(dev, cpu_model, loss_fn, label: str) -> dict:
    """One f32 step of ``loss_fn(model, device) -> loss`` on a copy of
    ``cpu_model`` on each device: the losses within STEP_TOL relative, the
    gradients within STEP_COS (cosine: whole, worst leaf above 1e-3 of the
    largest norm); then the card's SGD step: ms (median of 5)."""
    import copy

    models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to(dev)}
    out = {}
    for name, m in models.items():
        d = "cpu" if name == "cpu" else dev
        zero_counts()
        t0 = time.perf_counter()
        loss = loss_fn(m, d)
        loss.backward()
        if name == "card":
            torch.cuda.synchronize()
        out[name] = (float(loss.detach()), _grads(m), launch_counts(), time.perf_counter() - t0)
    (lc, gc, _, cpu_s), (lg, gg, counts, _) = out["cpu"], out["card"]
    rel = abs(lg - lc) / abs(lc)
    whole, leaf = _grad_cos(gg, gc)
    card = models["card"]
    opt = sgd(card)

    def step():
        opt.zero_grad()
        loss_fn(card, dev).backward()
        opt.step(0, torch.zeros(()))

    ms = time_ms(step, reps=5, warmup=1)
    print(f"{label}: loss card {lg:.6f} vs CPU {lc:.6f} (rel {rel:.2e} <= {STEP_TOL}); gradients "
          f"whole cosine {whole:.7f} (>= {STEP_COS[0]}), worst leaf {leaf:.6f} (>= {STEP_COS[1]}); "
          f"launches {counts}; SGD step {ms:.3f} ms on the card (median of 5), CPU forward + "
          f"backward {cpu_s:.1f} s")
    require(rel <= STEP_TOL and whole >= STEP_COS[0] and leaf >= STEP_COS[1]
            and counts == want() and np.isfinite(lg), label)
    return dict(loss=lg, loss_rel=rel, grad_cos=whole, grad_leaf_cos=leaf, ms_per_step=ms,
                cpu_s=cpu_s)


def vit_detector_step(dev) -> dict:
    """19b: ``ViTPatchDetector`` at JAX's defaults (1024 x 64, patch 16, dim
    256, depth 8, 8 heads), VOCAB classes, seeded (``det_head`` x3, so that
    the boxes spread), b VIT_DET_BATCH on 17b's block crops: the forward
    card vs CPU (1e-4 of the largest), then one ``vit_detector_loss`` step
    (16 ground-truth slots an image from the CPU's predicted boxes, jittered,
    4 padded; the threshold of epoch 0) under :func:`card_vs_cpu_step`."""
    import copy

    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.vit_detector import (
        ViTPatchDetector,
        dynamic_iou_threshold,
        vit_detector_loss,
    )

    cpu = flax_init_(ViTPatchDetector(**VIT_DET), torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.det_head.weight.mul_(3.0)
    x = block_crops(VIT_DET_BATCH, VIT_DET["image_size"], seed=27)
    gpu = copy.deepcopy(cpu).to(dev).eval()
    cpu.eval()
    with torch.no_grad():
        go, co = gpu(x.to(dev)), cpu(x)
    err = max(_rel(go[k], co[k]) for k in co)
    rng = np.random.default_rng(28)
    b, p = co["boxes"].shape[:2]
    pick = torch.from_numpy(rng.integers(0, p, (b, 16)))
    gt = co["boxes"].gather(1, pick[..., None].expand(-1, -1, 4))
    gt = (gt + torch.from_numpy(rng.normal(0, 0.01, gt.shape)).float()).clamp(0, 1)
    gt = torch.cat([torch.minimum(gt[..., :2], gt[..., 2:]),
                    torch.maximum(gt[..., :2], gt[..., 2:])], -1)
    labels = torch.from_numpy(rng.integers(0, VOCAB, (b, 16)))
    mask = torch.ones(b, 16, dtype=torch.bool)
    mask[:, 12:] = False
    thr = dynamic_iou_threshold(0)
    print(f"19b ViTPatchDetector {VIT_DET} b{b}: outputs card vs CPU {err:.2e} (<= {VIT_TOL}); "
          f"{sum(q.numel() for q in cpu.parameters())} params")
    require(err <= VIT_TOL, "19b ViTPatchDetector forward card vs CPU")

    def loss_fn(m, d):
        loss, metrics = vit_detector_loss(m(x.to(d), train=True), gt.to(d), labels.to(d),
                                          mask.to(d), thr, VOCAB)
        return loss

    with torch.no_grad():
        _, metrics = vit_detector_loss(co, gt, labels, mask, thr, VOCAB)
    out = card_vs_cpu_step(dev, cpu.train(), loss_fn, f"19b vit_detector_loss step b{b}")
    out.update(forward_err=err, n_matched=float(metrics["n_matched"]))
    print(f"19b matched ground truths an image (epoch 0, threshold {float(thr):.2f}): "
          f"{out['n_matched']:.2f} of 12")
    require(out["n_matched"] > 0, "19b ground truths matched")
    return out


def detr_step(dev) -> dict:
    """19c: DETR ``base`` (dim 256, 4 + 4 layers, 8 heads, 100 queries), one
    class (characters), seeded, at DETR_RUN's size and batch on column pages
    in [0, 1]: the forward card vs CPU (1e-4 of the largest), the matching
    cost (1e-4) and the Hungarian assignment on each device's cost (slots
    that differ counted), then one ``detr_loss`` step on the CPU's
    assignment under :func:`card_vs_cpu_step`; the host's share of a loss
    call (the cost's copy to the host and scipy) on its own line."""
    import copy

    from kuzu_torch.models.detr import SIZE_REGISTRY, DETR, _hungarian_host, detr_cost, detr_loss
    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.testing import column_pages

    size, sz, b, m = DETR_RUN
    cpu = flax_init_(DETR(num_classes=1, **SIZE_REGISTRY[size]), torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.query_embed.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(column_pages(b, sz, seed=29)).float() / 255.0
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(30)
    xy = rng.uniform(0, 0.9, (b, m, 2))
    gt = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(0.02, 0.1, (b, m, 2))], -1)).float()
    labels = torch.zeros(b, m, dtype=torch.long)
    mask = torch.ones(b, m, dtype=torch.bool)
    mask[:, m - 4:] = False
    with torch.no_grad():
        go, co = gpu(x.to(dev)), cpu(x)
        gcost = detr_cost(go, gt.to(dev), labels.to(dev), mask.to(dev), 1)
        ccost = detr_cost(co, gt, labels, mask, 1)
    err = max(_rel(go[k], co[k]) for k in co)
    cost_err = _rel(gcost, ccost)
    cassign = _hungarian_host(ccost.numpy())  # the first call imports scipy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = gcost.cpu().numpy()
    t1 = time.perf_counter()
    gassign = _hungarian_host(host)
    t2 = time.perf_counter()
    differ = int((gassign != cassign).sum())
    print(f"19c DETR {size} ({SIZE_REGISTRY[size]}) @{sz} b{b}: outputs card vs CPU {err:.2e}, "
          f"cost {cost_err:.2e} (<= {VIT_TOL}); assignment slots differing {differ} of "
          f"{gassign.size}")
    print(f"19c Hungarian matching on the host (B={b}, Q={go['logits'].shape[1]}, M={m}): cost "
          f"copy to the host {1e3 * (t1 - t0):.3f} ms, scipy linear_sum_assignment "
          f"{1e3 * (t2 - t1):.3f} ms")
    require(err <= VIT_TOL and cost_err <= VIT_TOL, "19c DETR forward and cost card vs CPU")
    assign = torch.from_numpy(cassign)

    def loss_fn(mdl, d):
        return detr_loss(mdl(x.to(d), train=True), gt.to(d), labels.to(d), mask.to(d), 1,
                         assign=assign)[0]

    out = card_vs_cpu_step(dev, cpu, loss_fn, f"19c detr_loss step b{b} (the CPU's assignment)")
    opt = sgd(gpu)

    def own_step():  # the loss as a user calls it: its own matching on the host
        opt.zero_grad()
        detr_loss(gpu(x.to(dev), train=True), gt.to(dev), labels.to(dev), mask.to(dev), 1)[0] \
            .backward()
        opt.step(0, torch.zeros(()))

    own_ms = time_ms(own_step, reps=5, warmup=1)
    print(f"19c detr_loss step with its own host matching: {own_ms:.3f} ms on the card (median of 5)")
    out.update(forward_err=err, cost_err=cost_err, assign_slots_differing=differ,
               hungarian_copy_ms=1e3 * (t1 - t0), hungarian_ms=1e3 * (t2 - t1),
               ms_per_step_own_matching=own_ms)
    return out


def glyphs(n: int, seed: int) -> torch.Tensor:
    """(n, 128, 128, 1) glyph-like images in [0, 1]: 17b's blocks, one channel."""
    return block_crops(n, (128, 128), seed)[..., :1].float() / 255.0


def generative_steps(dev) -> dict:
    """19d: the CVAE (VOCAB classes, latent 100, 128 px) at b GAN_CVAE_BATCH,
    seeded, one ``cvae_loss`` step on noise drawn once on the CPU, under
    :func:`card_vs_cpu_step`; StackGAN (VOCAB classes, latent 100, ``base_ch``
    GAN_BASE_CH; three discriminators) at b GAN_BATCH, seeded: one
    ``d_step`` and one ``g_step`` (SGD at GEN_LR) on each device with the
    same draws, each step from the same weights on both (the g_step from
    the CPU's discriminators after its d_step): the d loss within STEP_TOL
    relative, the g loss (a mean of logits of both signs, which cancels)
    within STEP_TOL of the logits' mean magnitude, the stepped models'
    updates within STEP_COS; ms of a step pair on the card."""
    import copy

    from kuzu_torch.models.cvae import CVAE, cvae_loss, init_cvae_
    from kuzu_torch.models.layers import flax_init_
    from kuzu_torch.models.stackgan import (
        StackGenerator,
        StageDiscriminator,
        gan_draws,
        make_gan_steps,
    )

    n = GAN_CVAE_BATCH
    cvae = init_cvae_(CVAE(VOCAB), torch.Generator().manual_seed(0))
    imgs, labels = glyphs(n, 31), torch.from_numpy(np.random.default_rng(32).integers(0, VOCAB, n))
    noise = torch.randn((n, 100), generator=torch.Generator().manual_seed(33))

    def loss_fn(m, d):
        recon, mu, logvar = m(imgs.to(d), labels.to(d), noise=noise.to(d))
        return cvae_loss(recon, imgs.to(d), mu, logvar)[0]

    out = dict(cvae=card_vs_cpu_step(dev, cvae, loss_fn, f"19d CVAE cvae_loss step b{n}"))
    out["cvae"]["noise_copies"] = cvae_noise_copies(dev, cvae, imgs, labels)

    n = GAN_BATCH
    gen = flax_init_(StackGenerator(VOCAB, base_ch=GAN_BASE_CH), torch.Generator().manual_seed(1))
    discs = [flax_init_(StageDiscriminator(VOCAB, s), torch.Generator().manual_seed(2 + i))
             for i, s in enumerate((32, 64, 128))]
    batch = {"image": glyphs(n, 34) * 2 - 1,
             "label": torch.from_numpy(np.random.default_rng(35).integers(0, VOCAB, n))}
    g = torch.Generator().manual_seed(36)
    d_draws, g_draws = gan_draws(g, n, 100, stages=3), gan_draws(g, n, 100)
    sides = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        gm, dm = copy.deepcopy(gen).to(d), [copy.deepcopy(x).to(d) for x in discs]
        d_step, g_step = make_gan_steps(gm, dm, sgd(gm), [sgd(x) for x in dm])
        sides[name] = (gm, dm, d_step, g_step, {k: v.to(d) for k, v in batch.items()})

    def step(name, which):
        """One d_step or g_step on ``name``'s side: (loss, the stepped models'
        updates, launches)."""
        gm, dm, d_step, g_step, b = sides[name]
        models = _named(None, dm) if which == "d" else _named(gm, [])
        before = {k: v.detach().clone() for k, v in models.items()}
        zero_counts()
        loss = float(d_step(b, d_draws) if which == "d" else g_step(b, g_draws["z"]))
        return loss, {k: v.detach() - before[k] for k, v in models.items()}, launch_counts()

    res = {}
    for which in ("d", "g"):
        if which == "g":  # the g_step from the same discriminators: the CPU's after its d_step
            for tgt, src in zip(sides["card"][1], sides["cpu"][1]):
                tgt.load_state_dict(src.state_dict())
            gm, dm, _, _, b = sides["cpu"]
            with torch.no_grad():  # the g loss cancels; its scale is the logits' magnitude
                fakes = gm(g_draws["z"], b["label"])
                scale = sum(float(x(f, b["label"]).abs().mean()) for x, f in zip(dm, fakes)) / 3
        (lc, uc, _), (lg, ug, counts) = step("cpu", which), step("card", which)
        rel = abs(lg - lc) / (abs(lc) if which == "d" else scale)
        whole, leaf = _step_cos(ug, uc)
        res[which] = dict(loss=lg, loss_cpu=lc, loss_rel=rel, update_cos=whole,
                          update_leaf_cos=leaf, launches=counts)
        require(rel <= STEP_TOL and whole >= STEP_COS[0] and leaf >= STEP_COS[1]
                and counts == want(), f"19d StackGAN {which}_step card vs CPU")
    gm, dm, d_step, g_step, b = sides["card"]
    ms = time_ms(lambda: (d_step(b, d_draws), g_step(b, g_draws["z"])), reps=5, warmup=1)
    params = sum(p.numel() for p in _named(gen, discs).values())
    d, g_ = res["d"], res["g"]
    print(f"19d StackGAN (base_ch {GAN_BASE_CH}, {params} params) b{n}, each step from the same "
          f"weights on both devices: d_step loss card {d['loss']:.6f} vs CPU {d['loss_cpu']:.6f} "
          f"(rel {d['loss_rel']:.2e}), discriminators' updates whole cosine "
          f"{d['update_cos']:.7f}, worst leaf {d['update_leaf_cos']:.6f}; g_step loss "
          f"{g_['loss']:.6f} vs {g_['loss_cpu']:.6f} (difference {g_['loss_rel']:.2e} of the "
          f"logits' mean magnitude {scale:.4f}), the generator's updates {g_['update_cos']:.7f}, "
          f"worst leaf {g_['update_leaf_cos']:.6f} (<= {STEP_TOL}; >= {STEP_COS}); launches "
          f"{g_['launches']}; d_step + g_step {ms:.3f} ms on the card (median of 5)")
    out["stackgan"] = dict(d_step=d, g_step=g_, logit_scale=scale, ms_per_step_pair=ms,
                           params=params)
    del sides
    torch.cuda.empty_cache()
    return out


def cvae_noise_copies(dev, cvae, imgs, labels) -> int:
    """19d: a CVAE forward on the card with neither noise nor a generator
    draws its noise on the card: the profile of one forward (its trace
    holding kernels, else taken again) has no host-to-device copy of the
    noise's size (a copy without a size counts as one)."""
    import copy
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    model = copy.deepcopy(cvae).to(dev).eval()
    x, y = imgs.to(dev), labels.to(dev)
    with torch.no_grad():
        mu = model.encoder(x, y)[0]
        noise_bytes = mu.numel() * 4
        model(x, y)
        torch.cuda.synchronize()
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model(x, y)
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
            if any(e.get("cat") == "kernel" for e in events):
                break
    require(any(e.get("cat") == "kernel" for e in events), "19d a CVAE forward's profile")
    htod = [e.get("args", {}).get("bytes") for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    copies = sum(1 for b in htod if b in (None, noise_bytes))
    print(f"19d CVAE forward without a generator: host-to-device copies {htod} (bytes), of the "
          f"noise's {noise_bytes} bytes {copies} (must be 0: the noise is drawn on the card)")
    require(copies == 0, "19d the CVAE's noise is drawn on the card")
    return copies


def _named(gen, discs) -> dict:
    out = {} if gen is None else {f"gen.{k}": v for k, v in gen.named_parameters()}
    for i, d in enumerate(discs):
        out.update({f"disc{i}.{k}": v for k, v in d.named_parameters()})
    return out


def track_frames() -> list[np.ndarray]:
    """TRACK's frames: a 640 px window sliding 2 px right and 1 px down a
    frame over one seeded column page."""
    from kuzu_torch.testing import column_pages

    _, sz, n = TRACK
    page = column_pages(1, sz + 64, seed=37)[0]
    return [np.ascontiguousarray(page[i:i + sz, 2 * i:2 * i + sz]) for i in range(n)]


def track_run_dir(dev, root, frames):
    """A detect run dir of TRACK's detector (nc 1), seeded, its BatchNorm
    calibrated on the first two frames and its box head biased to small
    boxes (phase 8's recipe), as ``DetectTrainer`` writes one."""
    import yaml

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.testing import box_head, calibrate_batch_norm

    name, sz, _ = TRACK
    det = YoloDetector(name, nc=1, imgsz=sz, device=dev).init(0)
    calibrate_batch_norm(det.graph, torch.from_numpy(np.stack(frames[:2])).to(dev))
    box_head(det, (2, 2, 2, 2))
    run = root / "track_run"
    run.mkdir()
    load_config(overrides={"task": "detect", "model": name, "imgsz": sz}).to_yaml(run / "args.yaml")
    (run / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 1, "names": {0: "char"}}))
    CheckpointManager(run / "weights").save(
        TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1)), fitness=1.0)
    del det
    return run


def id_persistence(results) -> dict:
    """Across consecutive frames: the boxes whose best-IoU box in the previous
    frame overlaps at TRACK_IOU_HIGH or more, and the share of them that
    carry that box's id."""
    from kuzu_torch.core.metrics import box_iou_np

    pairs = same = 0
    for prev, cur in zip(results[:-1], results[1:]):
        if not len(prev) or not len(cur):
            continue
        iou = box_iou_np(cur.boxes.xyxy, prev.boxes.xyxy)
        best = iou.argmax(1)
        high = iou[np.arange(len(cur)), best] >= TRACK_IOU_HIGH
        pairs += int(high.sum())
        same += int((cur.boxes.id[high] == prev.boxes.id[best[high]]).sum())
    return dict(high_iou_pairs=pairs, same_id=same, share=same / max(pairs, 1))


def tracking(dev, launches: dict) -> dict:
    """19e: ``Model(run_dir).track`` over TRACK's frames (one batch: K2 16
    launches, K1 one) with ByteTrack, thresholds at the median score of a
    first ``predict`` (seeded scores lie far below ByteTrack's 0.5); every
    K1 and K2 call held against its plain version (``path_kernel_checks``);
    every ``Results`` carries ids, and ids follow boxes that persist
    (``id_persistence``: share >= 0.5); ``ObjectCounter`` and ``Heatmap``
    over the tracked results, the heat map on the card against the CPU's
    within HEAT_TOL; ms a frame of ``track`` and of ``predict``; whether
    cv2 imports, and without it, BoT-SORT raising an error naming cv2."""
    import tempfile
    from pathlib import Path

    from kuzu_torch.api.model import Model
    from kuzu_torch.solutions import Heatmap, ObjectCounter

    name, sz, n = TRACK
    frames = track_frames()
    kw = dict(conf=CONF, iou=0.7, max_det=TRACK_MAX_DET, batch=n)
    with tempfile.TemporaryDirectory() as tmp:
        model = Model(str(track_run_dir(dev, Path(tmp), frames)), device=dev)
        first = model.predict(list(frames), **kw)
        thr = float(np.median(np.concatenate([r.boxes.conf for r in first])))
        tk = dict(track_high_thresh=thr, track_low_thresh=CONF, new_track_thresh=thr)
        torch.cuda.synchronize()
        zero_counts()
        results = model.track(list(frames), **kw, **tk)
        torch.cuda.synchronize()
        counts = launch_counts()
        require(counts == want(nms=1, fused_ablock=16), f"19e Model.track launches {counts}")
        for k, v in counts.items():
            launches[k] += v
        require(all(r.boxes.id is not None and len(r.boxes.id) == len(r) for r in results)
                and all(len(r) > 0 for r in results), "19e every Results carries ids")
        pers = id_persistence(results)
        n_ids = len({int(i) for r in results for i in r.boxes.id})
        print(f"19e Model({name} run dir).track over {n} frames of {sz} px, ByteTrack at high / "
              f"new threshold {thr:.4f} (the median score), low {CONF}: tracks a frame "
              f"{[len(r) for r in results]}, {n_ids} ids in all; boxes whose previous-frame "
              f"match overlaps >= {TRACK_IOU_HIGH}: {pers['high_iou_pairs']}, of them "
              f"{pers['same_id']} keep its id (share {pers['share']:.3f} >= 0.5); launches {counts}")
        require(pers["high_iou_pairs"] > 0 and pers["share"] >= 0.5, "19e ids persist")
        checks = path_kernel_checks(lambda: model.track(list(frames), **kw, **tk), shapes=(1, 2),
                                    where="Model.track")
        track_ms = time_ms(lambda: model.track(list(frames), **kw, **tk), reps=3, warmup=1) / n
        predict_ms = time_ms(lambda: model.predict(list(frames), **kw), reps=3, warmup=1) / n
        bd = device_breakdown(lambda: model.track(list(frames), **kw, **tk))
        counter = ObjectCounter(line=((sz // 2, 0), (sz // 2, sz)))
        heat = {d: Heatmap((sz, sz), device=d) for d in (dev, "cpu")}
        for r in results:
            counter.update(r)
            for h in heat.values():
                h.update(r)
        gh, ch = heat[dev].heat, heat["cpu"].heat
        heat_err = float(np.abs(gh - ch).max() / np.abs(ch).max())
        print(f"19e ObjectCounter (vertical line at x={sz // 2}): in {counter.in_count}, out "
              f"{counter.out_count}; Heatmap {gh.shape} card vs CPU {heat_err:.2e} (<= {HEAT_TOL}, "
              f"max {float(ch.max()):.3f}); track {track_ms:.3f} ms a frame, predict "
              f"{predict_ms:.3f} ms a frame (median of 3 calls of {n} frames, host included)")
        require(heat_err <= HEAT_TOL and ch.max() > 0, "19e heat map card vs CPU")
        try:
            import cv2  # noqa: F401

            has_cv2 = True
        except ImportError:
            has_cv2 = False
        if has_cv2:
            bot = model.track(list(frames), tracker="botsort", **kw, **tk)
            require(all(r.boxes.id is not None for r in bot), "19e BoT-SORT ids")
            bot_line = f"BoT-SORT tracked {[len(r) for r in bot]}"
        else:
            try:
                model.track(list(frames), tracker="botsort", **kw, **tk)
                raise RuntimeError("19e: BoT-SORT ran without cv2")
            except ImportError as e:
                require("cv2" in str(e), f"19e BoT-SORT's error names cv2: {e}")
                bot_line = f"BoT-SORT raises: {e}"
        print(f"19e cv2 imports: {has_cv2}; {bot_line}")
    return dict(launches=counts, ids=n_ids, persistence=pers, threshold=thr,
                ms_per_frame=track_ms, predict_ms_per_frame=predict_ms, device_ms=bd["busy_ms"],
                idle_share=bd["idle_share"], breakdown=bd, heat_err=heat_err,
                counts_in_out=(counter.in_count, counter.out_count), cv2=has_cv2,
                path_kernels=checks)


def last_models_phase(dev, launches: dict) -> dict:
    """Phase 19: 19a (SAM2's video predictor on K3 / K4), 19b (the ViT patch
    detector), 19c (DETR), 19d (the CVAE and StackGAN), 19e
    (``Model.track`` with the solutions)."""
    t0 = time.perf_counter()
    out = dict(sam2=sam2_video(dev, launches), vit_detector=vit_detector_step(dev),
               detr=detr_step(dev), generative=generative_steps(dev), track=tracking(dev, launches))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 19: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 20

EXPORT_F32 = ("yolov12n", 640, 8)  # 20c: model, image size, batch
TUNE = ("yolov12n", 128, 2)  # 20e: model, image size, iterations (one short epoch each)


def _fake_args(mode, args):
    return [[mode.from_tensor(w) for w in a] if isinstance(a, list)
            else mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]


def operator_checks(dev) -> dict:
    """20a: each ``kuzu_torch::`` operator on CUDA tensors at phase 3's
    shapes (K1 at B=8, K=2048; K2 at G=32 chunks of na=400, C=384, 12
    heads, hidden 576; K3 bf16 at G=32, N=400, C=64, 2 heads; K3 f32 at
    TROCR_K3), inside :func:`full_f32_references` as phase 3:
    ``torch.library.opcheck`` (schema, fake implementation, dispatch); the
    operator against its plain version (K1's keeps equal, K2 within
    ABLOCK_TOL, K3 within ATTN_TOL / ATTN_F32_TOL); the fake
    implementation's shape, dtype and device against the real output's.
    Then the operator boundary's host cost: K1 at B=1, K=64 (a launch the
    host outpaces) called 200 times through the operator and through its
    launch function directly, host microseconds a call."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from kuzu_torch.ops import nms_kernel
    from kuzu_torch.ops.flash_attention import area_attention_plain, attention_scale
    from kuzu_torch.ops.fused_ablock import fused_ablock_plain
    from kuzu_torch.ops.nms_kernel import suppress_reference
    from kuzu_torch.testing import ablock_over, attention_f32_over, attention_over

    gen = torch.Generator(device=dev).manual_seed(20)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def plain3(q, k, v, heads):
        return area_attention_plain(q, k, v, heads, attention_scale(q, heads))

    def keeps(out, ref):
        return int((out != ref).sum()), 0, 1.0

    na, c, heads, hid = 400, 384, 12, 576
    weights = [rnd(c, 2 * c, scale=c ** -0.5), rnd(1, 2 * c, dtype=torch.float32, scale=0.1),
               rnd(c, c, scale=c ** -0.5), rnd(1, c, dtype=torch.float32, scale=0.1),
               rnd(c, hid, scale=c ** -0.5), rnd(1, hid, dtype=torch.float32, scale=0.1),
               rnd(hid, c, scale=hid ** -0.5), rnd(1, c, dtype=torch.float32, scale=0.1)]
    gf, nf, cf, hf = TROCR_K3
    ops = torch.ops.kuzu_torch
    cases = {
        "nms_keep": (ops.nms_keep, (*nms_inputs(dev), 0.45), suppress_reference, keeps),
        "fused_ablock": (ops.fused_ablock, (*(rnd(32, na, c) for _ in range(3)), weights, 1,
                                            heads), fused_ablock_plain, ablock_over),
        "area_attention bf16": (ops.area_attention, (*(rnd(32, 400, 64) for _ in range(3)), 2),
                                plain3, attention_over),
        "area_attention f32": (ops.area_attention,
                               (*(rnd(gf, nf, cf, dtype=torch.float32) for _ in range(3)), hf),
                               plain3, attention_f32_over),
    }
    out = {}
    with full_f32_references():
        for name, (op, args, plain, over) in cases.items():
            checks = torch.library.opcheck(op, args)
            real, ref = op(*args), plain(*args)
            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                fake = op(*_fake_args(mode, args))
            torch.cuda.synchronize()
            err, n_over, close = over(real, ref)
            same = (fake.shape, fake.dtype, fake.device) == (real.shape, real.dtype, real.device)
            ok = n_over == 0 and (close > 0.999 if over is ablock_over else err == 0
                                  if over is keeps else True)
            print(f"20a kuzu_torch::{name}: opcheck {sorted(checks.items())}; against the plain "
                  f"version: {'keep mismatches' if name == 'nms_keep' else 'max_abs_err'} "
                  f"{err:.4g}, over tolerance {n_over}; fake {tuple(fake.shape)} {fake.dtype} "
                  f"{fake.device} == real: {same}")
            require(all(v == "SUCCESS" for v in checks.values()) and ok and same
                    and bool(torch.isfinite(real.float()).all()), f"20a kuzu_torch::{name}")
            out[name] = dict(opcheck=checks, max_abs_err=err, over=n_over, fake_equal=same)
    boxes, valid = nms_inputs(dev, 1, 64, seed=5)

    def host_us(fn, n: int = 200) -> float:
        for _ in range(10):
            fn(boxes, valid, 0.45)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(boxes, valid, 0.45)
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    through = [host_us(ops.nms_keep), host_us(nms_kernel.launch)]
    through += [host_us(ops.nms_keep), host_us(nms_kernel.launch)]
    cost = dict(operator_us=min(through[0::2]), launch_us=min(through[1::2]), runs_us=through)
    print(f"20a the operator boundary: K1 at B=1, K=64, host time a call through "
          f"kuzu_torch::nms_keep {cost['operator_us']:.2f} us, through its launch function "
          f"{cost['launch_us']:.2f} us (the lesser of 2 runs of 200 calls each: {through})")
    out["boundary"] = cost
    return out


def export_full_width(dev, launches: dict) -> dict:
    """20b: TRACK's run dir (yolov12x@640, nc 1, seeded, BatchNorm
    calibrated, box head set) exported through ``Model.export`` (``nms``,
    batch 8) into a temporary directory, reloaded by ``AutoBackend``: the
    graph's operator nodes (K1 1, K2 16); one reloaded call's launches by
    the counters (K1 1, K2 16, no plain call) and by the profiler (K2's
    attention kernel 16 times, K1's sweep once); its detections equal to
    the eager predictor's (``AutoBackend`` on the run dir, ``DetectPredictor.
    _fwd``) on the same f32 frames in [0, 1], and, printed, on their uint8
    pixels; export and reload seconds, the ``.pt2``'s MB; ms/img of eager
    and exported calls (CUDA events, median of 10) and the idle share of
    one profiled call of each. Returns the results, the frames and the
    exported call's detections (20f draws them)."""
    import tempfile
    from pathlib import Path

    from kuzu_torch.api.backend import AutoBackend
    from kuzu_torch.api.model import Model
    from kuzu_torch.ops.registry import graph_operators

    name, sz, b = TRACK
    frames = track_frames()
    u8 = torch.from_numpy(np.stack(frames)).to(dev)
    imgs = u8.float() / 255.0
    kw = dict(conf=CONF, iou=0.7, max_det=TRACK_MAX_DET)
    with tempfile.TemporaryDirectory() as tmp:
        run = track_run_dir(dev, Path(tmp), frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = Model(str(run), device=dev).export(format="stablehlo", nms=True, batch=b, **kw)
        export_s = time.perf_counter() - t0
        mb = blob.stat().st_size / 2**20
        t0 = time.perf_counter()
        exported = AutoBackend(blob)
        reload_s = time.perf_counter() - t0
        eager = AutoBackend(run, device=dev, **kw)
        nodes = graph_operators(exported._fn)
        print(f"20b {name}@{sz} b{b} exported through Model.export in {export_s:.1f} s, "
              f"{mb:.1f} MB, reloaded by AutoBackend in {reload_s:.1f} s; operator nodes "
              f"{nodes}, the .json's {exported.meta['operators']}; {exported.meta['in_avals']} -> "
              f"{exported.meta['out_avals']}, device {exported.meta['device']}")
        require(nodes == exported.meta["operators"]
                == {"nms_keep": 1, "fused_ablock": 16, "area_attention": 0},
                "20b the exported graph holds K1 once and K2 16 times")
        exported(imgs), eager(imgs)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        zero_counts()
        got = exported(imgs)
        torch.cuda.synchronize()
        counts, plain = launch_counts(), plain_counts()
        require(counts == want(nms=1, fused_ablock=16) and not any(plain.values()),
                f"20b one exported call's launches {counts}, plain calls {plain}")
        for k, v in counts.items():
            launches[k] += v
        ref = eager(imgs)
        diff = {k: int((got[k] != ref[k]).sum()) for k in ref}
        ref_u8 = eager(u8)
        diff_u8 = {k: int((got[k] != ref_u8[k]).sum()) for k in ref_u8}
        print(f"20b one exported call: launches {counts}; entries differing from the eager "
              f"predictor on the same f32 frames {diff} (must be 0), on their uint8 pixels "
              f"{diff_u8}; valid per frame {got['valid'].sum(1).tolist()}")
        require(not any(diff.values()) and got["valid"].sum() > 0,
                "20b the exported detections equal the eager predictor's")
        prof = kernel_launch_counts(lambda: exported(imgs))
        by = {kind: sum(n for k, n in prof.items() if pat in k) for kind, pat in
              (("K2 attention", "attention_fwd_kernel"), ("K2 GEMMs", "gemm::gemm_kernel"),
               ("K1 mask", "nms_mask"), ("K1 sweep", "nms_sweep"))}
        print(f"20b the profiler's kernels of one exported call: {by}")
        require(by["K2 attention"] == 16 and by["K1 sweep"] == 1,
                "20b the profiler shows K2 16 times and K1 once")
        calls = {"eager": lambda: eager(imgs), "exported": lambda: exported(imgs)}
        rounds = {k: [] for k in calls}
        for k in ("eager", "exported", "exported", "eager"):  # alternating, one process
            rounds[k].append(time_ms(calls[k], reps=10, warmup=2) / b)
        times = {f"{k}_ms_per_img": min(v) for k, v in rounds.items()}
        bd = {k: device_breakdown(fn) for k, fn in calls.items()}
        host = {k: host_ops(fn) for k, fn in calls.items()}
        print(f"20b ms/img (CUDA events, median of 10 calls, the numpy copy of the outputs "
              f"included; two rounds each, alternating): eager {rounds['eager']}, exported "
              f"{rounds['exported']}; device ms / idle share of one call: exported "
              f"{bd['exported']['busy_ms']:.3f} / {bd['exported']['idle_share']:.3f}, eager "
              f"{bd['eager']['busy_ms']:.3f} / {bd['eager']['idle_share']:.3f}")
    res = dict(export_s=export_s, reload_s=reload_s, pt2_mb=mb, nodes=nodes, launches=counts,
               differing=diff, differing_uint8=diff_u8, profiler_kernels=by, **times,
               rounds_ms_per_img=rounds, host_ops=host,
               device_ms={k: v["busy_ms"] for k, v in bd.items()},
               idle_share={k: v["idle_share"] for k, v in bd.items()})
    return res, frames, got


def host_ops(fn, top: int = 10) -> dict:
    """The host's side of one call of ``fn`` (torch.profiler, CPU activity,
    after one untimed call): its operator calls (``aten::`` and
    ``kuzu_torch::``), the host ms they take in all (self time), and the
    ``top`` operators by self time with their counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.key_averages() if e.key.startswith(("aten::", "kuzu_torch::"))]
    ranked = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]
    out = dict(wall_ms=wall, op_calls=sum(e.count for e in ops),
               op_self_ms=sum(e.self_cpu_time_total for e in ops) / 1e3,
               top={e.key: (e.count, round(e.self_cpu_time_total / 1e3, 3)) for e in ranked})
    print(f"  host side of one call (profiled wall {wall:.3f} ms): {out['op_calls']} operator "
          f"calls, {out['op_self_ms']:.3f} ms self time; top by self ms (count, ms): "
          f"{out['top']}")
    return out


def export_f32(dev, launches: dict) -> dict:
    """20c: yolov12n@640 b8 f32 (seeded; the module tree in eval mode)
    exported by ``export_detector`` and run by ``AutoBackend`` (inside
    ``f32_products``): its launches (K1 once: the f32 tree's attention is
    materialised on the card), its detections equal to the eager f32 path
    (``YoloGraph.forward``, TF32 off); printed, how many entries the same
    program gives otherwise when called outside ``f32_products`` (TF32 on
    for cuDNN, torch's default)."""
    import tempfile
    from pathlib import Path

    from kuzu_torch.api.backend import AutoBackend
    from kuzu_torch.api.export import export_detector
    from kuzu_torch.models.yolo.detector import YoloDetector

    name, sz, b = EXPORT_F32
    det = YoloDetector(name, nc=80, imgsz=sz, device=dev).init(0)
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (b, sz, sz, 3), dtype=np.uint8)).to(dev).float() / 255.0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        blob = export_detector(det, Path(tmp) / "f32", batch=b, conf=CONF, iou=0.7,
                               dtype=torch.float32)
        backend = AutoBackend(blob)
        seconds = time.perf_counter() - t0
    backend(imgs)
    torch.cuda.synchronize()
    zero_counts()
    got = backend(imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts == want(nms=1), f"20c one f32 exported call's launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    with torch.no_grad():
        ref = det.select(det.decode(det.graph.eval()(imgs)), CONF, 0.7, 300)
        raw = backend._fn(imgs)  # outside f32_products: TF32 convolutions
    diff = {k: int((got[k] != ref[k].cpu().numpy()).sum()) for k in ref}
    diff_tf32 = {k: int((raw[k] != ref[k]).sum()) for k in ref}
    ms = time_ms(lambda: backend(imgs), reps=5, warmup=1) / b
    print(f"20c {name}@{sz} b{b} f32 exported and reloaded in {seconds:.1f} s; launches {counts};"
          f" entries differing from the eager f32 path (TF32 off) {diff} (must be 0); the same "
          f"program called outside f32_products (TF32 on for cuDNN) {diff_tf32}; valid per "
          f"image {got['valid'].sum(1).tolist()}; {ms:.4f} ms/img (median of 5)")
    require(not any(diff.values()) and got["valid"].sum() > 0,
            "20c the f32 program equals the eager f32 path")
    return dict(seconds=seconds, launches=counts, differing=diff, differing_tf32=diff_tf32,
                ms_per_img=ms)


def benchmark_rows(dev) -> list:
    """20d: ``Model("yolov12x").benchmark`` at 640, b1 and b8: ms/img and
    TFLOP/s of the flop count of one call (``tools/profiling.flops_of``:
    products and convolutions, K1 and K2 by their operators' formulas)."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.tools.benchmarks import format_table

    t0 = time.perf_counter()
    rows = Model("yolov12x", device=dev).benchmark(imgsz=640, batches=(1, 8))["rows"]
    print(f"20d Model('yolov12x').benchmark(imgsz=640, batches=(1, 8)) in "
          f"{time.perf_counter() - t0:.1f} s:")
    print(format_table(rows))
    require(len(rows) == 2 and all(r["median_ms"] > 0 and r["tflops"] > 0 for r in rows),
            "20d benchmark rows")
    return rows


def tune_run(dev) -> dict:
    """20e: ``Model("yolov12n").tune(iterations=2)`` at 128, one short
    epoch an iteration, on a seeded YOLO folder (``write_yolo_folder``: 8
    training and 4 validation pages of 128 x 128, 2 classes): the CSV's
    rows and the seconds an iteration."""
    import tempfile
    from pathlib import Path

    from kuzu_torch.api.model import Model
    from kuzu_torch.testing import write_yolo_folder

    name, sz, iters = TUNE
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = write_yolo_folder(root / "data", {"train": 8, "val": 4}, hw=(sz, sz), nc=2)
        t0 = time.perf_counter()
        best = Model(name, device=dev).tune(iterations=iters, data=str(data), epochs=1,
                                            imgsz=sz, batch=4, workers=0, project=str(root),
                                            tune_dir=str(root / "tune"))
        seconds = (time.perf_counter() - t0) / iters
        rows = (root / "tune" / "tune_results.csv").read_text().splitlines()
    print(f"20e Model('{name}').tune(iterations={iters}) at {sz}: {seconds:.1f} s an iteration; "
          f"tune_results.csv:")
    for line in rows:
        print(f"  {line}")
    require(len(rows) == iters + 1 and np.isfinite(best["best_fitness"]), "20e tune rows")
    return dict(seconds_per_iteration=seconds, rows=rows, best_fitness=best["best_fitness"])


def results_plot(frames, dets) -> dict:
    """20f: ``Results.plot`` / ``save`` of 20b's first frame and its exported
    detections (640 px, no letterbox), the PNG read back equal; which video
    I/O backends this cv2 build has, and whether a clip it writes reads
    back (``cv2.VideoWriter`` / ``VideoCapture``, MJPG in AVI)."""
    import os
    import tempfile

    import cv2

    from kuzu_torch.api.results import Boxes, Results

    valid = dets["valid"][0]
    r = Results(frames[0], "frame0", {0: "char"},
                Boxes(dets["boxes"][0][valid], dets["scores"][0][valid],
                      dets["classes"][0][valid], frames[0].shape[:2]))
    with tempfile.TemporaryDirectory() as tmp:
        plot = r.plot()
        back = cv2.cvtColor(cv2.imread(str(r.save(os.path.join(tmp, "f.png")))),
                            cv2.COLOR_BGR2RGB)
        same = np.array_equal(back, plot)
        changed = int((plot != frames[0]).any(-1).sum())
        clip = os.path.join(tmp, "clip.avi")
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 48))
        for i in range(3):
            vw.write(np.full((48, 64, 3), 40 * i, np.uint8))
        vw.release()
        cap = cv2.VideoCapture(clip)
        read = 0
        while cap.read()[0]:
            read += 1
        cap.release()
    backends = [cv2.videoio_registry.getBackendName(b) for b in cv2.videoio_registry.getBackends()]
    print(f"20f Results.plot of {len(r)} boxes on a {frames[0].shape} frame: {changed} pixels "
          f"drawn; save read back equal: {same}; cv2 {cv2.__version__} video backends "
          f"{backends}, a 3-frame MJPG clip written and read back: {read} frames")
    require(same and changed > 0, "20f Results.plot / save")
    return dict(boxes=len(r), pixels_drawn=changed, saved_equal=same, video_backends=backends,
                clip_frames_read=read)


def export_phase(dev, launches: dict) -> dict:
    """Phase 20: 20a (the operators), 20b (the full-width export), 20c
    (an f32 export), 20d (``Model.benchmark``), 20e (``Model.tune``), 20f
    (``Results.plot`` / ``save``)."""
    t0 = time.perf_counter()
    out = dict(operators=operator_checks(dev))
    out["export"], frames, dets = export_full_width(dev, launches)
    out["export_f32"] = export_f32(dev, launches)
    out["benchmark"] = benchmark_rows(dev)
    out["tune"] = tune_run(dev)
    out["results"] = results_plot(frames, dets)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------- main

KERNELS = {
    "area_attention_f32": ("kuzu_torch/csrc/attention_f32.cuh",
                           "kuzu/ops/flash_attention.py:148"),
    "area_attention_bwd_f32": ("kuzu_torch/csrc/attention_f32_bwd.cuh",
                               "kuzu/ops/flash_attention.py:247"),
    "nms": ("kuzu_torch/csrc/nms.cu", "kuzu/ops/pallas_nms.py:314"),
    "area_attention": ("kuzu_torch/csrc/area_attention.cu", "kuzu/ops/flash_attention.py:148"),
    "fused_ablock": ("kuzu_torch/csrc/fused_ablock.cu", "kuzu/ops/fused_ablock.py:117"),
    "area_attention_bwd": ("kuzu_torch/csrc/area_attention_bwd.cu",
                           "kuzu/ops/flash_attention.py:247"),
    "flash_attention": ("kuzu_torch/csrc/flash_attention.cu", "kuzu/ops/flash_attention.py:68"),
    "fused_c3k2": ("kuzu_torch/csrc/fused_c3k2.cu", "kuzu/ops/fused_c3k2.py:194"),
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
    if sys.argv[1:] == ["16"]:
        heads = heads_phase(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"heads": heads, "card": card}, default=str))
        print(card)
        return 0
    if sys.argv[1:] == ["17"]:
        nas = nas_phase(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"nas_encoders_simple_vit": nas, "card": card}, default=str))
        print(card)
        return 0
    if sys.argv[1:] == ["18"]:
        sam = sam_phase(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"layout_options_sam": sam, "card": card}, default=str))
        print(card)
        return 0
    if sys.argv[1:] == ["19"]:
        last = last_models_phase(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"last_models_track": last, "card": card}, default=str))
        print(card)
        return 0
    if sys.argv[1:] == ["20"]:
        export = export_phase(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"export_tools": export, "card": card}, default=str))
        print(card)
        return 0
    if sys.argv[1:] == ["5"]:
        e2e = full_width(dev, dict.fromkeys(COUNTERS, 0))[0]
        print(json.dumps({"e2e_yolov12x_640_b8": e2e, "card": card}))
        print(card)
        return 0
    if sys.argv[1:] == ["10"]:
        train = train_full_width(dev, dict.fromkeys(COUNTERS, 0))
        train["remat"] = remat_full_width(dev, dict.fromkeys(COUNTERS, 0))
        print(json.dumps({"train_yolov12p2x_640_b8": train, "card": card}))
        print(card)
        return 0

    res = kernel_phase(dev)
    launches = dict.fromkeys(COUNTERS, 0)
    slice_check(dev, launches)
    e2e, det, imgs = full_width(dev, launches)
    res["fused_c3k2"] = c3k2_phase(dev, det, imgs, launches)
    del det, imgs  # the training phases' peak memory counts training alone
    # K5 before the training phases: after DetectTrainer.train() the
    # profiler sessions of device_times come back empty on this card
    res["flash_attention"] = flash_phase(dev, launches)
    torch.cuda.empty_cache()
    cascade = dict(card_vs_cpu=cascade_card_vs_cpu(dev))
    cascade["trocr_card_vs_cpu"] = trocr_card_vs_cpu(dev, launches)
    # K1's synthetic cross-tile check before 8b: 8b's profiler sessions (its
    # path checks' timings) leave later sessions missing launch records
    cascade["k1_cross_tile"] = k1_cross_tile(dev)
    cascade["full_width"] = cascade_full_width(dev, launches)
    torch.cuda.empty_cache()
    image_files = image_files_phase(dev, launches)
    recognizer_training = recognizer_training_phase(dev, launches)
    torch.cuda.empty_cache()
    train_slice_check(dev, launches)
    train = train_full_width(dev, launches)
    train["remat"] = remat_full_width(dev, launches)
    zoo = zoo_phase(dev, launches)
    heads = heads_phase(dev, launches)
    nas = nas_phase(dev, launches)
    sam = sam_phase(dev, launches)
    last = last_models_phase(dev, launches)
    export = export_phase(dev, launches)
    files = recognizer_training["image_file_training"]["detector"]
    print(f"p2x@640 b8 bf16 training: from the PNG folder (14b) {files['ms_per_step']:.3f} "
          f"ms/step, {files['images_per_s']:.2f} images/s; on synthetic tensors (10) "
          f"{train['ms_per_step']:.3f} ms/step, {train['images_per_s']:.2f} images/s")

    kernels = [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name],
             **{k: v for k, v in res[name].items()
                if k not in ("shapes", "nodes", "matmul_device_ms", "trocr_shape")})
        for name in COUNTERS
    ]
    print(json.dumps({"flash_attention_shapes": res["flash_attention"]["shapes"],
                      "area_attention_shapes": res["area_attention"]["shapes"],
                      "fused_c3k2_nodes": res["fused_c3k2"]["nodes"],
                      "fused_ablock_matmul_device_ms": res["fused_ablock"]["matmul_device_ms"],
                      "card": card}))
    print(json.dumps({"e2e_yolov12x_640_b8": e2e, "card": card}))
    print(json.dumps({"cascade_16_pages_1280": cascade, "card": card}))
    print(json.dumps({"image_files": image_files, "card": card}))
    print(json.dumps({"train_yolov12p2x_640_b8": train, "card": card}))
    print(json.dumps({"recognizer_training": recognizer_training, "card": card}, default=str))
    print(json.dumps({"yolo_zoo": zoo, "card": card}, default=str))
    print(json.dumps({"heads": heads, "card": card}, default=str))
    print(json.dumps({"nas_encoders_simple_vit": nas, "card": card}, default=str))
    print(json.dumps({"layout_options_sam": sam, "card": card}, default=str))
    print(json.dumps({"last_models_track": last, "card": card}, default=str))
    print(json.dumps({"export_tools": export, "card": card}, default=str))
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
    from kuzu_torch.ops.flash_attention import (
        FLASH_DS,
        FWD_DS,
        SMEM_LIMIT,
        attn_bwd_smem_bytes,
        attn_fwd_smem_bytes,
        f32_attn_bwd_smem_bytes,
        f32_attn_smem_bytes,
        flash_attention_smem_bytes,
    )
    from kuzu_torch.ops.fused_ablock import ablock_smem_bytes
    from kuzu_torch.ops.fused_c3k2 import COLUMN_TILES, fused_c3k2_smem_bytes
    from kuzu_torch.ops.nms_kernel import mask_words, sweep_smem_bytes

    fa = _build.library("area_attention").kuzu_area_attention_smem
    fab = _build.library("area_attention_bwd").kuzu_area_attention_bwd_smem
    fb = _build.library("fused_ablock").kuzu_fused_ablock_smem
    fa.restype = fab.restype = fb.restype = ctypes.c_size_t
    fa.argtypes = fab.argtypes = [ctypes.c_int]
    fb.argtypes = [ctypes.c_int] * 2
    fa32 = _build.library("area_attention").kuzu_area_attention_f32_smem
    fa32.restype, fa32.argtypes = ctypes.c_size_t, [ctypes.c_int]
    fab32 = _build.library("area_attention_bwd").kuzu_area_attention_bwd_f32_smem
    fab32.restype, fab32.argtypes = ctypes.c_size_t, [ctypes.c_int] * 2
    for hd in FWD_DS:
        require(fa(hd) == attn_fwd_smem_bytes(hd), f"forward attention smem hd={hd}")
        require(fa32(hd) == f32_attn_smem_bytes(hd), f"f32 attention smem hd={hd}")
        require(max(fab32(hd, 0), fab32(hd, 1)) == f32_attn_bwd_smem_bytes(hd) <= SMEM_LIMIT,
                f"f32 attention backward smem hd={hd}")
        require(fab(hd) == attn_bwd_smem_bytes(hd), f"attention backward smem hd={hd}")
    for c, h in ((384, 12), (128, 4), (64, 2), (512, 4)):
        require(fb(c, h) == ablock_smem_bytes(c, h), f"ablock smem c={c} h={h}")
    ff = _build.library("flash_attention").kuzu_flash_attention_smem
    fc = _build.library("fused_c3k2").kuzu_fused_c3k2_smem
    ff.restype = fc.restype = ctypes.c_size_t
    ff.argtypes = [ctypes.c_int] * 2
    fc.argtypes = [ctypes.c_int] * 2
    for d in FLASH_DS:
        for f32, dtype in ((0, torch.bfloat16), (1, torch.float32)):
            require(ff(d, f32) == flash_attention_smem_bytes(d, dtype),
                    f"flash attention smem d={d} f32={f32}")
    for bn in COLUMN_TILES:
        for k3 in (0, 1):
            require(fc(bn, k3) == fused_c3k2_smem_bytes(bn, bool(k3)),
                    f"fused C3k2 smem bn={bn} 3x3={k3}")
    nms = _build.library("nms")
    nw, ns = nms.kuzu_nms_mask_words, nms.kuzu_nms_sweep_smem
    nw.restype, ns.restype = ctypes.c_long, ctypes.c_size_t
    nw.argtypes = ns.argtypes = [ctypes.c_int]
    for k in (1, 64, 65, 2000, 2048, 8192, 8193, 30000):
        require(nw(k) == mask_words(k) and ns(k) == sweep_smem_bytes(k), f"NMS scratch, smem K={k}")


if __name__ == "__main__":
    sys.exit(main())
