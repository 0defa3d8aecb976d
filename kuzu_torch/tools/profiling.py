"""Profiling: timing, FLOPs accounting, device trace capture (counterpart of
``kuzu/tools/profiling.py``).

``timed`` times a call with CUDA events on the card (after warm-up calls)
and with ``time.perf_counter`` on the CPU; ``flops_of`` counts a call's
floating-point operations with ``torch.utils.flop_counter``; ``trace``
records a ``torch.profiler`` trace; ``StageTimer`` is a copy of JAX's.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode



def flops_of(fn: Callable, *args: Any) -> float:
    """Floating-point operations of one call ``fn(*args)``, counted by
    ``FlopCounterMode``: matrix products and convolutions only (two a
    multiply-add), and each ``kuzu_torch::`` operator by its own formula
    (``ops/registry.py``), so the count is the same whichever implementation
    of it runs and the plain version's products are not counted again.
    Unlike XLA's ``cost_analysis`` (JAX's ``flops_of``), elementwise ops,
    reductions and the softmax count nothing."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())


def _device(args) -> torch.device:
    for leaf in tree_leaves(args):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return torch.device("cpu")


def timed(fn: Callable, *args: Any, reps: int = 5, warmup: int = 2) -> dict[str, float]:
    """Time ``fn(*args)`` without gradients: ``warmup`` untimed calls, then
    ``reps`` timed ones, each between two CUDA events where an argument
    lies on the card, else by ``time.perf_counter``. Returns JAX's keys:
    ``median_ms``, ``min_ms``, ``tflops`` (of :func:`flops_of`'s count)
    and ``flops``."""
    device = _device(args)
    ts = []
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
        else:
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(*args)
                ts.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ts))
    fl = flops_of(fn, *args)
    return {
        "median_ms": med,
        "min_ms": float(min(ts)),
        "tflops": fl / (med * 1e-3) / 1e12 if med > 0 else 0.0,
        "flops": fl,
    }


def model_info(model: torch.nn.Module, *args: Any) -> dict[str, float]:
    """Parameter count and GFLOPs of ``model(*args)`` (reference
    ``model_info``)."""
    n_params = sum(p.numel() for p in model.parameters())
    return {"params": n_params, "gflops": flops_of(model, *args) / 1e9}


@contextlib.contextmanager
def trace(log_dir: str | Path = "runs/profile"):
    """Record a ``torch.profiler`` trace (the card's kernels too where there
    is one) and write it as ``<log_dir>/trace.json`` (Chrome trace format);
    yields the profiler, whose ``key_averages()`` read the same run."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StageTimer:
    """Per-stage wall timing for pipelines (cascade pre/detect/recognize/post
    — the reference's Results speed fields)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, float]:
        return {
            k: 1e3 * self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }
