"""Event/callback system + training observability (a copy of
``kuzu/core/callbacks.py``, which the port may not import).

Parity with the engine's callback registry
(``yolov12/ultralytics/utils/callbacks/base.py:146-178`` event list, W&B/TB
integrations) and the reference's results.csv metric persistence
(``engine/trainer.py:658-665``).
"""

from __future__ import annotations

import csv
import logging
import sys
import time
from pathlib import Path
from typing import Any, Callable

LOGGER = logging.getLogger("kuzu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(logging.INFO)
    LOGGER.propagate = False  # root handlers would double-print

EVENTS = (
    "on_train_start",
    "on_epoch_start",
    "on_step_end",
    "on_epoch_end",
    "on_val_start",
    "on_val_end",
    "on_checkpoint_save",
    "on_train_end",
    "on_predict_start",
    "on_predict_end",
)


class CallbackRegistry:
    def __init__(self) -> None:
        self._hooks: dict[str, list[Callable]] = {e: [] for e in EVENTS}

    def add(self, event: str, fn: Callable) -> None:
        if event not in self._hooks:
            raise KeyError(f"unknown event '{event}' (valid: {EVENTS})")
        self._hooks[event].append(fn)

    def run(self, event: str, *args: Any, **kwargs: Any) -> None:
        for fn in self._hooks.get(event, []):
            fn(*args, **kwargs)


class CSVLogger:
    """results.csv writer — one row per epoch, union of metric keys."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys: list[str] | None = None

    def log(self, row: dict[str, Any]) -> None:
        row = {k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()}
        if self._keys is None:
            self._keys = list(row)
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._keys)
                w.writeheader()
                w.writerow(row)
        else:
            for k in row:
                if k not in self._keys:  # schema drift: rewrite header
                    self._rewrite_with(list(row))
                    break
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore").writerow(row)

    def _rewrite_with(self, keys: list[str]) -> None:
        old_rows = []
        if self.path.exists():
            with open(self.path) as f:
                old_rows = list(csv.DictReader(f))
        merged = list(dict.fromkeys((self._keys or []) + keys))
        self._keys = merged
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=merged)
            w.writeheader()
            for r in old_rows:
                w.writerow(r)


class EarlyStopping:
    """Patience-based stop on a fitness scalar (reference
    ``utils/torch_utils.py:713``). All hosts compute the same decision from
    replicated metrics — no broadcast needed."""

    def __init__(self, patience: int = 50):
        self.patience = patience if patience and patience > 0 else float("inf")
        self.best_fitness = -float("inf")
        self.best_epoch = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


class Timer:
    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
