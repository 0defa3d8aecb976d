"""Hyperparameter tuner: mutation + fitness-CSV evolution loop (a copy of
``kuzu/tools/tuner.py``, which the port may not import: numpy only, so one
seed and the same fitnesses give the same hyperparameters in both packages).

Capability parity with the reference ``Tuner``
(``yolov12/ultralytics/engine/tuner.py:33``): per-iteration it mutates the
best-so-far hyperparameters within bounded gains, runs a short training, and
appends (fitness, hyps) to ``tune_results.csv``; mutation parents are chosen
from the top-5 by fitness with weighted sampling.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Callable

import numpy as np

# (min, max, mutation gain) per tunable key — reference search space shape
DEFAULT_SPACE: dict[str, tuple[float, float, float]] = {
    "lr0": (1e-5, 1e-1, 0.5),
    "lrf": (0.01, 1.0, 0.3),
    "momentum": (0.6, 0.98, 0.3),
    "weight_decay": (0.0, 0.001, 0.3),
    "warmup_epochs": (0.0, 5.0, 0.3),
    "box": (0.02, 10.0, 0.3),
    "cls": (0.2, 4.0, 0.3),
    "dfl": (0.4, 6.0, 0.3),
    "hsv_h": (0.0, 0.1, 0.3),
    "hsv_s": (0.0, 0.9, 0.3),
    "hsv_v": (0.0, 0.9, 0.3),
    "translate": (0.0, 0.9, 0.3),
    "scale": (0.0, 0.9, 0.3),
    "fliplr": (0.0, 1.0, 0.3),
    "mosaic": (0.0, 1.0, 0.3),
}


class Tuner:
    def __init__(
        self,
        train_fn: Callable[[dict[str, float]], float],
        space: dict[str, tuple[float, float, float]] | None = None,
        save_dir: str | Path = "runs/tune",
        seed: int = 0,
    ):
        """``train_fn(hyps) -> fitness`` runs one short training."""
        self.train_fn = train_fn
        self.space = space or DEFAULT_SPACE
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.save_dir / "tune_results.csv"
        self.rng = np.random.default_rng(seed)
        self.history: list[tuple[float, dict[str, float]]] = []

    def _mutate(self, base: dict[str, float], mutation: float = 0.8, sigma: float = 0.2):
        hyps = dict(base)
        keys = list(self.space)
        # mutate until at least one gene changes (reference behavior)
        changed = False
        while not changed:
            for k in keys:
                lo, hi, gain = self.space[k]
                if self.rng.random() < mutation:
                    factor = float(
                        np.clip(self.rng.normal(1.0, sigma * gain) , 0.3, 3.0)
                    )
                    new = float(np.clip(hyps.get(k, (lo + hi) / 2) * factor, lo, hi))
                    if new != hyps.get(k):
                        changed = True
                    hyps[k] = new
        return hyps

    def _parent(self) -> dict[str, float]:
        top = sorted(self.history, key=lambda t: -t[0])[:5]
        if not top:
            return {k: (lo + hi) / 2 for k, (lo, hi, _) in self.space.items()}
        w = np.array([f for f, _ in top]) - min(f for f, _ in top) + 1e-6
        idx = self.rng.choice(len(top), p=w / w.sum())
        return dict(top[idx][1])

    def run(self, iterations: int = 10, init_hyps: dict[str, float] | None = None):
        for it in range(iterations):
            base = init_hyps if (it == 0 and init_hyps) else self._parent()
            hyps = self._mutate(base) if it > 0 else dict(base)
            fitness = float(self.train_fn(hyps))
            self.history.append((fitness, hyps))
            self._write_csv()
        best = max(self.history, key=lambda t: t[0])
        (self.save_dir / "best_hyps.yaml").write_text(
            "\n".join(f"{k}: {v}" for k, v in best[1].items())
        )
        return best

    def _write_csv(self) -> None:
        keys = sorted({k for _, h in self.history for k in h})
        with open(self.csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fitness"] + keys)
            for fit, h in self.history:
                w.writerow([fit] + [h.get(k, "") for k in keys])
