"""Region and video analytics on top of predict / track results (a copy of
``kuzu/solutions/solutions.py``, which the port may not import): line
in / out counting, per-region counts, a zone filter, speeds, queue lengths,
a detection heat map and per-frame class counts. Each solution is a small
stateful consumer of per-frame ``Results`` (from ``Model.predict`` or
``Model.track``); they compose freely in one loop.

Host numpy, but for the heat map: box footprints are separable in y and
x, so a frame's accumulation is one ``(H, N) @ (N, W)`` product, which
:func:`heatmap_accumulate` runs on the device the caller names (the card
when None) with TF32 off, and returns as numpy. ``Heatmap.render`` draws
with cv2's colour map and raises an ImportError naming cv2 where OpenCV is
not installed.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from kuzu_torch.data.loader import next_bucket
from kuzu_torch.models.layers import f32_products
from kuzu_torch.models.yolo.detector import resolve_device

__all__ = [
    "Region",
    "RegionCounter",
    "ObjectCounter",
    "SpeedEstimator",
    "QueueManager",
    "TrackZone",
    "Heatmap",
    "Analytics",
]


# ------------------------------------------------------------------ regions


class Region:
    """Closed polygon with a vectorized point-in-polygon test (ray casting).

    The reference uses ``shapely`` (``object_counter.py:45``); a 10-line
    numpy ray cast avoids the dependency and tests identically.
    """

    def __init__(self, points) -> None:
        self.points = np.asarray(points, np.float32).reshape(-1, 2)
        if len(self.points) < 3:
            raise ValueError("a region needs >= 3 vertices")

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """(M, 2) points -> (M,) bool."""
        pts = np.asarray(pts, np.float32).reshape(-1, 2)
        x, y = pts[:, 0:1], pts[:, 1:2]  # (M,1)
        v0 = self.points  # (V,2)
        v1 = np.roll(v0, -1, axis=0)
        # edge straddles the horizontal ray?
        straddle = (v0[None, :, 1] > y) != (v1[None, :, 1] > y)  # (M,V)
        dy = v1[None, :, 1] - v0[None, :, 1]
        t = np.where(dy != 0, (y - v0[None, :, 1]) / np.where(dy == 0, 1, dy), 0)
        x_cross = v0[None, :, 0] + t * (v1[None, :, 0] - v0[None, :, 0])
        hits = straddle & (x_cross > x)
        return (hits.sum(axis=1) % 2).astype(bool)


def _centers(result) -> np.ndarray:
    b = result.boxes.xyxy
    return (b[:, :2] + b[:, 2:]) / 2 if len(b) else np.zeros((0, 2), np.float32)


class RegionCounter:
    """Per-frame object counts inside named polygonal regions
    (reference ``region_counter.py``)."""

    def __init__(self, regions: dict[str, list]) -> None:
        self.regions = {k: Region(v) for k, v in regions.items()}
        self.counts: dict[str, int] = {k: 0 for k in regions}

    def update(self, result) -> dict[str, int]:
        pts = _centers(result)
        self.counts = {
            name: int(reg.contains(pts).sum()) for name, reg in self.regions.items()
        }
        return self.counts


class TrackZone:
    """Restrict results to a polygonal zone (reference ``trackzone.py``):
    detections whose center falls outside are dropped before counting or
    display."""

    def __init__(self, region) -> None:
        self.region = Region(region)

    def __call__(self, result):
        import copy

        keep = self.region.contains(_centers(result))
        out = copy.copy(result)
        out.boxes = result.boxes[keep]
        return out


# ----------------------------------------------------------------- counting


def _side(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sign of point p relative to directed line a->b."""
    return np.sign(
        (b[0] - a[0]) * (p[:, 1] - a[1]) - (b[1] - a[1]) * (p[:, 0] - a[0])
    )


@dataclass
class ObjectCounter:
    """Line-crossing in/out counter over tracked results (reference
    ``object_counter.py``). Needs ``Model.track`` results: crossing is
    detected per track id as a sign change of the center against the
    directed counting line; ``in`` is a negative->positive crossing."""

    line: tuple = ((0, 0), (0, 100))
    in_count: int = 0
    out_count: int = 0
    classwise: dict = field(default_factory=lambda: defaultdict(lambda: [0, 0]))
    _last_side: dict = field(default_factory=dict)

    def update(self, result) -> tuple[int, int]:
        ids = result.boxes.id
        if ids is None:
            raise ValueError("ObjectCounter needs tracked results (Model.track)")
        pts = _centers(result)
        a = np.asarray(self.line[0], np.float32)
        b = np.asarray(self.line[1], np.float32)
        sides = _side(pts, a, b)
        for tid, cls, s in zip(ids, result.boxes.cls, sides):
            prev = self._last_side.get(int(tid))
            if prev is not None and s != 0 and prev != 0 and s != prev:
                if s > 0:
                    self.in_count += 1
                    self.classwise[int(cls)][0] += 1
                else:
                    self.out_count += 1
                    self.classwise[int(cls)][1] += 1
            if s != 0:
                self._last_side[int(tid)] = s
        return self.in_count, self.out_count


@dataclass
class SpeedEstimator:
    """Per-track speed from center displacement between consecutive frames
    (reference ``speed_estimation.py``). ``px_per_unit`` calibrates pixels
    to meters; speeds come back in units/s given ``fps``."""

    fps: float = 30.0
    px_per_unit: float = 1.0
    speeds: dict = field(default_factory=dict)
    _last: dict = field(default_factory=dict)

    def update(self, result) -> dict[int, float]:
        ids = result.boxes.id
        if ids is None:
            raise ValueError("SpeedEstimator needs tracked results (Model.track)")
        pts = _centers(result)
        out = {}
        for tid, p in zip(ids, pts):
            tid = int(tid)
            if tid in self._last:
                d = float(np.linalg.norm(p - self._last[tid]))
                out[tid] = d * self.fps / self.px_per_unit
            self._last[tid] = p
        self.speeds.update(out)
        return out


class QueueManager:
    """Queue length inside a region: tracks that have stayed inside for at
    least ``min_frames`` consecutive frames (reference
    ``queue_management.py``)."""

    def __init__(self, region, min_frames: int = 2) -> None:
        self.region = Region(region)
        self.min_frames = int(min_frames)
        self._streak: dict[int, int] = defaultdict(int)
        self.queue_len = 0

    def update(self, result) -> int:
        ids = result.boxes.id
        if ids is None:
            raise ValueError("QueueManager needs tracked results (Model.track)")
        inside = self.region.contains(_centers(result))
        seen = set()
        for tid, ins in zip(ids, inside):
            tid = int(tid)
            seen.add(tid)
            self._streak[tid] = self._streak[tid] + 1 if ins else 0
        for tid in list(self._streak):
            if tid not in seen:
                self._streak[tid] = 0
        self.queue_len = sum(v >= self.min_frames for v in self._streak.values())
        return self.queue_len


# ------------------------------------------------------------------ heatmap


def heatmap_accumulate(boxes: np.ndarray, weights: np.ndarray, shape: tuple[int, int],
                       device: torch.device | str | None = None) -> np.ndarray:
    """Accumulate (N, 4) xyxy boxes into an (H, W) float32 heat map on
    ``device`` (the card when None).

    Footprints are separable Gaussians (sigma ~ box extent), so the whole
    frame is ``(H, N) @ (N, W)``, one product for any N. Zero-weighted
    rows (padding) add nothing."""
    dev = resolve_device(device)
    h, w = int(shape[0]), int(shape[1])
    boxes = torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)
    weights = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :]  # (1, H)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]  # (1, W)
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    cy, sy = (y1 + y2) / 2, torch.clamp(y2 - y1, min=1.0) * 0.3
    cx, sx = (x1 + x2) / 2, torch.clamp(x2 - x1, min=1.0) * 0.3
    uy, ux = (ys - cy) / sy, (xs - cx) / sx
    gy = torch.exp(-0.5 * (uy * uy))  # (N, H)
    gx = torch.exp(-0.5 * (ux * ux))  # (N, W)
    with f32_products():
        heat = torch.einsum("nh,nw->hw", gy * weights[:, None], gx)
    return heat.cpu().numpy()


class Heatmap:
    """Cross-frame detection-density heat map (reference ``heatmap.py``).

    ``update`` folds a frame's boxes in (:func:`heatmap_accumulate` on
    ``device``, box counts padded to power-of-2 buckets as JAX's are);
    ``render`` overlays the normalized map on a frame with cv2's colour map.
    """

    def __init__(self, shape: tuple[int, int], device: torch.device | str | None = None) -> None:
        self.shape = (int(shape[0]), int(shape[1]))
        self.device = resolve_device(device)
        self.heat = np.zeros(self.shape, np.float32)

    def update(self, result) -> np.ndarray:
        b = result.boxes.xyxy
        n = len(b)
        if n:
            nb = next_bucket(n)
            boxes = np.zeros((nb, 4), np.float32)
            boxes[:n] = b
            wts = np.zeros(nb, np.float32)
            wts[:n] = result.boxes.conf if len(result.boxes.conf) else 1.0
            self.heat += heatmap_accumulate(boxes, wts, self.shape, self.device)
        return self.heat

    def render(self, frame: np.ndarray, alpha: float = 0.5) -> np.ndarray:
        try:
            import cv2
        except ImportError as e:
            raise ImportError("Heatmap.render draws with OpenCV (cv2), which is not installed; "
                              "the map itself is Heatmap.heat") from e

        h = self.heat / max(float(self.heat.max()), 1e-6)
        cmap = cv2.applyColorMap((h * 255).astype(np.uint8), cv2.COLORMAP_JET)
        if frame.shape[:2] != self.shape:
            cmap = cv2.resize(cmap, (frame.shape[1], frame.shape[0]))
        return cv2.addWeighted(frame, 1 - alpha, cmap, alpha, 0)


# ---------------------------------------------------------------- analytics


class Analytics:
    """Per-frame class-count time series + CSV export (reference
    ``analytics.py`` line/bar modes, minus the matplotlib window)."""

    def __init__(self, names: dict[int, str] | None = None) -> None:
        self.names = names or {}
        self.rows: list[dict[str, int]] = []

    def update(self, result) -> dict[str, int]:
        counts: dict[str, int] = defaultdict(int)
        for c in result.boxes.cls:
            counts[self.names.get(int(c), str(int(c)))] += 1
        self.rows.append(dict(counts))
        return self.rows[-1]

    def to_csv(self, path) -> None:
        keys = sorted({k for r in self.rows for k in r})
        lines = ["frame," + ",".join(keys)]
        for i, r in enumerate(self.rows):
            lines.append(f"{i}," + ",".join(str(r.get(k, 0)) for k in keys))
        from pathlib import Path

        Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
