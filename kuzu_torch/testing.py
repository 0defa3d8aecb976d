"""Comparison rules shared by the parity tests and ``chip_smoke.py``.

Two runs of the detector that differ only in where bf16 rounds (the JAX
package against the port, or the card against the CPU) are held to these
rules; each function returns the numbers it decides on, so the caller can
print them beside their limits.
"""

from __future__ import annotations

import numpy as np


def f32(x) -> np.ndarray:
    """A torch tensor or array-like as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# Raw maps: the criteria of tests/test_yolo_infer.py:35-40. bf16 rounding and
# reassociation allow 5% relative error (relative to max(|ref|, 1)) on every
# entry and agreement within 5% on 99.9% of them.
MAP_MAX_REL = 0.05
MAP_CLOSE_SHARE = 0.999


def maps_agreement(ref, out) -> tuple[float, float]:
    """(max relative error, share of entries within atol=rtol=0.05)."""
    r, o = f32(ref), f32(out)
    if r.shape != o.shape:
        raise ValueError(f"shapes differ: {r.shape} vs {o.shape}")
    rel = float((np.abs(r - o) / np.maximum(np.abs(r), 1.0)).max())
    return rel, float(np.isclose(r, o, atol=0.05, rtol=0.05).mean())


def maps_match(ref, out) -> bool:
    rel, share = maps_agreement(ref, out)
    return rel < MAP_MAX_REL and share > MAP_CLOSE_SHARE


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def detections_match(ref: dict, out: dict, min_iou: float = 0.5) -> float:
    """Share of ``ref``'s valid detections that have a detection of the same
    class with IoU >= ``min_iou`` in ``out`` (padded NMS outputs).

    Maps that differ by bf16 rounding can swap which of two overlapping
    near-equal boxes survives NMS, so detections are not compared exactly;
    such a swap still leaves a same-class match above 0.5 IoU."""
    hit = total = 0
    for b in range(f32(ref["valid"]).shape[0]):
        rv, ov = f32(ref["valid"][b]) > 0, f32(out["valid"][b]) > 0
        rb, ob = f32(ref["boxes"][b])[rv], f32(out["boxes"][b])[ov]
        rc, oc = f32(ref["classes"][b])[rv], f32(out["classes"][b])[ov]
        if len(rb) and len(ob):
            iou = _iou(rb, ob) * (rc[:, None] == oc[None, :])
            hit += int((iou.max(1) >= min_iou).sum())
        total += len(rb)
    return hit / max(total, 1)
