"""Comparison rules and the synthetic dataset shared by the parity tests and
``chip_smoke.py``.

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


class SyntheticDetectionDataset:
    """Seeded synthetic character pages, to the ``Dataset`` protocol of
    ``kuzu_torch.data.loader``: glyph-like dark rectangles of 8-40 px on a
    light page, 100-300 per 640x640 image (scaled by area at other sizes, at
    least one), so the assigner sees a character page's number of GTs.

    Sample ``i`` is drawn from ``seed`` and ``i`` alone: ``image`` uint8
    (imgsz, imgsz, 3), ``gt_boxes`` (max_boxes, 4) xyxy px, ``gt_labels``
    (max_boxes,) int32 and ``mask_gt`` (max_boxes,) bool, zero-padded."""

    def __init__(self, n: int, imgsz: int = 640, max_boxes: int = 400, nc: int = 1,
                 seed: int = 0, boxes: tuple[int, int] = (100, 300),
                 size: tuple[int, int] = (8, 40)):
        self.n, self.imgsz, self.max_boxes, self.nc, self.seed = n, imgsz, max_boxes, nc, seed
        frac = (imgsz / 640) ** 2
        self.boxes = (max(1, round(boxes[0] * frac)), max(1, round(boxes[1] * frac)))
        self.size = (size[0], min(size[1], imgsz // 2))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        s = self.imgsz
        img = rng.integers(215, 250, (s, s, 3), dtype=np.uint8)  # paper and grain
        k = min(int(rng.integers(self.boxes[0], self.boxes[1] + 1)), self.max_boxes)
        wh = rng.integers(self.size[0], self.size[1] + 1, (k, 2))
        x1 = (rng.random(k) * (s - wh[:, 0])).astype(np.int64)
        y1 = (rng.random(k) * (s - wh[:, 1])).astype(np.int64)
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros((self.max_boxes,), np.int32)
        mask = np.zeros((self.max_boxes,), bool)
        for j in range(k):
            x, y, w, h = x1[j], y1[j], wh[j, 0], wh[j, 1]
            img[y:y + h, x:x + w] = rng.integers(10, 90)  # ink
            boxes[j] = (x, y, x + w, y + h)
        labels[:k] = rng.integers(0, self.nc, k)
        mask[:k] = True
        return {"image": img, "gt_boxes": boxes, "gt_labels": labels, "mask_gt": mask}


# Attention in bf16 (K3, K5): both sides are f32 arithmetic rounded once to
# bf16, but the kernel sums in another order, runs an online softmax over
# 64-key tiles and feeds P to the tensor cores as one bf16 part, so a sum on
# a rounding edge flips an ulp: two ulps of the largest output plus one of
# the value. At N=400 the outputs are ~0.05 in size, so an absolute 1e-2
# would let a kernel that skips its last key tile pass; this does not.
ATTN_TOL = "2^-7 max|ref| + 2^-8|ref|"


def attention_over(out, ref) -> tuple[float, int, int]:
    """(max abs error, entries over ``ATTN_TOL``, entries) of ``out``
    against ``ref`` (torch tensors of one shape)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    tol = 2.0**-7 * float(r.abs().max()) + 2.0**-8 * r.abs()
    return float(err.max()), int((err > tol).sum()), err.numel()


def attention_exact(q, k, v, num_heads: int, scale: float, p_bf16: bool = False):
    """softmax(scale q_h k_h^T) v_h over head-packed (G, N, C) tensors in f32
    with one maximum over all keys, rounded once to q's dtype: the function
    both kernels compute. ``p_bf16`` rounds P to bf16 before P V (reported
    beside the tolerance, not a fault: it is what the kernel does)."""
    import torch

    g, n, c = q.shape
    hd = c // num_heads
    outs = []
    for i in range(0, g, 4):  # 4 groups at a time: N x N in f32

        def heads(t):
            return t[i:i + 4].float().reshape(-1, t.shape[1], num_heads, hd).transpose(1, 2)

        s = (heads(q) * scale) @ heads(k).transpose(-1, -2)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        o = (pv @ heads(v)) / p.sum(-1, keepdim=True)
        outs.append(o.transpose(1, 2).reshape(-1, n, c))
    return torch.cat(outs).to(q.dtype)


def attention_faults(q, k, v, num_heads: int, keys: int = 64) -> dict:
    """Outputs of kernels with a fault, each computed exactly (f32, rounded
    once to q's dtype) on the inputs of a check, keyed by the fault; each
    must exceed ``ATTN_TOL`` against the sound output:

    - the last key tile (``keys`` keys, or the ragged rest of N) skipped;
    - each head's columns read one head over (the last head wraps to the
      first; only where there is more than one head);
    - the scale of a head padded to the TPU's 128 lanes, 128^-1/2, in place
      of hd^-1/2 (where hd < 128)."""
    import torch

    n, c = q.shape[1], q.shape[2]
    hd = c // num_heads
    scale = hd**-0.5
    last = (n - 1) // keys * keys  # first key of the last tile
    out = {"last key tile skipped": attention_exact(q, k[:, :last], v[:, :last], num_heads,
                                                    scale)}
    if num_heads > 1:
        def shift(t):
            return torch.roll(t, -hd, dims=-1)

        # head h's output columns hold head h + 1's attention
        out["head columns read one head over"] = attention_exact(shift(q), shift(k), shift(v),
                                                                 num_heads, scale)
    if hd < 128:
        out["padded scale 128^-1/2"] = attention_exact(q, k, v, num_heads, 128**-0.5)
    return out
