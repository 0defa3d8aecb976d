"""The algorithm of the NMS kernel (``kuzu_torch/csrc/nms.cu``) on the CPU,
where the kernel cannot run: a numpy model of its two launches, the pair
rule packed into the kernel's triangular word layout and the chunked sweep
(the serial part on each chunk's diagonal words, then the OR pass of the kept
rows over the later words), must give exactly the keeps of the plain
recurrence ``suppress_reference`` and of the JAX scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu.ops import nms as j_nms
from kuzu_torch.ops.nms_kernel import (
    SWEEP_CAP,
    WORD,
    mask_words,
    suppress_reference,
    sweep_smem_bytes,
)
from test_torch_ops import _cluster_boxes, _rand_xyxy, _suppress_case


def _tri(c: int, w: int) -> int:
    return c * w - c * (c - 1) // 2


def pair_words(boxes: np.ndarray, valid: np.ndarray, thr: float) -> np.ndarray:
    """The mask kernel's output for one image: bit jj of word (c, w, r) is
    pair (64 c + r, 64 w + jj) over the threshold, for w >= c, laid out
    chunk by chunk, word-major, 64 rows per word."""
    k = boxes.shape[0]
    w = -(-k // WORD)
    t = torch.from_numpy(boxes)
    x1, y1, x2, y2 = t.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    iou = inter / (area[:, None] + area[None] - inter + 1e-7)
    v = torch.from_numpy(valid)
    over = ((iou > thr) & v[:, None] & v[None]).numpy() & np.triu(np.ones((k, k), bool), 1)
    full = np.zeros((w * WORD, w * WORD), bool)
    full[:k, :k] = over
    bits = (full.reshape(w, WORD, w, WORD).astype(np.uint64)
            << np.arange(WORD, dtype=np.uint64)).sum(-1, dtype=np.uint64)  # (c, r, w)
    words = np.zeros(mask_words(k), np.uint64)
    for c in range(w):
        for col in range(c, w):
            start = WORD * (_tri(c, w) + col - c)
            words[start:start + WORD] = bits[c, :, col]
    return words


def sweep_model(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The sweep kernel, chunk by chunk, on Python integers."""
    k = valid.shape[0]
    w = -(-k // WORD)
    vpad = np.zeros(w * WORD, bool)
    vpad[:k] = valid
    vwords = [int(sum(1 << r for r in range(WORD) if vpad[c * WORD + r])) for c in range(w)]
    removed = [0] * w
    keep = np.zeros(w * WORD, bool)
    full = (1 << WORD) - 1
    for c in range(w):
        base = WORD * _tri(c, w)
        diag = [int(d) for d in words[base:base + WORD]]
        # the serial part on the diagonal words, as the kernel runs it: invalid
        # rows start removed, rows 0..31 on the low half, their high halves
        # ORed in after, rows 32..63 on the high half; kept = bits still clear
        start = (removed[c] | ~vwords[c]) & full
        lo, hi = start & 0xFFFFFFFF, start >> 32
        for r in range(32):
            if not (lo >> r) & 1:
                lo |= diag[r] & 0xFFFFFFFF
        for r in range(32):
            if not (lo >> r) & 1:
                hi |= diag[r] >> 32
        for r in range(32, WORD):
            if not (hi >> (r - 32)) & 1:
                hi |= diag[r] >> 32
        kept = ~((hi << 32) | lo) & full
        keep[c * WORD:(c + 1) * WORD] = [(kept >> r) & 1 for r in range(WORD)]
        for j in range(1, w - c):  # the OR pass over the later words
            col = words[base + WORD * j:base + WORD * (j + 1)]
            for r in range(WORD):
                if (kept >> r) & 1:
                    removed[c + j] |= int(col[r])
    return keep[:k]


def _chain(k: int = 200):
    """Box r + 1 overlaps box r above the threshold, box r + 2 does not: the
    keeps alternate, and a sweep that ORed in rows that were not kept would
    lose every other keep. 200 boxes cross three chunk boundaries."""
    x = np.arange(k, dtype=np.float32)[:, None] * 4.0
    boxes = np.concatenate([x, np.zeros_like(x), x + 10.0, np.full_like(x, 10.0)], -1)
    return boxes[None], np.ones((1, k), bool), 0.3


def _disjoint(k: int = 256):
    x = np.arange(k, dtype=np.float32)[:, None] * 20.0
    boxes = np.concatenate([x, np.zeros_like(x), x + 10.0, np.full_like(x, 10.0)], -1)
    return boxes[None], np.ones((1, k), bool), 0.45


CASES = ["random", "cluster", "all_invalid", "ragged_k", "chain", "disjoint", "k65", "k128",
         "dense"]


def _case(name, rng):
    if name == "chain":
        return _chain()
    if name == "disjoint":
        return _disjoint()
    if name in ("k65", "k128"):
        k = int(name[1:])
        return _rand_xyxy(rng, (2, k), wmax=90.0), rng.uniform(size=(2, k)) > 0.1, 0.3
    if name == "dense":  # one cluster: almost every box suppressed
        return _cluster_boxes(rng, 300)[None], np.ones((1, 300), bool), 0.3
    return _suppress_case(name, rng)


@pytest.mark.parametrize("case", CASES)
def test_chunked_sweep_model_equals_reference(case, rng):
    boxes, valid, thr = _case(case, rng)
    ref = suppress_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    if case not in ("random", "cluster", "all_invalid", "ragged_k"):
        # the new cases against the JAX scan too (tests/test_torch_ops.py
        # holds the others there)
        scan = np.asarray(j_nms.batched_suppress(jnp.asarray(boxes), jnp.asarray(valid), thr))
        np.testing.assert_array_equal(ref, scan)
    got = np.stack([sweep_model(pair_words(boxes[b], valid[b], thr), valid[b])
                    for b in range(boxes.shape[0])])
    np.testing.assert_array_equal(got, ref)
    if case == "chain":
        assert (ref[0] == (np.arange(200) % 2 == 0)).all()
    if case == "disjoint":
        assert ref.all()
    if case == "dense":
        assert ref.sum() <= 8


@pytest.mark.parametrize("k,words,smem", [
    (2048, 64 * 32 * 33 // 2, 2 * 32 * 512 + 2 * 32 * 8),   # the main path's K
    (65, 64 * 3, 2 * 2 * 512 + 2 * 2 * 8),                  # two words, one ragged
    (64 * 200, 64 * 200 * 201 // 2, 2 * SWEEP_CAP * 512 + 2 * 200 * 8),  # past the window
])
def test_mask_layout_sizes(k, words, smem):
    assert mask_words(k) == words
    assert sweep_smem_bytes(k) == smem

