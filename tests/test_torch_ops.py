"""Parity of the port's box, anchor, image, decode and NMS ops with kuzu.ops.

Geometry is plain f32 arithmetic in the same order on both sides, so it is
compared exactly (or to 1 f32 ulp where XLA may fuse). NMS keeps, boxes,
classes and indices must be identical: to the JAX scan, to the Pallas kernel
(interpret mode) and across the port's own plain recurrence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu.ops import anchors as j_anchors
from kuzu.ops import boxes as j_boxes
from kuzu.ops import images as j_images
from kuzu.ops import nms as j_nms
from kuzu.ops.pallas_nms import LANES, pallas_suppress
from kuzu_torch.ops import anchors as t_anchors
from kuzu_torch.ops import boxes as t_boxes
from kuzu_torch.ops import images as t_images
from kuzu_torch.ops import nms as t_nms
from kuzu_torch.ops.nms_kernel import batched_suppress, suppress_reference


def _rand_xyxy(rng, shape, lo=0.0, hi=200.0, wmax=60.0):
    xy = rng.uniform(lo, hi, size=shape + (2,))
    wh = rng.uniform(1.0, wmax, size=shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_geometry_matches(rng):
    a = _rand_xyxy(rng, (37,))
    b = _rand_xyxy(rng, (29,))
    xywh = rng.uniform(0, 100, (5, 11, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        t_boxes.xywh2xyxy(torch.from_numpy(xywh)).numpy(),
        np.asarray(j_boxes.xywh2xyxy(jnp.asarray(xywh))))
    np.testing.assert_array_equal(
        t_boxes.box_area(torch.from_numpy(a)).numpy(),
        np.asarray(j_boxes.box_area(jnp.asarray(a))))
    np.testing.assert_allclose(
        t_boxes.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_boxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=2e-7, atol=0)


def test_anchors_and_dist2bbox_match(rng):
    shapes, strides = [(16, 12), (8, 6), (4, 3)], [8, 16, 32]
    tp, ts = t_anchors.make_anchors(shapes, strides)
    jp, js = j_anchors.make_anchors(shapes, strides)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    dist = rng.uniform(0, 15, (2, tp.shape[0], 4)).astype(np.float32)
    for xywh in (True, False):
        np.testing.assert_array_equal(
            t_anchors.dist2bbox(torch.from_numpy(dist), tp[None], xywh=xywh).numpy(),
            np.asarray(j_anchors.dist2bbox(jnp.asarray(dist), jp[None], xywh=xywh)))


def test_from_uint8_matches(rng):
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    t = t_images.from_uint8(torch.from_numpy(u8), dtype=torch.bfloat16)
    j = j_images.from_uint8(jnp.asarray(u8), dtype=jnp.bfloat16)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    fl = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    t = t_images.from_uint8(torch.from_numpy(fl), dtype=torch.bfloat16)
    j = j_images.from_uint8(jnp.asarray(fl), dtype=jnp.bfloat16)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_decode_matches_on_same_bf16_maps(rng):
    """DFL expectation + dist2bbox + sigmoid on identical bf16 maps. DFL runs
    in bf16 on both sides with the same rounding points, so boxes agree to
    a few bf16 ulps of the expected distance (< 16 bins) times the stride:
    atol 0.5 px; scores are f32 sigmoids of identical inputs (1e-6)."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    from kuzu_torch.models.yolo.detector import YoloDetector

    jdet = JaxDetector("yolov12n", nc=3, imgsz=128)
    tdet = YoloDetector("yolov12n", nc=3, imgsz=128, device="cpu")
    maps = [rng.normal(0, 2, (2, s, s, 67)).astype(np.float32) for s in (16, 8, 4)]
    jp = np.asarray(jdet.decode([jnp.asarray(m, jnp.bfloat16) for m in maps]))
    tp = tdet.decode([torch.from_numpy(m).to(torch.bfloat16) for m in maps]).numpy()
    assert tp.shape == jp.shape == (2, 7, 336)
    np.testing.assert_allclose(tp[:, :4], jp[:, :4], atol=0.5, rtol=0)
    np.testing.assert_allclose(tp[:, 4:], jp[:, 4:], atol=1e-6, rtol=0)
    # the expectation itself is within one bf16 rounding of the distance
    from kuzu.models.yolo.modules import dfl_expectation as j_dfl

    from kuzu_torch.models.yolo.modules import dfl_expectation as t_dfl
    d = maps[0][..., :64].reshape(2, -1, 64)
    np.testing.assert_allclose(
        t_dfl(torch.from_numpy(d).to(torch.bfloat16), 16).float().numpy(),
        np.asarray(j_dfl(jnp.asarray(d, jnp.bfloat16), 16), np.float32),
        atol=0.07, rtol=0)


# --------------------------------------------------------------------- NMS


def _cluster_boxes(rng, k):
    """The dense cluster of tests/test_pallas_nms.py:99."""
    centers = rng.uniform(50, 150, size=(4, 2))
    out = []
    for i in range(k):
        c = centers[i % 4] + rng.normal(0, 1.5, 2)
        out.append([c[0], c[1], c[0] + 30, c[1] + 30])
    return np.asarray(out, np.float32)


def _suppress_case(name, rng):
    """(boxes (B, K, 4) f32 score-sorted, valid (B, K) bool, thr)."""
    if name == "random":
        return _rand_xyxy(rng, (3, 256)), rng.uniform(size=(3, 256)) > 0.2, 0.45
    if name == "cluster":
        return _cluster_boxes(rng, 128)[None], np.ones((1, 128), bool), 0.5
    if name == "all_invalid":
        return _rand_xyxy(rng, (2, 128)), np.zeros((2, 128), bool), 0.45
    if name == "ragged_k":  # K not a multiple of 128 (and not of 64)
        return _rand_xyxy(rng, (2, 200), wmax=90.0), np.ones((2, 200), bool), 0.3
    raise ValueError(name)


@pytest.mark.parametrize("case", ["random", "cluster", "all_invalid", "ragged_k"])
def test_suppress_matches_scan_and_pallas(case, rng):
    boxes, valid, thr = _suppress_case(case, rng)
    ref_scan = np.asarray(j_nms.batched_suppress(jnp.asarray(boxes), jnp.asarray(valid), thr))
    k = boxes.shape[1]
    pad = (-k) % LANES  # the Pallas kernel needs K % 128 == 0; the port does not
    pb = np.pad(boxes, ((0, 0), (0, pad), (0, 0)))
    pv = np.pad(valid, ((0, 0), (0, pad)))
    ref_pallas = np.asarray(
        pallas_suppress(jnp.asarray(pb), jnp.asarray(pv), thr, interpret=True))[:, :k]
    before = batched_suppress.plain_calls
    keep = batched_suppress(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    assert batched_suppress.plain_calls == before + 1
    np.testing.assert_array_equal(keep, ref_scan)
    np.testing.assert_array_equal(keep, ref_pallas)
    if case == "cluster":
        assert 3 <= keep.sum() <= 8 and keep[0, 0]
    if case == "all_invalid":
        assert not keep.any()


def test_suppress_reference_is_the_greedy_rule(rng):
    """Brute-force greedy loop in numpy over the same f32 IoU expression."""
    boxes, valid, thr = _suppress_case("random", rng)
    keep = suppress_reference(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    for b in range(boxes.shape[0]):
        x1, y1, x2, y2 = boxes[b].T
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        kept = []
        for j in range(boxes.shape[1]):
            ok = bool(valid[b, j])
            for i in kept:
                iw = max(min(x2[i], x2[j]) - max(x1[i], x1[j]), np.float32(0))
                ih = max(min(y2[i], y2[j]) - max(y1[i], y1[j]), np.float32(0))
                inter = np.float32(iw) * np.float32(ih)
                iou = inter / (area[i] + area[j] - inter + np.float32(1e-7))
                if iou > np.float32(thr):
                    ok = False
                    break
            if ok:
                kept.append(j)
        expect = np.zeros(boxes.shape[1], bool)
        expect[kept] = True
        np.testing.assert_array_equal(keep[b], expect)


def _nms_inputs(case, rng):
    """(boxes, scores, classes, valid) numpy inputs for nms_padded_batch."""
    b, n = 2, 300
    boxes = _rand_xyxy(rng, (b, n), wmax=80.0)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    classes = np.zeros((b, n), np.int32)
    valid = np.ones((b, n), bool)
    if case == "tied":  # bf16 sigmoid scores tie in thousands
        scores = np.round(scores * 8) / 8
    elif case == "multiclass":
        classes = rng.integers(0, 4, (b, n)).astype(np.int32)
    elif case == "cluster":
        boxes = np.stack([_cluster_boxes(rng, n) for _ in range(b)])
    elif case == "all_invalid":
        valid[:] = False
    elif case == "few_candidates":  # k < max_det: padded outputs
        n = 40
        boxes, scores, classes, valid = boxes[:, :n], scores[:, :n], classes[:, :n], valid[:, :n]
        valid[:, ::3] = False
    return boxes, scores, classes, valid


NMS_CASES = ["random", "tied", "multiclass", "cluster", "all_invalid", "few_candidates"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_padded_batch_matches(case, rng):
    inp = _nms_inputs(case, rng)
    kw = dict(iou_threshold=0.45, score_threshold=0.05, max_det=100, max_nms=256,
              return_indices=True)
    ref = j_nms.nms_padded_batch(*(jnp.asarray(a) for a in inp), **kw)
    out = t_nms.nms_padded_batch(*(torch.from_numpy(a) for a in inp), **kw)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if case == "all_invalid":
        assert not out[3].any()


@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("nc", [1, 4])
def test_non_max_suppression_matches(nc, multi_label, rng):
    b, a = 2, 500
    xywh = np.concatenate([rng.uniform(0, 256, (b, a, 2)), rng.uniform(4, 64, (b, a, 2))], -1)
    scores = np.round(rng.uniform(0, 1, (b, a, nc)) * 64) / 64  # many ties
    pred = np.concatenate([xywh, scores], -1).transpose(0, 2, 1).astype(np.float32)
    kw = dict(conf_thres=0.1, iou_thres=0.5, max_det=300, max_nms=384,
              multi_label=multi_label, return_indices=True)
    ref = j_nms.non_max_suppression(jnp.asarray(pred), **kw)
    out = t_nms.non_max_suppression(torch.from_numpy(pred), **kw)
    assert set(ref) == set(out)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
