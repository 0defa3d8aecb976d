"""The port's trackers and ``Model.track`` against the JAX package's on the
CPU. The trackers are host numpy in both packages, so they are held equal
exactly: the Kalman filter, ByteTrack on ``tests/test_tracker.py``'s
sequences (consistent ids, the low-confidence rescue, lost and removed
tracks) and on a longer seeded one (objects that appear, vanish and drop
below the high threshold), and GMC / BoT-SORT on a panning texture (cv2 is
installed here). Without cv2 the port's BoT-SORT raises naming cv2.

``Model.track`` through a stub predictor (as ``tests/test_tracker.py``'s
facade test) and over a seeded yolov12n at 64 px with ``box_head``'s
biases (the JAX side runs the port's bf16 executor with Pallas
interpreted, so the detections agree to 1e-3 px): the ids equal, the
boxes within 1e-3 px, every ``Results`` carrying ids.
"""

import sys

import numpy as np
import pytest
import torch

from kuzu_torch.testing import box_head


def _tracks(tracks) -> list[tuple]:
    return [(t.track_id, t.state, t.cls, t.score, t.frames_lost, t.hits, tuple(t.box))
            for t in tracks]


def _both(cls_name: str, **kw):
    import kuzu.pipeline.tracker as jt

    import kuzu_torch.pipeline.tracker as pt

    return getattr(jt, cls_name)(**kw), getattr(pt, cls_name)(**kw)


def test_kalman_filter_matches_jax():
    from kuzu.pipeline.tracker import KalmanFilterCXCYAH as J
    from kuzu.pipeline.tracker import cxcyah_to_xyxy as j_back
    from kuzu.pipeline.tracker import xyxy_to_cxcyah as j_state

    from kuzu_torch.pipeline.tracker import KalmanFilterCXCYAH, cxcyah_to_xyxy, xyxy_to_cxcyah

    kj, kp = J(), KalmanFilterCXCYAH()
    a, b = kj.initiate(np.array([10.0, 10, 1.0, 20])), kp.initiate(np.array([10.0, 10, 1.0, 20]))
    for t in range(1, 6):
        a, b = kj.predict(*a), kp.predict(*b)
        meas = np.array([10.0 + 5 * t, 10, 1.0, 20])
        a, b = kj.update(*a, meas), kp.update(*b, meas)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert 3.0 < b[0][4] < 6.0
    box = np.array([3.0, 4.0, 30.0, 50.0])
    np.testing.assert_array_equal(xyxy_to_cxcyah(box), j_state(box))
    np.testing.assert_array_equal(cxcyah_to_xyxy(xyxy_to_cxcyah(box)), j_back(j_state(box)))


def _run(tracker, frames) -> list:
    return [_tracks(tracker.update(*f)) for f in frames]


def _consistent_frames():
    out = []
    for t in range(10):
        boxes = np.array([[10 + 4 * t, 10, 40 + 4 * t, 50], [200, 200 + 3 * t, 240, 260 + 3 * t]],
                         np.float32)
        out.append((boxes, np.array([0.9, 0.8]), np.array([0, 1])))
    return out


def _seeded_frames(n: int = 24, objects: int = 6, seed: int = 0):
    """Objects moving at constant velocities with jitter; each frame drops
    some, lowers some below the high threshold, adds clutter."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 400, (objects, 2))
    vel = rng.uniform(-6, 6, (objects, 2))
    size = rng.uniform(20, 60, (objects, 2))
    out = []
    for t in range(n):
        c = start + vel * t + rng.normal(0, 1.0, (objects, 2))
        boxes = np.concatenate([c, c + size], 1)
        scores = rng.choice([0.95, 0.7, 0.3, 0.05], objects, p=[0.5, 0.2, 0.2, 0.1])
        keep = rng.uniform(size=objects) > 0.15
        clutter = rng.uniform(0, 450, (2, 2))
        boxes = np.concatenate([boxes[keep], np.concatenate([clutter, clutter + 15], 1)])
        scores = np.concatenate([scores[keep], rng.uniform(0.1, 0.9, 2)])
        classes = np.concatenate([np.arange(objects)[keep] % 3, [0, 1]])
        out.append((boxes.astype(np.float32), scores, classes))
    return out


@pytest.mark.parametrize("case", ["consistent", "seeded", "seeded_buffer_3"])
def test_bytetracker_matches_jax(case):
    kw = {"consistent": dict(new_track_thresh=0.5), "seeded": {},
          "seeded_buffer_3": dict(track_buffer=3, match_thresh=0.6)}[case]
    frames = _consistent_frames() if case == "consistent" else _seeded_frames(seed=len(kw))
    j, p = _both("ByteTracker", **kw)
    got, want = _run(p, frames), _run(j, frames)
    assert got == want
    assert _tracks(p.tracks) == _tracks(j.tracks) and p._next_id == j._next_id
    if case == "consistent":
        assert all(sorted(t[0] for t in f) == [1, 2] for f in got)
    else:
        assert p._next_id > 7  # tracks were lost, removed and started again


def test_bytetracker_rescue_and_removal_match_jax():
    """BYTE keeps an id through a low-confidence frame; a track lost past its
    buffer is removed and a re-detection takes a new id."""
    box = np.array([[50.0, 50, 100, 120]], np.float32)
    empty = (np.zeros((0, 4), np.float32), np.zeros(0), np.zeros(0, int))
    j, p = _both("ByteTracker", track_high_thresh=0.5, track_low_thresh=0.1)
    frames = [(box, np.array([0.9]), np.array([0])), (box + 2, np.array([0.3]), np.array([0]))]
    got = _run(p, frames)
    assert got == _run(j, frames) and got[1][0][0] == 1
    j, p = _both("ByteTracker", track_buffer=2, new_track_thresh=0.5)
    frames = [(box, np.array([0.9]), np.array([0]))] + [empty] * 3 + \
        [(box, np.array([0.9]), np.array([0]))]
    got = _run(p, frames)
    assert got == _run(j, frames)
    assert len(p.tracks) == 1 and got[-1][0][0] == 2


def _texture(seed: int, size: int = 200, thresh: int = 248) -> np.ndarray:
    import cv2

    rng = np.random.default_rng(seed)
    t = (rng.uniform(0, 255, (size, size)) > thresh).astype(np.uint8) * 255
    return cv2.dilate(t, np.ones((3, 3), np.uint8))


def test_gmc_and_botsort_match_jax():
    """GMC's affine between shifted frames, ``warp_box``, and BoT-SORT
    through a fast pan: equal to JAX's, one identity kept."""
    from kuzu.pipeline.tracker import GMC as JGMC

    from kuzu_torch.pipeline.tracker import GMC

    f1 = np.stack([_texture(0, 160, 250)[:120]] * 3, -1)
    f2 = np.roll(f1, (5, 9), axis=(0, 1))
    gj, gp = JGMC(), GMC()
    for f in (f1, f2):
        mj, mp = gj.update(f), gp.update(f)
        np.testing.assert_array_equal(mp, mj)
    assert abs(mp[0, 2] - 9) < 2 and abs(mp[1, 2] - 5) < 2
    box = np.array([10.0, 10, 30, 30])
    np.testing.assert_array_equal(GMC.warp_box(box, mp), JGMC.warp_box(box, mj))

    texture = _texture(1)
    j, p = _both("BoTSORT", new_track_thresh=0.5)
    obj = np.array([[80.0, 80, 120, 130]], np.float32)
    ids = []
    for f in range(6):
        shift = f * 12
        frame = np.stack([np.roll(texture, shift, axis=1)] * 3, -1)
        args = (obj + [shift, 0, shift, 0], np.array([0.9]), np.array([0]))
        got, want = _tracks(p.update(*args, frame=frame)), _tracks(j.update(*args, frame=frame))
        assert got == want
        ids.append(got[0][0])
    assert len(set(ids)) == 1


def test_botsort_without_cv2_raises_naming_it(monkeypatch):
    """Where cv2 is not installed (the card's machine), building BoT-SORT
    raises an ImportError that names cv2; ByteTrack needs none."""
    from kuzu_torch.pipeline.tracker import BoTSORT, ByteTracker
    from kuzu_torch.solutions import Heatmap

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        BoTSORT()
    with pytest.raises(ImportError, match="cv2"):
        Heatmap((8, 8), device="cpu").render(np.zeros((8, 8, 3), np.uint8))
    assert ByteTracker().update(np.zeros((0, 4)), np.zeros(0), np.zeros(0)) == []


def _stub_predictors():
    """A JAX and a port stub predictor: one box drifting right, frame by
    frame (``tests/test_tracker.py::test_model_track_facade``)."""
    from kuzu.api.results import Boxes as JBoxes
    from kuzu.api.results import Results as JResults

    from kuzu_torch.api.results import Boxes, Results

    def make(boxes_cls, results_cls):
        class Stub:
            def __init__(self, cfg, device=None):
                self.n = 0

            def __call__(self, source):
                out = []
                for _ in list(source):
                    x = 10.0 + 3 * self.n
                    self.n += 1
                    out.append(results_cls(orig_img=None, path="", names={}, boxes=boxes_cls(
                        np.array([[x, 10, x + 20, 40]]), np.array([0.9]), np.array([0]),
                        (64, 64))))
                return out
        return Stub

    return make(JBoxes, JResults), make(Boxes, Results)


def test_model_track_stub_predictor_matches_jax():
    from kuzu.api.model import Model as JModel
    from kuzu.api.model import register_task as j_register

    from kuzu_torch.api.model import Model, register_task

    jstub, pstub = _stub_predictors()
    j_register("_stub_track_port", predictor=jstub)
    register_task("_stub_track", predictor=pstub)
    jm, pm = JModel("anything", task="_stub_track_port"), Model("anything", task="_stub_track",
                                                                device="cpu")
    want = jm.track(["f0", "f1", "f2"], tracker="bytetrack")
    got = pm.track(["f0", "f1", "f2"], tracker="bytetrack")
    assert [r.boxes.id.tolist() for r in got] == [r.boxes.id.tolist() for r in want] == [[1]] * 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes.xyxy, w.boxes.xyxy)
    # persist keeps the tracker and its ids; a call without it starts a new one
    tk = pm._tracker_obj
    assert pm.track(["f3"], persist=True)[0].boxes.id.tolist() == [1] and pm._tracker_obj is tk
    pm.track(["f4"])
    assert pm._tracker_obj is not tk


def _moving_pages(n: int, size: int = 64) -> list[np.ndarray]:
    """Light pages with dark blocks that move a few pixels a frame."""
    rng = np.random.default_rng(12)
    blocks = [(rng.integers(4, 30), rng.integers(4, 30), rng.integers(8, 20), rng.integers(8, 20))
              for _ in range(4)]
    pages = []
    for t in range(n):
        p = np.full((size, size, 3), 225, np.uint8)
        for i, (y, x, h, w) in enumerate(blocks):
            y, x = y + t * (i % 2), x + 2 * t * ((i + 1) % 2)
            p[y:y + h, x:x + w] = 40 + 30 * i
        pages.append(p)
    return pages


def test_model_track_on_a_seeded_detector_matches_jax():
    """yolov12n at 64 px, seeded, ``box_head``'s biases; both facades track
    the same frames with ByteTrack at thresholds under the seeded scores
    (about 0.01): equal ids, boxes within 1e-3 px, scores within an f32
    ulp, and ids that persist across frames."""
    from kuzu.api.model import Model as JModel
    from kuzu.api.model import register_task as j_register
    from torch_parity import jax_detect_predictor

    from kuzu_torch.api.model import Model, register_task
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.detect import DetectPredictor

    det = box_head(YoloDetector("yolov12n", nc=2, imgsz=64, device="cpu").init(4), (1, 2, 1, 2))
    jp = jax_detect_predictor(det, "yolov12n", conf=0.001, max_det=8, pad_to=4, batch=4)
    tp = DetectPredictor.from_detector(det, conf=0.001, iou=0.7, max_det=8)
    tp.cfg["batch"] = 4
    j_register("_jax_track_port", predictor=lambda cfg: jp)
    register_task("_port_track", predictor=lambda cfg, device=None: tp)
    kw = dict(track_high_thresh=0.005, track_low_thresh=0.001, new_track_thresh=0.005,
              match_thresh=0.5)
    frames = _moving_pages(4)
    want = JModel("yolov12n", task="_jax_track_port").track(list(frames), **kw)
    got = Model("yolov12n", task="_port_track", device="cpu").track(list(frames), **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.boxes.id is not None and len(g) > 0
        assert g.boxes.id.tolist() == w.boxes.id.tolist()
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
    assert set(got[0].boxes.id.tolist()) & set(got[-1].boxes.id.tolist())
    assert torch.get_num_threads() == 2
