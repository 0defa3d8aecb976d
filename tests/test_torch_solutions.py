"""The port's solutions against the JAX package's on the CPU: each solution
fed the same ``Results`` sequences (built once in each package's own
``Results``), the counts, zones, speeds, queue lengths and CSV rows equal
exactly; ``heatmap_accumulate`` and ``Heatmap`` within 1e-5 of the largest
entry (the JAX map is one jitted product, the port's a torch einsum with
TF32 off), ``Heatmap.render`` (cv2 on both sides) within one grey level.
"""

import numpy as np
import pytest

import kuzu.solutions as J
import kuzu_torch.solutions as P

REL = 1e-5


def _res(pkg, centers, ids=None, size=20.0, shape=(200, 200), cls=None, conf=None):
    """A ``Results`` of ``pkg`` (``"jax"`` or ``"port"``): square boxes at
    ``centers``."""
    if pkg == "jax":
        from kuzu.api.results import Boxes, Results
    else:
        from kuzu_torch.api.results import Boxes, Results
    c = np.asarray(centers, np.float32).reshape(-1, 2)
    boxes = np.concatenate([c - size / 2, c + size / 2], axis=1)
    n = len(boxes)
    return Results(orig_img=None, path="synthetic", names={0: "char"}, boxes=Boxes(
        boxes, np.full(n, 0.9, np.float32) if conf is None else np.asarray(conf, np.float32),
        np.zeros(n) if cls is None else np.asarray(cls), shape,
        None if ids is None else np.asarray(ids)))


def _sequence(seed: int = 0, frames: int = 12, n: int = 5, speed: float = 15.0):
    """Tracked frames: n objects wandering over a 200 x 200 frame, one
    missing now and then, classes 0-2."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(20, 180, (n, 2))
    vel = rng.uniform(-speed, speed, (n, 2))
    out = []
    for _ in range(frames):
        pos = np.clip(pos + vel + rng.normal(0, 3, (n, 2)), 0, 200)
        keep = rng.uniform(size=n) > 0.2
        out.append(dict(centers=pos[keep], ids=np.arange(1, n + 1)[keep],
                        cls=np.arange(n)[keep] % 3, conf=rng.uniform(0.3, 1.0, n)[keep]))
    return out


def _feed(make, update, seq):
    """Both packages' solution over ``seq``: the outputs of each frame."""
    out = {}
    for pkg in ("jax", "port"):
        sol = make(pkg)
        out[pkg] = [update(sol, _res(pkg, **f)) for f in seq]
    return out["port"], out["jax"]


def test_region_contains_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 15, (200, 2))
    for poly in ([(0, 0), (10, 0), (10, 10), (0, 10)],
                 [(0, 0), (10, 0), (10, 4), (4, 4), (4, 10), (0, 10)],
                 [(1, 1), (9, 2), (5, 9)]):
        np.testing.assert_array_equal(P.Region(poly).contains(pts), J.Region(poly).contains(pts))
    with pytest.raises(ValueError, match="3 vertices"):
        P.Region([(0, 0), (1, 1)])


def test_region_counter_and_trackzone_match_jax():
    regions = {"left": [(0, 0), (100, 0), (100, 200), (0, 200)],
               "top": [(0, 0), (200, 0), (200, 80), (0, 80)]}
    seq = _sequence(2)
    got, want = _feed(lambda k: (J if k == "jax" else P).RegionCounter(regions),
                      lambda s, r: dict(s.update(r)), seq)
    assert got == want and any(sum(c.values()) for c in got)
    zone = [(20, 20), (150, 30), (120, 170)]
    got, want = _feed(lambda k: (J if k == "jax" else P).TrackZone(zone),
                      lambda s, r: (s(r).boxes.id.tolist(), s(r).boxes.xyxy.tolist()), seq)
    assert got == want


def test_object_counter_matches_jax():
    seq = _sequence(3, frames=20)
    line = ((100, 0), (100, 200))
    got, want = _feed(lambda k: (J if k == "jax" else P).ObjectCounter(line=line),
                      lambda s, r: (s.update(r), {k: list(v) for k, v in s.classwise.items()}),
                      seq)
    assert got == want and got[-1][0] != (0, 0)
    with pytest.raises(ValueError, match="track"):
        P.ObjectCounter().update(_res("port", [(10, 10)]))


def test_speed_estimator_and_queue_manager_match_jax():
    seq = _sequence(4)
    got, want = _feed(lambda k: (J if k == "jax" else P).SpeedEstimator(fps=10.0, px_per_unit=2.0),
                      lambda s, r: s.update(r), seq)
    assert got == want and got[-1]
    region = [(100, 0), (200, 0), (200, 200), (100, 200)]
    got, want = _feed(lambda k: (J if k == "jax" else P).QueueManager(region, min_frames=2),
                      lambda s, r: s.update(r), _sequence(4, speed=3.0))
    assert got == want and max(got) > 0


def test_analytics_matches_jax(tmp_path):
    seq = _sequence(5)
    names = {0: "char", 1: "seal"}
    rows = {}
    for pkg in ("jax", "port"):
        an = (J if pkg == "jax" else P).Analytics(names=names)
        rows[pkg] = [an.update(_res(pkg, **f)) for f in seq]
        an.to_csv(tmp_path / f"{pkg}.csv")
    assert rows["port"] == rows["jax"]
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_heatmap_accumulate_matches_jax():
    """Random boxes (some thinner than a pixel) with weights, padded rows
    weighted 0, on non-square maps."""
    rng = np.random.default_rng(6)
    for n, shape in ((8, (100, 100)), (32, (48, 160)), (16, (200, 64))):
        xy = rng.uniform(-10, max(shape), (n, 2))
        wh = rng.uniform(0.2, 40, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        w = rng.uniform(0, 1, n).astype(np.float32)
        w[n // 2:] = 0
        got = P.heatmap_accumulate(boxes, w, shape, device="cpu")
        want = np.asarray(J.heatmap_accumulate(boxes, w, shape))
        assert got.shape == want.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_heatmap_matches_jax():
    seq = _sequence(7)
    maps = {}
    for pkg in ("jax", "port"):
        hm = J.Heatmap((200, 200)) if pkg == "jax" else P.Heatmap((200, 200), device="cpu")
        for f in seq:
            hm.update(_res(pkg, **f))
        maps[pkg] = (hm.heat.copy(), hm.render(np.full((200, 200, 3), 128, np.uint8)))
    np.testing.assert_allclose(maps["port"][0], maps["jax"][0], rtol=0,
                               atol=REL * maps["jax"][0].max())
    diff = np.abs(maps["port"][1].astype(int) - maps["jax"][1].astype(int))
    assert diff.max() <= 1
