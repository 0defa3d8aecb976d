"""The port's source matrix and ``Results`` against the JAX package on the
CPU: ``resolve_source`` gives the same frames (pixels, paths, indices) in
the same order for every in-memory and file kind, ``batched_frames`` the
same groups, and ``Results`` the same views and exports."""

import json

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from kuzu_torch.data.image_io import write_png


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A directory of images: PNG written by cv2 and by the port (Sub and
    Paeth), BMP, a gray PNG, and a text file a directory source skips."""
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (40 + 8 * i, 56 - 4 * i, 3), dtype=np.uint8) for i in range(5)]
    cv2.imwrite(str(root / "a_cv2.png"), imgs[0][..., ::-1].copy())
    write_png(root / "b_sub.png", imgs[1])
    write_png(root / "c_paeth.png", imgs[2], filter="paeth")
    cv2.imwrite(str(root / "d.bmp"), imgs[3][..., ::-1].copy())
    cv2.imwrite(str(root / "e_gray.png"), imgs[4][..., 0].copy())
    (root / "notes.txt").write_text("not an image")
    return root


def _frames(fn, source):
    return [(np.asarray(f.image), f.path, f.frame_idx, f.stream) for f in fn(source)]


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for (gi, gp, gf, gs), (wi, wp, wf, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert (gp, gf, gs) == (wp, wf, ws)


def _sources(media):
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (3, 20, 30, 3), dtype=np.uint8)
    return {
        "array": frame,
        "batch": batch,
        "list": [frame, batch, str(media / "b_sub.png")],
        "tuple": (frame, frame[::-1].copy()),
        "pil": Image.fromarray(frame).convert("L"),
        "path": str(media / "c_paeth.png"),
        "pathlib": media / "a_cv2.png",
        "directory": str(media),
        "glob": str(media / "*.png"),
        "paths": [str(media / "d.bmp"), str(media / "e_gray.png")],
    }


@pytest.mark.parametrize("kind", ["array", "batch", "list", "tuple", "pil", "path",
                                  "pathlib", "directory", "glob", "paths"])
def test_resolve_source_matches_jax(media, kind):
    from kuzu.data.sources import resolve_source as jax_resolve

    from kuzu_torch.data.sources import resolve_source

    source = _sources(media)[kind]
    _assert_same(_frames(resolve_source, source), _frames(jax_resolve, source))


def test_tensor_sources_match_arrays(media):
    """uint8 tensors, one frame and a batch, give the arrays' frames."""
    from kuzu_torch.data.sources import resolve_source

    src = _sources(media)
    for kind in ("array", "batch"):
        _assert_same(_frames(resolve_source, torch.from_numpy(src[kind])),
                     _frames(resolve_source, src[kind]))
    with pytest.raises(ValueError, match="bad source array"):
        list(resolve_source(torch.zeros((2, 3), dtype=torch.uint8)))


def test_batched_frames_match_jax(media):
    from kuzu.data.sources import batched_frames as jax_batched
    from kuzu.data.sources import resolve_source as jax_resolve

    from kuzu_torch.data.sources import batched_frames, resolve_source

    for batch in (1, 2, 4, 16):
        got = [[f.path for f in g] for g in batched_frames(resolve_source(str(media)), batch)]
        want = [[f.path for f in g] for g in jax_batched(jax_resolve(str(media)), batch)]
        assert got == want


@pytest.mark.parametrize("source", [0, "3", "clip.mp4", "rtsp://cam/1", "http://cam/live"])
def test_video_and_streams_raise(source):
    from kuzu_torch.data.sources import resolve_source

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        list(resolve_source(source))


def test_remote_image_url_refused_as_jax():
    from kuzu.data.sources import resolve_source as jax_resolve

    from kuzu_torch.data.sources import resolve_source

    url = "https://example.org/page.png"
    with pytest.raises(ValueError) as want:
        list(jax_resolve(url))
    with pytest.raises(ValueError) as got:
        list(resolve_source(url))
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- Results


def _results_pair():
    from kuzu.api.results import Boxes as JaxBoxes
    from kuzu.api.results import Results as JaxResults

    from kuzu_torch.api.results import Boxes, Results

    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 150, (6, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(3, 60, (6, 2)).astype(np.float32)], 1)
    scores = rng.uniform(0, 1, 6).astype(np.float32)
    classes = rng.integers(0, 3, 6)
    names = {0: "column", 1: "char", 2: "文"}
    img = rng.integers(0, 256, (210, 180, 3), dtype=np.uint8)
    args = (img, "page.png", names)
    return (Results(*args, Boxes(boxes, scores, classes, (210, 180)), {"inference_ms": 1.5}),
            JaxResults(*args, JaxBoxes(boxes, scores, classes, (210, 180)),
                       {"inference_ms": 1.5}))


def test_results_views_and_exports_match_jax(tmp_path):
    got, want = _results_pair()
    assert len(got) == len(want) == 6
    for view in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
        np.testing.assert_array_equal(getattr(got.boxes, view), getattr(want.boxes, view))
    for key in ("boxes", "scores", "classes", "path"):
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(KeyError):
        got["masks"]
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary() == json.loads(want.to_json())
    for conf in (True, False):
        g = got.save_txt(tmp_path / f"got{conf}.txt", save_conf=conf).read_text()
        assert g == want.save_txt(tmp_path / f"want{conf}.txt", save_conf=conf).read_text()
    for kw in (dict(min_conf=0.5), dict(classes=[0, 2]), dict(min_conf=0.3, classes=[1])):
        assert got.filter(**kw).to_json() == want.filter(**kw).to_json()
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    np.testing.assert_array_equal(got.boxes[1:4].xyxy, want.boxes[1:4].xyxy)
    assert got.speed == {"inference_ms": 1.5}
    # plot draws with cv2 as JAX's does, byte for byte; save writes it
    plot = got.plot()
    assert plot.tobytes() == want.plot().tobytes()
    saved = cv2.imread(str(got.save(tmp_path / "plot.png")))
    np.testing.assert_array_equal(cv2.cvtColor(saved, cv2.COLOR_BGR2RGB), plot)
