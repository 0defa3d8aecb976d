"""The port's YOLO folder dataset and its augmentations against
``kuzu/data/yolo_dataset.py`` and ``kuzu/data/augment_extra.py`` on a seeded
PNG folder of small images (up to 200 px, imgsz 128): every augmentation
with equal generator seeds, every sample over two epochs with mosaic,
mixup and copy-paste on, the letterbox route and rect buckets, the label
and image caches; then a port training run from the folder, its
``Model.val`` and ``evaluate_detector`` against JAX's on the same weights.

Images are compared byte for byte, labels exactly, boxes to 1e-5 px (both
sides compute them in numpy f64 / f32 from the same draws)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kuzu.data.augment_extra as jx_extra
import kuzu.data.yolo_dataset as jx
import kuzu_torch.data.augment_extra as pt_extra
import kuzu_torch.data.yolo_dataset as pt
from kuzu_torch.testing import write_yolo_folder

SHAPES = [(120, 160), (200, 90), (96, 96), (150, 200), (64, 180)]
HYP = dict(degrees=10.0, shear=5.0, perspective=5e-4, mixup=0.5, copy_paste=0.5)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo")
    return write_yolo_folder(root, {"train": 6, "val": 3}, n_boxes=(2, 9), size=(6, 30), nc=3,
                             seed=0, shapes=SHAPES)


def assert_sample_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _raw(folder, i=0):
    ds = jx.YoloDetectionDataset(folder, imgsz=128)
    return ds._load_raw(i)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_match_jax(folder, seed):
    img, boxes, labels = _raw(folder, seed)
    for name, call in [
        ("hsv", lambda m, r: (m.hsv_jitter(img, r, 0.3, 0.7, 0.4),)),
        ("affine", lambda m, r: m.random_affine(img, boxes, labels, r, 128, degrees=30,
                                                translate=0.2, scale=0.5, shear=10)),
        ("perspective", lambda m, r: m.random_affine(img, boxes, labels, r, 128, degrees=5,
                                                     shear=3, perspective=1e-3)),
        ("mixup", lambda m, r: m.mixup(img, boxes, labels, img[::-1].copy(), boxes[::-1],
                                       labels[::-1], r)),
        ("copy_paste", lambda m, r: m.copy_paste(img, boxes, labels, r, p=0.8)),
    ]:
        got = call(pt, np.random.default_rng(seed))
        want = call(jx, np.random.default_rng(seed))
        for g, w in zip(got, want):
            if g.dtype == np.uint8:
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_extras_match_jax(folder, seed):
    img = _raw(folder, seed + 1)[0]
    for name in ("gauss_noise", "motion_blur", "grid_distortion", "coarse_dropout"):
        got = getattr(pt_extra, name)(img, np.random.default_rng(seed))
        want = getattr(jx_extra, name)(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want, err_msg=name)
    kw = dict(p_noise=0.5, p_blur=0.9, p_distort=0.9, p_dropout=0.5)
    np.testing.assert_array_equal(pt_extra.apply_photometric(img, np.random.default_rng(seed), **kw),
                                  jx_extra.apply_photometric(img, np.random.default_rng(seed), **kw))
    with pytest.raises(NotImplementedError, match="JPEG codec"):
        pt_extra.apply_photometric(img, np.random.default_rng(seed), p_jpeg=1.0)


def test_samples_over_two_epochs_match_jax(folder):
    """Mosaic (with perspective, rotation and shear), mixup, copy-paste, HSV,
    the extras and the flips on; every sample of two epochs."""
    hyp = {**HYP, "flipud": 0.5, "blur": 0.3, "distort": 0.3, "erasing": 0.3, "noise": 0.3}
    kw = dict(imgsz=128, max_boxes=40, hyp=hyp, seed=3)
    p, j = pt.YoloDetectionDataset(folder, **kw), jx.YoloDetectionDataset(folder, **kw)
    for epoch in (0, 1):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(j)):
            assert_sample_equal(p[i], j[i])
    p.close_mosaic()
    j.close_mosaic()
    assert_sample_equal(p[2], j[2])


@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_route_and_rect_buckets_match_jax(folder, rect):
    kw = dict(split="val", imgsz=128, max_boxes=16, augment=False, rect=rect)
    p, j = pt.YoloDetectionDataset(folder, **kw), jx.YoloDetectionDataset(folder, **kw)
    assert [p.batch_shape_key(i) for i in range(len(p))] == \
        [j.batch_shape_key(i) for i in range(len(j))]
    for i in range(len(j)):
        assert_sample_equal(p[i], j[i])


def test_label_cache_round_trips_and_invalidates(folder):
    ds = pt.YoloDetectionDataset(folder, imgsz=128)
    cache = ds._label_cache_file()
    assert cache.exists()
    first = [x.copy() for x in ds._labels]
    z = dict(np.load(cache))
    again = pt.YoloDetectionDataset(folder, imgsz=128)
    assert all(np.array_equal(a, b) for a, b in zip(first, again._labels))
    assert str(np.load(cache)["key"]) == str(z["key"])
    # the JAX package reads the port's cache (one format) and agrees
    assert all(np.array_equal(a, b) for a, b in
               zip(first, jx.YoloDetectionDataset(folder, imgsz=128)._labels))
    label = pt._label_path(ds.images[0])
    text = label.read_text()
    try:
        label.write_text("1 0.5 0.5 0.25 0.25\n")
        fresh = pt.YoloDetectionDataset(folder, imgsz=128)
        np.testing.assert_array_equal(fresh._labels[0], [[1, 0.5, 0.5, 0.25, 0.25]])
        assert str(np.load(cache)["key"]) != str(z["key"])
    finally:
        label.write_text(text)
    assert all(np.array_equal(a, b) for a, b in
               zip(first, pt.YoloDetectionDataset(folder, imgsz=128)._labels))


def test_image_caches_give_equal_samples(folder, tmp_path):
    kw = dict(imgsz=128, max_boxes=40, hyp=HYP, seed=1)
    plain = pt.YoloDetectionDataset(folder, **kw)
    want = [plain[i] for i in range(3)]
    for mode in ("ram", "disk"):
        ds = pt.YoloDetectionDataset(folder, cache_images=mode, **kw)
        for _ in range(2):  # the first pass fills the cache, the second reads it
            for i in range(3):
                assert_sample_equal(ds[i], want[i])
        if mode == "disk":
            npy = list(ds.images[0].parent.glob("*.cache.npy"))
            assert npy
            for f in npy:
                f.unlink()


def test_undecodable_image_falls_back_to_gray_and_codec_raises(folder, tmp_path):
    """A file that does not decode gives the reference's 114 square; a JPEG
    where no codec imports raises its ImportError."""
    import shutil
    import sys

    root = tmp_path / "bad"
    shutil.copytree(folder.parent, root)
    (root / "images" / "train" / "im000.png").write_bytes(b"not an image")
    ds = pt.YoloDetectionDataset(root / "dataset.yaml", imgsz=64, augment=False)
    assert (ds._decode(0) == 114).all() and ds._decode(0).shape == (64, 64, 3)
    (root / "images" / "train" / "im001.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    ds = pt.YoloDetectionDataset(root / "dataset.yaml", imgsz=64, augment=False)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        with pytest.raises(ImportError, match="JPEG"):
            ds._decode(1)
    finally:
        sys.modules["cv2"] = saved


@pytest.fixture(scope="module")
def run(folder, tmp_path_factory):
    """A one-epoch f32 port run from the folder through the facade
    (yolov12n@128, batch 2, the mosaic route: ``augment=True``, the default
    config's ``augment`` being false, and ``close_mosaic=0``)."""
    from kuzu_torch.api.model import Model

    project = tmp_path_factory.mktemp("runs")
    model = Model("yolov12n", task="detect", device="cpu")
    final = model.train(data=str(folder), imgsz=128, batch=2, epochs=1, workers=0,
                        augment=True, close_mosaic=0, project=str(project), name="r",
                        exist_ok=True,
                        verbose=False)
    return model, final, project / "detect" / "r"


def test_facade_trains_from_the_folder_and_val_equals_its_validation(run, folder):
    from kuzu_torch.api.model import Model

    model, final, run_dir = run
    ds = model._trainer.train_ds
    assert ds.augment and ds.hyp["mosaic"] == 1.0
    assert model._trainer.state.step == 3 and np.isfinite(final["loss"])
    got = Model(str(run_dir), device="cpu").val(data=str(folder), project=str(run_dir.parent))
    want = {k: final[k] for k in got}
    assert got == want


def _port_detector(run_dir):
    from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector("yolov12n", nc=3, imgsz=128, device="cpu")
    det.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights")))
    return det


def test_val_and_evaluate_detector_match_jax(run, folder, monkeypatch):
    """The run's weights in JAX: its ``DetectTrainer.validate`` on its own
    validation loader of the folder, and its ``evaluate_detector`` (its
    predictor over the run's weights, the BN-folded bf16 executor with
    Pallas interpreted), against the port's."""
    import jax.numpy as jnp
    import kuzu.tasks.detect as jdetect
    import kuzu.tools.evaluation as jeval
    from kuzu.core.config import load_config as j_config
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from types import SimpleNamespace

    from kuzu_torch.api.model import Model
    from kuzu_torch.tools.evaluation import evaluate_detector
    from torch_parity import flax_variables, jax_detect_predictor

    _, final, run_dir = run
    det = _port_detector(run_dir)
    variables = flax_variables(det.graph)
    jt = jdetect.DetectTrainer(j_config(overrides=dict(
        data=str(folder), imgsz=128, batch=2, workers=0, project=str(run_dir.parent / "jax"))))
    _, jt.val_loader = jt.build_datasets()
    jt.imgsz, jt.detector = 128, JaxDetector("yolov12n", nc=3, dtype=jnp.bfloat16, imgsz=128)
    want = jt.validate(SimpleNamespace(ema_params=None, params=variables["params"],
                                       model_state={"batch_stats": variables["batch_stats"]}))
    got = Model(str(run_dir), device="cpu").val(data=str(folder), project=str(run_dir.parent))
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k

    jpred = jax_detect_predictor(det, "yolov12n", conf=0.001, iou=0.7, max_det=300, pad_to=1)
    monkeypatch.setattr(jdetect, "DetectPredictor", lambda cfg: jpred)
    jres = jeval.evaluate_detector(run_dir, folder, split="val")
    tres = evaluate_detector(run_dir, folder, split="val", device="cpu")
    assert tres["worst_images"] == jres["worst_images"]
    assert [r["image"] for r in tres["per_image"]] == [r["image"] for r in jres["per_image"]]
    for a, b in zip(tres["per_image"], jres["per_image"]):
        for k in ("precision", "recall", "f1"):
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-9)
    for k in ("map50", "map", "fitness"):
        assert tres[k] == pytest.approx(jres[k], rel=1e-6, abs=1e-9), k
    assert final["map50"] >= 0
