"""The Segment head in the port against the JAX package on the CPU:
yolov8n-seg at 64 px, batch 2, nc 3, the port's seeded weights handed to
JAX through the inverse bridge.

- module tree: the train-mode forward in f64 (``det`` maps, ``coeffs``,
  ``protos`` and every new running statistic within 1e-9) and the BN-folded
  executor's dict (bf16 maps within ``maps_match``, coeffs / protos f32);
- ops: ``crop_loss_to_box`` exact, ``compose_masks`` exact in f64 and at
  least 99% of pixels in f32, ``segmentation_loss`` within 1e-5 relative
  with more foreground anchors than ``max_fg`` (ties resolved as
  ``lax.top_k`` resolves them);
- data: ``image_io.fill_poly`` byte-equal to ``cv2.fillPoly``; the
  ``YoloSegmentDataset`` sample for sample equal to JAX's (augmented);
- task: one f32 ``SegmentTrainer`` step (at 128 px), the validator's
  metrics and the predictor's masks against JAX's.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_heads import (check_step, f64_forward_pair, jax_trainer, patch_jax_predictor,
                         port_trainer, seeded_graph, step_pair, val_state)
from torch_parity import assert_maps_close

NAME, IMGSZ, NC = "yolov8n-seg", 64, 3
STEP_IMGSZ = 128  # at 64 px the 2 x 2 P5 maps' batch statistics amplify f32 rounding
GT_BOXES = [[[4, 4, 28, 30], [36, 8, 60, 28], [10, 36, 40, 60]],
            [[34, 34, 60, 58], [4, 6, 26, 40], [30, 4, 56, 26]]]


def seg_batch(seed: int = 0, size: int = IMGSZ) -> dict:
    """Two seeded images of ``size`` px, 3 GT slots each (one padding slot
    in the second image; the boxes scaled from 64 px), and their
    overlap-index maps at stride 4: each GT's box region, later instances
    over earlier ones."""
    rng = np.random.default_rng(seed)
    boxes = np.array(GT_BOXES, np.float32) * (size / 64)
    valid = np.array([[1, 1, 1], [1, 1, 0]], bool)
    masks = np.zeros((2, size // 4, size // 4), np.int32)
    for b in range(2):
        for i in range(3):
            if valid[b, i]:
                x1, y1, x2, y2 = (boxes[b, i] / 4).astype(int)
                masks[b, y1:y2, x1:x2] = i + 1
    return {"image": rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8),
            "gt_labels": np.array([[0, 1, 2], [2, 0, 1]], np.int32),
            "gt_boxes": boxes, "mask_gt": valid, "masks": masks}


@pytest.fixture(scope="module")
def seg():
    """The seeded port graph, its flax variables and the folded detector."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    graph, variables = seeded_graph(NAME, NC)
    det = YoloDetector(graph.spec, imgsz=IMGSZ, device="cpu")
    det.graph.load_state_dict(graph.state_dict())
    det._load()
    imgs = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return SimpleNamespace(graph=graph, variables=variables, det=det, imgs=imgs)


def test_train_forward_matches_flax_in_f64(seg):
    """Every output leaf (the three ``det`` maps, coeffs (B, A, 32), protos
    (B, 16, 16, 32)) and every new running statistic within 1e-9."""
    from kuzu_torch.bridge import _targets

    jout, jstats, tout, g64 = f64_forward_pair(seg.graph, seg.variables,
                                               seg.imgs.astype(np.float64) / 255)
    assert len(jout) == len(tout) == 5
    for r, o in zip(jout, tout):
        np.testing.assert_allclose(o, r, rtol=1e-9, atol=1e-9)
    n = 0
    for path, tensor, _ in _targets(g64):
        if path[0] == "batch_stats":
            want = jstats
            for key in path[1:]:
                want = want[key]
            np.testing.assert_allclose(tensor.numpy(), want, rtol=1e-9, atol=1e-11)
            n += 1
    assert n == 2 * sum(1 for m in g64.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_executor_matches_jax(seg):
    """The BN-folded executor in bf16 against JAX's ``run_graph``: the same
    keys, coeffs and protos in f32, every output within ``maps_match``."""
    from kuzu.models.yolo.infer import run_graph

    jmod_spec = seg.det.spec
    jm = jax.jit(lambda v, x: run_graph(jmod_spec, v, x, interpret=True))(
        seg.variables, jnp.asarray(seg.imgs))
    tm = seg.det.infer(torch.from_numpy(seg.imgs))
    assert set(jm) == set(tm) == {"det", "coeffs", "protos"}
    for a, b in zip(jm["det"], tm["det"]):
        assert_maps_close(a, b)
    for k in ("coeffs", "protos"):
        assert jm[k].dtype == jnp.float32 and tm[k].dtype == torch.float32
        assert tuple(jm[k].shape) == tuple(tm[k].shape)
        assert_maps_close(jm[k], tm[k])


def test_crop_loss_to_box_matches_jax():
    """Exact: the same pixels zeroed, boxes on and off pixel edges."""
    from kuzu.ops.seg_loss import crop_loss_to_box as j_crop

    from kuzu_torch.ops.seg_loss import crop_loss_to_box

    rng = np.random.default_rng(0)
    loss = rng.random((2, 5, 12, 16)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-2, 18, (2, 5, 2)), rng.uniform(-2, 18, (2, 5, 2))],
                           -1).astype(np.float32)
    boxes[0, 0] = [2, 3, 7, 9]  # integer edges
    want = np.asarray(j_crop(jnp.asarray(loss), jnp.asarray(boxes)))
    got = crop_loss_to_box(torch.from_numpy(loss), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compose_masks_matches_jax(dtype):
    """sigmoid(coeffs @ protos) > 0.5 cropped to the kept boxes: in f64 the
    same masks exactly; in f32 (the two products sum in another order) at
    least 99% of the pixels, here all but those within 1e-5 of 0.5."""
    from kuzu.tasks.segment import compose_masks as j_compose

    from kuzu_torch.tasks.segment import compose_masks

    rng = np.random.default_rng(3)
    dt = np.dtype(dtype)
    outputs = {"coeffs": rng.normal(size=(2, 84, 32)).astype(dt),
               "protos": rng.normal(size=(2, 16, 16, 32)).astype(dt) * 0.3}
    nms = {"indices": rng.integers(0, 84, (2, 10)).astype(np.int32),
           "boxes": np.sort(rng.uniform(0, 64, (2, 10, 2, 2)), 2).reshape(2, 10, 4).astype(dt),
           "valid": rng.random((2, 10)) < 0.8}
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.jit(lambda o, n: j_compose(o, n, IMGSZ))(
            {k: jnp.asarray(v) for k, v in outputs.items()},
            {k: jnp.asarray(v) for k, v in nms.items()}))
    got = compose_masks({k: torch.from_numpy(v) for k, v in outputs.items()},
                        {k: torch.from_numpy(v) for k, v in nms.items()}, IMGSZ).numpy()
    assert got.shape == want.shape == (2, 10, 16, 16) and want.any()
    if dtype == "float64":
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.99


def test_segmentation_loss_matches_jax(seg):
    """The loss of the f32 train-mode maps on both sides, ``max_fg`` 4, far
    below the foreground count, so the top-k over the tied 0/1 foreground
    mask picks among ties: every term within 1e-5 relative, and the
    clipped share (``seg_fg_dropped``) equal."""
    from kuzu.ops.seg_loss import segmentation_loss as j_loss

    from kuzu_torch.ops.seg_loss import segmentation_loss

    b = seg_batch()
    graph = seeded_graph(NAME, NC)[0].train()
    with torch.no_grad():
        out = graph(torch.from_numpy(b["image"]))
    kw = dict(nc=NC, imgsz=IMGSZ, strides=tuple(seg.det.strides), max_fg=4)
    jout = {"det": [jnp.asarray(f.numpy()) for f in out["det"]],
            "coeffs": jnp.asarray(out["coeffs"].numpy()),
            "protos": jnp.asarray(out["protos"].numpy())}
    jt, jm = jax.jit(lambda *a: j_loss(*a, **kw))(
        jout, jnp.asarray(b["gt_labels"]), jnp.asarray(b["gt_boxes"]), jnp.asarray(b["masks"]),
        jnp.asarray(b["mask_gt"]))
    tt, tm = segmentation_loss(out, *(torch.from_numpy(b[k]) for k in
                                      ("gt_labels", "gt_boxes", "masks", "mask_gt")), **kw)
    assert float(jm["seg_fg_dropped"]) > 0.5  # most foreground anchors clipped
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)


POLY_CASES = {
    "square": [[2, 2], [9, 2], [9, 9], [2, 9]],
    "concave": [[1, 1], [14, 1], [7, 6], [14, 12], [1, 12]],
    "bowtie": [[1, 1], [12, 10], [12, 1], [1, 10]],  # self-intersecting
    "point": [[5, 5], [5, 5], [5, 5]],
    "two_points": [[2, 3], [11, 8], [2, 3]],
    "zero_area": [[1, 4], [6, 4], [12, 4]],
    "out_of_frame": [[-6, 7], [20, -3], [14, 18]],
    "far_out": [[-40, -40], [-30, 50], [-20, -40]],
}


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_fill_poly_matches_cv2(case):
    """cv2.fillPoly's bytes for a named polygon, and then for 300 seeded
    random ones of its kind (1-8 vertices in and around a 13 x 16 int32
    image, several filled over each other)."""
    import cv2

    from kuzu_torch.data.image_io import fill_poly

    pts = np.array(POLY_CASES[case], np.int32)
    want, got = np.zeros((13, 16), np.int32), np.zeros((13, 16), np.int32)
    cv2.fillPoly(want, [pts], color=3)
    fill_poly(got, [pts], 3)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(sorted(POLY_CASES).index(case))
    lo, hi = pts.min(0) - 4, pts.max(0) + 5
    for _ in range(300):
        want, got = np.zeros((13, 16), np.int32), np.zeros((13, 16), np.int32)
        for i in range(int(rng.integers(1, 4))):
            p = rng.integers(lo, hi, (int(rng.integers(1, 9)), 2)).astype(np.int32)
            cv2.fillPoly(want, [p], color=i + 1)
            fill_poly(got, [p], i + 1)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def seg_folder(tmp_path_factory):
    from kuzu_torch.testing import write_head_folder

    return write_head_folder(tmp_path_factory.mktemp("segds"), "segment",
                             {"train": 4, "val": 4}, hw=(90, 120), nc=NC, seed=2)


def test_dataset_matches_jax(seg_folder):
    """Every training sample (HSV and flips on, two epochs) and validation
    sample of the folder: images and masks byte-equal, boxes within 1e-6,
    the same labels and slots."""
    from kuzu.data.yolo_dataset import YoloSegmentDataset as JaxDataset

    from kuzu_torch.data.yolo_dataset import YoloSegmentDataset

    for split, augment in (("train", True), ("val", False)):
        kw = dict(split=split, imgsz=IMGSZ, max_boxes=8, augment=augment, seed=3)
        port, ref = YoloSegmentDataset(seg_folder, **kw), JaxDataset(seg_folder, **kw)
        for epoch in (0, 1) if augment else (0,):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ref)):
                got, want = port[i], ref[i]
                assert set(got) == set(want)
                assert want["masks"].any()
                for k in ("image", "masks", "gt_labels", "mask_gt"):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], atol=1e-6, rtol=0)


def test_segment_trainer_step_matches_jax(seg):
    """One f32 step of ``SegmentTrainer.loss_fn`` (the train forward and
    ``segmentation_loss``) against JAX's under ``value_and_grad`` and the
    optax chain: every check of the detector's step pair."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.tasks.segment import SegmentTrainer as JaxTrainer

    from kuzu_torch.tasks.segment import SegmentTrainer

    graph, variables = seeded_graph(NAME, NC)
    cfg = dict(seg_max_fg=16)

    jt = jax_trainer(JaxTrainer, cfg, imgsz=STEP_IMGSZ,
                     detector=JaxDetector(NAME, nc=NC, imgsz=STEP_IMGSZ))
    tt = port_trainer(SegmentTrainer, cfg, graph.spec, STEP_IMGSZ)
    pair = step_pair(graph, variables, jt.loss_fn, tt.loss_fn, seg_batch(size=STEP_IMGSZ))
    check_step(pair, ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg", "seg_loss",
                      "seg_fg_dropped"))


def test_validator_and_predictor_match_jax(seg, seg_folder, tmp_path, monkeypatch):
    """The trainer's validation of the folder's val split (box mAP; JAX's
    on its flax apply in bf16) within 1e-6, and ``SegmentPredictor`` over
    the val images against JAX's on the same folded bf16 executor: the same
    detections (boxes 1e-3 px) and at least 99% of mask pixels equal."""
    from kuzu.core.config import load_config as j_config
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.tasks.segment import SegmentPredictor as JaxPredictor
    from kuzu.tasks.segment import SegmentTrainer as JaxTrainer

    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer
    from kuzu_torch.tasks.segment import SegmentPredictor, SegmentTrainer

    ov = dict(data=str(seg_folder), model=NAME, imgsz=IMGSZ, batch=2, workers=0)
    jt = JaxTrainer(j_config(overrides=dict(ov, project=str(tmp_path / "j"))))
    _, jt.val_loader = jt.build_datasets()
    jt.imgsz, jt.detector = IMGSZ, JaxDetector(NAME, nc=NC, dtype=jnp.bfloat16, imgsz=IMGSZ)
    want = jt.validate(val_state(seg.variables))
    tt = SegmentTrainer(load_config(overrides=dict(ov, project=str(tmp_path / "t"))),
                        device="cpu")
    tt.train_loader, tt.val_loader = tt.build_datasets()
    model = tt.build_model()
    model.load_state_dict(seg.graph.state_dict())
    got = tt.validate(TrainState(model, build_optimizer(tt.cfg, model), use_ema=False))
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k

    patch_jax_predictor(monkeypatch, seg.det, JaxDetector(NAME, nc=NC, dtype=jnp.bfloat16,
                                                          imgsz=IMGSZ))
    images = sorted((seg_folder.parent / "images" / "val").glob("*.png"))
    jp = JaxPredictor(j_config(overrides=dict(conf=0.005, max_det=20, batch=4)))
    tp = SegmentPredictor.from_detector(seg.det, conf=0.005, max_det=20)
    tp.cfg["batch"] = 4
    wres, gres = jp(images), tp(images)
    assert len(gres) == len(wres) == 4
    for g, w in zip(gres, wres):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3, rtol=0)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        assert g.masks.data.shape == w.masks.data.shape
        assert (g.masks.data == w.masks.data).mean() >= 0.99
        np.testing.assert_array_equal(g.masks.full().shape, w.masks.full().shape)
