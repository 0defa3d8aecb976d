"""The Pose and OBB heads in the port against the JAX package on the CPU:
yolov8n-pose (kpt_shape 17 x 3) and yolov8n-obb at 64 px, batch 2, nc 3,
the port's seeded weights handed to JAX through the inverse bridge.

- module trees: the train-mode forward in f64 (every output leaf and new
  running statistic within 1e-9) and the BN-folded executor's dict;
- ops: ``kpts_decode``, ``oks_matrix``, ``probiou``, ``dist2rbox``,
  ``rbox_corners``, ``anchors_in_rboxes`` (each at its stated tolerance),
  ``nms_rotated_padded`` (the keeps exact, tied scores included, the pairs
  within 1e-6 of the threshold counted), ``pose_loss`` and ``obb_loss``
  (1e-5 relative);
- data: ``YoloPoseDataset`` (``flip_idx``) and ``YoloOBBDataset``, and
  ``read_yolo_obb``'s float64 angles, sample for sample against JAX's;
- tasks: one f32 step of each trainer (128 px), the validators' metrics,
  the predictors' keypoints and rotated boxes, ``Keypoints`` and
  ``OBBoxes`` against JAX's classes, the pose trainer's head check.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_heads import (check_step, f64_forward_pair, f64_gradients, jax_trainer,
                         patch_jax_predictor, port_trainer, seeded_graph, step_pair, val_state)
from torch_parity import assert_maps_close

IMGSZ, NC, STEP_IMGSZ = 64, 3, 128
GT_BOXES = [[[8, 8, 56, 60], [72, 16, 120, 56], [20, 72, 80, 120]],
            [[68, 68, 120, 116], [8, 12, 52, 80], [60, 8, 112, 52]]]


@pytest.fixture(scope="module", params=["yolov8n-pose", "yolov8n-obb"])
def head(request):
    """The seeded port graph of the head, its flax variables and the folded
    detector."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    graph, variables = seeded_graph(request.param, NC)
    det = YoloDetector(graph.spec, imgsz=IMGSZ, device="cpu")
    det.graph.load_state_dict(graph.state_dict())
    det._load()
    imgs = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return SimpleNamespace(name=request.param, graph=graph, variables=variables, det=det,
                           imgs=imgs)


def test_train_forward_matches_flax_in_f64(head):
    """Every output leaf (the three ``det`` maps and ``kpts_raw`` (B, A, 17,
    3) or ``angle`` (B, A, 1)) and every new running statistic within 1e-9;
    the angle within 5e-7: both heads take its sigmoid in f32 (flax casts
    the branch to f32), where the two libraries' sigmoids part by an ulp."""
    from kuzu_torch.bridge import _targets

    jout, jstats, tout, g64 = f64_forward_pair(head.graph, head.variables,
                                               head.imgs.astype(np.float64) / 255)
    assert len(jout) == len(tout) == 4
    for r, o in zip(jout, tout):
        tol = 5e-7 if head.name.endswith("obb") and r.shape[-1] == 1 else 1e-9
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol)
    n = 0
    for path, tensor, _ in _targets(g64):
        if path[0] == "batch_stats":
            want = jstats
            for key in path[1:]:
                want = want[key]
            np.testing.assert_allclose(tensor.numpy(), want, rtol=1e-9, atol=1e-11)
            n += 1
    assert n == 2 * sum(1 for m in g64.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_executor_matches_jax(head):
    """The BN-folded executor in bf16 against JAX's ``run_graph``: the same
    keys, the extra output in f32, each within ``maps_match``."""
    from kuzu.models.yolo.infer import run_graph

    spec = head.det.spec
    jm = jax.jit(lambda v, x: run_graph(spec, v, x, interpret=True))(
        head.variables, jnp.asarray(head.imgs))
    tm = head.det.infer(torch.from_numpy(head.imgs))
    extra = "kpts_raw" if head.name.endswith("pose") else "angle"
    assert set(jm) == set(tm) == {"det", extra}
    for a, b in zip(jm["det"], tm["det"]):
        assert_maps_close(a, b)
    assert jm[extra].dtype == jnp.float32 and tm[extra].dtype == torch.float32
    assert tuple(jm[extra].shape) == tuple(tm[extra].shape)
    assert_maps_close(jm[extra], tm[extra])


# ------------------------------------------------------------------ pose ops


def test_kpts_decode_and_oks_matrix_match_jax():
    """``kpts_decode`` exact (a multiply-add in f32 on both sides);
    ``oks_matrix`` (numpy on both sides) within 1e-6, 17 keypoints with
    visibility and 5 without."""
    from kuzu.models.yolo.modules import kpts_decode as j_decode
    from kuzu.ops.pose_loss import OKS_SIGMA_17 as J_SIGMA
    from kuzu.tasks.pose import oks_matrix as j_oks

    from kuzu_torch.models.yolo.modules import kpts_decode
    from kuzu_torch.ops.pose_loss import OKS_SIGMA_17
    from kuzu_torch.tasks.pose import oks_matrix

    rng = np.random.default_rng(0)
    anc = rng.uniform(0, 8, (84, 2)).astype(np.float32)
    raw = rng.normal(size=(2, 84, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(kpts_decode(torch.from_numpy(anc), torch.from_numpy(raw)),
                                  np.asarray(j_decode(jnp.asarray(anc), jnp.asarray(raw))))
    np.testing.assert_array_equal(OKS_SIGMA_17.numpy(), np.asarray(J_SIGMA))
    for k, d in ((17, 3), (5, 2)):
        gk = rng.uniform(0, 64, (4, k, d)).astype(np.float32)
        if d == 3:
            gk[..., 2] = rng.integers(0, 3, (4, k))
        else:
            gk[0, :2] = 0  # zero coordinates: invisible
        pk = gk[rng.integers(0, 4, 6)] + rng.normal(size=(6, k, d)).astype(np.float32) * 3
        gb = np.sort(rng.uniform(0, 64, (4, 2, 2)), 1).reshape(4, 4).astype(np.float32)
        want = j_oks(gk, pk, gb, np.asarray(J_SIGMA))
        assert np.isfinite(want).all() and want.max() > 0.1
        np.testing.assert_allclose(oks_matrix(gk, pk, gb, OKS_SIGMA_17.numpy()), want,
                                   rtol=1e-6, atol=1e-7)


def _head_outputs(name: str, size: int = STEP_IMGSZ, seed: int = 0):
    """The f32 train-mode outputs of a fresh seeded graph on seeded images."""
    graph = seeded_graph(name, NC)[0].train()
    imgs = np.random.default_rng(seed).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    with torch.no_grad():
        return graph(torch.from_numpy(imgs)), graph


def pose_batch(size: int = STEP_IMGSZ, seed: int = 0) -> dict:
    """Two seeded images, 3 GT slots each (one padding), 17 keypoints per GT
    inside its box, visibility 0, 1 or 2."""
    rng = np.random.default_rng(seed)
    boxes = np.array(GT_BOXES, np.float32) * (size / 128)
    kp = np.concatenate([rng.uniform(boxes[..., None, :2], boxes[..., None, 2:], (2, 3, 17, 2)),
                         rng.integers(0, 3, (2, 3, 17, 1))], -1).astype(np.float32)
    return {"image": rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8),
            "gt_labels": np.array([[0, 1, 2], [2, 0, 1]], np.int32), "gt_boxes": boxes,
            "gt_kpts": kp, "mask_gt": np.array([[1, 1, 1], [1, 1, 0]], bool)}


def test_pose_loss_matches_jax():
    """``pose_loss`` of the same f32 outputs: every term within 1e-5
    relative."""
    from kuzu.ops.pose_loss import pose_loss as j_loss

    from kuzu_torch.ops.pose_loss import pose_loss

    out, graph = _head_outputs("yolov8n-pose")
    b = pose_batch()
    kw = dict(nc=NC, imgsz=STEP_IMGSZ, strides=tuple(graph.spec.strides))
    jt, jm = jax.jit(lambda *a: j_loss(*a, **kw))(
        {"det": [jnp.asarray(f.numpy()) for f in out["det"]],
         "kpts_raw": jnp.asarray(out["kpts_raw"].numpy())},
        *(jnp.asarray(b[k]) for k in ("gt_labels", "gt_boxes", "gt_kpts", "mask_gt")))
    tt, tm = pose_loss(out, *(torch.from_numpy(b[k]) for k in
                              ("gt_labels", "gt_boxes", "gt_kpts", "mask_gt")), **kw)
    assert float(jm["num_fg"]) > 0
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------------------------------------------- OBB ops


def _rboxes(rng, n: int, lo: float = 0, hi: float = 64) -> np.ndarray:
    """n seeded xywhr boxes, angles over the head's range and beyond."""
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(2, 24, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def test_obb_geometry_matches_jax():
    """``probiou`` (pairs from disjoint to identical, degenerate boxes) and
    ``dist2rbox`` within 1e-6; ``rbox_corners`` within 1e-5 px;
    ``anchors_in_rboxes`` equal but for anchors within 1e-4 px of an edge
    (counted, none expected to differ elsewhere)."""
    from kuzu.ops import obb as J

    from kuzu_torch.ops import obb as T

    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, 64), _rboxes(rng, 64)
    b[:8] = a[:8]  # identical pairs
    a[8:12, 2] = 0.0  # a zero side
    # JAX's ops one by one, as written: jitted, XLA rewrites probIoU's
    # 1 - exp(-bd) near bd = eps (identical boxes: 0.999512 against 0.999532)
    j = lambda f, *x: np.asarray(f(*(jnp.asarray(v) for v in x)))
    t = lambda f, *x: f(*(torch.from_numpy(v) for v in x)).numpy()
    np.testing.assert_allclose(t(T.probiou, a[:, None], b[None]), j(J.probiou, a[:, None], b[None]),
                               rtol=0, atol=1e-6)
    dist = rng.uniform(0, 16, (2, 84, 4)).astype(np.float32)
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 84, 1)).astype(np.float32)
    anc = rng.uniform(0, 8, (84, 2)).astype(np.float32)
    np.testing.assert_allclose(t(T.dist2rbox, dist, ang, anc[None]),
                               j(J.dist2rbox, dist, ang, anc[None]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(t(T.rbox_corners, a), j(J.rbox_corners, a), rtol=0, atol=1e-5)
    pts = rng.uniform(0, 64, (400, 2)).astype(np.float32)
    gt = a.reshape(2, 32, 5)
    got, want = t(T.anchors_in_rboxes, pts, gt), j(J.anchors_in_rboxes, pts, gt)
    assert want.any()
    # the anchors' in-box coordinates: a disagreement only at an edge
    d = pts[None, None] - gt[..., None, :2]
    c, s = np.cos(gt[..., 4:5]), np.sin(gt[..., 4:5])
    u, v = d[..., 0] * c + d[..., 1] * s, -d[..., 0] * s + d[..., 1] * c
    edge = (np.abs(np.abs(u) - gt[..., None, 2] / 2) < 1e-4) | (
        np.abs(np.abs(v) - gt[..., None, 3] / 2) < 1e-4)
    np.testing.assert_array_equal(got[~edge], want[~edge])


@pytest.mark.parametrize("max_det", [20, 300])
def test_nms_rotated_matches_jax(max_det):
    """``nms_rotated_padded`` over 2 x 600 candidates of 2 classes, a
    quarter of the scores tied, many boxes overlapping: the kept boxes,
    scores, classes and validity equal JAX's scan exactly. The pairs of
    candidates whose probIoU lies within 1e-6 of the threshold are counted
    (printed with ``-s``): a difference there would be the two libraries'
    rounding, not the sweep."""
    from kuzu.ops.obb import nms_rotated_padded as j_nms
    from kuzu.ops.obb import probiou as j_probiou

    from kuzu_torch.ops.obb import nms_rotated_padded

    rng = np.random.default_rng(1)
    rb = np.stack([_rboxes(rng, 600, 0, 96) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, 600)).astype(np.float32)
    scores[:, ::4] = np.round(scores[:, ::4], 1)  # ties
    classes = rng.integers(0, 2, (2, 600)).astype(np.int32)
    valid = rng.random((2, 600)) < 0.95
    kw = dict(iou_threshold=0.45, score_threshold=0.2, max_det=max_det, max_nms=512)
    want = jax.jit(lambda *a: j_nms(*a, **kw))(jnp.asarray(rb), jnp.asarray(scores),
                                               jnp.asarray(classes), jnp.asarray(valid))
    got = nms_rotated_padded(torch.from_numpy(rb), torch.from_numpy(scores),
                             torch.from_numpy(classes), torch.from_numpy(valid), **kw)
    iou = np.asarray(jax.jit(lambda r: j_probiou(r[:, :, None], r[:, None]))(jnp.asarray(rb)))
    near = int((np.abs(iou - 0.45) < 1e-6).sum()) // 2
    print(f"candidate pairs within 1e-6 of the threshold: {near}")
    assert int(np.asarray(want["valid"]).sum()) > 20
    for k in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_greedy_keep_equals_the_scan():
    """The fixed point equals the one-by-one scan on random suppression
    matrices, long chains among them."""
    from kuzu_torch.ops.obb import greedy_keep

    rng = np.random.default_rng(2)
    for k, p in ((1, 0.5), (7, 0.9), (64, 0.05), (64, 0.5), (200, 0.02)):
        over = torch.from_numpy(rng.random((3, k, k)) < p)
        valid = torch.from_numpy(rng.random((3, k)) < 0.9)
        want = torch.zeros(3, k, dtype=torch.bool)
        for b in range(3):
            sup = torch.zeros(k, dtype=torch.bool)
            for i in range(k):
                alive = bool(valid[b, i] and not sup[i])
                want[b, i] = alive
                if alive:
                    sup |= over[b, i] & (torch.arange(k) > i)
        assert torch.equal(greedy_keep(over, valid), want)


def obb_batch(size: int = STEP_IMGSZ, seed: int = 0) -> dict:
    """Two seeded images, 3 rotated GTs each (one padding slot), their
    centres and sides from ``GT_BOXES``, angles in the head's range."""
    rng = np.random.default_rng(seed)
    boxes = np.array(GT_BOXES, np.float32) * (size / 128)
    ctr, wh = (boxes[..., :2] + boxes[..., 2:]) / 2, (boxes[..., 2:] - boxes[..., :2]) * 0.8
    r = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 3, 1))
    return {"image": rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8),
            "gt_labels": np.array([[0, 1, 2], [2, 0, 1]], np.int32),
            "gt_rboxes": np.concatenate([ctr, wh, r], -1).astype(np.float32),
            "mask_gt": np.array([[1, 1, 1], [1, 1, 0]], bool)}


def test_obb_loss_matches_jax():
    """``obb_loss`` (the rotated assignment: probIoU overlaps, the
    in-rotated-box gate) of the same f32 outputs: every term within 1e-5
    relative."""
    from kuzu.ops.obb import obb_loss as j_loss

    from kuzu_torch.ops.obb import obb_loss

    out, graph = _head_outputs("yolov8n-obb")
    b = obb_batch()
    kw = dict(nc=NC, imgsz=STEP_IMGSZ, strides=tuple(graph.spec.strides))
    jt, jm = jax.jit(lambda *a: j_loss(*a, **kw))(
        {"det": [jnp.asarray(f.numpy()) for f in out["det"]],
         "angle": jnp.asarray(out["angle"].numpy())},
        *(jnp.asarray(b[k]) for k in ("gt_labels", "gt_rboxes", "mask_gt")))
    tt, tm = obb_loss(out, *(torch.from_numpy(b[k]) for k in
                             ("gt_labels", "gt_rboxes", "mask_gt")), **kw)
    assert float(jm["num_fg"]) > 0
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_rotated_assigner_matches_jax():
    """``task_aligned_assign(rotated=True)`` on seeded predictions: the same
    foreground, GT indices and labels, targets within 1e-6."""
    from kuzu.ops.assigner import task_aligned_assign as j_assign

    from kuzu_torch.ops.assigner import task_aligned_assign

    rng = np.random.default_rng(3)
    anc = np.stack(np.meshgrid(np.arange(16) * 8 + 4.0, np.arange(16) * 8 + 4.0), -1)
    anc = anc.reshape(-1, 2).astype(np.float32)
    b = obb_batch()
    pd = np.concatenate([anc[None].repeat(2, 0) + rng.normal(size=(2, 256, 2)) * 2,
                         rng.uniform(10, 50, (2, 256, 2)),
                         rng.uniform(-0.7, 2.3, (2, 256, 1))], -1).astype(np.float32)
    sc = rng.uniform(0.01, 0.9, (2, 256, NC)).astype(np.float32)
    args = (sc, pd, anc, b["gt_labels"], b["gt_rboxes"], b["mask_gt"])
    want = j_assign(*(jnp.asarray(a) for a in args), num_classes=NC, rotated=True)
    got = task_aligned_assign(*(torch.from_numpy(a) for a in args), num_classes=NC,
                              rotated=True)
    assert np.asarray(want["fg_mask"]).sum() > 10
    for k in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("target_bboxes", "target_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------------ datasets


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    from kuzu_torch.testing import write_head_folder

    root = tmp_path_factory.mktemp("heads")
    return {task: write_head_folder(root / task, task, {"train": 4, "val": 4}, hw=(90, 120),
                                    nc=NC, seed=5)
            for task in ("pose", "obb")}


@pytest.mark.parametrize("task", ["pose", "obb"])
def test_dataset_matches_jax(task, folders):
    """Every training sample (augmented, two epochs) and validation sample:
    images and labels byte-equal, boxes, keypoints and rotated boxes (their
    float64 angles) within 1e-6."""
    import kuzu.data.yolo_dataset as J

    import kuzu_torch.data.yolo_dataset as T

    cls = "YoloPoseDataset" if task == "pose" else "YoloOBBDataset"
    for split, augment in (("train", True), ("val", False)):
        kw = dict(split=split, imgsz=IMGSZ, max_boxes=8, augment=augment, seed=3)
        port, ref = getattr(T, cls)(folders[task], **kw), getattr(J, cls)(folders[task], **kw)
        if task == "pose":
            assert port.flip_idx == ref.flip_idx and len(port.flip_idx) == 17
        for epoch in (0, 1) if augment else (0,):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ref)):
                got, want = port[i], ref[i]
                assert set(got) == set(want)
                for k in ("image", "gt_labels", "mask_gt"):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                for k in set(want) - {"image", "gt_labels", "mask_gt"}:
                    np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


# --------------------------------------------------------------------- tasks


@pytest.mark.parametrize("task", ["pose", "obb"])
def test_trainer_step_matches_jax(task):
    """One f32 step of ``PoseTrainer.loss_fn`` / ``OBBTrainer.loss_fn``
    against JAX's under ``value_and_grad`` and the optax chain: every check
    of the detector's step pair (pose: the gradients against f64's)."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    import kuzu.tasks.obb as JO
    import kuzu.tasks.pose as JP

    import kuzu_torch.tasks.obb as TO
    import kuzu_torch.tasks.pose as TP

    name = f"yolov8n-{task}"
    graph, variables = seeded_graph(name, NC)
    jcls, tcls = (JP.PoseTrainer, TP.PoseTrainer) if task == "pose" else (JO.OBBTrainer,
                                                                           TO.OBBTrainer)
    jt = jax_trainer(jcls, {}, imgsz=STEP_IMGSZ,
                     detector=JaxDetector(name, nc=NC, imgsz=STEP_IMGSZ))
    tt = port_trainer(tcls, {}, graph.spec, STEP_IMGSZ)
    batch = pose_batch() if task == "pose" else obb_batch()
    pair = step_pair(graph, variables, jt.loss_fn, tt.loss_fn, batch)
    if task == "pose":
        # one stem gradient entry of the two f32 sides parts by 2% of itself
        # (5.0e-5 against the leaf's 4.2e-5 tolerance): held against the f64
        # gradients, the port's vector lies 6.4e-5 from them, JAX's 9.0e-5
        check_step(pair, ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg", "kpt_loss",
                          "kobj_loss"), exact=f64_gradients(graph.spec, tt.loss_fn, pair))
    else:
        check_step(pair, ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"))


def test_validator_and_predictor_match_jax(head, folders, tmp_path, monkeypatch):
    """The trainer's validation of the folder's val split within 1e-6 of
    JAX's (box and OKS pose mAP; probIoU mAP and P/R/F1), and the predictor
    over the val images against JAX's on the same folded bf16 executor: the
    same detections, keypoints within 0.05 px (visibility 1e-4), rotated
    boxes within 1e-3 px (angles 1e-5)."""
    import kuzu.tasks.obb as JO
    import kuzu.tasks.pose as JP
    from kuzu.core.config import load_config as j_config
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    import kuzu_torch.tasks.obb as TO
    import kuzu_torch.tasks.pose as TP
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer

    task = head.name.split("-")[1]
    J, T = (JP, TP) if task == "pose" else (JO, TO)
    jtrain, ttrain = (J.PoseTrainer, T.PoseTrainer) if task == "pose" else (J.OBBTrainer,
                                                                            T.OBBTrainer)
    ov = dict(data=str(folders[task]), model=head.name, imgsz=IMGSZ, batch=2, workers=0)
    jt = jtrain(j_config(overrides=dict(ov, project=str(tmp_path / "j"))))
    _, jt.val_loader = jt.build_datasets()
    jt.imgsz = IMGSZ
    jt.detector = JaxDetector(head.name, nc=NC, dtype=jnp.bfloat16, imgsz=IMGSZ)
    want = jt.validate(val_state(head.variables))
    tt = ttrain(load_config(overrides=dict(ov, project=str(tmp_path / "t"))), device="cpu")
    tt.train_loader, tt.val_loader = tt.build_datasets()
    model = tt.build_model()
    model.load_state_dict(head.graph.state_dict())
    got = tt.validate(TrainState(model, build_optimizer(tt.cfg, model), use_ema=False))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k

    jdet = JaxDetector(head.name, nc=NC, dtype=jnp.bfloat16, imgsz=IMGSZ)
    patch_jax_predictor(monkeypatch, head.det, jdet)
    images = sorted((folders[task].parent / "images" / "val").glob("*.png"))
    jpred = J.PosePredictor if task == "pose" else J.OBBPredictor
    tpred = T.PosePredictor if task == "pose" else T.OBBPredictor
    jp = jpred(j_config(overrides=dict(conf=0.005, max_det=20, batch=4)))
    tp = tpred.from_detector(head.det, conf=0.005, max_det=20)
    tp.cfg["batch"] = 4
    wres, gres = jp(images), tp(images)
    assert len(gres) == len(wres) == 4
    for g, w in zip(gres, wres):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3, rtol=0)
        if task == "pose":
            np.testing.assert_allclose(g.keypoints.xy, w.keypoints.xy, atol=0.05, rtol=0)
            np.testing.assert_allclose(g.keypoints.conf, w.keypoints.conf, atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(g.obb.xywhr[:, :4], w.obb.xywhr[:, :4], atol=1e-3, rtol=0)
            np.testing.assert_allclose(g.obb.xywhr[:, 4], w.obb.xywhr[:, 4], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g.obb.conf, w.obb.conf, rtol=1e-6, atol=0)


def test_results_classes_match_jax():
    """``Keypoints`` (xy, conf; none without visibility) and ``OBBoxes``
    (xywhr, xyxyxyxy within 1e-5 px) on the same arrays as JAX's classes."""
    from kuzu.tasks.obb import OBBoxes as JOBB
    from kuzu.tasks.pose import Keypoints as JKeypoints

    from kuzu_torch.api.results import Keypoints, OBBoxes

    rng = np.random.default_rng(4)
    for d in (3, 2):
        kp = rng.uniform(0, 50, (4, 17, d)).astype(np.float32)
        got, want = Keypoints(kp, (50, 60)), JKeypoints(kp, (50, 60))
        assert len(got) == len(want) == 4
        np.testing.assert_array_equal(got.xy, want.xy)
        if d == 3:
            np.testing.assert_array_equal(got.conf, want.conf)
        else:
            assert got.conf is None and want.conf is None
    rb = _rboxes(rng, 6)
    conf, cls = rng.random(6).astype(np.float32), rng.integers(0, 3, 6)
    got, want = OBBoxes(rb, conf, cls), JOBB(rb, conf, cls)
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got.xywhr, want.xywhr)
    np.testing.assert_allclose(got.xyxyxyxy, want.xyxyxyxy, rtol=0, atol=1e-5)


def test_pose_trainer_refuses_a_detect_model(folders, tmp_path):
    """A detect-head model under the pose task fails in ``build_model`` with
    JAX's message naming the fix (``tests/test_pose.py``'s check)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.pose import PoseTrainer

    cfg = load_config(overrides=dict(task="pose", model="yolov8n", data=str(folders["pose"]),
                                     epochs=1, batch=2, imgsz=64, max_boxes=4, workers=0,
                                     project=str(tmp_path / "runs"), name="mismatch",
                                     exist_ok=True))
    with pytest.raises(ValueError, match="detect head.*pose.*yolov8n-pose"):
        PoseTrainer(cfg, device="cpu").train()
