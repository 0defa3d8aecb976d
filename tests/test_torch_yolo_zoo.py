"""The rest of the YOLO detect zoo in the port against the JAX package on the
CPU: yolov8 (the v8 Detect head), yolov9c (RepNCSPELAN4, ADown, SPPELAN),
yolov10 (SCDown, C2fCIB, PSA, the dual head, NMS-free selection, the E2E
loss) and yolo11 (C2PSA, SPPF).

Each family at its n scale (yolov9c has one) at 64 px, batch 2, nc 3, on the
port's seeded weights handed to JAX through the inverse bridge
(``torch_parity.flax_variables``: no JAX init compile). The JAX side is jitted
once per family in module-scoped fixtures. Criteria:

- BN-folded executor (bf16): the raw maps (yolov10: its one2one head, the
  one inference decodes) under ``assert_maps_close``; decoded detections under ``detections_match``;
- train-mode forward: the whole graph in f64 (maps and new BatchNorm
  statistics within 1e-9, 1e-6 where PSA attention runs in f32), and each
  new block in bf16 (the port no farther from the f64 forward than JAX);
- ``nms_free_select``: equal, ties included;
- one f32 train step of yolo11n and yolov10n through
  ``test_torch_train_step.run_step_pair`` and its checks;
- ``DetectPredictor`` of yolo11n and yolov10n against JAX's predictor.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.testing import detections_match, f32
from torch_parity import assert_maps_close, flax_variables, numpy_tree

FAMILIES = ["yolov8n", "yolo11n", "yolov10n", "yolov9c"]
IMGSZ = 64
CONF = 0.001  # seeded scores are ~sigmoid(-4.6) ~ 0.01
# The published parameter counts (tests/test_yolo_graph.py; yolo11x and
# yolov10x from their yaml's comments). JAX counts each less 16: the
# reference's frozen DFL conv is an einsum in both packages.
PUBLISHED = {"yolov8n": 3_157_200, "yolo11n": 2_624_080, "yolo11s": 9_458_752,
             "yolov10n": 2_775_520, "yolov10s": 8_128_272, "yolov9c": 25_590_912,
             "yolo11x": 56_966_176, "yolov10x": 31_808_960}


def _heads(maps) -> dict:
    """Raw maps by head: ``{"": maps}``, or yolov10's two."""
    return maps if isinstance(maps, dict) else {"": maps}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family: the port's seeded detector, its flax variables, JAX's
    bf16 detector and both packages' folded-executor maps of one batch."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.models.yolo.infer import run_graph

    from kuzu_torch.models.yolo.detector import YoloDetector

    name = request.param
    tdet = YoloDetector(name, nc=3, imgsz=IMGSZ, device="cpu").init(0)
    variables = flax_variables(tdet.graph)
    jdet = JaxDetector(name, nc=3, dtype=jnp.bfloat16, imgsz=IMGSZ)
    imgs = np.random.default_rng(0).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    jmaps = jax.jit(lambda v, x: run_graph(jdet.spec, v, x, interpret=True))(
        variables, jnp.asarray(imgs))
    return SimpleNamespace(name=name, tdet=tdet, jdet=jdet, variables=variables, imgs=imgs,
                           jmaps=jmaps, tmaps=tdet.infer(torch.from_numpy(imgs)))


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_param_count_matches_jax(name):
    from kuzu_torch.models.yolo.detector import YoloDetector

    assert YoloDetector(name, nc=80, device="cpu").param_count() == PUBLISHED[name] - 16


def test_bridge_consumes_every_leaf(family):
    """The flax graph's own init tree (its shapes, from ``eval_shape``) loads
    into a fresh port graph: ``from_flax`` raises on a leaf left over, one
    missing or one of another shape."""
    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo.graph import YoloGraph

    jdet = family.jdet
    shapes = jax.eval_shape(lambda: jdet.module.init(
        jax.random.key(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_leaves = len(jax.tree.leaves(tree))
    graph = YoloGraph(family.tdet.spec)
    from_flax(graph, tree)
    n_port = sum(1 for _ in graph.parameters()) + 2 * sum(
        1 for m in graph.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert n_port == n_leaves


def test_run_graph_matches_jax(family):
    """The BN-folded executor in bf16, the raw maps of the head inference
    decodes: yolov10's one2one alone (JAX's also returns one2many's, which
    its jitted callers drop; the f64 train-forward test holds both)."""
    jm, tm = _heads(family.jmaps), _heads(family.tmaps)
    assert set(jm) == ({"one2many", "one2one"} if family.name == "yolov10n" else {""})
    assert set(tm) == ({"one2one"} if family.name == "yolov10n" else {""})
    for head in tm:
        assert len(jm[head]) == len(tm[head]) == 3
        for r, o in zip(jm[head], tm[head]):
            assert tuple(r.shape) == tuple(o.shape) == (2, *o.shape[1:3], 64 + 3)
            assert_maps_close(r, o)


def test_detections_match_jax(family):
    """Decode (yolov10: its one2one head) and the family's selection, NMS or
    NMS-free, on each side: valid counts within 10% and >= 90% matched both
    ways (``detections_match``)."""
    from kuzu.ops.nms import nms_free_select as j_free
    from kuzu.ops.nms import non_max_suppression as j_nms

    jdet, tdet = family.jdet, family.tdet
    jpred = jdet.decode(family.jmaps)
    jd = j_free(jpred, conf_thres=CONF) if jdet.spec.end2end else j_nms(jpred, conf_thres=CONF)
    td = tdet.select(tdet.decode(family.tmaps), CONF, 0.45, 300)
    jn, tn = f32(jd["valid"]).sum(1), f32(td["valid"]).sum(1)
    assert (jn > 0).all()
    assert (np.abs(jn - tn) <= 0.1 * jn).all(), (jn, tn)
    assert detections_match(jd, td) >= 0.9 and detections_match(td, jd) >= 0.9


def test_train_forward_matches_flax_in_f64(family):
    """The training forward (batch statistics) in f64 on both sides, so
    that the comparison sees the arithmetic and not f32's rounding, which
    64 px maps at batch 2 amplify through the BatchNorms of the 2 x 2 P5
    level: every head's maps and the new running statistics of every
    BatchNorm against flax's ``apply(train=True)`` within 1e-9; within 1e-6
    for yolo11n and yolov10n, whose PSA attention runs in f32 on both sides
    (flax's ``preferred_element_type``), summed in another order. Pixels go
    in as x / 255 already in f64: jitted, JAX's uint8 path divides by a
    reciprocal in f32. The bf16 rounding points of the new blocks are held
    by ``test_block_train_forward_matches_flax_in_bf16``."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    from kuzu_torch.bridge import _targets
    from kuzu_torch.models.yolo.graph import YoloGraph

    x = family.imgs.astype(np.float64) / 255.0
    with jax.enable_x64(True):
        jdet = JaxDetector(family.name, nc=3, dtype=jnp.float64, imgsz=IMGSZ)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), family.variables)
        jmaps, mutated = jax.jit(lambda v, x: jdet.module.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        jmaps = {h: [np.asarray(m) for m in maps] for h, maps in _heads(jmaps).items()}
        js = numpy_tree(mutated["batch_stats"])
    graph = YoloGraph(family.tdet.spec, dtype=torch.float64)
    graph.load_state_dict(family.tdet.graph.state_dict())
    graph.double().train()
    with torch.no_grad():
        tmaps = _heads(graph(torch.from_numpy(x)))
    tol = 1e-6 if family.name in ("yolo11n", "yolov10n") else 1e-9
    for head in jmaps:
        for r, o in zip(jmaps[head], tmaps[head]):
            np.testing.assert_allclose(o.numpy(), r, rtol=tol, atol=tol, err_msg=head)
    n = 0
    for path, tensor, _ in _targets(graph):
        if path[0] == "batch_stats":
            want = js
            for key in path[1:]:
                want = want[key]
            np.testing.assert_allclose(tensor.numpy(), want, rtol=tol, atol=1e-2 * tol,
                                       err_msg="/".join(path))
            n += 1
    assert n == 2 * sum(1 for m in graph.modules() if isinstance(m, torch.nn.BatchNorm2d))


BLOCKS = {  # the port module and the flax one, (c1, args)
    "ADown": (32, (64,)),
    "SPPELAN": (32, (48, 16)),
    "RepNCSPELAN4": (32, (48, 32, 16, 1)),
    "SCDown": (32, (64, 3, 2)),
    "C2fCIB": (32, (32, True, True)),
    "PSA": (128, (128,)),
    "C2PSA": (128, (128,)),
    "C2f": (32, (32, True)),
    "SPPF": (32, (32, 5)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_train_forward_matches_flax_in_bf16(block):
    """Each new block in training mode in bf16 (flax's rounding points: a
    conv's output in bf16, BatchNorm in f32 cast back, adds and pools in
    bf16, PSA attention's f32 scores and its softmax cast to bf16), on an
    8 x 8 map of batch 2, against flax's jitted ``apply(train=True)``. The
    batch statistics renormalise each conv's rounding, so two bf16 runs
    part by up to ~0.1 on O(1) outputs, past the raw-map criteria; and
    jitted on the CPU XLA takes a bf16 conv's statistics from its f32
    result where flax's graph rounds it first. So both bf16 runs are held
    against flax's f64 forward of the block on the same bf16 input and
    weights: the port's RMS error on the output within 0.6x-1.1x JAX's, on
    every BatchNorm's new running statistics within 0.6x-1.25x JAX's, whose
    statistics read the unrounded conv results (ratios seen: output
    0.83-1.05, statistics 0.73-1.17). The lower bounds fail a port that
    skips flax's bf16 rounding points: one running the blocks in f32 reads
    at most 2e-3x."""
    import kuzu.models.yolo.modules as JM

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo import modules as M

    c1, args = BLOCKS[block]
    x = np.random.default_rng(7).normal(0, 1, (2, 8, 8, c1)).astype(np.float32)
    jm = getattr(JM, block)(*args, dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    variables = jax.jit(lambda r: jm.init(r, xj, False))(jax.random.key(3))
    jy, mutated = jax.jit(lambda v: jm.apply(v, xj, True, mutable=["batch_stats"]))(variables)
    with jax.enable_x64(True):
        jm64 = getattr(JM, block)(*args, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ey, emut = jax.jit(lambda v, x: jm64.apply(v, x, True, mutable=["batch_stats"]))(
            v64, jnp.asarray(np.asarray(xj.astype(jnp.float32)), jnp.float64))
        ey, es = np.asarray(ey), numpy_tree(emut["batch_stats"])
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    tm = getattr(M, block)(c1, *args)
    from_flax(tm, numpy_tree(variables))
    with torch.no_grad():
        ty = tm.train()(xt.contiguous(memory_format=torch.channels_last))
    names = [n for n, _ in tm.named_buffers() if "running" in n]
    bufs = dict(tm.named_buffers())

    def flax_stats(tree):
        out = []
        for n in names:
            leaf = tree
            for key in n.replace("running_", "").split("."):
                leaf = leaf[key]
            out.append(np.asarray(leaf, np.float64).ravel())
        return np.concatenate(out)

    port = (ty.double().permute(0, 2, 3, 1).numpy(),
            torch.cat([bufs[n].double().ravel() for n in names]).numpy())
    jax_run = (np.asarray(jy.astype(jnp.float32), np.float64),
               flax_stats(numpy_tree(mutated["batch_stats"])))
    exact = (ey, flax_stats(es))
    for i, what in enumerate(("output", "statistics")):
        ours = float(np.sqrt(((port[i] - exact[i]) ** 2).mean()))
        ref = float(np.sqrt(((jax_run[i] - exact[i]) ** 2).mean()))
        lo, hi = ((0.6, 1.1), (0.6, 1.25))[i]
        assert lo * ref <= ours <= hi * ref, (what, ours / ref, ours, ref)


def _tied_prediction(b: int, a: int, nc: int, seed: int) -> np.ndarray:
    """(B, 4 + nc, A) xywh boxes and scores drawn from 8 levels: many anchors
    tie on their best score and many (anchor, class) pairs on a score."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(8, 56, (b, 2, a)), rng.uniform(2, 20, (b, 2, a))], 1)
    scores = rng.integers(0, 8, (b, nc, a)) / 8.0
    return np.concatenate([boxes, scores], 1).astype(np.float32)


@pytest.mark.parametrize("a,nc,max_det", [(84, 3, 300), (84, 3, 20), (336, 1, 50),
                                          (200, 5, 200)])
def test_nms_free_select_matches_jax_exactly(a, nc, max_det):
    """Padding (max_det above the anchors), a cut through tied scores, one
    class, and k = A: every output equal, ties resolved lower index first
    as ``jax.lax.top_k`` resolves them."""
    from kuzu.ops.nms import nms_free_select as j_free

    from kuzu_torch.ops.nms import nms_free_select

    pred = _tied_prediction(2, a, nc, seed=a + nc)
    want = j_free(jnp.asarray(pred), conf_thres=0.3, max_det=max_det)
    got = nms_free_select(torch.from_numpy(pred), conf_thres=0.3, max_det=max_det)
    assert got["boxes"].shape == (2, max_det, 4)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("name", ["yolov8n", "yolov10n"])
def test_seeded_detect_biases_are_flax(name):
    """The legacy head and both of yolov10's heads get flax's Detect biases:
    1.0 on the box leaves, -4.6 on the class leaves, in every level."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector(name, nc=3, imgsz=IMGSZ, device="cpu").init(0)
    leaves = {n: p for n, p in det.graph.named_parameters()
              if "Detect" in n and n.endswith("_2.bias")}
    heads = 2 if name == "yolov10n" else 1
    assert len(leaves) == 2 * 3 * heads
    for n, p in leaves.items():
        assert torch.equal(p, torch.full_like(p, 1.0 if "box" in n else -4.6)), n
    if name == "yolov8n":
        assert det.spec.legacy_head and hasattr(det.graph.n22_Detect, "cls0_0")


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolov8n-pose", "yolov8n-obb", "yolov8n-cls"])
def test_other_task_heads_name_their_slice(name):
    """The other tasks' heads build now (their slice is ported): the
    Segment, Pose and OBB detectors run the BN-folded executor; Classify
    has no folded route, as in JAX, and its executor says so."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector(name, nc=3, imgsz=IMGSZ, device="cpu").init(0)
    images = torch.zeros(1, IMGSZ, IMGSZ, 3, dtype=torch.uint8)
    if name.endswith("cls"):
        with pytest.raises(NotImplementedError, match="Classify has no BN-folded route"):
            det.infer(images)
    else:
        assert set(det.infer(images)) >= {"det"}


# ------------------------------------------------------------------ training


@pytest.fixture(scope="module")
def yolo11n_pair():
    from test_torch_train_step import run_step_pair

    return run_step_pair(arch="yolo11n", detect_biases="flax")


@pytest.fixture(scope="module")
def yolov10n_pair():
    from test_torch_train_step import run_step_pair

    return run_step_pair(arch="yolov10n", detect_biases="flax")


def test_yolo11n_step_matches_jax(yolo11n_pair):
    """yolo11n@128 on the seeded init's flax biases: every check of the
    yolov12n pair (loss terms and gradient norm 1e-5, every gradient leaf,
    the statistics, the weights and EMA after the update)."""
    from test_torch_train_step import check_batch_stats, check_gradients, check_loss, \
        check_update

    check_loss(yolo11n_pair)
    check_gradients(yolo11n_pair)
    check_batch_stats(yolo11n_pair)
    check_update(yolo11n_pair, "params")
    check_update(yolo11n_pair, "ema")


def test_yolov10n_e2e_step_matches_jax(yolov10n_pair):
    """yolov10n@128, the E2E loss of both heads, on flax's biases: the loss
    terms (1e-5), the statistics and the update as the yolov12n pair's; the
    gradients, whose norm parts from JAX's by ~1.1e-5 here as yolov12n's
    does on these biases, held against the f64 gradients of JAX's graph as
    ``test_flax_biases_gradients_against_f64`` holds that pair."""
    from test_torch_train_step import check_batch_stats, check_gradients_against_f64, \
        check_loss, check_update

    check_loss(yolov10n_pair, keys=("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"))
    check_gradients_against_f64(yolov10n_pair)
    check_batch_stats(yolov10n_pair)
    check_update(yolov10n_pair, "params")
    check_update(yolov10n_pair, "ema")


def test_yolov10n_one2one_trains_its_head_alone(yolov10n_pair):
    """The one2one term's gradient reaches the one2one head and nothing
    else: the backbone and the one2many head learn from one2many alone."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.ops.detect_loss import detection_loss

    det = YoloDetector("yolov10n", nc=3, imgsz=128, device="cpu").init(0)
    graph = det.graph.float().train()
    b = {k: torch.from_numpy(v) for k, v in yolov10n_pair["batch"].items()}
    feats = graph(b["image"])
    loss, _ = detection_loss(feats["one2one"], b["gt_labels"], b["gt_boxes"], b["mask_gt"],
                             nc=3, imgsz=128, strides=det.strides, topk=1)
    loss.backward()
    reached = {n for n, p in graph.named_parameters()
               if p.grad is not None and bool(p.grad.abs().sum() > 0)}
    assert all(".one2one." in n for n in reached), sorted(reached)
    # the class BCE spans every anchor: every level's class branch learns
    assert all(f"n23_v10Detect.one2one.cls{i}_2.weight" in reached for i in range(3))


@pytest.fixture(scope="module")
def yolo11n_remat(tmp_path_factory):
    from test_torch_remat import _step

    tmp = tmp_path_factory.mktemp("remat11")
    return _step(False, tmp, "yolo11n"), _step(True, tmp, "yolo11n")


def test_yolo11n_remat_step_matches_plain(yolo11n_remat):
    """``remat`` recomputes the C3k2 and C2PSA blocks (9 block forwards a
    plain step, 18 under remat) and changes nothing: loss and gradients
    within the remat tolerances, equal statistics."""
    from test_torch_remat import check_remat_pair, check_remat_stats

    plain, remat = yolo11n_remat
    assert (plain["block_calls"], remat["block_calls"]) == (9, 18)
    check_remat_pair(yolo11n_remat)
    check_remat_stats(yolo11n_remat)


# ---------------------------------------------------------------- predictor


@pytest.mark.parametrize("name", ["yolo11n", "yolov10n"])
def test_detect_predictor_matches_jax(name):
    """``DetectPredictor`` over three pages of three shapes, batch 2, against
    JAX's predictor on the same weights (its bf16 executor): the same boxes
    (1e-3 px), scores (an f32 ulp) and classes. The box biases make the
    boxes differ by level; class scores stay near sigmoid(-4.6), so
    yolov10n's top-k sorts close and tied scores."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import box_head, mixed_pages
    from torch_parity import jax_detect_predictor

    pages = mixed_pages([(80, 60), (50, 75), (64, 64)], seed=5)
    det = box_head(YoloDetector(name, nc=2, imgsz=IMGSZ, device="cpu").init(0), (1, 3, 1, 3))
    jp = jax_detect_predictor(det, name, conf=CONF, max_det=30, pad_to=2, batch=2)
    tp = DetectPredictor.from_detector(det, conf=CONF, iou=0.7, max_det=30)
    tp.cfg["batch"] = 2
    want, got = jp(list(pages)), tp(list(pages))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)


@pytest.mark.parametrize("name", ["yolov9c", "yolov10n"])
def test_run_dir_loads_into_predictor_model_and_cascade(name, tmp_path):
    """A run dir of the family (``args.yaml``, ``data_spec.yaml`` and
    ``weights/`` as ``DetectTrainer`` writes them) loads into
    ``DetectPredictor``, the ``Model`` facade and the cascade's detectors,
    each giving the detections of the same weights in memory (NMS, or
    yolov10's NMS-free selection)."""
    import yaml

    from kuzu_torch.api.model import Model
    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import box_head, mixed_pages

    load_config(overrides={"task": "detect", "model": name, "imgsz": IMGSZ}).to_yaml(
        tmp_path / "args.yaml")
    (tmp_path / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 2, "names": {0: "a", 1: "b"}}))
    det = box_head(YoloDetector(name, nc=2, imgsz=IMGSZ, device="cpu").init(4), (1, 3, 1, 3))
    CheckpointManager(tmp_path / "weights").save(
        TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1)), fitness=1.0)
    pages = mixed_pages([(80, 60), (64, 64)], seed=9)
    want = DetectPredictor.from_detector(det, conf=CONF, max_det=20)(list(pages))
    got = {
        "predictor": DetectPredictor(load_config(overrides={"model": str(tmp_path), "conf": CONF,
                                                            "max_det": 20}), device="cpu"),
        "model": lambda src: Model(str(tmp_path), device="cpu").predict(src, conf=CONF,
                                                                        max_det=20),
        "cascade": KuzushijiPipeline(column_model=str(tmp_path), col_conf=CONF,
                                     device="cpu").column_det,
    }
    got["cascade"].max_det = 20
    for kind, pred in got.items():
        res = pred(list(pages))
        assert [len(r) for r in res] == [len(r) for r in want] == [20, 20], kind
        for g, w in zip(res, want):
            np.testing.assert_array_equal(g.boxes.xyxy, w.boxes.xyxy, err_msg=kind)
            np.testing.assert_array_equal(g.boxes.conf, w.boxes.conf, err_msg=kind)
