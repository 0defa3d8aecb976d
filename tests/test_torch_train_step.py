"""One training step of yolov12n@128, batch 2, in f32, the port against the
JAX package: the port's ``make_train_step`` against
``kuzu.core.train.make_train_step(has_model_state=True)`` over the JAX
``DetectTrainer.loss_fn`` equivalent (train-mode flax apply, mutable
``batch_stats``, ``detection_loss``), as ``tests/test_train_accumulate.py``
drives it. Default hyperparameters with ``warmup_epochs=0``, so the one step
moves the weights: clipping at 10 (the gradient norm is far above it),
weight decay on the kernels, Nesterov SGD, the EMA.

Both sides start from the port's seeded weights (passed to JAX through the
inverse bridge; their Detect biases flax's, or set to 0), see the same uint8 images and the same GTs: three boxes
per image that do not overlap, chosen so that no assignment decision is a
near-tie (checked below). In f32 the JAX einsum attention route and the
port's plain AreaAttention route are the same arithmetic, so differences
are the order of f32 sums through the network: tolerances are stated at
each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import flax_variables, numpy_tree

STEP_OVERRIDES = dict(warmup_epochs=0, epochs=1)
GT_BOXES = [[[8, 8, 40, 44], [60, 10, 96, 40], [20, 70, 60, 110]],
            [[70, 70, 110, 100], [10, 20, 40, 60], [50, 30, 90, 60]]]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


_JAX_STEPS: dict = {}  # (arch, remat) -> (detector, optimizer, jitted step), compiled once


def jax_step(remat: bool, arch: str = "yolov12n"):
    """JAX's detector, optimizer and train step for the pair, built once per
    ``(arch, remat)`` so that every pair of a process shares one compile:
    the optimizer chain wrapped so that its state also carries the
    gradients it was handed. The loss is the JAX trainer's choice: the E2E
    loss for yolov10's dual head, else the v8 loss."""
    if (arch, remat) in _JAX_STEPS:
        return _JAX_STEPS[arch, remat]
    from kuzu.core.config import load_config as j_config
    from kuzu.core.train import build_optimizer as j_optimizer
    from kuzu.core.train import make_train_step as j_step
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.ops.detect_loss import detection_loss, e2e_detection_loss

    jdet = JaxDetector(arch, nc=3, dtype=jnp.float32, imgsz=128, remat=remat)
    j_loss = e2e_detection_loss if jdet.spec.end2end else detection_loss
    strides = tuple(jdet.strides)
    base = j_optimizer(j_config(overrides=STEP_OVERRIDES), 1)

    def update(g, s, p=None):
        u, inner = base.update(g, s[0], p)
        return u, (inner, g)

    tx = optax.GradientTransformation(
        lambda p: (base.init(p), jax.tree.map(jnp.zeros_like, p)), update)

    def j_loss_fn(params, model_state, b, _rng):
        feats, mutated = jdet.apply({"params": params, **model_state}, b["image"], train=True,
                                    mutable=["batch_stats"])
        total, metrics = j_loss(feats, b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=3,
                                imgsz=128, strides=strides)
        return total, (metrics, dict(mutated))

    _JAX_STEPS[arch, remat] = (jdet, tx, j_step(j_loss_fn, tx, has_model_state=True,
                                                donate=False))
    return _JAX_STEPS[arch, remat]


def run_step_pair(remat: bool = False, detect_biases: str = "flax",
                  batch: dict | None = None, arch: str = "yolov12n") -> dict:
    """The step of ``arch`` on both sides; with ``remat`` each block of both
    graphs is rematerialized in the backward (flax's ``nn.remat``, the
    port's ``torch.utils.checkpoint``). ``detect_biases``: ``"flax"`` keeps
    the seeded init's Detect biases (box 1.0, cls -4.6, flax's), ``"zero"``
    sets them to 0. ``batch``: 2 images of 128 with 3 GT slots each
    (default: seeded noise and ``GT_BOXES``). ``maps`` in the result are
    the port's (for yolov10 its one2many head's)."""
    from kuzu.core.train import init_state

    from kuzu_torch.bridge import _targets
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.models.yolo.graph import YoloGraph
    from kuzu_torch.ops.detect_loss import detection_loss, e2e_detection_loss
    from kuzu_torch.ops.flash_attention import area_attention

    jdet, tx, step = jax_step(remat, arch)
    graph = YoloGraph(jdet.spec, dtype=torch.float32, remat=remat)
    graph.reset_parameters(torch.Generator().manual_seed(0))
    if detect_biases == "zero":
        for name, p in graph.named_parameters():
            if "Detect" in name and name.endswith("_2.bias"):  # every head's
                with torch.no_grad():
                    p.zero_()
    # copies: numpy views of the port's buffers would let the port's step,
    # which updates the running statistics in place, race JAX's dispatch
    variables = jax.tree.map(lambda a: jnp.array(a, copy=True), flax_variables(graph))

    if batch is None:
        rng = np.random.default_rng(0)
        batch = {
            "image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
            "gt_labels": np.array([[0, 1, 2], [2, 0, 1]], np.int32),
            "gt_boxes": np.array(GT_BOXES, np.float32),
            "mask_gt": np.array([[1, 1, 1], [1, 1, 0]], bool),
        }
    strides = tuple(jdet.strides)

    state = init_state(variables["params"], tx, use_ema=True,
                       model_state={"batch_stats": variables["batch_stats"]})
    jstate, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.key(0))
    jax.block_until_ready((jstate, jmetrics))

    # the port
    topt = build_optimizer(load_config(overrides=STEP_OVERRIDES), graph, 1)
    tstate = TrainState(graph, topt)
    grads, maps = {}, []
    update = topt.step

    def snapshot_then_step(count, grad_norm):  # foreach SGD may edit .grad
        grads.update({n: p.grad.detach().clone() for n, p in graph.named_parameters()})
        update(count, grad_norm)

    topt.step = snapshot_then_step

    t_loss = e2e_detection_loss if jdet.spec.end2end else detection_loss

    def t_loss_fn(model, b):
        feats = model(b["image"])
        maps.append([f.detach() for f in (feats["one2many"] if isinstance(feats, dict)
                                          else feats)])
        return t_loss(feats, b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=3, imgsz=128,
                      strides=strides)

    k3_before = area_attention.plain_calls
    tmetrics = make_train_step(t_loss_fn, topt)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    names = {id(p): n for n, p in graph.named_parameters()}
    return dict(arch=arch, variables=variables, jstate=jstate, jmetrics=jmetrics,
                jgrads=numpy_tree(jstate.opt_state[1]),
                tstate=tstate, tmetrics=tmetrics, tgrads=grads, maps=maps[0], batch=batch,
                targets=list(_targets(graph)), names=names, strides=strides,
                k3_calls=area_attention.plain_calls - k3_before)


@pytest.fixture(scope="module")
def step_pair():
    """The pair on zero Detect biases, the weights these checks were first
    written for (the cls head's gradients then outweigh the backbone's)."""
    return run_step_pair(detect_biases="zero")


@pytest.fixture(scope="module")
def flax_bias_pair():
    """The pair on the seeded init's own Detect biases (flax's 1.0 / -4.6):
    the backbone's gradients then carry most of the gradient norm."""
    return run_step_pair(detect_biases="flax")


def test_no_near_tie_in_the_assignment(step_pair):
    assert_no_near_tie(step_pair)


def assert_no_near_tie(step_pair: dict) -> None:
    """Among each GT's in-box anchors the 10th and 11th align values (the
    top-k boundary) differ by more than 1e-3 relative, far above the f32
    differences between the two forwards, and no anchor lies in two GTs. A
    GT with fewer than 10 anchors of nonzero align takes them all: it has
    no boundary to tie at."""
    from kuzu_torch.ops.anchors import dist2bbox, make_anchors
    from kuzu_torch.ops.assigner import anchors_in_gts
    from kuzu_torch.ops.boxes import bbox_iou
    from kuzu_torch.models.yolo.modules import dfl_expectation

    maps, b = step_pair["maps"], step_pair["batch"]
    cat = torch.cat([f.reshape(2, -1, f.shape[-1]) for f in maps], 1)
    anc, st = make_anchors([(f.shape[1], f.shape[2]) for f in maps], step_pair["strides"])
    boxes = dist2bbox(dfl_expectation(cat[..., :64], 16), anc[None], xywh=False) * st[None]
    scores = torch.sigmoid(cat[..., 64:])
    gt = torch.from_numpy(b["gt_boxes"])
    labels = torch.from_numpy(b["gt_labels"]).long()
    ov = bbox_iou(gt[:, :, None], boxes[:, None], ciou=True).clamp(min=0)
    sc = torch.gather(scores.transpose(1, 2), 1, labels[:, :, None].expand(-1, -1, ov.shape[-1]))
    inside = anchors_in_gts(anc * st, gt)
    align = torch.where(inside, sc.sqrt() * ov**6, torch.zeros(()))
    top = align.sort(-1, descending=True).values
    boundary = top[..., 9] > 0
    gap = (top[..., 9] - top[..., 10]) / torch.where(boundary, top[..., 9], 1.0)
    mask = torch.from_numpy(b["mask_gt"])
    assert (gap[mask & boundary] > 1e-3).all(), gap
    assert ((inside & mask[..., None]).sum(1) <= 1).all()


def check_loss(pair: dict,
               keys=("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg", "grad_norm")) -> None:
    """f32 through the whole network and the loss: 1e-5 relative."""
    jm, tm = pair["jmetrics"], pair["tmetrics"]
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)


def flax_layout(kernel: np.ndarray) -> np.ndarray:
    """A port kernel in flax's layout: a conv's OIHW as HWIO, a Dense's
    (out, in) as (in, out)."""
    return kernel.transpose(2, 3, 1, 0) if kernel.ndim == 4 else kernel.T


def gradient_leaves(pair: dict, jtree):
    """(path, the port's gradient leaf in the flax layout, ``jtree``'s leaf)
    for every parameter."""
    tg, names = pair["tgrads"], pair["names"]
    for path, tensor, is_kernel in pair["targets"]:
        if path[0] != "params":
            continue
        got = tg[names[id(tensor)]].numpy()
        if is_kernel:
            got = flax_layout(got)
        yield path, got, _leaf(jtree, path[1:])


_EXACT: dict = {}  # arch -> the jitted f64 loss and gradient, compiled once a process


def _exact_step(arch: str, strides: tuple):
    """The f64 ``value_and_grad`` of ``arch``'s loss as a jitted function of
    (params, batch_stats, images, labels, boxes, mask): the weights and the
    batch are its arguments, so every pair of a process shares one compile."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.ops.detect_loss import detection_loss, e2e_detection_loss

    if arch not in _EXACT:
        jdet = JaxDetector(arch, nc=3, dtype=jnp.float64, imgsz=128)
        j_loss = e2e_detection_loss if jdet.spec.end2end else detection_loss

        def loss(params, stats, images, labels, boxes, mask):
            feats, _ = jdet.apply({"params": params, "batch_stats": stats}, images, train=True,
                                  mutable=["batch_stats"])
            return j_loss(feats, labels, boxes, mask, nc=3, imgsz=128, strides=strides)

        _EXACT[arch] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return _EXACT[arch]


def exact_gradients(pair: dict, with_metrics: bool = False):
    """The step's gradients in f64 through the JAX graph (x64 on for this
    call alone), from the pair's initial weights and batch: the exact
    function both f32 sides approximate; ``with_metrics``: (its loss terms
    as floats, the gradients)."""
    b = pair["batch"]
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        variables = f64(pair["variables"])
        (total, metrics), grads = _exact_step(pair["arch"], pair["strides"])(
            variables["params"], variables["batch_stats"], jnp.asarray(b["image"]),
            jnp.asarray(b["gt_labels"]), f64(b["gt_boxes"]), jnp.asarray(b["mask_gt"]))
        grads = numpy_tree(grads)
        metrics = {"loss": float(total), **{k: float(v) for k, v in metrics.items()}}
        return (metrics, grads) if with_metrics else grads


def check_gradients(pair: dict) -> None:
    """Each leaf mapped through the bridge. f32 sums in another order through
    ~60 layers: 1e-4 relative to the leaf's largest entry plus 1e-3 of each
    entry. BatchNorm biases ahead of a conv + BatchNorm have gradients that
    are zero but for rounding; they are held to the absolute term of the
    largest leaf instead (1e-6 of it)."""
    tg = pair["tgrads"]
    top = max(float(t.abs().max()) for t in tg.values())
    n = 0
    for path, got, want in gradient_leaves(pair, pair["jgrads"]):
        atol = max(1e-4 * float(np.abs(want).max()), 1e-6 * top)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg="/".join(path))
        n += 1
    assert n == len(tg)


def check_batch_stats(pair: dict) -> None:
    """The new running statistics (0.97 old + 0.03 batch, the biased batch
    variance): f32 batch means, 1e-5 relative plus 1e-6 absolute."""
    js = numpy_tree(pair["jstate"].model_state["batch_stats"])
    m = 0
    for path, tensor, _ in pair["targets"]:
        if path[0] == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), _leaf(js, path[1:]), rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
            m += 1
    assert m > 0


def test_loss_matches(step_pair):
    check_loss(step_pair)


def test_every_gradient_leaf_matches(step_pair):
    check_gradients(step_pair)


def test_batch_norm_statistics_match(step_pair):
    check_batch_stats(step_pair)


def check_update(pair: dict, which: str) -> None:
    """After clipping, weight decay, Nesterov SGD and the EMA: the update is
    lr 0.01 x a clipped gradient, so the weights agree to f32 rounding of
    the sums, 1e-5 relative plus 1e-6 absolute."""
    jstate, tstate = pair["jstate"], pair["tstate"]
    jtree = numpy_tree(jstate.params if which == "params" else jstate.ema_params)
    names = pair["names"]
    assert tstate.step == int(jstate.step) == 1
    for path, tensor, is_kernel in pair["targets"]:
        if path[0] != "params":
            continue
        got = (tensor if which == "params" else tstate.ema[names[id(tensor)]]).detach().numpy()
        if is_kernel:
            got = flax_layout(got)
        np.testing.assert_allclose(got, _leaf(jtree, path[1:]), rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("which", ["params", "ema"])
def test_params_and_ema_after_the_update_match(step_pair, which):
    check_update(step_pair, which)


def test_flax_biases_loss_gradients_and_update_match(flax_bias_pair):
    """On flax's Detect biases every check of the zero-bias pair holds but
    the gradient norm's against JAX (held against f64 below)."""
    check_loss(flax_bias_pair, keys=("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"))
    check_gradients(flax_bias_pair)
    check_batch_stats(flax_bias_pair)
    check_update(flax_bias_pair, "params")
    check_update(flax_bias_pair, "ema")


def test_flax_biases_gradients_against_f64(flax_bias_pair):
    """On flax's Detect biases the two f32 gradient norms differ by ~1.1e-5
    relative, past ``check_loss``'s 1e-5, and the f64 gradients say whose
    rounding that is: held against them, the port's gradient norm is within
    1e-5 relative and no farther than JAX's, and the port's whole gradient
    vector no farther from them than JAX's (f32 on the CPU: port 2.5e-6,
    JAX 1.4e-5 from the f64 norm). Run with ``-s`` it prints the readings
    and the largest leaves'."""
    check_gradients_against_f64(flax_bias_pair)


def check_gradients_against_f64(flax_bias_pair: dict) -> None:
    """The port's gradient norm within 1e-5 relative of the f64 one and no
    farther than JAX's, its gradient vector no farther from the f64 one
    than JAX's."""
    exact = exact_gradients(flax_bias_pair)
    f64_sq = 0.0
    dist = {"port": 0.0, "jax": 0.0}
    leaves = []  # (squared norm, path, each side's scale against the f64 leaf)
    for path, got, ref in gradient_leaves(flax_bias_pair, exact):
        want = _leaf(flax_bias_pair["jgrads"], path[1:]).astype(np.float64)
        got = got.astype(np.float64)
        ref_sq = float((ref ** 2).sum())
        f64_sq += ref_sq
        dist["port"] += float(((got - ref) ** 2).sum())
        dist["jax"] += float(((want - ref) ** 2).sum())
        if ref_sq > 0:
            leaves.append((ref_sq, "/".join(path[1:]), float((got * ref).sum()) / ref_sq - 1,
                           float((want * ref).sum()) / ref_sq - 1))
    for ref_sq, name, port_scale, jax_scale in sorted(leaves, reverse=True)[:5]:
        print(f"{name}: {ref_sq / f64_sq:.3f} of the squared norm, its projection on the "
              f"f64 leaf off by port {port_scale:+.2e}, JAX {jax_scale:+.2e}")
    norm = f64_sq ** 0.5
    port_norm = float(flax_bias_pair["tmetrics"]["grad_norm"])
    jax_norm = float(flax_bias_pair["jmetrics"]["grad_norm"])
    print(f"gradient norm from the f64 one: port {port_norm / norm - 1:+.3e}, JAX "
          f"{jax_norm / norm - 1:+.3e}; gradient vector's distance from the f64 one, "
          f"relative: port {(dist['port'] / f64_sq) ** 0.5:.3e}, JAX "
          f"{(dist['jax'] / f64_sq) ** 0.5:.3e}")
    assert abs(port_norm - norm) <= 1e-5 * norm, (port_norm, norm)
    assert abs(port_norm - norm) <= abs(jax_norm - norm), (port_norm, jax_norm, norm)
    assert dist["port"] <= dist["jax"], dist



def test_step_from_a_folder_matches_jax(tmp_path):
    """The detector trainer's first batch from a YOLO folder of PNG files
    (mosaic, affine, HSV and flips on; a glyph an image, so the mosaic's GTs
    lie apart; 3 GT slots, as the pair's compiled step takes) equals JAX's ``DetectTrainer``'s byte for byte, and one f32
    step on it holds the pair's loss, gradient and statistics tolerances."""
    from kuzu.core.config import load_config as j_config
    from kuzu.tasks.detect import DetectTrainer as JaxTrainer

    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectTrainer
    from kuzu_torch.testing import write_yolo_folder

    data = write_yolo_folder(tmp_path / "data", {"train": 4, "val": 1}, hw=(150, 180),
                             n_boxes=(1, 1), size=(24, 48), nc=3, seed=4)
    ov = dict(data=str(data), imgsz=128, batch=2, max_boxes=3, workers=0, seed=0, augment=True)
    port = DetectTrainer(load_config(overrides=dict(ov, project=str(tmp_path / "t"))),
                         device="cpu").build_datasets()[0]
    ref = JaxTrainer(j_config(overrides=dict(ov, project=str(tmp_path / "j")))).build_datasets()[0]
    port.set_epoch(0)
    ref.set_epoch(0)
    batch, want = next(iter(port)), next(iter(ref))
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    assert (batch["mask_gt"].sum(1) >= 1).all()  # a GT in each image
    pair = run_step_pair(detect_biases="zero", batch=batch)
    assert_no_near_tie(pair)
    # paper-white pages leave the early BatchNorms little variance, so the
    # two f32 sides part by ~1e-4 where the noise batch keeps them within
    # 1e-5; the f64 graph says whose rounding that is: the port's loss terms
    # and gradients lie no farther from it than JAX's
    exact, grads64 = exact_gradients(pair, with_metrics=True)
    assert float(pair["tmetrics"]["num_fg"]) == float(pair["jmetrics"]["num_fg"])
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        port, ref = float(pair["tmetrics"][k]), float(pair["jmetrics"][k])
        assert abs(port - exact[k]) <= max(abs(ref - exact[k]), 1e-5 * abs(exact[k])), k
    dist = {"port": 0.0, "jax": 0.0}
    for path, got, want in gradient_leaves(pair, grads64):
        ref = _leaf(pair["jgrads"], path[1:]).astype(np.float64)
        dist["port"] += float(((got - want) ** 2).sum())
        dist["jax"] += float(((ref - want) ** 2).sum())
    assert dist["port"] <= dist["jax"], dist
