"""One training step of yolov12n@128, batch 2, in f32, the port against the
JAX package: the port's ``make_train_step`` against
``kuzu.core.train.make_train_step(has_model_state=True)`` over the JAX
``DetectTrainer.loss_fn`` equivalent (train-mode flax apply, mutable
``batch_stats``, ``detection_loss``), as ``tests/test_train_accumulate.py``
drives it. Default hyperparameters with ``warmup_epochs=0``, so the one step
moves the weights: clipping at 10 (the gradient norm is far above it),
weight decay on the kernels, Nesterov SGD, the EMA.

Both sides start from the port's seeded weights (passed to JAX through the
inverse bridge), see the same uint8 images and the same GTs: three boxes
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

GT_BOXES = [[[8, 8, 40, 44], [60, 10, 96, 40], [20, 70, 60, 110]],
            [[70, 70, 110, 100], [10, 20, 40, 60], [50, 30, 90, 60]]]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def run_step_pair(remat: bool = False) -> dict:
    """The step on both sides; with ``remat`` each block of both graphs is
    rematerialized in the backward (flax's ``nn.remat``, the port's
    ``torch.utils.checkpoint``)."""
    from kuzu.core.config import load_config as j_config
    from kuzu.core.train import build_optimizer as j_optimizer
    from kuzu.core.train import init_state, make_train_step as j_step
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.ops.detect_loss import detection_loss as j_loss

    from kuzu_torch.bridge import _targets
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step
    from kuzu_torch.models.yolo.graph import YoloGraph
    from kuzu_torch.ops.detect_loss import detection_loss
    from kuzu_torch.ops.flash_attention import area_attention

    jdet = JaxDetector("yolov12n", nc=3, dtype=jnp.float32, imgsz=128, remat=remat)
    graph = YoloGraph(jdet.spec, dtype=torch.float32, remat=remat)
    graph.reset_parameters(torch.Generator().manual_seed(0))
    # copies: numpy views of the port's buffers would let the port's step,
    # which updates the running statistics in place, race JAX's dispatch
    variables = jax.tree.map(lambda a: jnp.array(a, copy=True), flax_variables(graph))

    rng = np.random.default_rng(0)
    batch = {
        "image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
        "gt_labels": np.array([[0, 1, 2], [2, 0, 1]], np.int32),
        "gt_boxes": np.array(GT_BOXES, np.float32),
        "mask_gt": np.array([[1, 1, 1], [1, 1, 0]], bool),
    }
    over = dict(warmup_epochs=0, epochs=1)
    strides = tuple(jdet.strides)

    # JAX: the optimizer chain wrapped so that its state also carries the
    # gradients it was handed
    base = j_optimizer(j_config(overrides=over), 1)

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

    state = init_state(variables["params"], tx, use_ema=True,
                       model_state={"batch_stats": variables["batch_stats"]})
    step = j_step(j_loss_fn, tx, has_model_state=True, donate=False)
    jstate, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.key(0))
    jax.block_until_ready((jstate, jmetrics))

    # the port
    topt = build_optimizer(load_config(overrides=over), graph, 1)
    tstate = TrainState(graph, topt)
    grads, maps = {}, []
    update = topt.step

    def snapshot_then_step(count, grad_norm):  # foreach SGD may edit .grad
        grads.update({n: p.grad.detach().clone() for n, p in graph.named_parameters()})
        update(count, grad_norm)

    topt.step = snapshot_then_step

    def t_loss_fn(model, b):
        feats = model(b["image"])
        maps.append([f.detach() for f in feats])
        return detection_loss(feats, b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=3,
                              imgsz=128, strides=strides)

    k3_before = area_attention.plain_calls
    tmetrics = make_train_step(t_loss_fn, topt)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    names = {id(p): n for n, p in graph.named_parameters()}
    return dict(jstate=jstate, jmetrics=jmetrics, jgrads=numpy_tree(jstate.opt_state[1]),
                tstate=tstate, tmetrics=tmetrics, tgrads=grads, maps=maps[0], batch=batch,
                targets=list(_targets(graph)), names=names, strides=strides,
                k3_calls=area_attention.plain_calls - k3_before)


@pytest.fixture(scope="module")
def step_pair():
    return run_step_pair()


def test_no_near_tie_in_the_assignment(step_pair):
    """Among each GT's in-box anchors the 10th and 11th align values (the
    top-k boundary) differ by more than 1e-3 relative, far above the f32
    differences between the two forwards, and no anchor lies in two GTs."""
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
    gap = (top[..., 9] - top[..., 10]) / top[..., 9]
    mask = torch.from_numpy(b["mask_gt"])
    assert (gap[mask] > 1e-3).all(), gap
    assert ((inside & mask[..., None]).sum(1) <= 1).all()


def check_loss(pair: dict) -> None:
    """f32 through the whole network and the loss: 1e-5 relative."""
    jm, tm = pair["jmetrics"], pair["tmetrics"]
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)


def check_gradients(pair: dict) -> None:
    """Each leaf mapped through the bridge. f32 sums in another order through
    ~60 layers: 1e-4 relative to the leaf's largest entry plus 1e-3 of each
    entry. BatchNorm biases ahead of a conv + BatchNorm have gradients that
    are zero but for rounding; they are held to the absolute term of the
    largest leaf instead (1e-6 of it)."""
    jg, tg, names = pair["jgrads"], pair["tgrads"], pair["names"]
    top = max(float(t.abs().max()) for t in tg.values())
    n = 0
    for path, tensor, is_kernel in pair["targets"]:
        if path[0] != "params":
            continue
        want = _leaf(jg, path[1:])
        got = tg[names[id(tensor)]].numpy()
        if is_kernel:
            got = got.transpose(2, 3, 1, 0)
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


@pytest.mark.parametrize("which", ["params", "ema"])
def test_params_and_ema_after_the_update_match(step_pair, which):
    """After clipping, weight decay, Nesterov SGD and the EMA: the update is
    lr 0.01 x a clipped gradient, so the weights agree to f32 rounding of
    the sums, 1e-5 relative plus 1e-6 absolute."""
    jstate, tstate = step_pair["jstate"], step_pair["tstate"]
    jtree = numpy_tree(jstate.params if which == "params" else jstate.ema_params)
    names = step_pair["names"]
    assert tstate.step == int(jstate.step) == 1
    for path, tensor, is_kernel in step_pair["targets"]:
        if path[0] != "params":
            continue
        got = (tensor if which == "params" else tstate.ema[names[id(tensor)]]).detach().numpy()
        if is_kernel:
            got = got.transpose(2, 3, 1, 0)
        np.testing.assert_allclose(got, _leaf(jtree, path[1:]), rtol=1e-5, atol=1e-6,
                                   err_msg="/".join(path))
