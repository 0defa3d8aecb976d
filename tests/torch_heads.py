"""Helpers for the parity tests of the Segment, Pose, OBB and Classify heads
(``tests/test_torch_heads_*.py``): the port's seeded graph of a head model
with its flax variables, the f64 train-mode forward of both packages, one
f32 training step of a task's own ``loss_fn`` on both sides, and a JAX
predictor over the port's weights.

The step pair follows ``test_torch_train_step.run_step_pair``: the port's
seeded weights go to JAX through the inverse bridge, both sides take the
same batch, and the result dict is the one that file's ``check_*`` helpers
read.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_parity import flax_variables, numpy_tree

STEP_OVERRIDES = dict(warmup_epochs=0, epochs=1)


def seeded_graph(name: str, nc: int = 3, seed: int = 0, kpt_shape=None):
    """The port's f32 ``YoloGraph`` of ``name`` (seeded init; a Pose head
    with ``kpt_shape`` where given) and its flax variables."""
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec

    path, scale = resolve_model_spec(name)
    spec = parse_model_yaml(path, scale=scale, nc=nc)
    if kpt_shape:
        for node in spec.nodes:
            if node.module == "Pose":
                node.args[1] = list(kpt_shape)
        spec.kpt_shape = tuple(kpt_shape)
    graph = YoloGraph(spec)
    graph.reset_parameters(torch.Generator().manual_seed(seed))
    return graph, flax_variables(graph)


def jax_graph(spec, dtype=jnp.float32):
    """The flax ``YoloGraph`` of the port's parsed ``spec`` (the same nodes,
    a Pose head's ``kpt_shape`` included)."""
    from kuzu.models.yolo.graph import YoloGraph as JaxGraph

    return JaxGraph(spec, dtype=dtype)


def f64_forward_pair(graph, variables, x: np.ndarray):
    """The train-mode forward in f64 on both sides: (JAX's outputs as numpy
    leaves, JAX's new batch statistics, the port's outputs as numpy leaves,
    the port's f64 graph) on the pixels ``x`` in [0, 1]."""
    from kuzu_torch.models.yolo.graph import YoloGraph

    with jax.enable_x64(True):
        module = jax_graph(graph.spec, jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out, mutated = jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                         mutable=["batch_stats"]))(
            v64, jnp.asarray(x))
        jout = [np.asarray(a) for a in jax.tree.leaves(out)]
        jstats = numpy_tree(mutated["batch_stats"])
    g64 = YoloGraph(graph.spec, dtype=torch.float64)
    g64.load_state_dict(graph.state_dict())
    g64.double().train()
    with torch.no_grad():
        tout = g64(torch.from_numpy(x))
    leaves = [tout] if torch.is_tensor(tout) else jax.tree.leaves(
        tout, is_leaf=lambda t: torch.is_tensor(t))
    return jout, jstats, [t.numpy() for t in leaves], g64


def jax_trainer(cls, cfg: dict, **attrs):
    """A JAX task trainer of class ``cls`` without its ``__init__`` (no run
    dir): ``cfg`` as its config, ``attrs`` set on it (``detector``,
    ``imgsz``; classify: ``model``, ``_model_state``)."""
    from kuzu.core.config import load_config

    t = object.__new__(cls)
    t.cfg = load_config(overrides=cfg)
    for k, v in attrs.items():
        setattr(t, k, v)
    return t


def port_trainer(cls, cfg: dict, spec=None, imgsz: int = 64):
    """A port task trainer of class ``cls`` without its ``__init__``, with
    the attributes its ``loss_fn`` reads."""
    from kuzu_torch.core.config import load_config

    t = object.__new__(cls)
    t.cfg = load_config(overrides=cfg)
    if spec is not None:
        t.spec, t.nc, t.strides, t.imgsz = spec, spec.nc, list(spec.strides), imgsz
    return t


def step_pair(graph, variables, j_loss_fn, t_loss_fn, batch: dict) -> dict:
    """One f32 step on both sides from the same weights and batch:
    ``j_loss_fn(params, model_state, batch, rng)`` through ``kuzu.core.
    train.make_train_step(has_model_state=True)`` with the default optimizer
    (``STEP_OVERRIDES``), and ``t_loss_fn(model, batch, rng)`` through the
    port's ``make_train_step``. The result is ``run_step_pair``'s dict."""
    from kuzu.core.config import load_config as j_config
    from kuzu.core.train import build_optimizer as j_optimizer
    from kuzu.core.train import init_state
    from kuzu.core.train import make_train_step as j_step

    from kuzu_torch.bridge import _targets
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer, make_train_step

    base = j_optimizer(j_config(overrides=STEP_OVERRIDES), 1)

    def update(g, s, p=None):
        u, inner = base.update(g, s[0], p)
        return u, (inner, g)

    tx = optax.GradientTransformation(
        lambda p: (base.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    variables = jax.tree.map(lambda a: jnp.array(a, copy=True), variables)
    state = init_state(variables["params"], tx, use_ema=True,
                       model_state={"batch_stats": variables["batch_stats"]})
    jstate, jmetrics = j_step(j_loss_fn, tx, has_model_state=True, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    jax.block_until_ready((jstate, jmetrics))

    graph.train()
    initial = {k: v.detach().clone() for k, v in graph.state_dict().items()}
    topt = build_optimizer(load_config(overrides=STEP_OVERRIDES), graph, 1)
    tstate = TrainState(graph, topt)
    grads = {}
    inner = topt.step

    def snapshot_then_step(count, grad_norm):  # foreach SGD may edit .grad
        grads.update({n: p.grad.detach().clone() for n, p in graph.named_parameters()})
        inner(count, grad_norm)

    topt.step = snapshot_then_step
    tmetrics = make_train_step(t_loss_fn, topt)(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return dict(variables=variables, initial=initial, jstate=jstate, jmetrics=jmetrics,
                jgrads=numpy_tree(jstate.opt_state[1]), tstate=tstate, tmetrics=tmetrics,
                tgrads=grads, targets=list(_targets(graph)),
                names={id(p): n for n, p in graph.named_parameters()}, batch=batch)


def check_step(pair: dict, loss_keys: tuple, exact: dict | None = None) -> None:
    """Every check of the detector's step pair: loss terms 1e-5 relative,
    every gradient leaf (with ``exact``, the f64 gradients: held against
    them instead, :func:`check_gradients_against_f64`), the new BatchNorm
    statistics (moved once), the weights and EMA after the update."""
    from test_torch_train_step import check_batch_stats, check_gradients, check_loss, \
        check_update

    check_loss(pair, keys=loss_keys)
    if exact is None:
        check_gradients(pair)
    else:
        check_gradients_against_f64(pair, exact)
    check_batch_stats(pair)
    check_update(pair, "params")
    check_update(pair, "ema")
    moved = [t for path, t, _ in pair["targets"]
             if path[0] == "batch_stats" and path[-1] == "var"]
    assert moved and all(not torch.equal(t, torch.ones_like(t)) for t in moved)


def patch_jax_predictor(monkeypatch, det, jdet):
    """JAX's ``DetectPredictor._setup`` replaced so that a JAX head
    predictor runs the port detector ``det``'s weights with no run dir, its
    detector ``jdet`` inferring through the BN-folded bf16 executor (Pallas
    interpreted), the executor the port runs."""
    import kuzu.tasks.detect as jdetect
    from kuzu.models.yolo.infer import run_graph

    variables = flax_variables(det.graph)
    jdet.infer = lambda v, images: run_graph(jdet.spec, v, images, interpret=True)

    def setup(self):
        self.detector, self.imgsz, self.names = jdet, det.imgsz, {}
        self.variables, self.min_bucket, self._put = variables, 1, jnp.asarray
        self.ready = True

    monkeypatch.setattr(jdetect.DetectPredictor, "_setup", setup)
    return variables


def val_state(variables: dict) -> SimpleNamespace:
    """The JAX validators' train-state view of flax ``variables`` (no EMA)."""
    return SimpleNamespace(ema_params=None, params=variables["params"],
                           model_state={"batch_stats": variables["batch_stats"]})



def f64_gradients(spec, t_loss_fn, pair: dict) -> dict:
    """The gradients of the port's ``t_loss_fn`` on its graph in f64 (the
    graph's f64 forward equals flax's within 1e-9, the heads' tests hold
    it), at the pair's initial weights and batch, in flax's layout: the
    exact function both f32 sides approximate, with no JAX compile."""
    from kuzu_torch.models.yolo.graph import YoloGraph

    g64 = YoloGraph(spec, dtype=torch.float64)
    g64.load_state_dict(pair["initial"])
    g64.double().train()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in pair["batch"].items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    t_loss_fn(g64, batch)[0].backward()
    grads = {n: p.grad for n, p in g64.named_parameters()}
    return flax_variables(g64, grads, collections=("params",))["params"]


def check_gradients_against_f64(pair: dict, exact: dict) -> None:
    """Where the two f32 gradient vectors part by more than the detector
    pair's per-leaf tolerances: against the f64 gradients, JAX's vector
    within 1e-3 relative (so the reference is JAX's function, whichever
    package computed it), the port's no farther than JAX's, and the port's
    norm (an f32 sum of some 3M squares on each side) within 2e-5 relative
    of the f64 norm."""
    from test_torch_train_step import _leaf, gradient_leaves

    sq = {"port": 0.0, "jax": 0.0, "f64": 0.0}
    for path, got, ref in gradient_leaves(pair, exact):
        want = _leaf(pair["jgrads"], path[1:]).astype(np.float64)
        sq["port"] += float(((got.astype(np.float64) - ref) ** 2).sum())
        sq["jax"] += float(((want - ref) ** 2).sum())
        sq["f64"] += float((ref ** 2).sum())
    norm = sq["f64"] ** 0.5
    port_norm, jax_norm = (float(pair[k]["grad_norm"]) for k in ("tmetrics", "jmetrics"))
    print(f"gradient vector from the f64 one, relative: port {(sq['port'] / sq['f64']) ** 0.5:.3e}"
          f", JAX {(sq['jax'] / sq['f64']) ** 0.5:.3e}; norm: port {port_norm / norm - 1:+.3e}, "
          f"JAX {jax_norm / norm - 1:+.3e}")
    assert sq["jax"] <= 1e-6 * sq["f64"], sq
    assert sq["port"] <= sq["jax"], sq
    assert abs(port_norm - norm) <= 2e-5 * norm, (port_norm, norm)
