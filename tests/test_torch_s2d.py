"""The space-to-depth math options in the port against the JAX package on
the CPU (``kuzu/ops/s2d.py``, ``Conv(impl="s2d")``, ``run_graph``'s
``stem_s2d`` / ``stem_packed``):

- ``space_to_depth`` (2 x 2 and the packed stem's 4 x 4) and ``s2d_kernel``
  equal to JAX's bit for bit, after the NHWC / HWIO -> NCHW / OIHW
  transpose alone (the packed channel order is JAX's ``(u, v, c)``);
- ``Conv(impl="s2d")`` in f32, dense and grouped: the train-mode output,
  the new BatchNorm statistics and the gradients against JAX's
  ``_S2dStridedConv`` route and the port's native route, at
  ``tests/test_conv_s2d.py``'s tolerances; ineligible convolutions take the
  native route exactly;
- ``YoloGraph(conv_impl="s2d")`` against native on yolov12n at 64 px
  (1e-4, as JAX's test), with the same parameters;
- ``run_graph(stem_s2d=True)`` and ``(stem_packed=True)`` against JAX's
  ``run_graph`` with the same flag and against the port's plain stem on
  yolov12n at 64 px (node 1 is the grouped g = 2 conv: stage B's group
  slices), at ``tests/test_yolo_infer.py``'s bound (relative 0.02), the
  decoded class argmax identical and boxes within 0.5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_variables, jax_and_port_detector, numpy_tree

STEM_REL = 0.02  # tests/test_yolo_infer.py:57, 76


def _nchw(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_space_to_depth_and_kernel_equal_jax():
    from kuzu.ops.s2d import s2d_kernel as j_kernel
    from kuzu.ops.s2d import space_to_depth as j_s2d

    from kuzu_torch.ops.s2d import s2d_kernel, space_to_depth

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 16, 5)).astype(np.float32)
    got = space_to_depth(torch.from_numpy(_nchw(x)))
    np.testing.assert_array_equal(got.numpy(), _nchw(j_s2d(jnp.asarray(x))))
    # the packed stem's 4 x 4 packing, as kuzu/models/yolo/infer.py:151-155 writes it
    b, h, w, c = x.shape
    want4 = x.reshape(b, h // 4, 4, w // 4, 4, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // 4, w // 4, 16 * c)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(_nchw(x)), 4).numpy(),
                                  _nchw(want4))
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)  # HWIO
    got = s2d_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_kernel(jnp.asarray(k))).transpose(
        3, 2, 0, 1))


def _jax_conv_pair(g: int, shape, impl: str = "s2d", k: int = 3, s: int = 2):
    """(JAX Conv module with ``impl``, its variables, port Conv with
    ``impl`` and the native port Conv on the same weights, x)."""
    from kuzu.models.yolo import modules as JM

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo.modules import Conv

    cin, cout = 8 * g, 16 * g
    x = np.random.default_rng(1).normal(size=(*shape, cin)).astype(np.float32)
    jmod = JM.Conv(cout, k, s, g=g, dtype=jnp.float32, impl=impl)
    v = numpy_tree(jmod.init(jax.random.key(0), jnp.asarray(x), train=True))
    ports = []
    for i in (impl, "native"):
        m = Conv(cin, cout, k, s, g=g, impl=i)
        from_flax(m, v)
        ports.append(m)
    return jmod, v, ports[0], ports[1], x


@pytest.mark.parametrize("g", [1, 2])
def test_s2d_conv_matches_jax_forward_and_gradient(g):
    jmod, v, port, native, x = _jax_conv_pair(g, (2, 16, 12))
    xt = torch.from_numpy(_nchw(x)).contiguous(memory_format=torch.channels_last)
    weights = np.cos(np.arange(2 * 16 * 8 * 6 * g)).astype(np.float32)

    def j_loss(params):
        y, mut = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (y * jnp.asarray(weights).reshape(y.shape)).sum(), (y, mut)

    (_, (jy, jmut)), jgrad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(v["params"])
    assert port.s2d_eligible(xt) and not native.s2d_eligible(xt)
    for m in (port, native):
        m.train()
        y = m(xt)
        wt = torch.from_numpy(_nchw(weights.reshape(2, 8, 6, 16 * g)))
        (y * wt).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), _nchw(jy), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(m.bn.running_mean.numpy(),
                                   np.asarray(jmut["batch_stats"]["bn"]["mean"]), atol=2e-5)
        np.testing.assert_allclose(m.bn.running_var.numpy(),
                                   np.asarray(jmut["batch_stats"]["bn"]["var"]), atol=2e-5)
        grads = flax_variables(m, {n: p.grad for n, p in m.named_parameters()},
                               collections=("params",))["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(jgrad):
            got = grads
            for key in path:
                got = got[key.key]
            np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=1e-3,
                                       err_msg=str(path))
    assert port.conv.weight.shape == (16 * g, 8, 3, 3)  # the 3 x 3 parameter tree


@pytest.mark.parametrize("kw", [dict(k=1, s=1), dict(k=3, s=2)])
def test_ineligible_conv_takes_native_route(kw):
    """k1 s1, and k3 s2 over odd sizes (15 x 15): the s2d module computes
    the native convolution exactly, and both equal JAX's."""
    jmod, v, port, native, x = _jax_conv_pair(1, (1, 15, 15), **kw)
    xt = torch.from_numpy(_nchw(x))
    assert not port.s2d_eligible(xt)
    port.eval()
    native.eval()
    with torch.no_grad():
        got, ref = port(xt), native(xt)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    want = jmod.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=2e-5, rtol=1e-4)


def test_yolograph_conv_impl_s2d_matches_native():
    """yolov12n at 64 px, f32, train mode: conv_impl='s2d' against native
    within 1e-4 (tests/test_conv_s2d.py:98-101), the same state dict."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector("yolov12n", nc=3, imgsz=64, device="cpu")
    spec = det.spec
    from kuzu_torch.models.yolo.graph import YoloGraph

    g0 = YoloGraph(spec)
    g0.reset_parameters(torch.Generator().manual_seed(0))
    g1 = YoloGraph(spec, conv_impl="s2d")
    assert g0.state_dict().keys() == g1.state_dict().keys()
    g1.load_state_dict(g0.state_dict())
    n_s2d = sum(m.impl == "s2d" for m in g1.modules() if hasattr(m, "impl"))
    assert n_s2d == sum(n.module == "Conv" for n in spec.nodes) > 0
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32))
    with torch.no_grad():
        out0, out1 = g0.train()(x), g1.train()(x)
    for r, o in zip(out0, out1):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def stems():
    """yolov12n at 64 px, batch 2: JAX's run_graph (Pallas interpreted)
    and the port's, plain and with each stem option, on the port's seeded
    weights; each port run takes its stem route once (counted), and no
    other."""
    from kuzu.models.yolo.infer import run_graph as j_run

    import kuzu_torch.models.yolo.infer as I

    jdet, variables, tdet = jax_and_port_detector("yolov12n", nc=3, imgsz=64)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    flags = {"plain": {}, "s2d": dict(stem_s2d=True), "packed": dict(stem_packed=True)}
    jfn = jax.jit(lambda v, x, **kw: j_run(jdet.spec, v, x, interpret=True, **kw),
                  static_argnames=("stem_s2d", "stem_packed"))
    xt = torch.from_numpy(x)
    jout = {k: [np.asarray(a, np.float32) for a in jfn(variables, jnp.asarray(x), **kw)]
            for k, kw in flags.items()}
    calls = {"s2d": 0, "packed": 0}
    saved = {k: getattr(I, f) for k, f in (("s2d", "stem_conv_s2d"),
                                           ("packed", "stem_pair_packed"))}

    def counted(key):
        def fn(*args, **kw):
            calls[key] += 1
            return saved[key](*args, **kw)
        return fn

    try:
        I.stem_conv_s2d, I.stem_pair_packed = counted("s2d"), counted("packed")
        tout = {}
        for k, kw in flags.items():
            before = dict(calls)
            tout[k] = [a.float().numpy() for a in I.run_graph(tdet.spec, tdet.folded, xt, **kw)]
            assert {c: calls[c] - before[c] for c in calls} == {
                c: int(c == k) for c in calls}, (k, calls)
    finally:
        I.stem_conv_s2d, I.stem_pair_packed = saved["s2d"], saved["packed"]
    fusable = I.stem_fusable(tdet.spec, tdet.folded, xt.permute(0, 3, 1, 2))
    return jdet, tdet, jout, tout, fusable


def _rel(r, o) -> float:
    return float((np.abs(r - o) / np.maximum(np.abs(r), 1.0)).max())


@pytest.mark.parametrize("stem", ["s2d", "packed"])
def test_stem_options_match_jax_and_plain(stems, stem):
    jdet, tdet, jout, tout, fusable = stems
    assert fusable and tdet.spec.nodes[1].args[4] == 2  # the grouped stage B
    for r, o in zip(jout[stem], tout[stem]):
        assert r.shape == o.shape
        assert _rel(r, o) < STEM_REL
    for r, o in zip(tout["plain"], tout[stem]):
        assert _rel(r, o) < STEM_REL
    ref = tdet.decode([torch.from_numpy(a) for a in tout["plain"]]).numpy()
    got = tdet.decode([torch.from_numpy(a) for a in tout[stem]]).numpy()
    np.testing.assert_array_equal(got[:, 4:].argmax(1), ref[:, 4:].argmax(1))
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=0.5)


def test_stem_fusable_mirrors_jax():
    """The packed stem's gate: an image not tiling by 4, a later node
    reading node 0, a node 0 without SiLU or a 1 x 1 node 1 take the plain
    stem, as JAX's ``_stem_fusable`` (which does not check the padding)."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.models.yolo.graph import parse_model_yaml
    from kuzu_torch.models.yolo.infer import stem_fusable

    def fusable(backbone, size=64):
        spec = parse_model_yaml({"backbone": backbone,
                                 "head": [[[-1], 1, "Detect", []]]}, nc=2)
        det = YoloDetector(spec, device="cpu").init(0)
        return stem_fusable(spec, det.folded, torch.zeros(1, 3, size, size))

    base = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2, None, 2]],
            [-1, 1, "Conv", [32, 3, 2]]]
    assert fusable(base)
    assert not fusable(base, size=62)
    assert not fusable([base[0], [-1, 1, "Conv", [32, 1, 2]], base[2]])
    assert not fusable([[-1, 1, "Conv", [16, 3, 2, None, 1, False]], *base[1:]])
    assert not fusable([*base[:2], [[0, 1], 1, "Concat", [1]]])
