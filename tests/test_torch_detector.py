"""The port's detector slice against the JAX package on the CPU.

yolov12n@128, batch 2, nc=3, the same seeded weights on both sides (through
the weight bridge). Node 6 (C=64, area 4, na=16) takes the area-attention
route and node 8 (C=128, na=16) the fused-ABlock route, on both sides.
NMS runs at conf_thres=0.001: random-init scores are ~sigmoid(-4.6) ~ 0.01.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module itself: the package attribute of that name is the function it exports
t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")
from kuzu_torch.ops import fused_ablock as t_fb
from kuzu_torch.ops import nms_kernel as t_nk
from kuzu_torch.ops.nms import non_max_suppression as t_nms
from kuzu_torch.testing import detections_match, f32
from torch_parity import assert_maps_close, jax_and_port_detector, numpy_tree

CONF = 0.001


@pytest.fixture(scope="module")
def models():
    return jax_and_port_detector("yolov12n", nc=3, imgsz=128, seed=0)


@pytest.fixture(scope="module")
def slice_run(models):
    from kuzu.models.yolo.infer import run_graph
    from kuzu.ops.nms import non_max_suppression as j_nms

    jdet, variables, tdet = models
    imgs = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    def jax_slice(v, x):  # one compile of the whole JAX side
        maps = run_graph(jdet.spec, v, x, interpret=True)
        pred = jdet.decode(maps)
        return maps, pred, j_nms(pred, conf_thres=CONF)

    jmaps, jpred, jdets = jax.jit(jax_slice)(variables, jnp.asarray(imgs))

    counters = (t_fa.area_attention, t_fb.fused_ablock, t_nk.batched_suppress)
    for c in counters:
        c.plain_calls = 0
    tmaps = tdet.infer(torch.from_numpy(imgs))
    tpred = tdet.decode(tmaps)
    tdets = t_nms(tpred, conf_thres=CONF)
    calls = [c.plain_calls for c in counters]
    return dict(jmaps=jmaps, jpred=jpred, jdets=jdets, tmaps=tmaps, tpred=tpred,
                tdets=tdets, calls=calls)


def test_bridge_consumes_every_leaf(models):
    """The flax graph's own init tree (its shapes from ``eval_shape``, seeded
    values) loads into a fresh port graph, each leaf in its layout; a stray
    leaf or a missing one raises."""
    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo.graph import YoloGraph

    jdet, variables, tdet = models
    shapes = jax.eval_shape(lambda: jdet.module.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), train=False))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    n_leaves = len(jax.tree.leaves(tree))
    n_port = sum(1 for _ in tdet.graph.parameters()) + 2 * sum(
        1 for m in tdet.graph.modules() if isinstance(m, torch.nn.BatchNorm2d))
    assert n_leaves == n_port == len(jax.tree.leaves(variables))
    extra = numpy_tree(tree)
    extra["params"]["n0_Conv"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stray"):
        from_flax(YoloGraph(tdet.spec), extra)
    short = numpy_tree(tree)
    del short["batch_stats"]["n2_C3k2"]["cv1"]["bn"]["var"]
    with pytest.raises(ValueError, match="n2_C3k2/cv1/bn/var"):
        from_flax(YoloGraph(tdet.spec), short)
    # the loaded weights are the flax ones, transposed HWIO -> OIHW
    graph = from_flax(YoloGraph(tdet.spec), numpy_tree(tree))
    k = tree["params"]["n1_Conv"]["conv"]["kernel"]
    np.testing.assert_array_equal(graph.n1_Conv.conv.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("name", ["yolov12n", "yolov12s", "yolov12-p2n"])
def test_param_count_matches(name):
    """Equal parameter counts pin the graph: every module, width and repeat."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    from kuzu_torch.models.yolo.detector import YoloDetector

    jdet = JaxDetector(name, nc=80, imgsz=64)
    shapes = jax.eval_shape(
        lambda: jdet.module.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    expect = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes["params"]))
    assert YoloDetector(name, nc=80, device="cpu").param_count() == expect


def test_slice_routes_through_both_attention_kernels(slice_run):
    """4 area-attention calls (node 6: 2 repeats x 2 ABlocks), 4 fused-ABlock
    calls (node 8) and 1 NMS, through the wrappers' plain versions here."""
    assert slice_run["calls"] == [4, 4, 1]


def test_slice_raw_maps_match(slice_run):
    assert len(slice_run["jmaps"]) == len(slice_run["tmaps"]) == 3
    for r, o in zip(slice_run["jmaps"], slice_run["tmaps"]):
        assert tuple(r.shape) == tuple(o.shape)
        assert_maps_close(r, o)


def test_slice_decode_within_bf16(slice_run):
    """Raw maps differ by bf16 roundings, which DFL turns into a fraction of
    a bin (x stride <= 32 px): boxes within 2 px; scores are sigmoids of
    logits near -4.6, whose bf16 ulp (2^-6) moves them by < 2e-4."""
    jp, tp = f32(slice_run["jpred"]), f32(slice_run["tpred"])
    assert jp.shape == tp.shape == (2, 7, 336)
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp[:, :4], jp[:, :4], atol=2.0, rtol=0)
    np.testing.assert_allclose(tp[:, 4:], jp[:, 4:], atol=2e-4, rtol=0)


def test_nms_on_same_decoded_tensor_is_exact(slice_run):
    jdets = slice_run["jdets"]
    tdets = t_nms(torch.tensor(f32(slice_run["jpred"])), conf_thres=CONF)
    assert int(tdets["valid"].sum()) > 0
    for key in jdets:
        np.testing.assert_array_equal(tdets[key].numpy(), np.asarray(jdets[key]), err_msg=key)


def test_slice_detections_match(slice_run):
    """Valid counts within 10% per image, and >= 90% of detections matched
    both ways under ``kuzu_torch.testing.detections_match``."""
    jd, td = slice_run["jdets"], slice_run["tdets"]
    jn, tn = f32(jd["valid"]).sum(1), f32(td["valid"]).sum(1)
    assert (jn > 0).all()
    assert (np.abs(jn - tn) <= 0.1 * jn).all(), (jn, tn)
    assert detections_match(jd, td) >= 0.9
    assert detections_match(td, jd) >= 0.9


def test_p2_character_detector_runs():
    """yolov12-p2 (the P2-P5 character detector) uses the same module set:
    it builds, runs and decodes on four levels."""
    from kuzu_torch.models.yolo.detector import YoloDetector

    det = YoloDetector("yolov12-p2n", nc=1, imgsz=128, device="cpu").init(0)
    imgs = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 128, 128, 3),
                                                              dtype=np.uint8))
    maps = det.infer(imgs)
    assert [tuple(m.shape[1:3]) for m in maps] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    pred = det.decode(maps)
    assert pred.shape == (1, 5, 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4)
    assert torch.isfinite(pred).all()


@pytest.mark.parametrize("name", ["yolov12n", "yolov12-p2n"])
def test_seeded_init_sets_flax_detect_biases(name):
    """The seeded init gives every Detect level flax's biases, 1.0 on the
    box head and -4.6 on the class head (the walk over the modules used to
    zero them again while visiting the Detect's convs), and zero on every
    other conv bias; the folded executor carries them."""
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.models.yolo.modules import Detect

    det = YoloDetector(name, nc=2, imgsz=64, device="cpu").init(0)
    heads = [m for m in det.graph.modules() if isinstance(m, Detect)]
    assert len(heads) == 1 and heads[0].nl == (4 if "p2" in name else 3)
    head = heads[0]
    for i in range(head.nl):
        assert torch.equal(getattr(head, f"box{i}_2").bias, torch.full_like(
            getattr(head, f"box{i}_2").bias, 1.0))
        assert torch.equal(getattr(head, f"cls{i}_2").bias, torch.full_like(
            getattr(head, f"cls{i}_2").bias, -4.6))
    others = [m.bias for n, m in det.graph.named_modules()
              if isinstance(m, torch.nn.Conv2d) and m.bias is not None
              and not n.endswith(("_2",))]
    assert all(not b.any() for b in others)
    # at init every anchor scores about sigmoid(-4.6) through the folded
    # executor (the class convs' outputs are small)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3),
                                                              dtype=np.uint8))
    scores = det.decode(det.infer(imgs))[:, 4:].float()
    np.testing.assert_allclose(scores.numpy(), 1 / (1 + np.exp(4.6)), rtol=0.05)
