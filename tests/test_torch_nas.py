"""YOLO-NAS in the port against the JAX package on the CPU.

- ``QARepVGG`` (the three ``tests/test_nas.py`` cases and an odd input at
  stride 2): the train-mode output and the moved running statistics, the
  eval forward unfused and re-parameterised, each against flax's on the
  same weights; the port's fused forward against its unfused one. Output
  1e-5 absolute (values O(1)), statistics 1e-6, fused against unfused
  1e-4 (``tests/test_nas.py``'s own). At stride 2 the 1x1 branch (padding
  0) and the 3x3 centre tap (padding 1) sample the same pixels at odd
  sizes too: both give ``floor((H - 1) / 2) + 1`` outputs at ``2 i``, and
  JAX's fused and unfused forwards agree there as at even sizes;
- ``yolo_nas_s`` at 64 px, nc 3, f32, the port's seeded weights handed to
  flax: the unfused and fused eval maps (1e-6 absolute, maps O(0.05)),
  ``decode`` and ``decoded`` (pixels 1e-4 absolute, scores 1e-6), and the
  NMS keeps on each side's decode identical;
- one f32 ``NASTrainer`` loss and its gradients against JAX's
  ``value_and_grad`` of the same loss at 128 px: loss terms 1e-5 relative,
  the moved statistics 1e-5. The gradients are held against the port's
  f64 ones (JAX's x64 gradients agree with those to 1e-4 of the stem's
  largest entry, but XLA's jitted f32 ones part from them by ~1% at the
  stem): each port leaf within 1e-3 relative plus 1e-4 of the leaf's
  largest entry (BatchNorm biases ahead of a BatchNorm, zero but for
  rounding: 1e-6 of the largest entry of all), the port's vector no farther than JAX's f32 vector (and
  within 1e-4 relative), JAX's within 1e-2;
- the parameter counts of s, m and l equal to flax's (``jax.eval_shape``
  of ``init``: nothing compiles);
- the ``nas`` task through ``Model``: train -> val -> predict on a tiny PNG
  folder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flax_variables, numpy_tree

IMGSZ, NC = 64, 3
STEP_SZ = 128  # the step's images: at 64 px the 2 x 2 P5 BatchNorms amplify f32 rounding


@pytest.mark.parametrize("ci,co,stride,hw", [(32, 32, 1, 16), (32, 48, 1, 16),
                                             (32, 48, 2, 16), (32, 48, 2, 15)])
def test_qarepvgg_matches_flax(ci, co, stride, hw):
    from kuzu.models.nas import QARepVGG as JaxQARepVGG

    from kuzu_torch.models.nas import QARepVGG, fold_nas

    block = QARepVGG(ci, co, stride)
    block.reset_parameters(torch.Generator().manual_seed(0))
    variables = flax_variables(block)
    x = np.random.default_rng(0).normal(size=(2, hw, hw, ci)).astype(np.float32)
    jblock = JaxQARepVGG(co, stride=stride)
    jy, mutated = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    block.train()
    with torch.no_grad():
        ty = block(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ty, np.asarray(jy), rtol=0, atol=1e-5)
    stats = numpy_tree(mutated["batch_stats"])
    for name in block.flax_batch_stats:
        np.testing.assert_allclose(getattr(block, name).numpy(), stats[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert not np.allclose(stats["bn_var"], 1.0)  # the statistics moved

    moved = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    x_in = jnp.asarray(x)
    jeval = np.asarray(jblock.apply(moved, x_in))
    jfused = np.asarray(JaxQARepVGG(co, stride=stride, fuse=True).apply(moved, x_in))
    block.eval()
    with torch.no_grad():
        teval = block(xt).permute(0, 2, 3, 1).numpy()
        tfused = block(xt, fold_nas(block)).permute(0, 2, 3, 1).numpy()
    assert teval.shape == tfused.shape == jeval.shape
    np.testing.assert_allclose(teval, jeval, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tfused, jfused, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tfused, teval, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(jfused, jeval, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def nas_pair():
    """The port's seeded ``yolo_nas_s`` detector on the CPU, JAX's over the
    same weights, one batch of uint8 images, and each side's eval maps
    (unfused, fused)."""
    from kuzu.models.nas import NASDetector as JaxNASDetector

    from kuzu_torch.models.nas import NASDetector

    det = NASDetector("yolo_nas_s", nc=NC, imgsz=IMGSZ, device="cpu").init(0)
    variables = flax_variables(det.graph)
    jdet = JaxNASDetector("yolo_nas_s", nc=NC, imgsz=IMGSZ)
    images = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    fwd = jax.jit(lambda v, x: (jdet.apply(v, x), jdet.infer(v, x), jdet.decoded(v, x)))
    junfused, jfused, jdecoded = fwd(variables, jnp.asarray(images))
    x = torch.from_numpy(images)
    return dict(det=det, jdet=jdet, variables=variables, images=images,
                jmaps=(junfused, jfused), jdecoded=jdecoded, tmaps=(det.apply(x), det.infer(x)))


def test_yolo_nas_maps_match_flax(nas_pair):
    shapes = [(8, 8), (4, 4), (2, 2)]
    for jm, tm in zip(nas_pair["jmaps"], nas_pair["tmaps"]):
        assert [tuple(t.shape[1:3]) for t in tm] == shapes
        for j, t in zip(jm, tm):
            assert t.shape == (2, *t.shape[1:3], 4 * 16 + NC) and t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    for u, f in zip(*nas_pair["tmaps"]):  # fused against unfused (tests/test_nas.py's 2e-4)
        np.testing.assert_allclose(f.numpy(), u.numpy(), rtol=2e-4, atol=2e-4)


def test_yolo_nas_decode_decoded_and_nms_match_flax(nas_pair):
    from kuzu.ops.nms import non_max_suppression as jax_nms

    det, jdet = nas_pair["det"], nas_pair["jdet"]
    jpred = np.asarray(jdet.decode(nas_pair["jmaps"][1]))
    tpred = det.decode(nas_pair["tmaps"][1])
    a = 8 * 8 + 4 * 4 + 2 * 2
    assert tpred.shape == (2, 4 + NC, a)
    np.testing.assert_allclose(tpred[:, :4].numpy(), jpred[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tpred[:, 4:].numpy(), jpred[:, 4:], rtol=0, atol=1e-6)
    jboxes, jscores = nas_pair["jdecoded"]
    boxes, scores = det.decoded(torch.from_numpy(nas_pair["images"]))
    assert boxes.shape == (2, a, 4) and scores.shape == (2, a, NC)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-6)
    want = jax_nms(jnp.asarray(jpred), conf_thres=0.25, iou_thres=0.7, max_det=16)
    got = det.select(tpred, 0.25, 0.7, 16)
    assert int(got["valid"].sum()) > 0
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-4)


def test_nas_trainer_loss_and_gradients_match_flax(nas_pair):
    """One f32 ``NASTrainer.loss_fn`` on the train-mode forward, and its
    gradients, against JAX's ``value_and_grad`` of the detect trainer's
    loss over ``NASDetector.apply(train=True)``."""
    from kuzu.ops.detect_loss import detection_loss as jax_loss
    from test_torch_train_step import flax_layout, _leaf
    from torch_heads import port_trainer

    from kuzu_torch.bridge import _targets
    from kuzu_torch.models.nas import NASDetector, YoloNAS
    from kuzu_torch.tasks.nas import NASTrainer

    src = nas_pair["det"]
    det = NASDetector("yolo_nas_s", nc=NC, imgsz=IMGSZ, device="cpu")
    det.graph.load_state_dict(src.graph.state_dict())
    graph = det.graph.train()
    boxes = 2 * np.array([[[8, 8, 32, 30], [36, 40, 60, 62]],
                          [[4, 20, 28, 44], [30, 6, 58, 34]]], np.float32)
    images = np.random.default_rng(2).integers(0, 256, (2, STEP_SZ, STEP_SZ, 3), dtype=np.uint8)
    batch = dict(image=images, gt_boxes=boxes,
                 gt_labels=np.array([[0, 2], [1, 0]], np.int32), mask_gt=np.ones((2, 2), bool))
    jdet, variables = nas_pair["jdet"], nas_pair["variables"]

    def loss(params, stats, b):
        feats, mutated = jdet.apply({"params": params, "batch_stats": stats}, b["image"],
                                    train=True, mutable=["batch_stats"])
        total, metrics = jax_loss(feats, b["gt_labels"], b["gt_boxes"], b["mask_gt"], nc=NC,
                                  imgsz=STEP_SZ, strides=(8, 16, 32))
        return total, (metrics, mutated["batch_stats"])

    (jtotal, (jmetrics, jstats)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = port_trainer(NASTrainer, {}, det.spec, STEP_SZ)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = trainer.loss_fn(graph, tbatch)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in ("box_loss", "cls_loss", "dfl_loss", "num_fg"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert float(metrics["num_fg"]) > 0
    jstats = numpy_tree(jstats)
    for path, tensor, _ in _targets(graph):
        if path[0] == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), _leaf(jstats, path[1:]), rtol=1e-5,
                                       atol=1e-6, err_msg="/".join(path))
    # the gradients: both f32 vectors against the port's f64 one
    g64 = YoloNAS(NC, "s", 16, torch.float64)
    g64.load_state_dict(src.graph.state_dict())
    g64.double().train()
    batch64 = dict(tbatch, gt_boxes=tbatch["gt_boxes"].double())
    trainer.loss_fn(g64, batch64)[0].backward()
    exact = flax_variables(g64, {n: p.grad for n, p in g64.named_parameters()},
                           collections=("params",))["params"]
    jgrads = numpy_tree(jgrads)
    top = max(float(p.grad.abs().max()) for p in g64.parameters())
    sq = {"port": 0.0, "jax": 0.0, "f64": 0.0}
    n = 0
    for path, tensor, layout in _targets(graph):
        if path[0] != "params":
            continue
        got = tensor.grad.numpy().astype(np.float64)
        got = flax_layout(got) if layout else got
        ref, want = _leaf(exact, path[1:]), _leaf(jgrads, path[1:])
        atol = max(1e-4 * float(np.abs(ref).max()), 1e-6 * top)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=atol, err_msg="/".join(path))
        sq["port"] += float(((got - ref) ** 2).sum())
        sq["jax"] += float(((want - ref) ** 2).sum())
        sq["f64"] += float((ref ** 2).sum())
        n += 1
    assert n == len(list(graph.parameters()))
    rel = {k: (sq[k] / sq["f64"]) ** 0.5 for k in ("port", "jax")}
    print(f"gradient vectors from the f64 one, relative: {rel}")
    assert rel["jax"] <= 1e-2 and rel["port"] <= min(rel["jax"], 1e-4), rel


def test_param_counts_equal_flax():
    from kuzu.models.nas import YoloNAS as JaxYoloNAS

    from kuzu_torch.models.nas import YoloNAS, nas_size

    counts = {}
    for size in "sml":
        with torch.device("meta"):
            port = YoloNAS(80, size)
        shapes = jax.eval_shape(lambda s=size: JaxYoloNAS(nc=80, size=s).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
        leaves = lambda tree: sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
        counts[size] = sum(p.numel() for p in port.parameters())
        assert counts[size] == leaves(shapes["params"]), size
        stats = sum(b.numel() for n, b in port.named_buffers()
                    if not n.endswith("num_batches_tracked"))  # torch's BatchNorm2d counter
        assert stats == leaves(shapes["batch_stats"]), size
    assert counts["s"] < counts["m"] < counts["l"] and counts["s"] > 1e6
    assert nas_size("yolo_nas") == "s"
    with pytest.raises(ValueError, match="unknown YOLO-NAS size"):
        nas_size("yolo_nas_x")


def test_nas_task_trains_validates_and_predicts(tmp_path):
    """``Model("yolo_nas_s", task="nas")``: one epoch on a PNG folder (the
    card's machine decodes no JPEG), the run dir validated (the keys of the
    training's own validation, equal) and predicted over (boxes inside the
    frames)."""
    from kuzu_torch.api.model import Model, task_map
    from kuzu_torch.testing import write_yolo_folder

    assert {"trainer", "validator", "predictor"} <= set(task_map()["nas"])
    data = write_yolo_folder(tmp_path / "data", {"train": 4, "val": 2}, hw=(96, 96), nc=2)
    final = Model("yolo_nas_s", task="nas", device="cpu").train(
        data=str(data), imgsz=IMGSZ, batch=2, epochs=1, workers=0, dtype="float32",
        optimizer="adamw", lr0=0.002, warmup_epochs=0.0, close_mosaic=0, max_boxes=20,
        project=str(tmp_path / "runs"), name="nas", exist_ok=True, verbose=False)
    assert np.isfinite(final["loss"]) and "map50" in final
    run = tmp_path / "runs" / "nas" / "nas"
    assert (run / "weights").is_dir()
    got = Model(str(run), device="cpu").val(data=str(data), project=str(tmp_path / "v"))
    assert {"map50", "map", "fitness"} <= set(got) and got == {k: final[k] for k in got}
    res = Model(str(run), device="cpu").predict(str(tmp_path / "data" / "images" / "val"),
                                               conf=0.0001)
    assert len(res) == 2
    for r in res:
        assert r.boxes.xyxy.shape[1] == 4 and len(r) > 0
        assert (r.boxes.xyxy >= 0).all() and (r.boxes.xyxy <= 96).all()
