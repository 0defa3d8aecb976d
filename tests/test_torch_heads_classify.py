"""The Classify head and the classify task in the port against the JAX
package on the CPU, the module trees of all four head yamls at every scale,
and the ``Model`` facade over the four new tasks.

- module trees: parameter and BatchNorm-statistic counts equal flax's for
  yolov8{n,s,m,l,x}-{seg,pose,obb,cls} (shapes only, no forward);
- yolov8n-cls at 64 px, batch 4, 5 classes: the train-mode forward in f64
  (logits within 1e-6: flax's Dense runs in f32 whatever the weights'
  dtype; statistics within 1e-9), one f32 ``ClassifyTrainer`` step with
  label smoothing against JAX's (the detector pair's checks), the
  validation's accuracy equal and its loss within 1e-5, the predictor's
  top-5 identical;
- data: PIL's ``convert("L")`` byte for byte, ``GlyphFolderDataset`` sample
  for sample against JAX's (grayscale and RGB);
- facade: the task a name guesses (JAX's), one training step of each task
  through ``Model(..., task=...)``, and the SimpleViT route training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_heads import (check_step, f64_forward_pair, jax_graph, jax_trainer, port_trainer,
                         seeded_graph, step_pair)
from torch_parity import flax_variables

NAME, IMGSZ, NC = "yolov8n-cls", 64, 5


@pytest.mark.parametrize("scale", list("nsmlx"))
@pytest.mark.parametrize("head", ["seg", "pose", "obb", "cls"])
def test_param_and_statistic_counts_match_flax(head, scale):
    """The port's module tree (built on the meta device) holds as many
    parameters and BatchNorm statistics as flax's init tree (from
    ``eval_shape``), at the yaml's own nc: Segment's width-scaled prototype
    channels and Pose's ``max(ch[0] // 4, 51)`` branch width included."""
    from kuzu.models.yolo.graph import YoloGraph as JaxGraph

    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec

    path, sc = resolve_model_spec(f"yolov8{scale}-{head}")
    spec = parse_model_yaml(path, scale=sc)
    with torch.device("meta"):
        graph = YoloGraph(spec)
    shapes = jax.eval_shape(lambda: JaxGraph(spec).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    count = lambda tree: sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
    bns = [m for m in graph.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert sum(p.numel() for p in graph.parameters()) == count(shapes["params"])
    assert sum(2 * m.num_features for m in bns) == count(shapes["batch_stats"])


@pytest.fixture(scope="module")
def cls_graph():
    return seeded_graph(NAME, NC)


def test_train_forward_matches_flax_in_f64(cls_graph):
    """The logits within 1e-6 (the Dense in f32 on both sides) and every new
    running statistic within 1e-9."""
    from kuzu_torch.bridge import _targets

    graph, variables = cls_graph
    x = np.random.default_rng(0).random((4, IMGSZ, IMGSZ, 3))
    jout, jstats, tout, g64 = f64_forward_pair(graph, variables, x)
    assert len(jout) == len(tout) == 1 and tout[0].shape == (4, NC)
    assert tout[0].dtype == np.float32
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6, atol=1e-6)
    n = 0
    for path, tensor, _ in _targets(g64):
        if path[0] == "batch_stats":
            want = jstats
            for key in path[1:]:
                want = want[key]
            np.testing.assert_allclose(tensor.numpy(), want, rtol=1e-9, atol=1e-11)
            n += 1
    assert n > 0


def cls_batch(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (4, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "label": np.array([0, 3, 1, 4], np.int32)}


def test_classify_trainer_step_matches_jax():
    """One f32 step of ``ClassifyTrainer.loss_fn`` (label smoothing 0.1,
    optax's smoothed softmax cross-entropy) against JAX's: the loss and the
    accuracy, every gradient leaf, the statistics, the update and the EMA."""
    from kuzu.tasks.classify import ClassifyTrainer as JaxTrainer

    from kuzu_torch.tasks.classify import ClassifyTrainer

    graph, variables = seeded_graph(NAME, NC)
    cfg = dict(label_smoothing=0.1)
    jt = jax_trainer(JaxTrainer, cfg, model=jax_graph(graph.spec),
                     _model_state={"batch_stats": variables["batch_stats"]})
    tt = port_trainer(ClassifyTrainer, cfg)
    pair = step_pair(graph, variables, jt.loss_fn, tt.loss_fn, cls_batch())
    check_step(pair, ("loss", "acc", "grad_norm"))


def test_l_conversion_matches_pil():
    """``rgb_to_l_u8`` against PIL's ``convert("L")`` on every gray level
    of each channel and random pixels."""
    from PIL import Image

    from kuzu_torch.data.image_io import rgb_to_l_u8

    ramp = np.zeros((3, 256, 3), np.uint8)
    for c in range(3):
        ramp[c, :, c] = np.arange(256)
    rng = np.random.default_rng(0)
    for img in (ramp, rng.integers(0, 256, (64, 97, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(rgb_to_l_u8(img),
                                      np.asarray(Image.fromarray(img).convert("L")))


@pytest.fixture(scope="module")
def glyphs(tmp_path_factory):
    from kuzu_torch.testing import write_glyph_folder

    return write_glyph_folder(tmp_path_factory.mktemp("glyphs"), {"train": 3, "val": 2},
                              n_classes=NC)


@pytest.mark.parametrize("channels", [1, 3])
def test_glyph_dataset_matches_jax(glyphs, channels):
    """Every sample of the folder (46 x 52 pages resized to 64 and 24):
    the same class map, images byte-equal and the same labels."""
    from kuzu.data.folder_dataset import GlyphFolderDataset as JaxDataset

    from kuzu_torch.data.folder_dataset import GlyphFolderDataset

    for size in (64, 24):
        port = GlyphFolderDataset(glyphs / "train", size, channels)
        ref = JaxDataset(glyphs / "train", size, channels)
        assert port.class_map == ref.class_map and len(port) == len(ref) == 3 * NC
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert got["image"].shape == want["image"].shape == (size, size, channels)
            np.testing.assert_array_equal(got["image"], want["image"])
            assert got["label"] == want["label"]


@pytest.fixture(scope="module")
def cls_run(glyphs, tmp_path_factory):
    """A port classify run on the glyph folder through the facade (one epoch
    of 2 steps, 64 px)."""
    from kuzu_torch.api.model import Model

    project = tmp_path_factory.mktemp("runs")
    final = Model(NAME, task="classify", device="cpu").train(
        data=str(glyphs), imgsz=IMGSZ, batch=8, epochs=1, workers=0, project=str(project),
        name="cls", exist_ok=True, verbose=False, label_smoothing=0.1)
    return final, project / "classify" / "cls"


def test_validation_and_prediction_match_jax(cls_run, glyphs):
    """The run's weights in JAX: ``ClassifyTrainer.validate`` on the val
    split (the same accuracy; the mean cross-entropy, f32 through the
    network, within 1e-5 relative), and JAX's ``ClassifyPredictor`` on the
    val images against the port's: the same classes, the same top-5,
    confidences within 1e-5 relative."""
    from PIL import Image

    from kuzu.core.config import load_config as j_config
    from kuzu.core.mesh import make_mesh
    from kuzu.tasks.classify import ClassifyPredictor as JaxPredictor
    from kuzu.tasks.classify import ClassifyTrainer as JaxTrainer

    from kuzu_torch.api.model import Model
    from kuzu_torch.tasks.classify import ClassifyPredictor

    final, run_dir = cls_run
    got = Model(str(run_dir), device="cpu").val(data=str(glyphs), project=str(run_dir.parent))
    assert {k: final[k] for k in got} == got
    tp = ClassifyPredictor(Model(str(run_dir))._cfg("predict"), device="cpu")
    tp._setup()
    variables = flax_variables(tp.model)
    jt = object.__new__(JaxTrainer)
    jt.cfg = j_config(overrides=dict(data=str(glyphs), imgsz=IMGSZ, batch=8, workers=0,
                                     model=NAME))
    jt.save_dir, jt.mesh = run_dir.parent / "jax", make_mesh(1, 1)
    jt.save_dir.mkdir(exist_ok=True)
    _, jt.val_loader = jt.build_datasets()
    jt.model = jax_graph(tp.model.spec)
    want = jt.validate(type("S", (), dict(ema_params=None, params=variables["params"],
                                          model_state={"batch_stats":
                                                       variables["batch_stats"]}))())
    assert set(want) == set(got)
    assert got["acc"] == want["acc"] and got["fitness"] == want["fitness"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)

    images = sorted((glyphs / "val").rglob("*.png"))
    jp = JaxPredictor(j_config(overrides={}))
    jp.idx_to_name, jp.imgsz, jp.channels = tp.idx_to_name, IMGSZ, 3
    jp.min_bucket, jp._put, jp.variables, jp.ready = 1, jnp.asarray, variables, True
    module = jax_graph(tp.model.spec)
    jp._fwd = jax.jit(lambda v, x: jax.nn.softmax(module.apply(v, x, train=False), -1))
    wres, gres = jp(images), tp(images)
    pages = [np.asarray(Image.open(p).convert("RGB").resize((IMGSZ, IMGSZ), Image.BILINEAR))
             for p in images]
    probs = np.asarray(jp._fwd(variables, jnp.asarray(np.stack(pages))))
    assert len(gres) == len(wres) == len(images)
    for g, w, pr in zip(gres, wres, probs):
        assert (g["path"], g["class"], g["name"]) == (w["path"], w["class"], w["name"])
        assert g["confidence"] == pytest.approx(w["confidence"], rel=1e-5)
        assert g["top5"] == [int(c) for c in np.argsort(-pr, kind="stable")[:5]]


@pytest.mark.parametrize("name", ["yolov8n-seg", "yolov8n-pose", "yolov8n-obb", "yolov8n-cls",
                                  "simplevit", "yolov8n"])
def test_model_guesses_the_task_as_jax(name):
    """A name guesses JAX's task: by its markers alone, so a head model's
    name guesses detect and its task is named explicitly, as in JAX."""
    from kuzu.api.model import Model as JaxModel

    from kuzu_torch.api.model import Model

    assert Model(name).task == JaxModel(name).task


@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_model_trains_each_head(task, tmp_path):
    """``Model("yolov8n-<head>", task=...)`` trains a step on a folder of its
    task, writes a run dir that ``val`` and ``predict`` read back, and its
    validation's keys are JAX's."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.testing import write_head_folder

    data = write_head_folder(tmp_path / "data", task, {"train": 2, "val": 2}, hw=(70, 90),
                             nc=2, kpt_shape=(5, 3))
    suffix = {"segment": "seg", "pose": "pose", "obb": "obb"}[task]
    final = Model(f"yolov8n-{suffix}", task=task, device="cpu").train(
        data=str(data), imgsz=IMGSZ, batch=2, epochs=1, workers=0,
        project=str(tmp_path / "runs"), name="r", exist_ok=True, verbose=False)
    assert np.isfinite(final["loss"])
    run = tmp_path / "runs" / task / "r"
    got = Model(str(run), device="cpu").val(data=str(data), project=str(tmp_path / "v"))
    keys = {"segment": {"map50", "map", "fitness"},
            "pose": {"map50", "map", "pose_map50", "pose_map", "fitness"},
            "obb": {"map50", "map", "precision", "recall", "f1", "fitness"}}[task]
    assert keys <= set(got) and got == {k: final[k] for k in got}
    res = Model(str(run), device="cpu").predict(str(tmp_path / "data" / "images" / "val"),
                                               conf=0.001)
    assert len(res) == 2
    extra = {"segment": "masks", "pose": "keypoints", "obb": "obb"}[task]
    assert all(getattr(r, extra) is not None and len(getattr(r, extra)) == len(r)
               for r in res)


def test_simplevit_classify_names_its_item(glyphs, tmp_path):
    """The SimpleViT route of the classify task is ported (the item it named
    is done): a name without ``-cls`` trains a SimpleViT on the glyph
    folder's grayscale images (held against JAX in
    ``test_torch_encoders.py``)."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.models.simple_vit import SimpleViT

    m = Model("simplevit", task="classify", device="cpu")
    final = m.train(data=str(glyphs), imgsz=32, patch=8, dim=32, depth=1, heads=2, batch=4,
                    epochs=1, workers=0, project=str(tmp_path), name="v", exist_ok=True,
                    verbose=False)
    assert np.isfinite(final["loss"])
    assert isinstance(m._trainer.state.model, SimpleViT)
