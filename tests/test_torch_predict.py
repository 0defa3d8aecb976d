"""The port's predictors over image files against the JAX package's on the
CPU: ``DetectPredictor.__call__`` over files, a directory, a glob and decoded
arrays (its ``Results`` and their exports), ``CTCPredictor`` and
``RecognizePredictor`` over crop files, and the ``Model`` facade and the CLI
over a port run dir.

The detectors: a seeded yolov12n at init with ``box_head``'s Detect biases
(every anchor scores sigmoid(-4.6); the JAX side runs the port's bf16
executor with Pallas interpreted, so the maps and the letterboxes are
bit-equal and boxes are held within 1e-3 px), and the same detector with
its BatchNorm calibrated on the pages (page-dependent scores), where both
sides take their f32 forwards (the JAX predictor's flax apply on the CPU)
and are held by ``testing.detections_match`` to ``CAL_MATCH``."""

import copy
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.data.image_io import write_png
from kuzu_torch.testing import box_head, detections_match, mixed_pages, write_yolo_folder

SHAPES = [(160, 120), (100, 150), (128, 128)]
CAL_MATCH = 0.9  # f32 maps summed in another order: near-equal boxes may swap in NMS


def _padded(results) -> dict:
    n = max(max(len(r) for r in results), 1)
    out = {"boxes": np.zeros((len(results), n, 4), np.float32),
           "valid": np.zeros((len(results), n), bool),
           "classes": np.zeros((len(results), n), np.int32)}
    for i, r in enumerate(results):
        out["boxes"][i, :len(r)] = r.boxes.xyxy
        out["valid"][i, :len(r)] = True
        out["classes"][i, :len(r)] = r.boxes.cls
    return out


@pytest.fixture(scope="module")
def detect_pair(tmp_path_factory):
    """Both packages' predictors over three pages of three shapes, as PNG
    files (one Paeth-filtered) in a directory and as arrays; batch 2, so the
    pages split into groups of 2 and 1."""
    from kuzu_torch.data.yolo_dataset import letterbox_np
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import calibrate_batch_norm
    from torch_parity import jax_detect_predictor

    root = tmp_path_factory.mktemp("predict_pages")
    pages = mixed_pages(SHAPES, seed=3)
    paths = [write_png(root / f"p{i}.png", p, filter="paeth" if i == 2 else "sub")
             for i, p in enumerate(pages)]
    det = box_head(YoloDetector("yolov12n", nc=2, imgsz=128, device="cpu", reg_max=32).init(0),
                   (1, 6, 1, 6))
    cal = copy.deepcopy(det)
    calibrate_batch_norm(cal.graph, torch.stack([torch.from_numpy(letterbox_np(p, 128)[0])
                                                 for p in pages]))
    box_head(cal, (1, 6, 1, 6))
    cal.infer = lambda images, g=cal.graph: g(images)  # the f32 forward
    out = {}
    for key, d, f32 in (("seeded", det, False), ("calibrated", cal, True)):
        jp = jax_detect_predictor(d, "yolov12n", conf=0.001, max_det=50, f32=f32, pad_to=2,
                                  batch=2)
        jp.names = {0: "column", 1: "char"}
        tp = DetectPredictor.from_detector(d, conf=0.001, iou=0.7, max_det=50)
        tp.cfg["batch"], tp.names = 2, {0: "column", 1: "char"}
        out[key] = SimpleNamespace(jax=jp, port=tp)
    return SimpleNamespace(root=root, pages=pages, paths=paths, **out)


@pytest.mark.parametrize("kind", ["directory", "glob", "arrays", "paths"])
def test_detect_predictor_matches_jax(detect_pair, kind):
    """Seeded detector: the same boxes (1e-3 px), scores (an f32 ulp),
    classes, paths and shapes from every kind of source."""
    src = {"directory": str(detect_pair.root), "glob": str(detect_pair.root / "*.png"),
           "arrays": list(detect_pair.pages), "paths": [str(p) for p in detect_pair.paths]}[kind]
    want = detect_pair.seeded.jax(src)
    got = detect_pair.seeded.port(src)
    assert len(got) == len(want) == len(SHAPES)
    for g, w, shape in zip(got, want, SHAPES):
        assert g.path == w.path and g.boxes.orig_shape == w.boxes.orig_shape == shape
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g.boxes.cls, w.boxes.cls)
        assert g.speed["inference_ms"] > 0


def test_detect_predictor_sources_agree(detect_pair):
    """The directory, the glob and the decoded arrays give equal Results,
    and the port's Results export as JAX's do."""
    port = detect_pair.seeded.port
    runs = [port(str(detect_pair.root)), port(str(detect_pair.root / "*.png")),
            port(list(detect_pair.pages))]
    for other in runs[1:]:
        for a, b in zip(runs[0], other, strict=True):
            np.testing.assert_array_equal(a.boxes.xyxy, b.boxes.xyxy)
            np.testing.assert_array_equal(a.boxes.conf, b.boxes.conf)
    want = detect_pair.seeded.jax(str(detect_pair.root))
    for g, w in zip(runs[0], want):
        assert g.to_json() == w.to_json()
        np.testing.assert_allclose(g.boxes.xywhn, w.boxes.xywhn, atol=1e-5)
        assert g.filter(min_conf=0.0, classes=[0]).to_json() == \
            w.filter(min_conf=0.0, classes=[0]).to_json()


def test_detect_predictor_calibrated_matches_jax(detect_pair):
    """Page-dependent scores (calibrated BatchNorm, f32 forwards): detections
    matched both ways."""
    src = str(detect_pair.root)
    want = detect_pair.calibrated.jax(src)
    got = detect_pair.calibrated.port(src)
    w, g = _padded(want), _padded(got)
    assert w["valid"].sum(1).min() > 0
    assert detections_match(w, g) >= CAL_MATCH and detections_match(g, w) >= CAL_MATCH
    scores = np.concatenate([r.boxes.conf for r in got])
    assert len(np.unique(scores)) > len(scores) // 2  # scores depend on the page


# ------------------------------------------------------------ recognizers


@pytest.fixture(scope="module")
def crop_files(tmp_path_factory):
    """Column crops of several aspects as PNG, and one as JPEG (decoded by
    PIL, the reference's reader, on both sides)."""
    from kuzu_torch.testing import column_pages

    root = tmp_path_factory.mktemp("crops")
    page = column_pages(1, 384, seed=6)[0]
    crops = [page[10:370, 330:372], page[40:200, 300:340], page[0:384, 200:260],
             page[100:160, 100:240]]
    paths = [write_png(root / f"c{i}.png", np.ascontiguousarray(c)) for i, c in enumerate(crops)]
    cv2.imwrite(str(root / "c4.jpg"), np.ascontiguousarray(crops[0][..., ::-1]))
    return paths + [root / "c4.jpg"]


def test_ctc_predictor_over_files_matches_jax(crop_files):
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.crnn import CRNN as JaxCRNN
    from kuzu.ops.ctc import ctc_greedy_decode
    from kuzu.tasks.ctc import CTCPredictor as JaxCTCPredictor

    from kuzu_torch.bridge import crnn_from_flax
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.crnn import CRNN
    from kuzu_torch.tasks.ctc import CTCPredictor
    from torch_parity import numpy_tree

    chars = "abcdefghijklmnopqrst"
    jmodel = JaxCRNN(num_classes=25, lstm_hidden=32)
    variables = numpy_tree(jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 160, 40, 3), jnp.uint8)))(jax.random.key(1)))
    variables["params"]["head"]["kernel"] = variables["params"]["head"]["kernel"] * 10
    jp = JaxCTCPredictor(None)
    jp.ready, jp.image_size, jp.min_bucket, jp._put = True, (160, 40), 1, jnp.asarray
    jp.tokenizer, jp.variables = JaxTokenizer.train([chars]), variables
    jp._fwd = jax.jit(lambda v, x: (ctc_greedy_decode(jmodel.apply(v, x)[0]), None))
    tp = CTCPredictor.from_model(crnn_from_flax(CRNN(25, lstm_hidden=32), variables),
                                 CharTokenizer.train([chars]), (160, 40), device="cpu")
    files = [str(p) for p in crop_files]
    want = jp(files)
    assert tp(files) == want and any(want)
    assert tp(files[1]) == jp(files[1])  # one path


def test_recognize_predictor_over_files_matches_jax(crop_files):
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.trocr import TrOCR as JaxTrOCR
    from kuzu.tasks.recognize import RecognizePredictor as JaxRecognizePredictor

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.core.config import Config
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.trocr import TrOCR
    from kuzu_torch.tasks.recognize import RecognizePredictor
    from torch_parity import TOKEN_CHARS, TROCR_KW, jax_trocr_variables

    trocr = jax_trocr_variables()
    jp = JaxRecognizePredictor(Config())
    jp.ready, jp.image_size, jp.min_bucket, jp._put = True, (128, 32), 1, jnp.asarray
    jp.tokenizer = JaxTokenizer.train([TOKEN_CHARS])
    jp.model, jp.params = JaxTrOCR(**TROCR_KW, ctc_head=True), trocr["params"]
    tp = RecognizePredictor.from_model(from_flax(TrOCR(**TROCR_KW, ctc_head=True), trocr),
                                       CharTokenizer.train([TOKEN_CHARS]), (128, 32),
                                       device="cpu")
    files = [str(p) for p in crop_files[:4]]
    want = jp(files)
    assert tp(files) == want and len(set(want)) > 1


# ------------------------------------------------------- facade and CLI


@pytest.fixture(scope="module")
def detect_run(tmp_path_factory):
    """A detector run dir as DetectTrainer writes it (yolov12n at 64, two
    classes) and a directory of three pages."""
    import yaml

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState
    from kuzu_torch.models.yolo.detector import YoloDetector

    run = tmp_path_factory.mktemp("detect_run")
    load_config(overrides={"task": "detect", "model": "yolov12n", "imgsz": 64}).to_yaml(
        run / "args.yaml")
    (run / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 2, "names": {0: "a", 1: "b"}}))
    det = box_head(YoloDetector("yolov12n", nc=2, imgsz=64, device="cpu").init(2), (1, 2, 1, 2))
    CheckpointManager(run / "weights").save(
        TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1)), fitness=1.0)
    pages = tmp_path_factory.mktemp("cli_pages")
    for i, p in enumerate(mixed_pages(SHAPES[:3], seed=8)):
        write_png(pages / f"p{i}.png", p)
    return run, pages


def test_model_predict_on_a_port_run_dir(detect_run, tmp_path):
    from kuzu_torch.api.model import YOLO, Model
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tasks.detect import DetectPredictor

    run, pages = detect_run
    model = Model(str(run), device="cpu")
    assert model.task == "detect"
    got = model.predict(str(pages), conf=0.001, max_det=20)
    want = DetectPredictor(load_config(overrides={"model": str(run), "conf": 0.001,
                                                  "max_det": 20}), device="cpu")(str(pages))
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert [len(r) for r in got] == [20, 20, 20] and got[0].names == {0: "a", 1: "b"}
    assert [r.to_json() for r in model(str(pages), conf=0.001, max_det=20)] == \
        [r.to_json() for r in got]
    assert YOLO(str(run)).task == "detect"
    tracked = model.track(str(pages), conf=0.001, max_det=20)
    assert len(tracked) == 3 and all(r.boxes.id is not None and len(r.boxes.id) == len(r)
                                     for r in tracked)
    # tune, export and benchmark run on the run dir: one short tuning
    # iteration from its weights, the default export (the .pt2 program and
    # its .json under the run), one benchmark row of its architecture
    data = write_yolo_folder(tmp_path / "data", {"train": 2, "val": 1}, hw=(48, 64), nc=2)
    tuned = model.tune(iterations=1, model="yolov12n", pretrained=str(run / "weights"),
                       data=str(data), epochs=1, imgsz=64, batch=2, workers=0,
                       project=str(tmp_path), tune_dir=str(tmp_path / "tune"))
    assert np.isfinite(tuned["best_fitness"]) and "lr0" in tuned
    blob = model.export()
    assert blob == run / "export" / "detector.pt2" and blob.with_suffix(".json").exists()
    rows = model.benchmark(imgsz=64, batches=(1,))["rows"]
    assert [(r["model"], r["batch"]) for r in rows] == [("yolov12n", 1)]
    assert Model("crnn").task == "ctc" and Model("trocr_base").task == "recognize"


def test_cli_predict_on_a_port_run_dir(detect_run, capsys):
    """``python -m kuzu_torch.api.cli predict detect model=<run> source=<dir>
    device=cpu`` prints one line a result, as the JAX CLI does."""
    from kuzu_torch.api import cli

    run, pages = detect_run
    assert cli.main(["predict", "detect", f"model={run}", f"source={pages}", "device=cpu",
                     "conf=0.001", "max_det=7"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"[{i}] {pages / f'p{i}.png'}: 7 boxes" for i in range(3)]
    assert cli.main(["predict", "nosuchtask"]) == 2
    assert cli.main([]) == 0 and "usage" in capsys.readouterr().out
