"""The port's cascade from image files against JAX's on the CPU, on seeded
weights: ``process_page``'s reference-shaped flow (``tile_grid=0``: columns,
each column's crop read, its characters detected inside it),
``process_pages`` with ``tile_grid=0``, the tiled host path
(``ship_once=False``, and pages of mixed shapes, which take it on their
own), the ``yc`` transport, and ``save_result``.

As in tests/test_torch_cascade.py, the detectors stay at init with their
Detect biases set by ``box_head``: every anchor scores sigmoid(-4.6) and both
sides keep the same index-ordered candidates, so boxes are held within 1e-3
px and scores within an f32 ulp (``SCORE_RTOL``). The letterboxes and crops
on these paths are cv2's resize on both sides (the port's to the byte), so
texts are held equal. The ``yc`` transport rebuilds RGB through a bilinear
chroma upsample whose pixels may differ by a level (``F.interpolate`` against
``jax.image.resize``): its columns are held as above, its texts to
``YC_TEXTS``.

With those heads the columns hardly depend on the pixels. So the host path
(``ship_once=False``, and mixed shapes) also runs with a column detector
whose BatchNorm is calibrated on the pages (page-dependent scores), both
sides on their f32 forwards (the JAX predictor's flax apply): its letterbox,
tiles and geometry feed a detector that reads the pixels, and its columns
are held by ``testing.detections_match`` to ``CAL_MATCH`` both ways."""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.testing import box_head, detections_match, mixed_pages, page_files

SCORE_RTOL = 1e-6  # torch.sigmoid and jax.nn.sigmoid differ by an f32 ulp at times
YC_TEXTS = 0.9  # share of columns whose text is equal on the yc transport
EQUAL = [(192, 192), (192, 192)]
MIXED = [(192, 160), (160, 200), (176, 176)]
COL_MAX_DET = 12  # columns a page (a seeded head emits a column at every anchor)
CAL_MATCH = 0.9  # f32 maps summed in another order: near-equal boxes may swap in NMS


def _jax_crnn(variables, model, n_pad: int):
    """The JAX CTC recognizer stand-in: greedy decode of the CRNN, every
    batch padded to ``n_pad`` crops (one compile)."""
    from kuzu.ops.ctc import ctc_greedy_decode

    fwd = jax.jit(lambda v, x: ctc_greedy_decode(model.apply(v, x)[0]))

    def run(v, x):
        n = x.shape[0]
        if n > n_pad:
            raise ValueError(f"{n} crops: raise n_pad ({n_pad})")
        full = jnp.concatenate([x, jnp.zeros((n_pad - n, *x.shape[1:]), x.dtype)])
        seqs, lens = fwd(v, full)
        return (seqs[:n], lens[:n]), None

    return run


@pytest.fixture(scope="module")
def host_pair(tmp_path_factory):
    """JAX's ``KuzushijiPipeline`` with JAX ``DetectPredictor``s over the
    port's seeded detectors (the bf16 executor, Pallas interpreted) and a
    CRNN stand-in, and the port's pipeline over the same weights: yolov12n
    columns at 128 (reg_max 32, ``COL_MAX_DET`` a page), yolov12n
    characters at 64, a CRNN of 25 classes at [160, 40]. Pages: two of
    192 x 192 and three of mixed shapes, written as PNG (one
    Paeth-filtered). Runs every flow once on both sides."""
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.crnn import CRNN as JaxCRNN
    from kuzu.pipeline.cascade import KuzushijiPipeline as JaxPipeline

    from kuzu_torch.bridge import crnn_from_flax
    from kuzu_torch.data.yolo_dataset import letterbox_np
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.crnn import CRNN
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import calibrate_batch_norm
    from torch_parity import jax_detect_predictor, numpy_tree

    root = tmp_path_factory.mktemp("host_cascade")
    equal = mixed_pages(EQUAL, seed=10)
    mixed = mixed_pages(MIXED, seed=20)
    equal_paths = page_files(root / "equal", equal, paeth=(1,))
    mixed_paths = page_files(root / "mixed", mixed)

    col = box_head(YoloDetector("yolov12n", nc=1, imgsz=128, device="cpu", reg_max=32).init(0),
                   (1, 6, 1, 6))
    char = box_head(YoloDetector("yolov12n", nc=1, imgsz=64, device="cpu").init(1),
                    (1, 1, 1, 1))
    chars = "abcdefghijklmnopqrst"
    jmodel = JaxCRNN(num_classes=25, lstm_hidden=32)
    variables = numpy_tree(jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 160, 40, 3),
                                                                      jnp.uint8)))(
        jax.random.key(0)))
    variables["params"]["head"]["kernel"] = variables["params"]["head"]["kernel"] * 10

    jax_pipe = JaxPipeline(conf=0.001, max_det=2000, lm_mode="off")
    jax_pipe.column_det = jax_detect_predictor(col, "yolov12n", 0.001, COL_MAX_DET, pad_to=4)
    jax_pipe.char_det = jax_detect_predictor(char, "yolov12n", 0.001, 2000, pad_to=32)
    jax_pipe.recognizer = SimpleNamespace(
        ready=True, image_size=(160, 40), tokenizer=JaxTokenizer.train([chars]),
        variables=variables, min_bucket=1, _put=jnp.asarray,
        _fwd=_jax_crnn(variables, jmodel, 48))
    jax_pipe.rec_task = "ctc"
    port = KuzushijiPipeline(
        column_model=DetectPredictor.from_detector(col, conf=0.001, iou=0.7,
                                                   max_det=COL_MAX_DET),
        char_model=DetectPredictor.from_detector(char, conf=0.001, iou=0.7, max_det=2000),
        recognizer=CTCPredictor.from_model(crnn_from_flax(CRNN(25, lstm_hidden=32), variables),
                                           CharTokenizer.train([chars]), (160, 40),
                                           device="cpu"),
        max_det=2000, device="cpu")

    runs = {}

    def both(key, fn, **settings):
        for pipe in (jax_pipe, port):
            for k, v in settings.items():
                setattr(pipe, k, v)
        runs[key] = (fn(jax_pipe, "jax"), fn(port, "port"))

    both("page", lambda p, s: [p.process_page(mixed_paths[0])], tile_grid=0)
    both("flat", lambda p, s: p.process_pages(mixed_paths), tile_grid=0)
    both("host", lambda p, s: p.process_pages(equal_paths), tile_grid=2, ship_once=False)
    both("mixed", lambda p, s: p.process_pages(mixed_paths), tile_grid=2, ship_once=True)
    both("yc", lambda p, s: p.process_pages(equal_paths), tile_grid=2, transport="yc")
    port.transport = "rgb"
    # a column detector that reads the pixels: BatchNorm calibrated on the
    # pages' letterboxes, the f32 forward on both sides
    cal = copy.deepcopy(col)
    calibrate_batch_norm(cal.graph, torch.stack([torch.from_numpy(letterbox_np(p, 128)[0])
                                                 for p in equal + mixed]))
    box_head(cal, (1, 6, 1, 6))
    cal.infer = lambda images, g=cal.graph: g(images)
    seeded = jax_pipe.column_det, port.column_det
    jax_pipe.column_det = jax_detect_predictor(cal, "yolov12n", 0.001, COL_MAX_DET, f32=True,
                                               pad_to=4)
    port.column_det = DetectPredictor.from_detector(cal, conf=0.001, iou=0.7,
                                                    max_det=COL_MAX_DET)
    both("calibrated host", lambda p, s: p.process_pages(equal_paths), tile_grid=2,
         ship_once=False)
    both("calibrated mixed", lambda p, s: p.process_pages(mixed_paths), tile_grid=2,
         ship_once=True)
    jax_pipe.column_det, port.column_det = seeded
    # the port over decoded arrays and over a batch tensor, named as the files
    arrays = {"tensor": port.process_pages(torch.from_numpy(np.stack(equal))),
              "rgb files": port.process_pages(equal_paths)}
    port.tile_grid = 0
    arrays["flat"] = port.process_pages(mixed, names=[str(p) for p in mixed_paths])
    arrays["page"] = port.process_page(mixed[0], name="first")
    return SimpleNamespace(runs=runs, arrays=arrays, port=port, jax_pipe=jax_pipe,
                           equal_paths=equal_paths, mixed_paths=mixed_paths, root=root)


def _assert_columns(got: list[dict], want: list[dict], texts: bool = True) -> None:
    for g, w in zip(got, want, strict=True):
        assert g["image"] == w["image"]
        assert len(g["columns"]) == len(w["columns"]) > 0
        np.testing.assert_allclose([c["box"] for c in g["columns"]],
                                   [c["box"] for c in w["columns"]], atol=1e-3, rtol=0)
        np.testing.assert_allclose([c["score"] for c in g["columns"]],
                                   [c["score"] for c in w["columns"]], rtol=SCORE_RTOL, atol=0)
        if texts:
            assert [c["text"] for c in g["columns"]] == [c["text"] for c in w["columns"]]
            assert g["text"] == w["text"]


def _assert_chars(got: list[dict], want: list[dict], page_level: bool) -> None:
    """Per-column characters (and the page's, where the flow gives them)."""
    n = 0
    for g, w in zip(got, want, strict=True):
        for gc, wc in zip(g["columns"], w["columns"], strict=True):
            assert ("chars" in gc) == ("chars" in wc)
            if "chars" in wc:
                gb = np.reshape(gc["chars"]["boxes"], (-1, 4))
                assert gb.shape == np.reshape(wc["chars"]["boxes"], (-1, 4)).shape
                np.testing.assert_allclose(gb, np.reshape(wc["chars"]["boxes"], (-1, 4)),
                                           atol=1e-3, rtol=0)
                np.testing.assert_allclose(gc["chars"]["scores"], wc["chars"]["scores"],
                                           rtol=SCORE_RTOL, atol=0)
                n += len(gb)
        assert ("characters" in g) == ("characters" in w) == page_level
        if page_level:
            np.testing.assert_allclose(np.reshape(g["characters"]["boxes"], (-1, 4)),
                                       np.reshape(w["characters"]["boxes"], (-1, 4)),
                                       atol=1e-3, rtol=0)
    assert n > 0


def test_process_page_flat_matches_jax(host_pair):
    """``process_page(path)`` with ``tile_grid=0``: columns, texts, and the
    characters detected inside each column crop, mapped back to the page."""
    want, got = host_pair.runs["page"]
    _assert_columns(got, want)
    _assert_chars(got, want, page_level=True)
    assert got[0]["image"] == str(host_pair.mixed_paths[0])


def test_process_pages_flat_matches_jax(host_pair):
    """``process_pages`` with ``tile_grid=0`` over pages of three shapes:
    one recognizer batch for every page's crops, characters per column."""
    want, got = host_pair.runs["flat"]
    _assert_columns(got, want)
    _assert_chars(got, want, page_level=False)
    assert any(c["text"] for r in got for c in r["columns"])


@pytest.mark.parametrize("key", ["host", "mixed"])
def test_tiled_host_path_matches_jax(host_pair, key):
    """The tiled cascade's host path: ``ship_once=False`` on equal shapes,
    and pages of mixed shapes with ``ship_once`` on (routed there as the
    reference routes them): columns refined on the characters of each
    page's host tiles, texts of the host crops."""
    want, got = host_pair.runs[key]
    _assert_columns(got, want)
    _assert_chars(got, want, page_level=True)
    for r, shape in zip(got, EQUAL if key == "host" else MIXED):
        boxes = np.asarray([c["box"] for c in r["columns"]])
        assert (boxes >= 0).all() and (boxes[:, [1, 3]] <= shape[0]).all()
        assert (boxes[:, [0, 2]] <= shape[1]).all()


def _column_dets(results: list[dict]) -> dict:
    """Result columns as padded detections for ``detections_match``."""
    n = max(max(len(r["columns"]) for r in results), 1)
    out = {"boxes": np.zeros((len(results), n, 4), np.float32),
           "valid": np.zeros((len(results), n), bool),
           "classes": np.zeros((len(results), n), np.int32)}
    for i, r in enumerate(results):
        out["boxes"][i, :len(r["columns"])] = [c["box"] for c in r["columns"]]
        out["valid"][i, :len(r["columns"])] = True
    return out


@pytest.mark.parametrize("key", ["calibrated host", "calibrated mixed"])
def test_calibrated_host_path_matches_jax(host_pair, key):
    """The host path (``ship_once=False`` on equal shapes, and mixed
    shapes) with a calibrated column detector: columns that depend on the
    pixels the host letterbox and tiles produce, matched both ways."""
    want, got = host_pair.runs[key]
    w, g = _column_dets(want), _column_dets(got)
    assert w["valid"].sum(1).min() > 0 and g["valid"].sum(1).min() > 0
    assert detections_match(w, g) >= CAL_MATCH and detections_match(g, w) >= CAL_MATCH
    scores = [c["score"] for r in got for c in r["columns"]]
    assert len(np.unique(scores)) > len(scores) // 2  # scores depend on the page


def test_yc_transport_matches_jax(host_pair):
    """``transport="yc"``: the same columns and characters as JAX's yc
    cascade, texts to ``YC_TEXTS``."""
    want, got = host_pair.runs["yc"]
    _assert_columns(got, want, texts=False)
    _assert_chars(got, want, page_level=True)
    texts = [(g["text"], w["text"]) for r, s in zip(got, want)
             for g, w in zip(r["columns"], s["columns"])]
    assert sum(a == b for a, b in texts) >= YC_TEXTS * len(texts), texts


def test_decoded_pages_match_files(host_pair):
    """Decoded arrays (named as the files) and a (B, H, W, 3) tensor give the
    results of the files; ``process_page`` names its result."""
    runs, arrays = host_pair.runs, host_pair.arrays
    assert arrays["flat"] == runs["flat"][1]
    tensor, files = arrays["tensor"], arrays["rgb files"]
    assert [r["image"] for r in tensor] == [0, 1]
    assert [r["columns"] for r in tensor] == [r["columns"] for r in files]
    assert arrays["page"]["image"] == "first"
    assert arrays["page"]["columns"] == runs["page"][1][0]["columns"]


def test_save_result_matches_jax(host_pair, tmp_path):
    """``save_result``: the same YAML text, unicode kept."""
    result = dict(host_pair.runs["flat"][1][0], note="列の文字")
    host_pair.port.save_result(result, tmp_path / "port" / "r.yaml")
    host_pair.jax_pipe.save_result(result, tmp_path / "jax" / "r.yaml")
    text = (tmp_path / "port" / "r.yaml").read_text(encoding="utf-8")
    assert text == (tmp_path / "jax" / "r.yaml").read_text(encoding="utf-8")
    assert "列の文字" in text


@pytest.mark.parametrize("grid", [0, 2])
def test_detect_chars_matches_jax(host_pair, grid):
    """``detect_chars`` on a page file: over its overlap tiles merged by the
    cross-tile NMS (``tile_grid=2``, ``_detect_tiled``), or on the page
    letterboxed (``tile_grid=0``)."""
    path = host_pair.mixed_paths[1]
    host_pair.jax_pipe.tile_grid = host_pair.port.tile_grid = grid
    want = host_pair.jax_pipe.detect_chars(path)
    got = host_pair.port.detect_chars(path)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=SCORE_RTOL,
                               atol=0)
