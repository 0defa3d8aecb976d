"""The port's ship-once tiled cascade against the JAX package on the CPU:
device pages (letterbox, tiles, crops), the cross-tile merge, the copied
column geometry, ``DetectPredictor`` over a port run dir, and the whole
``process_pages`` against JAX's ``_process_pages_tiled`` on seeded weights.

Pixels from the two resize kernels (``F.interpolate`` against
``jax.image.resize``'s weight matrices) may differ by one level after
rounding where the f32 result lies on a .5 edge: held to at most one level
per pixel and at least 99.9% of pixels exact. Geometry (tile bounds, gains,
pads, keeps) is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.pipeline import device_pages as tdp
from kuzu_torch.pipeline import tiling as ttl
from kuzu_torch.testing import box_head, column_pages

PIXEL_EXACT_SHARE = 0.999  # share of pixels equal; the rest within one level


def assert_pixels_close(got, want) -> None:
    got, want = np.asarray(got).astype(np.int16), np.asarray(want).astype(np.int16)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= PIXEL_EXACT_SHARE, (diff == 0).mean()


@pytest.fixture(scope="module")
def pages():
    """Three seeded pages (256 x 192: not square, so the letterbox pads) and
    random-noise pages, whose every pixel is an edge for the resize."""
    ink = column_pages(3, 256, seed=0)[:, :, 32:224]
    noise = np.random.default_rng(0).integers(0, 256, (3, 256, 192, 3), dtype=np.uint8)
    return {"ink": ink, "noise": noise}


@pytest.mark.parametrize("kind", ["ink", "noise"])
@pytest.mark.parametrize("size", [128, 320])  # down- and upscale
def test_device_letterbox_matches_jax(pages, kind, size):
    from kuzu.pipeline.device_pages import device_letterbox as jax_letterbox

    x = pages[kind]
    want, wgain, wpad = jax.jit(lambda p: jax_letterbox(p, size))(jnp.asarray(x))
    got, gain, pad = tdp.device_letterbox(torch.from_numpy(x), size)
    assert (gain, pad) == (wgain, wpad)
    assert_pixels_close(got, want)


@pytest.mark.parametrize("kind", ["ink", "noise"])
def test_device_tiles_match_jax(pages, kind):
    from kuzu.pipeline.device_pages import device_tiles as jax_tiles

    x = pages[kind]
    want, wmetas = jax.jit(lambda p: jax_tiles(p, 2, 0.15, 96))(jnp.asarray(x))
    got, metas = tdp.device_tiles(torch.from_numpy(x), 2, 0.15, 96)
    assert metas == wmetas
    assert tuple(got.shape) == (12, 96, 96, 3)
    assert_pixels_close(got, want)


@pytest.mark.parametrize("hw", [(256, 192), (1280, 1280), (1000, 733)])
@pytest.mark.parametrize("grid", [2, 3])
def test_tile_bounds_and_grid_match_jax(hw, grid):
    from kuzu.pipeline.device_pages import tile_bounds_px
    from kuzu.pipeline.tiling import grid_bounds

    assert ttl.grid_bounds(grid, 0.15) == grid_bounds(grid, 0.15)
    assert tdp.tile_bounds_px(*hw, grid, 0.15) == tile_bounds_px(*hw, grid, 0.15)


def _crop_windows():
    """Column windows: interior, page edges, thin and wide, a window larger
    than the crop on both axes, one under a pixel wide, one past the page
    (clamped taps), and one whose gain times its width is a whole number
    (71 px into 40: the true f32 quotient 40 / 71 gives 40 columns of
    content, torch's reciprocal-times-scalar 39)."""
    return np.array([
        [10, 20, 40, 200], [100, 5, 130, 120], [0, 0, 192, 256], [150.6, 30.2, 191.9, 255.7],
        [60, 100, 61.5, 140], [5, 250, 180, 256], [20.4, 10.8, 20.9, 90], [170, 200, 200, 270],
        [61, 0, 132, 192],
    ], np.float32)


@pytest.mark.parametrize("kind", ["ink", "noise"])
@pytest.mark.parametrize("out_hw", [(128, 32), (160, 40)])
def test_device_crops_match_jax(pages, kind, out_hw):
    from kuzu.pipeline.device_pages import device_crops as jax_crops

    x = pages[kind]
    boxes = _crop_windows()
    pidx = np.arange(len(boxes), dtype=np.int32) % len(x)
    want = jax_crops(jnp.asarray(x), jnp.asarray(pidx), jnp.asarray(boxes), out_h=out_hw[0],
                     out_w=out_hw[1], chunk=4)
    got = tdp.device_crops(torch.from_numpy(x), torch.from_numpy(pidx),
                           torch.from_numpy(boxes), out_h=out_hw[0], out_w=out_hw[1], chunk=4)
    assert tuple(got.shape) == (len(boxes), *out_hw, 3)
    assert_pixels_close(got, want)
    # the letterbox fill beyond the content is exact
    assert ((np.asarray(want) == 255) <= (got.numpy() == 255)).mean() >= PIXEL_EXACT_SHARE


def _tile_dets(rng, n_tiles: int, k: int, page: int):
    dets = []
    for _ in range(n_tiles):
        n = 0 if page == 1 else k
        xy = rng.uniform(0, 90, (k, 2)).astype(np.float32)
        wh = rng.uniform(3, 30, (k, 2)).astype(np.float32)
        valid = np.zeros(k, bool)
        valid[:n] = rng.random(n) > 0.2
        dets.append({"boxes": np.concatenate([xy, xy + wh], 1),
                     "scores": np.round(rng.uniform(0.05, 1.0, k), 2).astype(np.float32),
                     "classes": rng.integers(0, 2, k).astype(np.int32), "valid": valid})
    return dets


@pytest.mark.parametrize("k", [50, 400])  # candidate buckets 256 and 1024
def test_merge_tile_detections_pages_matches_jax(k):
    """Keeps, boxes, scores and classes exactly, a page with no candidates
    included; the metas are a 2x2 tiling's."""
    from kuzu.pipeline.tiling import merge_tile_detections_pages

    rng = np.random.default_rng(k)
    _, metas = tdp.device_tiles(torch.zeros((1, 256, 192, 3), dtype=torch.uint8), 2, 0.15, 96)
    per_page = [_tile_dets(rng, len(metas), k, p) for p in range(3)]
    kw = dict(iou_thres=0.55, max_det=300, page_shapes=[(256, 192)] * 3)
    want = merge_tile_detections_pages(per_page, [metas] * 3, **kw)
    got = ttl.merge_tile_detections_pages(per_page, [metas] * 3, device="cpu", **kw)
    assert len(got[1]["boxes"]) == 0 and len(got[0]["boxes"]) > 0
    for g, w in zip(got, want):
        for key in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(g[key], np.asarray(w[key]))
    one = ttl.merge_tile_detections(per_page[2], metas, iou_thres=0.55, max_det=300,
                                    page_shape=(256, 192), device="cpu")
    for key in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(one[key], got[2][key])


def test_nms_bucket_matches_jax():
    from kuzu.pipeline.tiling import _nms_bucket

    for n in (1, 256, 257, 4096, 8000, 16384, 16385, 70000):
        assert ttl._nms_bucket(n) == _nms_bucket(n)


# ------------------------------------------------------- column geometry


def test_column_geometry_copies_match_jax():
    """The inputs of tests/test_cascade_e2e.py's geometry tests, and random
    ones, through the reference and the copy: bit-equal."""
    from kuzu.pipeline import cascade as jc

    from kuzu_torch.pipeline import cascade as tc

    boxes = np.array([[100.0, 0, 140, 400], [102.0, 20, 141, 180], [100.0, 420, 140, 600],
                      [300.0, 0, 340, 400]])
    for scores in (np.array([0.9, 0.3, 0.8, 0.7]), np.array([0.2, 0.9, 0.8, 0.7])):
        np.testing.assert_array_equal(tc.dedup_columns(boxes, scores),
                                      jc.dedup_columns(boxes, scores))
    seg1 = [(100.0, y, 130.0, y + 20) for y in range(10, 200, 24)]
    seg2 = [(100.0, y, 130.0, y + 20) for y in range(290, 432, 24)]
    chars = np.array(seg1 + seg2)
    cols = np.array([[98.0, 5, 132, 120], [98.0, 285, 132, 430], [300.0, 10, 340, 200],
                     [98.0, 90, 132, 200]])
    for a, b in zip(tc.refine_columns_by_chars(cols, chars),
                    jc.refine_columns_by_chars(cols, chars)):
        np.testing.assert_array_equal(a, b)
    claimed = [(100.0, y, 130.0, y + 20) for y in range(10, 200, 24)]
    missed = [(200.0, y, 228.0, y + 20) for y in range(10, 150, 24)]
    chars = np.array(claimed + missed + [(300.0, 10, 330.0, 30)])
    scores = np.concatenate([np.full(len(claimed), 0.9), np.full(len(missed), 0.8), [0.7]])
    for a, b in zip(tc.columns_from_orphan_chars(chars, scores, np.array([[96.0, 6, 134, 202]])),
                    jc.columns_from_orphan_chars(chars, scores, np.array([[96.0, 6, 134, 202]]))):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for _ in range(20):
        xy = rng.uniform(0, 500, (60, 2))
        ch = np.concatenate([xy, xy + rng.uniform(5, 30, (60, 2))], 1).astype(np.float32)
        cl = np.concatenate([xy[:8], xy[:8] + rng.uniform(20, 300, (8, 2))], 1)
        sc = rng.uniform(0, 1, 60)
        for a, b in zip(tc.refine_columns_by_chars(cl, ch), jc.refine_columns_by_chars(cl, ch)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tc.columns_from_orphan_chars(ch, sc, cl[:3]),
                        jc.columns_from_orphan_chars(ch, sc, cl[:3])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tc.dedup_columns(cl, sc[:8]), jc.dedup_columns(cl, sc[:8]))
        np.testing.assert_array_equal(tc.sort_columns_right_to_left(cl),
                                      jc.sort_columns_right_to_left(cl))


# ------------------------------------------------------ DetectPredictor


def test_detect_predictor_loads_a_port_run_dir(tmp_path):
    """A run dir as DetectTrainer writes it (args.yaml, data_spec.yaml,
    weights/{last,best}): the predictor restores the EMA of ``best``, the
    run's reg_max and imgsz, and predicts what the in-memory detector does."""
    import yaml

    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.tasks.detect import DetectPredictor

    cfg = load_config(overrides={"model": "yolov12n", "imgsz": 64, "reg_max": 32})
    cfg.to_yaml(tmp_path / "args.yaml")
    (tmp_path / "data_spec.yaml").write_text(yaml.safe_dump({"nc": 2, "names": {0: "a", 1: "b"}}))
    det = YoloDetector("yolov12n", nc=2, imgsz=64, device="cpu", reg_max=32).init(3)
    state = TrainState(det.graph, torch.optim.SGD(det.graph.parameters(), lr=0.1))
    for n, t in state.ema.items():  # an EMA unlike the live weights
        t.mul_(0.5)
    mgr = CheckpointManager(tmp_path / "weights")
    mgr.save(state, fitness=1.0)  # last and best
    with torch.no_grad():
        for p in det.graph.parameters():
            p.add_(1.0)
    mgr.save(state, fitness=0.0)  # a worse last
    ref = YoloDetector("yolov12n", nc=2, imgsz=64, device="cpu", reg_max=32)
    best = mgr.restore("best")
    ref.load_state_dict({**best["model"], **best["ema"]})
    mem = DetectPredictor.from_detector(ref, conf=0.001, iou=0.7, max_det=50)
    run = DetectPredictor(load_config(overrides={"model": str(tmp_path), "conf": 0.001,
                                                 "max_det": 50}), device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                                              dtype=np.uint8))
    got, want = run._fwd(imgs), mem._fwd(imgs)
    assert run.ready and run.imgsz == 64 and run.names == {0: "a", 1: "b"}
    assert run.detector.spec.reg_max == 32 and run.detector.nc == 2
    assert int(want["valid"].sum()) > 0
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ------------------------------------------------------------ the slice


def _jax_detector_standin(tdet, name: str, conf: float, max_det: int, f32: bool = False):
    """What ``_process_pages_tiled`` reads of a JAX DetectPredictor, over
    the port detector's weights: the BN-folded executor in bf16 (the
    port's) with Pallas in interpret mode, or with ``f32`` the flax apply in
    f32 (what JAX's predictor takes on the CPU); decode and NMS."""
    from types import SimpleNamespace

    from kuzu.models.yolo.detector import YoloDetector as JaxDetector
    from kuzu.models.yolo.infer import run_graph
    from kuzu.ops.nms import non_max_suppression

    from torch_parity import flax_variables

    jdet = JaxDetector(name, nc=tdet.nc, dtype=jnp.float32 if f32 else jnp.bfloat16,
                       imgsz=tdet.imgsz, reg_max=tdet.spec.reg_max)

    def fwd(variables, images):
        maps = (jdet.module.apply(variables, images, train=False) if f32
                else run_graph(jdet.spec, variables, images, interpret=True))
        pred = jdet.decode(maps)
        return non_max_suppression(pred, conf_thres=conf, iou_thres=0.7, max_det=max_det)

    return SimpleNamespace(ready=True, imgsz=tdet.imgsz, min_bucket=1,
                           variables=flax_variables(tdet.graph), _fwd_jit=jax.jit(fwd))


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """JAX's ``KuzushijiPipeline(tile_grid=2, conf=0.001, max_det=2000,
    ship_once=True)`` with stand-ins for its three predictors, and the port's
    pipeline over the same weights: yolov12n columns (reg_max 32) and
    characters at 128 px, a CRNN of 25 classes at [160, 40], two seeded
    192 px pages (as PNG files for JAX, as arrays for the port).

    The detectors stay at init, their Detect biases set by ``box_head``
    (boxes shaped into columns and characters, classes at flax's -4.6): every
    anchor scores sigmoid(-4.6), the two executors' maps are bit-equal, and
    both sides' NMS keep the same index-ordered candidates. That holds the
    geometry exactly, but not detections that depend on the page. So both
    sides run once more with the detectors' BatchNorm calibrated on the pages
    (``calibrate_batch_norm``): the activations are O(1), scores and boxes
    depend on the page. There a seeded network amplifies bf16 rounding: each
    package's bf16 maps lie as far from its own f32 maps as from the other
    package's bf16 maps, while the two f32 forwards agree to ~3e-4 of the
    largest logit. So that run takes both detectors' forwards in f32 (the
    port's ``YoloGraph`` in eval mode, JAX's flax apply) and is held to a
    matched share (``CAL_MATCH``, ``CAL_TEXTS``)."""
    import copy
    from types import SimpleNamespace

    import cv2

    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.crnn import CRNN as JaxCRNN
    from kuzu.ops.ctc import ctc_greedy_decode as jax_decode
    from kuzu.pipeline.cascade import KuzushijiPipeline as JaxPipeline

    from kuzu_torch.bridge import crnn_from_flax
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.crnn import CRNN
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.ctc import CTCPredictor
    from kuzu_torch.tasks.detect import DetectPredictor
    from kuzu_torch.testing import calibrate_batch_norm
    from torch_parity import flax_variables, numpy_tree

    root = tmp_path_factory.mktemp("cascade_pages")
    pages = column_pages(2, 192, seed=1)
    paths = []
    for i, p in enumerate(pages):
        paths.append(root / f"page{i}.png")
        cv2.imwrite(str(paths[-1]), cv2.cvtColor(p, cv2.COLOR_RGB2BGR))

    col = box_head(YoloDetector("yolov12n", nc=1, imgsz=128, device="cpu", reg_max=32).init(0),
                    (1, 6, 1, 6))
    char = box_head(YoloDetector("yolov12n", nc=1, imgsz=128, device="cpu").init(1),
                     (1, 1, 1, 1))
    chars = "abcdefghijklmnopqrst"
    jmodel = JaxCRNN(num_classes=25, lstm_hidden=32)
    variables = numpy_tree(jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 160, 40, 3),
                                                                      jnp.uint8)))(
        jax.random.key(0)))
    variables["params"]["head"]["kernel"] = variables["params"]["head"]["kernel"] * 10

    jax_pipe = JaxPipeline(tile_grid=2, conf=0.001, max_det=2000, ship_once=True,
                           lm_mode="off")
    jax_pipe.column_det = _jax_detector_standin(col, "yolov12n", 0.001, 300)
    jax_pipe.char_det = _jax_detector_standin(char, "yolov12n", 0.001, 2000)
    jax_pipe.recognizer = SimpleNamespace(
        ready=True, image_size=(160, 40), tokenizer=JaxTokenizer.train([chars]),
        variables=variables, min_bucket=1,
        _fwd=jax.jit(lambda v, x: (jax_decode(jmodel.apply(v, x)[0]), None)))
    jax_pipe.rec_task = "ctc"
    want = jax_pipe.process_pages(paths)

    port = KuzushijiPipeline(
        column_model=DetectPredictor.from_detector(col, conf=0.001, iou=0.7, max_det=300),
        char_model=DetectPredictor.from_detector(char, conf=0.001, iou=0.7, max_det=2000),
        recognizer=CTCPredictor.from_model(crnn_from_flax(CRNN(25, lstm_hidden=32), variables),
                                           CharTokenizer.train([chars]), (160, 40),
                                           device="cpu"),
        tile_grid=2, max_det=2000, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = port.process_pages(list(pages), names=[str(p) for p in paths])
    stages = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
              if e.name.startswith("cascade/")]
    # the options off the production path, on both sides: columns at a
    # smaller letterbox than the model's, no dedup, no snapping to chars
    # (nor orphan recovery, which needs it)
    variant = dict(col_imgsz=96, col_dedup=False, col_refine=False)
    for pipe in (jax_pipe, port):
        for key, value in variant.items():
            setattr(pipe, key, value)
    want_variant = jax_pipe.process_pages(paths)
    got_variant = port.process_pages(list(pages), names=[str(p) for p in paths])
    port.col_imgsz, port.col_dedup, port.col_refine = None, True, True
    jax_pipe.col_imgsz, jax_pipe.col_dedup, jax_pipe.col_refine = None, True, True
    ar = _trocr_runs(jax_pipe, port, pages, paths)

    on_page = torch.from_numpy(pages)
    col, char = copy.deepcopy(col), copy.deepcopy(char)
    calibrate_batch_norm(col.graph, tdp.device_letterbox(on_page, 128)[0])
    calibrate_batch_norm(char.graph, tdp.device_tiles(on_page[:1], 2, 0.15, 128)[0])
    box_head(col, (1, 6, 1, 6))
    box_head(char, (1, 1, 1, 1))
    for det in (col, char):  # the graph's f32 forward in place of the bf16 executor
        det.infer = lambda images, g=det.graph: g(images)
    jax_pipe.column_det = _jax_detector_standin(col, "yolov12n", 0.001, 300, f32=True)
    jax_pipe.char_det = _jax_detector_standin(char, "yolov12n", 0.001, 2000, f32=True)
    jax_pipe._dev_fwd_cache = {}  # its jits close over the predictors they were built for
    want_cal = jax_pipe.process_pages(paths)
    port_cal = KuzushijiPipeline(
        column_model=DetectPredictor.from_detector(col, conf=0.001, iou=0.7, max_det=300),
        char_model=DetectPredictor.from_detector(char, conf=0.001, iou=0.7, max_det=2000),
        recognizer=port.recognizer, tile_grid=2, max_det=2000, device="cpu")
    got_cal = port_cal.process_pages(list(pages), names=[str(p) for p in paths])
    return SimpleNamespace(want=want, got=got, stages=stages, port=port, pages=pages,
                           want_variant=want_variant, got_variant=got_variant,
                           want_cal=want_cal, got_cal=got_cal, ar=ar)


def _trocr_runs(jax_pipe, port, pages, paths) -> dict:
    """Both cascades again with the AR recognizer in place of the CRNN: the
    tiny TrOCR and CharMLM of ``torch_parity`` on [128, 32] crops, under
    ``decode`` greedy and ``beam`` (no LM stage) and ``beam_lm`` (n-best
    reranked by the LM, which then annotates each column,
    ``lm_mode="annotate"``). Returns {decode: (JAX's results, the port's, the
    port's stage ranges in order)}."""
    from types import SimpleNamespace

    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.lm import CharMLM as JaxCharMLM
    from kuzu.models.trocr import TrOCR as JaxTrOCR

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.lm import CharMLM
    from kuzu_torch.models.trocr import TrOCR
    from kuzu_torch.pipeline import cascade
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.lm import LMPredictor
    from kuzu_torch.tasks.recognize import RecognizePredictor
    from torch_parity import (LM_KW, TOKEN_CHARS, TROCR_KW, jax_lm_variables,
                              jax_trocr_variables)

    trocr, lm = jax_trocr_variables(), jax_lm_variables()
    jtok = JaxTokenizer.train([TOKEN_CHARS])
    crnn = jax_pipe.recognizer
    jax_pipe.recognizer = SimpleNamespace(
        ready=True, image_size=(128, 32), tokenizer=jtok, min_bucket=1,
        model=JaxTrOCR(**TROCR_KW, ctc_head=True), params=trocr["params"])
    jax_pipe.rec_task = "recognize"
    jax_pipe.lm = SimpleNamespace(ready=True, tokenizer=jtok, max_len=32, min_bucket=1,
                                  model=JaxCharMLM(**LM_KW), params=lm["params"],
                                  _put=jnp.asarray)
    tok = CharTokenizer.train([TOKEN_CHARS])
    port_ar = KuzushijiPipeline(
        column_model=port.column_det, char_model=port.char_det,
        recognizer=RecognizePredictor.from_model(
            from_flax(TrOCR(**TROCR_KW, ctc_head=True), trocr), tok, (128, 32),
            device="cpu"),
        lm=LMPredictor.from_model(from_flax(CharMLM(**LM_KW), lm), tok, max_len=32,
                                  device="cpu"),
        tile_grid=2, max_det=2000, device="cpu")
    out = {}
    stage = cascade._stage
    for decode, lm_mode in (("greedy", "off"), ("beam", "off"), ("beam_lm", "annotate")):
        jax_pipe.decode = port_ar.decode = decode
        jax_pipe.lm_mode = port_ar.lm_mode = lm_mode
        want = jax_pipe.process_pages(paths)
        stages = []  # the stage ranges entered, in order (a profiler's trace of the
        # decode loops on the CPU takes seconds to build)
        cascade._stage = lambda name: (stages.append(f"cascade/{name}"), stage(name))[1]
        try:
            got = port_ar.process_pages(list(pages), names=[str(p) for p in paths])
        finally:
            cascade._stage = stage
        out[decode] = (want, got, stages)
    jax_pipe.recognizer, jax_pipe.rec_task, jax_pipe.lm = crnn, "ctc", None
    jax_pipe.lm_mode, jax_pipe.decode = "off", "greedy"
    return out


SCORE_RTOL = 1e-6  # torch.sigmoid and jax.nn.sigmoid differ by an f32 ulp at times


def test_slice_columns_match_jax(slice_pair):
    """Same columns in the same order: boxes within 1e-3 px, scores within
    an f32 ulp."""
    for g, w in zip(slice_pair.got, slice_pair.want, strict=True):
        assert g["image"] == w["image"]
        assert len(g["columns"]) == len(w["columns"]) > 0
        np.testing.assert_allclose([c["box"] for c in g["columns"]],
                                   [c["box"] for c in w["columns"]], atol=1e-3, rtol=0)
        np.testing.assert_allclose([c["score"] for c in g["columns"]],
                                   [c["score"] for c in w["columns"]], rtol=SCORE_RTOL, atol=0)


def test_slice_options_match_jax(slice_pair):
    """col_imgsz=96, col_dedup and col_refine off: the same columns and
    texts on both sides, and more columns than with dedup."""
    for g, w, base in zip(slice_pair.got_variant, slice_pair.want_variant, slice_pair.got,
                          strict=True):
        assert len(g["columns"]) == len(w["columns"]) > len(base["columns"])
        np.testing.assert_allclose([c["box"] for c in g["columns"]],
                                   [c["box"] for c in w["columns"]], atol=1e-3, rtol=0)
        assert [c["text"] for c in g["columns"]] == [c["text"] for c in w["columns"]]
        boxes = np.asarray([c["box"] for c in g["columns"]])
        assert (boxes >= 0).all() and (boxes <= 192).all()


def test_slice_texts_match_jax(slice_pair):
    for g, w in zip(slice_pair.got, slice_pair.want, strict=True):
        assert [c["text"] for c in g["columns"]] == [c["text"] for c in w["columns"]]
        assert g["text"] == w["text"]
    assert any(c["text"] for r in slice_pair.got for c in r["columns"])


def test_slice_characters_match_jax(slice_pair):
    """Cross-tile merged characters per page and per column: boxes within
    1e-3 px, scores within an f32 ulp."""
    for g, w in zip(slice_pair.got, slice_pair.want, strict=True):
        gb, wb = np.asarray(g["characters"]["boxes"]), np.asarray(w["characters"]["boxes"])
        assert gb.shape == wb.shape and len(gb) > 0
        np.testing.assert_allclose(gb, wb, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["characters"]["scores"], w["characters"]["scores"],
                                   rtol=SCORE_RTOL, atol=0)
        for gc, wc in zip(g["columns"], w["columns"]):
            np.testing.assert_allclose(np.reshape(gc["chars"]["boxes"], (-1, 4)),
                                       np.reshape(wc["chars"]["boxes"], (-1, 4)), atol=1e-3)


# Calibrated detectors in f32 on both sides: their maps part by f32 sums in
# another order, so a swap between near-equal boxes in NMS, or a column
# refined onto another char segment, is no fault. Held: the share of either
# side's columns and characters that the other side has (IoU >= 0.5), and
# the share of matched columns that read the same text.
CAL_MATCH = 0.9
CAL_TEXTS = 0.8


def _padded(results: list[dict], key: str) -> dict:
    """One result field ("columns" or "characters") as padded detections."""
    boxes = [np.asarray([c["box"] for c in r["columns"]] if key == "columns"
                        else r["characters"]["boxes"], np.float32).reshape(-1, 4)
             for r in results]
    n = max(max(len(b) for b in boxes), 1)
    out = {"boxes": np.zeros((len(boxes), n, 4), np.float32),
           "valid": np.zeros((len(boxes), n), bool),
           "classes": np.zeros((len(boxes), n), np.int32)}
    for i, b in enumerate(boxes):
        out["boxes"][i, :len(b)], out["valid"][i, :len(b)] = b, True
    return out


def test_slice_calibrated_matches_jax(slice_pair):
    """With page-dependent scores and boxes: columns and characters matched
    both ways, and matched columns' texts mostly equal."""
    from kuzu_torch.testing import detections_match, iou_matrix

    got, want = slice_pair.got_cal, slice_pair.want_cal
    for key in ("columns", "characters"):
        g, w = _padded(got, key), _padded(want, key)
        assert w["valid"].sum(1).min() > 0, key
        assert detections_match(w, g) >= CAL_MATCH, key
        assert detections_match(g, w) >= CAL_MATCH, key
    # scores differ between pages and anchors: NMS ranks by score here
    scores = np.concatenate([np.asarray(r["characters"]["scores"]) for r in got])
    assert len(np.unique(scores)) > len(scores) // 2
    same = total = 0
    for g, w in zip(got, want, strict=True):
        iou = iou_matrix(np.asarray([c["box"] for c in w["columns"]], np.float32),
                         np.asarray([c["box"] for c in g["columns"]], np.float32))
        for i, j in enumerate(iou.argmax(1)):
            if iou[i, j] >= 0.5:
                total += 1
                same += w["columns"][i]["text"] == g["columns"][j]["text"]
    assert total > 0 and same / total >= CAL_TEXTS, (same, total)


# the LM's pseudo-log-likelihoods, f32 sums in another order: 1e-5 of the
# largest score
LM_SCORE_REL = 1e-5


@pytest.mark.parametrize("decode", ["greedy", "beam", "beam_lm"])
def test_slice_trocr_texts_match_jax(slice_pair, decode):
    """The cascade with the TrOCR recognizer: the same columns read the same
    texts as JAX's, under each decode; under ``beam_lm``, where the LM also
    annotates, each column's lm_score within 1e-5 of the largest, and the LM
    stage is entered after the recognizer's."""
    from kuzu_torch.pipeline.cascade import LM_STAGE, STAGES

    want, got, stages = slice_pair.ar[decode]
    annotate = decode == "beam_lm"
    assert stages == [f"cascade/{s}" for s in STAGES + ((LM_STAGE,) if annotate else ())]
    texts = []
    for g, w in zip(got, want, strict=True):
        assert len(g["columns"]) == len(w["columns"]) > 0
        assert [c["text"] for c in g["columns"]] == [c["text"] for c in w["columns"]]
        assert g["text"] == w["text"]
        texts += [c["text"] for c in g["columns"]]
        if annotate:
            ws = np.array([c["lm_score"] for c in w["columns"]])
            np.testing.assert_allclose([c["lm_score"] for c in g["columns"]], ws, rtol=0,
                                       atol=LM_SCORE_REL * max(np.abs(ws).max(), 1.0))
        else:
            assert all("lm_score" not in c for c in g["columns"])
    assert len(set(texts)) > 2, texts  # texts differ between columns
    if decode == "beam_lm":  # the rerank chose other hypotheses than the beam's best
        beam = [c["text"] for r in slice_pair.ar["beam"][1] for c in r["columns"]]
        assert beam != texts


def test_slice_stages_and_refusals(slice_pair):
    from kuzu_torch.pipeline.cascade import STAGES, KuzushijiPipeline

    assert slice_pair.stages == [f"cascade/{s}" for s in STAGES]
    port, pages = slice_pair.port, slice_pair.pages
    # a (B, H, W, 3) tensor is an entry too; names default to the indices;
    # one page through process_page is the batch's page
    again = port.process_pages(torch.from_numpy(pages))
    assert [r["image"] for r in again] == [0, 1]
    assert again[1]["columns"] == slice_pair.got[1]["columns"]
    single = port.process_page(pages[1], name="p1")
    assert single["image"] == "p1" and single["columns"] == slice_pair.got[1]["columns"]
    # pages of mixed shapes take the host path: each page's own letterbox,
    # tiles and crops (the same columns as the batch's where they share shape)
    mixed = port.process_pages([pages[0], pages[1][:100]])
    assert [r["image"] for r in mixed] == [0, 1]
    boxes = np.asarray([c["box"] for c in mixed[1]["columns"]])
    assert len(boxes) > 0 and (boxes[:, [1, 3]] <= 100).all() and "text" in mixed[1]
    port.decode = "beam_lm"
    with pytest.raises(ValueError, match="beam_lm"):
        port.process_pages(list(pages))
    port.decode = "greedy"
    with pytest.raises(NotImplementedError, match="item 12"):
        KuzushijiPipeline(device="cpu", dp=2)
    # the yc transport and the host path (ship_once=False) run: on these
    # seeded heads every anchor scores the same, so the columns are the
    # ship-once RGB run's
    for kw in (dict(transport="yc"), dict(ship_once=False)):
        other = KuzushijiPipeline(column_model=port.column_det, char_model=port.char_det,
                                  recognizer=port.recognizer, tile_grid=2, max_det=2000,
                                  device="cpu", **kw)
        assert (other.transport, other.ship_once) == (kw.get("transport", "rgb"),
                                                      kw.get("ship_once", True))
        got = other.process_pages(list(pages))
        assert [r["columns"][i]["box"] for r in got for i in range(len(r["columns"]))] == \
            [c["box"] for r in slice_pair.got for c in r["columns"]], kw
    # tile_grid <= 1: the reference-shaped flow, columns on the full page
    flat = KuzushijiPipeline(column_model=port.column_det, device="cpu")
    flat_res = flat.process_pages(list(pages))
    assert [len(r["columns"]) > 0 for r in flat_res] == [True, True]
    assert all("text" not in r and "characters" not in r for r in flat_res)


@pytest.mark.parametrize("task,what", [("recognize", "holds no weights"),
                                       ("ctc", "holds no weights")],
                         ids=["recognize-item 14", "ctc-item 8"])
def test_recognizer_run_dirs_refuse(tmp_path, task, what):
    """A recognizer run dir routes by its args.yaml task, as in JAX, and is
    refused at its first use when it holds no weights: a recognize run dir
    without the weights a RecognizeTrainer writes, a CTC run dir without
    those a CTCTrainer writes."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.models.yolo.detector import YoloDetector
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.detect import DetectPredictor

    load_config(overrides={"task": task}).to_yaml(tmp_path / "args.yaml")
    det = DetectPredictor.from_detector(
        YoloDetector("yolov12n", nc=1, imgsz=64, device="cpu").init(0), conf=0.001)
    pipe = KuzushijiPipeline(column_model=det, recognizer=tmp_path, tile_grid=2, device="cpu")
    assert pipe.rec_task == task
    with pytest.raises(FileNotFoundError, match=what):
        pipe.process_pages(column_pages(1, 96, seed=0))


def test_cascade_needs_cuda_by_default(monkeypatch):
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KuzushijiPipeline(tile_grid=2)
