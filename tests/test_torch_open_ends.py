"""The open ends of ported modules against the JAX package on the CPU, and
the f32 graph's TF32 setting.

- ``ops/letterbox.py``: ``letterbox`` (bilinear and nearest, centred and
  top-left, f32 and uint8 images, a content size that lands on .5 and
  rounds half to even), ``resize_keep_aspect`` and ``normalize_image``
  against JAX's jitted functions: gain and pad exact, canvases within 1e-6
  (pixels in [0, 1]; the uint8 nearest canvas exact);
- ``ops/nms.py::nms_padded``: boxes, scores, classes and validity equal to
  JAX's (class-aware and agnostic, ``max_det`` under and over the pool);
- ``RecognizeValidator``: the arguments it hands ``evaluate_recognizer``
  equal JAX's validator's, and a recognize run dir validated through
  ``Model(run).val``;
- the f32 ``YoloGraph`` forward runs with cuDNN's TF32 off and the matmul
  precision ``"highest"``; the bf16 graph's leaves both settings as they are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _letterbox_cases():
    rng = np.random.default_rng(0)
    f32 = lambda h, w: rng.random((h, w, 3)).astype(np.float32)  # noqa: E731
    return [
        ("bilinear-center", f32(37, 53), (64, 64), dict()),
        ("bilinear-topleft", f32(53, 37), (48, 80), dict(center=False, fill=1.0)),
        ("nearest-center", f32(30, 70), (64, 64), dict(method="nearest")),
        ("nearest-uint8", rng.integers(0, 256, (41, 29, 3), dtype=np.uint8), (64, 48),
         dict(method="nearest")),
        ("upscale", f32(9, 14), (64, 64), dict()),
        ("half-down", f32(5, 20), (10, 10), dict()),  # h * gain = 2.5 -> 2
        ("half-up", f32(7, 20), (10, 10), dict()),  # h * gain = 3.5 -> 4
    ]


@pytest.mark.parametrize("case", _letterbox_cases(), ids=lambda c: c[0])
def test_letterbox_matches_jax(case):
    from kuzu.ops.letterbox import letterbox as jax_letterbox

    from kuzu_torch.ops import letterbox

    _, image, (oh, ow), kw = case
    want, wgain, wpad = jax_letterbox(jnp.asarray(image), oh, ow, **kw)
    got, gain, pad = letterbox(torch.from_numpy(image), oh, ow, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert gain.dtype == torch.float32 and float(gain) == float(wgain)
    np.testing.assert_array_equal(pad.numpy(), np.asarray(wpad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0 if image.dtype == np.uint8 else 1e-6)


def test_letterbox_rounds_half_to_even():
    """The content size of the two .5 cases: round(2.5) = 2 (half up would
    give 3) and round(3.5) = 4, in both frameworks; the pad is
    floor((10 - rows) / 2)."""
    from kuzu_torch.ops import letterbox

    for h, rows in ((5, 2), (7, 4)):
        _, gain, pad = letterbox(torch.zeros((h, 20, 3)), 10, 10)
        assert float(gain) == 0.5
        assert int(pad[1]) == (10 - rows) // 2


def test_resize_keep_aspect_and_normalize_match_jax():
    from kuzu.ops.letterbox import KUZUSHIJI_MEAN as JMEAN
    from kuzu.ops.letterbox import normalize_image as jax_normalize
    from kuzu.ops.letterbox import resize_keep_aspect as jax_resize

    from kuzu_torch.ops import (KUZUSHIJI_MEAN, KUZUSHIJI_STD, normalize_image,
                                resize_keep_aspect)

    image = np.random.default_rng(1).random((40, 12, 3)).astype(np.float32)
    want, wgain = jax_resize(jnp.asarray(image), 128, 32)
    got, gain = resize_keep_aspect(torch.from_numpy(image), 128, 32)
    assert float(gain) == float(wgain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got[-1, -1, 0]) == 1.0  # white fill, top-left anchored
    np.testing.assert_array_equal(KUZUSHIJI_MEAN, JMEAN)
    want = jax_normalize(jnp.asarray(image), jnp.asarray(KUZUSHIJI_MEAN),
                         jnp.asarray(KUZUSHIJI_STD))
    got = normalize_image(torch.from_numpy(image), KUZUSHIJI_MEAN, KUZUSHIJI_STD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agnostic,max_det", [(False, 50), (True, 50), (False, 400)])
def test_nms_padded_matches_jax(agnostic, max_det):
    from kuzu.ops.nms import nms_padded as jax_nms_padded

    from kuzu_torch.ops import nms_padded

    rng = np.random.default_rng(2)
    n = 300
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (n, 2)).astype(np.float32)], 1)
    scores = rng.permutation(np.linspace(0.05, 0.95, n)).astype(np.float32)
    classes = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    kw = dict(iou_threshold=0.5, score_threshold=0.2, max_det=max_det, max_nms=256,
              agnostic=agnostic)
    want = jax_nms_padded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                          jnp.asarray(valid), **kw)
    got = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.from_numpy(classes), torch.from_numpy(valid), **kw)
    assert got[0].shape == (max_det, 4)
    assert 0 < int(got[3].sum()) < int(valid.sum())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="K1"):
        nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(classes), torch.from_numpy(valid), backend="xla")


def test_recognize_validator_matches_jax(monkeypatch, tmp_path):
    """Both validators hand ``evaluate_recognizer`` the same run, data,
    split (default ``val``) and ``max_samples``; then a real run dir (one
    epoch on a one-line folder) validates through the facade: JAX's keys,
    ``n`` the split's crops."""
    import kuzu.tools.evaluation as jeval
    from kuzu.core.config import load_config as jax_config
    from kuzu.tasks.recognize import RecognizeValidator as JaxValidator

    import kuzu_torch.tools.evaluation as teval
    from kuzu_torch.api.model import Model, task_map
    from kuzu_torch.core.config import load_config
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.tasks.recognize import RecognizeValidator
    from kuzu_torch.testing import synthetic_texts, write_oneline_folder
    from torch_parity import TOKEN_CHARS

    assert task_map()["recognize"]["validator"] is RecognizeValidator
    calls = []
    record = lambda *a, **k: calls.append((a, {n: v for n, v in k.items() if n != "device"}))
    for mod in (jeval, teval):
        monkeypatch.setattr(mod, "evaluate_recognizer", record)
    for over in ({"model": "runs/r", "data": "lines"},
                 {"model": "runs/r", "data": "lines", "split": "test", "max_samples": 3}):
        JaxValidator(jax_config(overrides=over)).run()
        RecognizeValidator(load_config(overrides=over), device="cpu").run()
        assert calls[-1] == calls[-2], calls[-2:]
    monkeypatch.undo()

    lines = write_oneline_folder(tmp_path / "lines", {
        "train": synthetic_texts(2, TOKEN_CHARS, 6, seed=7),
        "test": synthetic_texts(3, TOKEN_CHARS, 6, seed=8)}, hw=((80, 150), (14, 40)), seed=9)
    CharTokenizer.train([TOKEN_CHARS]).save(tmp_path / "tok.json")
    Model("trocr", task="recognize", device="cpu").train(
        data=str(lines), tokenizer=str(tmp_path / "tok.json"), batch=2, epochs=1, workers=0,
        project=str(tmp_path), name="r", verbose=False, imgsz=[64, 32], enc_dim=32,
        enc_depth=1, enc_heads=2, dec_dim=32, dec_depth=1, dec_heads=2, max_label_length=8)
    got = Model(str(tmp_path / "recognize" / "r"), task="recognize", device="cpu").val(
        data=str(lines), split="test")
    assert set(got) == {"cer", "exact_match", "n"} and got["n"] == 3
    assert np.isfinite(got["cer"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_forward_tf32_setting(dtype):
    """A forward hook on the first conv reads the settings its convolution
    runs under: an f32 graph's with TF32 off for cuDNN and the matmul
    precision "highest" (as the f32 backward and the recognizers' forwards
    run), a bf16 graph's those of the caller, left as they were."""
    from kuzu_torch.models.yolo.graph import YoloGraph, parse_model_yaml, resolve_model_spec

    path, scale = resolve_model_spec("yolov8n")
    graph = YoloGraph(parse_model_yaml(path, scale=scale, nc=2), dtype=dtype).eval()
    seen = []
    graph.n0_Conv.register_forward_hook(lambda m, i, o: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")  # a caller's TF32 setting
    try:
        with torch.no_grad():
            graph(torch.zeros((1, 32, 32, 3), dtype=torch.uint8))
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])
    assert seen == [(False, "highest") if dtype == torch.float32 else (True, "high")]
    assert after == (True, "high")  # restored after the f32 forward
