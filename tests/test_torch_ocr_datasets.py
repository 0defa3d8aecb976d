"""The recognizers' image-file data against ``kuzu/data/ocr_datasets.py``:
``ColumnInfoDataset`` (its CSV read without pandas, held against pandas on
edge cases), ``OneLineDataset`` (with character boxes) and
``build_tokenizer_from_datasets``; the CTC and recognize trainers'
``build_datasets`` (their first batch and their tokenizer resolution), the
facade training each from files on the CPU, and ``evaluate_recognizer``
against JAX's on the same weights.

Images are compared byte for byte, tokens, lengths and boxes exactly."""

from __future__ import annotations

import json

import numpy as np
import pytest

import kuzu.data.ocr_datasets as jx
import kuzu_torch.data.ocr_datasets as pt
from kuzu_torch.testing import synthetic_texts, write_column_csv, write_oneline_folder
from torch_parity import TOKEN_CHARS

CHARS = "あいうえおかきくけこさしすせそ"
SIZE = (96, 24)  # (H, W) of the letterboxed crops


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocr")
    texts = synthetic_texts(20, CHARS, 8, seed=1)
    csv_path = write_column_csv(root / "cols", texts, hw=((60, 160), (12, 40)), seed=2)
    lines = write_oneline_folder(root / "lines", {"train": texts[:8], "val": texts[8:11],
                                                  "test": texts[11:14]},
                                 hw=((60, 160), (12, 40)), seed=3, boxes=True)
    return csv_path, lines, texts


def _tokenizers(texts):
    from kuzu.data.tokenizer import CharTokenizer as JTok

    from kuzu_torch.data.tokenizer import CharTokenizer

    return CharTokenizer.train(texts), JTok.train(texts)


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


CSV_CASES = [
    'column_image,unicode_ids\na.png,U+3042 U+3044\n"b,c.png","U+3046"\n\n\n',
    '﻿column_image,unicode_ids\na.png,\nb.png,U+3042\n',
    'column_image,unicode_ids,n\n1,NA,3\n2,"U+30""42",\n01,nan,5\n',
    'column_image,unicode_ids,f,b\nx,U+1,1.5,True\ny,U+2,1e-5,false\n',
    'column_image,unicode_ids\r\nx.png,U+3042\r\ny.png,"U+3043\nU+3044"\r\n',
]


@pytest.mark.parametrize("i", range(len(CSV_CASES)))
def test_csv_reader_matches_pandas(tmp_path, i):
    import pandas as pd

    path = tmp_path / "c.csv"
    path.write_text(CSV_CASES[i], encoding="utf-8", newline="")
    df = pd.read_csv(path)
    got = pt.read_csv_columns(path)
    assert list(got) == list(df.columns)
    for col in df.columns:  # pandas leaves NaN a float: the reference str()s it
        assert got[col] == [str(v) for v in df[col].astype(str)], col


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_column_info_dataset_matches_jax(data, split):
    csv_path, _, texts = data
    tok, jtok = _tokenizers(texts)
    for aug, cache in ((False, None), (True, "ram")):
        kw = dict(split=split, image_size=SIZE, max_length=12, augment=aug, seed=4,
                  cache_images=cache)
        p, j = pt.ColumnInfoDataset(csv_path, tok, **kw), jx.ColumnInfoDataset(csv_path, jtok, **kw)
        assert p.items == j.items and p.texts() == j.texts()
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(j)):
                assert_samples_equal(p[i], j[i])


@pytest.mark.parametrize("boxes", [False, True])
def test_one_line_dataset_matches_jax(data, boxes):
    _, lines, texts = data
    tok, jtok = _tokenizers(texts)
    kw = dict(image_size=SIZE, max_length=12, with_boxes=boxes, max_boxes=6, augment=True,
              seed=5)
    for split in ("train", "val"):
        p = pt.OneLineDataset(lines, tok, split=split, **kw)
        j = jx.OneLineDataset(lines, jtok, split=split, **kw)
        assert p.items == j.items and p.augment == j.augment == (not boxes)
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(j)):
                assert_samples_equal(p[i], j[i])
    if boxes:
        assert any(int(p[i]["num_boxes"]) for i in range(len(p)))
    p = pt.OneLineDataset(lines, None, split="train", image_size=SIZE)
    j = jx.OneLineDataset(lines, None, split="train", image_size=SIZE)
    assert_samples_equal(p[0], j[0])


def test_build_tokenizer_from_datasets_matches_jax(data):
    csv_path, lines, _ = data
    p = pt.build_tokenizer_from_datasets(pt.ColumnInfoDataset(csv_path, None),
                                         pt.OneLineDataset(lines, None))
    j = jx.build_tokenizer_from_datasets(jx.ColumnInfoDataset(csv_path, None),
                                         jx.OneLineDataset(lines, None))
    assert p.vocab == j.vocab


def _first_batches(task, overrides, tmp_path):
    """The port's and JAX's trainer of ``task`` over ``overrides``: their
    first training batch and their tokenizer's vocabulary."""
    import importlib

    from kuzu.core.config import load_config as j_config

    from kuzu_torch.core.config import load_config

    jmod = importlib.import_module(f"kuzu.tasks.{task}")
    tmod = importlib.import_module(f"kuzu_torch.tasks.{task}")
    name = {"ctc": "CTCTrainer", "recognize": "RecognizeTrainer"}[task]
    ov = dict(task=task, batch=2, workers=0, seed=1, **overrides)
    t = getattr(tmod, name)(load_config(overrides=dict(ov, project=str(tmp_path / "t"))),
                            device="cpu")
    j = getattr(jmod, name)(j_config(overrides=dict(ov, project=str(tmp_path / "j"))))
    (tl, _), (jl, _) = t.build_datasets(), j.build_datasets()
    tl.set_epoch(0)
    jl.set_epoch(0)
    return next(iter(tl)), next(iter(jl)), t.tokenizer.vocab, j.tokenizer.vocab


@pytest.mark.parametrize("task", ["ctc", "recognize"])
@pytest.mark.parametrize("kind", ["csv", "lines"])
def test_trainers_build_datasets_like_jax(data, task, kind, tmp_path):
    csv_path, lines, _ = data
    src = str(csv_path) if kind == "csv" else str(lines)
    ov = dict(data=src, imgsz=list(SIZE), max_label_length=12)
    if task == "ctc" and kind == "lines":
        ov["max_boxes"] = 6
    tb, jb, tv, jv = _first_batches(task, ov, tmp_path)
    assert tv == jv
    assert_samples_equal(tb, jb)


@pytest.mark.parametrize("which", ["pretrained", "decoder_init", "tokenizer", "missing"])
def test_recognize_tokenizer_resolution_matches_jax(data, tmp_path, which):
    """``tokenizer``, then ``pretrained``'s, then ``decoder_init``'s, else
    trained on the training split: each trainer takes the same one."""
    from kuzu_torch.data.tokenizer import CharTokenizer

    _, lines, _ = data
    for i, chars in enumerate(("abc", "xyz")):
        (tmp_path / f"run{i}").mkdir()
        CharTokenizer.train([chars]).save(tmp_path / f"run{i}" / "tokenizer.json")
    extra = {"pretrained": {"pretrained": str(tmp_path / "run0"),
                            "decoder_init": str(tmp_path / "run1")},
             "decoder_init": {"decoder_init": str(tmp_path / "run1")},
             "tokenizer": {"tokenizer": str(tmp_path / "run1" / "tokenizer.json"),
                           "pretrained": str(tmp_path / "run0")},
             "missing": {"pretrained": str(tmp_path / "none")}}[which]
    _, _, tv, jv = _first_batches("recognize", dict(data=str(lines), imgsz=list(SIZE),
                                                    max_label_length=12, **extra), tmp_path)
    assert tv == jv
    assert (len(tv) == 8) == (which != "missing")  # abc / xyz and the five specials


def test_facade_trains_ctc_from_a_csv(data, tmp_path, monkeypatch):
    from kuzu_torch.api.model import Model

    monkeypatch.setattr("kuzu_torch.tasks.ctc.DIMS", (8, 16, 16, 16))
    csv_path, _, _ = data
    final = Model("crnn", task="ctc", device="cpu").train(
        data=str(csv_path), imgsz=[64, 16], lstm_hidden=16, max_label_length=12, batch=4,
        epochs=1, workers=2, cache_images="ram", project=str(tmp_path), name="c",
        verbose=False)
    assert np.isfinite(final["loss"]) and 0 <= final["cer"]
    assert (tmp_path / "ctc" / "c" / "tokenizer.json").exists()


@pytest.fixture(scope="module")
def rec_run(data, tmp_path_factory):
    """A recognize run dir over the one-line folder: the facade's training
    (the tiny TrOCR of ``torch_parity``, 40 ids), then its weights replaced
    by ``jax_trocr_variables`` (decoder scaled so tokens depend on the crop
    with margins), which JAX also gets."""
    from kuzu_torch.api.model import Model
    from kuzu_torch.bridge import from_flax
    from kuzu_torch.core.checkpoint import CheckpointManager
    from kuzu_torch.core.config import load_config
    from kuzu_torch.core.train import TrainState, build_optimizer
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.trocr import TrOCR
    from torch_parity import TROCR_KW, jax_trocr_variables

    _, _, texts = data
    root = tmp_path_factory.mktemp("rec")
    lines = write_oneline_folder(root / "lines", {
        "train": synthetic_texts(4, TOKEN_CHARS, 6, seed=7),
        "test": synthetic_texts(6, TOKEN_CHARS, 6, seed=8)}, hw=((80, 150), (14, 40)), seed=9)
    CharTokenizer.train([TOKEN_CHARS]).save(root / "tok.json")
    arch = dict(imgsz=[128, 32], enc_dim=64, enc_depth=2, enc_heads=2, dec_dim=64, dec_depth=2,
                dec_heads=4, max_label_length=16, ctc_weight=0.1)
    final = Model("trocr", task="recognize", device="cpu").train(
        data=str(lines), tokenizer=str(root / "tok.json"), batch=2, epochs=1, workers=0,
        project=str(root), name="r", verbose=False, **arch)
    run_dir = root / "recognize" / "r"
    variables = jax_trocr_variables()
    model = from_flax(TrOCR(**TROCR_KW, ctc_head=True), variables)
    cfg = load_config(overrides=arch)
    mgr = CheckpointManager(run_dir / "weights")
    for name in ("last", "best"):
        mgr.save(TrainState(model, build_optimizer(cfg, model), use_ema=False), name=name)
    return run_dir, lines, variables, final


def test_facade_trains_recognize_and_evaluate_recognizer_matches_jax(rec_run, monkeypatch):
    import jax.numpy as jnp
    import kuzu.tasks.recognize as jrec
    import kuzu.tools.evaluation as jeval
    from kuzu.data.tokenizer import CharTokenizer as JTok
    from kuzu.models.trocr import TrOCR as JaxTrOCR

    from kuzu_torch.core.metrics import character_error_rate
    from kuzu_torch.tasks.recognize import RecognizePredictor
    from kuzu_torch.core.config import load_config
    from kuzu_torch.tools.evaluation import evaluate_recognizer
    from torch_parity import TROCR_KW

    run_dir, lines, variables, final = rec_run
    assert np.isfinite(final["loss"])
    jp = jrec.RecognizePredictor(None)
    jp.cfg = {"decode": "greedy"}
    jp.ready, jp.min_bucket, jp._dp, jp._put = True, 1, None, jnp.asarray
    jp.tokenizer = JTok.load(run_dir / "tokenizer.json")
    jp.image_size = (128, 32)
    jp.model = JaxTrOCR(**TROCR_KW, ctc_head=True)
    jp.params = variables["params"]
    jp._setup = lambda: None
    monkeypatch.setattr(jrec, "RecognizePredictor", lambda cfg: jp)
    want = jeval.evaluate_recognizer(run_dir, lines, split="test")
    got = evaluate_recognizer(run_dir, lines, split="test", device="cpu")
    assert got == want and got["n"] == 6
    pred = RecognizePredictor(load_config(overrides={"model": str(run_dir)}), device="cpu")
    items = pt.OneLineDataset(lines, None, split="test").items
    reads = pred([p for p, _, _ in items])
    assert got["cer"] == character_error_rate(reads, [t for _, t, _ in items])
    assert len(set(reads)) > 1  # the texts depend on the crops
    json.dumps(got)
