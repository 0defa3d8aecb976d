"""The port's CTC recognizer against the JAX package on the CPU: the CRNN
carried across by ``kuzu_torch.bridge.crnn_from_flax`` (logits, then texts),
greedy CTC decoding, the tokenizer copy and ``from_uint8``'s mean/std."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.bridge import crnn_from_flax
from kuzu_torch.data.tokenizer import CharTokenizer
from kuzu_torch.models.crnn import CRNN
from kuzu_torch.ops.ctc import ctc_greedy_decode
from kuzu_torch.tasks.ctc import CTCPredictor
from torch_parity import numpy_tree

CHARS = "abcdefghijklmnopqrst"  # a 20-character vocabulary, 25 ids with the specials
# f32 on both sides; the sums of the convs and the LSTM run in another order
# (XLA's against oneDNN's), so the logits agree to f32 rounding grown over ~12
# layers and 40 recurrent steps: 1e-5 of the largest logit plus 1e-5 absolute
LOGIT_RTOL = LOGIT_ATOL = 1e-5


def _jax_crnn(time_axis: str, max_boxes: int = 0, seed: int = 0):
    from kuzu.models.crnn import CRNN as JaxCRNN

    size = (160, 40) if time_axis == "height" else (40, 160)
    model = JaxCRNN(num_classes=25, lstm_hidden=32, time_axis=time_axis, max_boxes=max_boxes)
    x = jnp.zeros((1, *size, 3), jnp.uint8)
    variables = numpy_tree(jax.jit(lambda r: model.init(r, x))(jax.random.key(seed)))
    # BatchNorm statistics away from the identity, so the bridge's mean/var
    # mapping is exercised
    rng = np.random.default_rng(seed)
    for leaf in _bn_leaves(variables["batch_stats"]):
        leaf["mean"] = rng.normal(0, 0.2, leaf["mean"].shape).astype(np.float32)
        leaf["var"] = rng.uniform(0.5, 2.0, leaf["var"].shape).astype(np.float32)
    # a head ~10x larger than at init: logits of O(1), so argmax ties are
    # far apart and the texts test the decode, not rounding
    variables["params"]["head"]["kernel"] = variables["params"]["head"]["kernel"] * 10
    return model, variables, size


def _bn_leaves(tree):
    if "mean" in tree:
        yield tree
        return
    for v in tree.values():
        yield from _bn_leaves(v)


@pytest.fixture(scope="module", params=["height", "width"])
def crnn_pair(request):
    model, variables, size = _jax_crnn(request.param, max_boxes=3)
    images = np.random.default_rng(1).integers(0, 256, (4, *size, 3), dtype=np.uint8)
    logits, boxes = jax.jit(lambda v, x: model.apply(v, x))(variables, jnp.asarray(images))
    port = crnn_from_flax(CRNN(25, lstm_hidden=32, time_axis=request.param, max_boxes=3),
                          variables).eval()
    with torch.no_grad():
        tlogits, tboxes = port(torch.from_numpy(images))
    return dict(jax=(np.asarray(logits), np.asarray(boxes)), port=(tlogits, tboxes),
                model=port, images=images, size=size)


def test_crnn_logits_match(crnn_pair):
    jl, jb = crnn_pair["jax"]
    tl, tb = crnn_pair["port"]
    assert tl.shape == jl.shape == (4, 40, 25)
    assert np.abs(jl).max() > 0.5  # logits of O(1), see _jax_crnn
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=LOGIT_ATOL + LOGIT_RTOL * np.abs(jl).max())
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-6)


def test_crnn_texts_match(crnn_pair):
    """Greedy CTC texts of the two packages' logits, exactly, through each
    package's decode and the two tokenizer copies."""
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.ops.ctc import ctc_greedy_decode as jax_decode

    jtok, ttok = JaxTokenizer.train([CHARS]), CharTokenizer.train([CHARS])
    assert jtok.vocab == ttok.vocab and len(ttok) == 25
    js, jn = (np.asarray(a) for a in jax_decode(jnp.asarray(crnn_pair["jax"][0])))
    ts, tn = ctc_greedy_decode(crnn_pair["port"][0])
    want = [jtok.decode(s[:m]) for s, m in zip(js, jn)]
    got = [ttok.decode(s[:m]) for s, m in zip(ts.numpy(), tn.numpy())]
    assert got == want
    assert any(want)  # not all empty


def test_bridge_rejects_a_missing_or_stray_leaf():
    model, variables, _ = _jax_crnn("height", seed=2)
    short = numpy_tree(variables)
    del short["params"]["OptimizedLSTMCell_1"]["hg"]["bias"]
    with pytest.raises(ValueError, match="OptimizedLSTMCell_1/hg/bias"):
        crnn_from_flax(CRNN(25, lstm_hidden=32), short)
    extra = numpy_tree(variables)
    extra["params"]["head"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="head/stray"):
        crnn_from_flax(CRNN(25, lstm_hidden=32), extra)
    port = crnn_from_flax(CRNN(25, lstm_hidden=32), variables)
    # the input projection has no bias in flax: bias_ih is zero
    assert not port.lstm.bias_ih_l0.any() and not port.lstm.bias_ih_l0_reverse.any()
    np.testing.assert_array_equal(port.head.weight.detach().numpy(),
                                  variables["params"]["head"]["kernel"].T)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_ctc_greedy_decode_matches_jax(with_lengths):
    """Sequences and lengths exactly: repeats, blanks, runs across blanks,
    an all-blank row and, with lengths, rows cut short."""
    from kuzu.ops.ctc import ctc_greedy_decode as jax_decode

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 30, 7)).astype(np.float32)
    logits[0, :, 0] += 10  # all blank
    logits[1, ::3, 0] += 10  # blanks every third step, repeats between
    logits[2, :, 4] += 10  # one long run of one label
    lengths = np.array([30, 12, 30, 1, 0, 29], np.int32) if with_lengths else None
    js, jn = jax_decode(jnp.asarray(logits),
                        None if lengths is None else jnp.asarray(lengths))
    ts, tn = ctc_greedy_decode(torch.from_numpy(logits),
                               None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_tokenizer_copy_matches(tmp_path):
    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer

    texts = ["ｶﾞ漢字かな", "abcａｂｃ", "かな漢"]
    j, t = JaxTokenizer.train(texts), CharTokenizer.train(texts)
    assert j.vocab == t.vocab
    for s in texts + ["unknown字"]:
        np.testing.assert_array_equal(t.encode(s, max_length=8), j.encode(s, max_length=8))
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    assert (CharTokenizer.from_unicode_ids(["U+4E00", "U+3042"]).vocab
            == JaxTokenizer.from_unicode_ids(["U+4E00", "U+3042"]).vocab)
    j.save(tmp_path / "tok.json")  # the two packages read each other's files
    assert CharTokenizer.load(tmp_path / "tok.json").vocab == j.vocab


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (0.5, 0.5)])
def test_from_uint8_mean_std_exact(mean, std):
    from kuzu.ops.images import from_uint8 as jax_from_uint8

    from kuzu_torch.ops.images import from_uint8

    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    want = np.asarray(jax_from_uint8(jnp.asarray(x), mean=mean, std=std))
    got = from_uint8(torch.from_numpy(x), mean=mean, std=std).numpy()
    np.testing.assert_array_equal(got, want)
    assert from_uint8(torch.ones(2), mean=mean, std=std).dtype == torch.float32  # float passes


def test_ctc_predictor_from_model_and_run_dir(crnn_pair, tmp_path):
    from kuzu_torch.core.config import Config

    tok = CharTokenizer.train([CHARS])
    pred = CTCPredictor.from_model(crnn_pair["model"], tok, crnn_pair["size"], device="cpu")
    (seqs, lens), boxes = pred._fwd(torch.from_numpy(crnn_pair["images"]))
    ts, tn = ctc_greedy_decode(crnn_pair["port"][0])
    assert torch.equal(seqs, ts) and torch.equal(lens, tn) and boxes.shape == (4, 3, 4)
    assert pred.image_size == crnn_pair["size"]
    with pytest.raises(FileNotFoundError, match="holds no weights"):  # a run dir without them
        CTCPredictor(Config(model=str(tmp_path)), device="cpu")._fwd(
            torch.from_numpy(crnn_pair["images"]))
