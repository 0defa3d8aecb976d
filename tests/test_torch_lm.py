"""The port's char-LM against the JAX package on the CPU: the tiny CharMLM
of ``torch_parity`` carried across by ``kuzu_torch.bridge.from_flax``
(logits with and without a padding mask), and the cascade's
pseudo-log-likelihood rescoring (``KuzushijiPipeline.rescore_texts``)
against JAX's over the same texts.

f32 on both sides, sums in another order: logits are held to 1e-5 of the
largest logit, PLL scores (means of log-probabilities) to 1e-5 of the
largest score."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import LM_KW, TOKEN_CHARS, jax_lm_variables

REL = 1e-5

TEXTS = ["abc", "hello", "", "q", "kuzushiji", "ABCDEFGHIabcdefghi",
         "zzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzz", "ab", "xyzzy"]


@pytest.fixture(scope="module")
def lm_pair():
    from types import SimpleNamespace

    from kuzu.data.tokenizer import CharTokenizer as JaxTokenizer
    from kuzu.models.lm import CharMLM as JaxCharMLM

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.data.tokenizer import CharTokenizer
    from kuzu_torch.models.lm import CharMLM

    variables = jax_lm_variables()
    return SimpleNamespace(
        variables=variables, jmodel=JaxCharMLM(**LM_KW),
        port=from_flax(CharMLM(**LM_KW), variables).eval(),
        jtok=JaxTokenizer.train([TOKEN_CHARS]), ttok=CharTokenizer.train([TOKEN_CHARS]))


def test_char_mlm_logits_match(lm_pair):
    """Logits over padded rows: with the attention mask (padding keys
    masked at -1e30) and without it."""
    ids = np.stack([lm_pair.ttok.encode(t, max_length=24) for t in TEXTS[:6]])
    attn = (ids != 0).astype(np.float32)
    assert (attn == 0).any() and lm_pair.ttok.vocab == lm_pair.jtok.vocab
    for mask in (attn, None):
        want = np.asarray(lm_pair.jmodel.apply(
            lm_pair.variables, jnp.asarray(ids), None if mask is None else jnp.asarray(mask)))
        with torch.no_grad():
            got = lm_pair.port(torch.from_numpy(ids).long(),
                               None if mask is None else torch.from_numpy(mask)).numpy()
        assert np.abs(want).max() > 1  # logits of O(1), see jax_lm_variables
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_rescore_texts_matches_jax(lm_pair):
    """The PLL of every text, all texts in one batch; a text of no
    character scores 0.0, one of a character its log-probability."""
    from types import SimpleNamespace

    from kuzu.pipeline.cascade import KuzushijiPipeline as JaxPipeline

    from kuzu_torch.pipeline.cascade import KuzushijiPipeline
    from kuzu_torch.tasks.lm import LMPredictor

    jax_pipe = JaxPipeline(lm_mode="annotate")
    jax_pipe.lm = SimpleNamespace(ready=True, tokenizer=lm_pair.jtok, max_len=32,
                                  model=lm_pair.jmodel, params=lm_pair.variables["params"],
                                  min_bucket=1, _put=jnp.asarray)
    want = np.asarray(jax_pipe.rescore_texts(TEXTS))
    port = KuzushijiPipeline(lm=LMPredictor.from_model(lm_pair.port, lm_pair.ttok, max_len=32,
                                                       device="cpu"), device="cpu")
    got = np.asarray(port.rescore_texts(TEXTS))
    assert got.shape == (len(TEXTS),) and want[2] == got[2] == 0.0
    assert np.ptp(want) > 0.5  # scores spread
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    assert port.rescore_texts([]) == []


def test_lm_run_dirs_refuse(tmp_path):
    """An LM run dir without the weights an LMTrainer writes is refused at
    its first use (the trained run dirs load: tests/test_torch_lm_train.py)."""
    from kuzu_torch.core.config import load_config
    from kuzu_torch.pipeline.cascade import KuzushijiPipeline

    load_config(overrides={"task": "lm"}).to_yaml(tmp_path / "args.yaml")
    pipe = KuzushijiPipeline(lm=tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="holds no weights"):
        pipe.rescore_texts(["abc"])
