"""The port's TrOCR against the JAX package on the CPU: the tiny TrOCR of
``torch_parity`` carried across by ``kuzu_torch.bridge.from_flax``:
encoder memory through both routes of the ViT's self-attention (the
kernel route, whose plain K3 runs against JAX's Pallas K3 in interpret
mode, and the einsum path), teacher-forced logits, the cached decode step
against the full causal pass, greedy and beam-4 tokens (with the argmax
margins that make exact tokens meaningful), n-best scores, the CTC head,
and the beam's top-k order among ties.

f32 on both sides, sums in another order (XLA's against oneDNN's): floats
are held to 1e-5 of the largest value of the compared tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TROCR_KW, jax_trocr_variables

REL = 1e-5  # of the largest value of the compared tensor
B = 6  # crops


def _close(got, want, rel=REL) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    from types import SimpleNamespace

    from kuzu.models.trocr import TrOCR as JaxTrOCR
    from kuzu.models.trocr import beam_generate as jax_beam
    from kuzu.models.trocr import greedy_generate as jax_greedy

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.trocr import TrOCR

    variables = jax_trocr_variables()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, 128, 32, 3), dtype=np.uint8)
    tokens = rng.integers(0, 40, (B, 16)).astype(np.int32)
    jimg = jnp.asarray(images)
    out = SimpleNamespace(images=images, tokens=tokens, variables=variables)
    for impl in ("flash_interpret", "einsum"):
        jm = JaxTrOCR(**TROCR_KW, ctc_head=True, attn_impl=impl)
        port = from_flax(TrOCR(**TROCR_KW, ctc_head=True, attn_impl=impl), variables)
        setattr(out, f"jmem_{impl}", np.asarray(jm.apply(variables, jimg, method=JaxTrOCR.encode)))
        setattr(out, f"port_{impl}", port.eval())
    jm = JaxTrOCR(**TROCR_KW, ctc_head=True, attn_impl="einsum")
    mem = jnp.asarray(out.jmem_einsum)
    out.jlogits = np.asarray(jm.apply(variables, jnp.asarray(tokens), mem,
                                      method=JaxTrOCR.decode_tokens, train=False))
    out.jctc = np.asarray(jm.apply(variables, mem, method=JaxTrOCR.ctc_logits))
    out.jgreedy = np.asarray(jax_greedy(jm, variables["params"], jimg, max_len=16))
    jt, jn = jax_beam(jm, variables["params"], jimg, max_len=16, num_beams=4,
                      return_nbest=True)
    out.jbeam, out.jnorm = np.asarray(jt), np.asarray(jn)
    return out


@pytest.mark.parametrize("impl", ["flash_interpret", "einsum"])
def test_encoder_memory_matches(pair, impl):
    """Both routes of the ViT's self-attention: the kernel route (the port's
    plain K3 against JAX's interpreted Pallas K3) and the einsum path."""
    from kuzu_torch.ops.flash_attention import area_attention

    port = getattr(pair, f"port_{impl}")
    before = area_attention.plain_calls
    with torch.no_grad():
        mem = port.encode(torch.from_numpy(pair.images))
    # the kernel route takes K3 once per encoder layer; einsum never
    assert area_attention.plain_calls - before == (2 if impl == "flash_interpret" else 0)
    assert mem.shape == (B, 16, 64)
    _close(mem.numpy(), getattr(pair, f"jmem_{impl}"))


def test_auto_route_is_einsum_on_the_cpu(pair):
    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.trocr import TrOCR
    from kuzu_torch.ops.flash_attention import area_attention

    port = from_flax(TrOCR(**TROCR_KW, ctc_head=True), pair.variables).eval()
    before = area_attention.plain_calls
    with torch.no_grad():
        mem = port.encode(torch.from_numpy(pair.images))
    assert area_attention.plain_calls == before
    np.testing.assert_array_equal(
        mem.numpy(), pair.port_einsum.encode(torch.from_numpy(pair.images)).detach().numpy())


def test_teacher_forced_logits_and_ctc_head_match(pair):
    port = pair.port_einsum
    with torch.no_grad():
        mem = port.encode(torch.from_numpy(pair.images))
        logits = port.decode_tokens(torch.from_numpy(pair.tokens).long(), mem)
        ctc = port.ctc_logits(mem)
    assert np.abs(pair.jlogits).max() > 10  # logits of O(10), see jax_trocr_variables
    _close(logits.numpy(), pair.jlogits)
    assert ctc.shape == (B, 8, 40)
    _close(ctc.numpy(), pair.jctc)


def test_cached_decode_step_matches_the_full_causal_pass(pair):
    """Step by step with the KV cache (the cross-attention's keys and values
    computed once) against the teacher-forced pass over the same tokens."""
    port = pair.port_einsum
    tokens = torch.from_numpy(pair.tokens).long()
    with torch.no_grad():
        mem = port.encode(torch.from_numpy(pair.images))
        full = port.decode_tokens(tokens, mem)
        state = port.start_decode(mem)
        steps = [port.decode_step(tokens[:, t:t + 1], state, t) for t in range(16)]
    _close(torch.cat(steps, 1).numpy(), full.numpy())


def test_greedy_tokens_match_with_margins(pair):
    """Exact tokens; each step's argmax leads the runner-up by far more than
    the logits' tolerance, so the exact comparison holds the arithmetic, not
    luck; rows end at different steps (EOS, then padding), and a batch whose
    rows all end stops at the step after the last EOS."""
    from kuzu_torch.models.trocr import greedy_generate

    port = pair.port_einsum
    out = greedy_generate(port, torch.from_numpy(pair.images), max_len=16).numpy()
    np.testing.assert_array_equal(out, pair.jgreedy)
    ends = np.array([int(np.argmax(row == 3)) if (row == 3).any() else 16 for row in out])
    assert len(set(ends)) > 2 and (ends < 16).sum() >= 2, ends
    assert greedy_generate.steps == 16
    prev = np.concatenate([np.full((B, 1), 2, np.int32), out[:, :-1]], 1)
    with torch.no_grad():
        logits = port(torch.from_numpy(pair.images), torch.from_numpy(prev).long()).numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    live = np.arange(16)[None] <= ends[:, None]
    margin = (top2[..., 1] - top2[..., 0])[live].min()
    assert margin > 100 * REL * np.abs(logits).max(), margin
    # the rows that end: the loop exits after their last EOS
    ending = np.flatnonzero(ends < 16)
    part = greedy_generate(port, torch.from_numpy(pair.images[ending]), max_len=16).numpy()
    np.testing.assert_array_equal(part, pair.jgreedy[ending])
    assert greedy_generate.steps == ends[ending].max() + 1 < 16


def test_beam_tokens_and_nbest_scores_match(pair):
    from kuzu_torch.models.trocr import beam_generate

    port = pair.port_einsum
    images = torch.from_numpy(pair.images)
    tokens, norm = beam_generate(port, images, max_len=16, num_beams=4, return_nbest=True)
    np.testing.assert_array_equal(tokens.numpy(), pair.jbeam)
    assert (pair.jbeam[:, 0] != pair.jbeam[:, 1]).any()  # the hypotheses differ
    np.testing.assert_allclose(norm.numpy(), pair.jnorm, rtol=REL, atol=REL)
    # the best hypothesis, by the length-normalised score
    best = beam_generate(port, images, max_len=16, num_beams=4)
    np.testing.assert_array_equal(best.numpy(),
                                  pair.jbeam[np.arange(B), pair.jnorm.argmax(-1)])


def test_top_k_keeps_jax_order_among_ties():
    """Planted ties: dead beams' candidates all at -1e30 (-1e30 + log p
    rounds to -1e30 in f32), and equal live scores; the lower index first,
    as jax.lax.top_k."""
    from kuzu_torch.models.trocr import top_k_stable

    rng = np.random.default_rng(4)
    x = np.full((3, 4 * 40), -1e30, np.float32)
    x[0, 5] = -0.5  # one live candidate, three ties for the rest
    x[1, [7, 47, 90, 130]] = -1.25  # four equal live candidates across beams
    x[1, 3] = -1.25
    x[2] = rng.normal(size=160).astype(np.float32).round(1)  # many ties
    assert (np.float32(-1e30) + np.float32(-3.7)) == np.float32(-1e30)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = top_k_stable(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy()[0], [5, 0, 1, 2])


def test_unported_encoders_refuse():
    """The refusal is retired: ``unet`` and ``csa`` build their encoders
    (held against JAX in ``test_torch_encoders.py``), and any other name
    builds the ViT, as JAX's ``TrOCR.setup`` does."""
    from kuzu_torch.models.csa_vit import CSAViTEncoder
    from kuzu_torch.models.trocr import TrOCR, ViTEncoder
    from kuzu_torch.models.unet_transformer import UNetTransformerEncoder

    for kind, cls in (("unet", UNetTransformerEncoder), ("csa", CSAViTEncoder),
                      ("vit", ViTEncoder), ("swin", ViTEncoder)):
        assert type(TrOCR(**TROCR_KW, encoder_type=kind).encoder) is cls


@pytest.mark.parametrize("g,n,c,heads", [(3, 16, 64, 2), (2, 80, 128, 2), (1, 256, 384, 6)])
def test_k3_f32_plain_matches_pallas(g, n, c, heads):
    """K3's f32 route on the CPU (its plain version, as the wrapper takes it
    for a CPU tensor) against JAX's Pallas K3 in interpret mode on f32
    inputs: f32 out, within the f32 tolerance the card holds the kernel to
    (``ATTN_F32_TOL``); planted faults exceed it."""
    from kuzu.ops.flash_attention import area_attention as jax_area_attention

    from kuzu_torch.ops.flash_attention import area_attention
    from kuzu_torch.testing import attention_f32_over, attention_faults

    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(g, n, c)).astype(np.float32) for _ in range(3))
    want = np.array(jax_area_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads, interpret=True))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = area_attention(tq, tk, tv, heads)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err, n_over, _ = attention_f32_over(got, torch.from_numpy(want))
    assert n_over == 0, err
    for name, bad in attention_faults(tq, tk, tv, heads, keys=min(64, n // 2)).items():
        assert attention_f32_over(bad, torch.from_numpy(want))[1] > 0, name


def test_k3_f32_gate():
    """The f32 route's gate: the reference's terms (N % 16, N^2 * 4 <=
    8 MiB), head widths 16-128 in steps of 16, the 3xTF32 kernel's block
    within the shared memory at every width."""
    from kuzu_torch.ops.flash_attention import (FWD_DS, SMEM_LIMIT, area_attention_fwd_fits,
                                                f32_attn_smem_bytes)

    f32 = torch.float32
    assert area_attention_fwd_fits(256, 384, 6, f32)  # the production TrOCR encoder
    assert area_attention_fwd_fits(16, 64, 2, f32)  # the parity tests' encoder
    assert all(f32_attn_smem_bytes(hd) <= SMEM_LIMIT for hd in FWD_DS)
    assert f32_attn_smem_bytes(128) == 197760
    for n, c, heads in ((250, 384, 6), (1456, 384, 6), (256, 48, 6), (256, 384, 5),
                        (256, 288, 2)):
        assert not area_attention_fwd_fits(n, c, heads, f32), (n, c, heads)
