"""Parity of the port's flash attention (K5) and fused C3k2 (K6) with the
Pallas kernels run in interpret mode, and of their entry points' routing and
refusals, on the CPU.

Tolerances, each with its reason:
- flash attention in f32: both sides run the same online-softmax recurrence
  over the same 128-key tiles in f32, so only the order of f32 sums differs:
  the JAX tests' own 2e-5 (1e-4 for logits scaled by 30);
- flash attention in bf16: f32 arithmetic rounded once to bf16, so the two
  agree to one bf16 rounding (2^-8 relative);
- fused C3k2: the same weights, the same rounding points (f32 sums, f32 bias
  and SiLU, bf16 after each conv, bf16 residual adds), so an intermediate
  rounds differently only where an f32 sum lands at a bf16 rounding edge:
  one bf16 ulp (2^-8 relative, 2^-8 absolute near zero), and almost all
  outputs identical;
- against the port's executor (bias added after the bf16 rounding of the
  conv), the JAX test's own tolerance (tests/test_yolo_infer.py:101-103).

The C3k2 weights are the port module's seeded ones, handed to JAX as a flax
tree (no flax init), with random BatchNorm statistics so that folding does
work.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu_torch.models.yolo import modules as TM
from kuzu_torch.ops import fused_c3k2 as t_c3
from kuzu_torch.testing import f32
from torch_parity import flax_variables

# the module itself: the package attribute of that name is the function it exports
t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")

BF16_ULP = 2.0**-8


def _qkv(rng, bh, n, d, q_scale=1.0):
    q, k, v = (rng.normal(0, 1, (bh, n, d)).astype(np.float32) for _ in range(3))
    return q * np.float32(q_scale), k, v


# (BH, N, D, dtype, q scale, atol): the four cases of tests/test_flash_attention.py
# (aligned N, D=32, large logits, unaligned N=400) and one in bf16
FLASH_CASES = {
    "aligned": (2, 256, 64, "float32", 1.0, 2e-5),
    "d32": (2, 256, 32, "float32", 1.0, 2e-5),
    "large_logits": (2, 128, 64, "float32", 30.0, 1e-4),
    "unaligned_n400": (6, 400, 32, "float32", 1.0, 2e-5),
    "bf16_n384": (4, 384, 64, "bfloat16", 1.0, None),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(case, rng):
    from kuzu.ops.flash_attention import flash_attention

    bh, n, d, dtype, q_scale, atol = FLASH_CASES[case]
    arrs = _qkv(rng, bh, n, d, q_scale)
    ref = f32(flash_attention(*(jnp.asarray(a, dtype) for a in arrs), interpret=True))
    before = t_fa.flash_attention.plain_calls
    out = t_fa.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs))
    assert t_fa.flash_attention.plain_calls == before + 1
    assert out.dtype == getattr(torch, dtype) and out.shape == (bh, n, d)
    assert np.isfinite(f32(out)).all()
    if atol is None:  # bf16: one rounding apart
        np.testing.assert_allclose(f32(out), ref, atol=BF16_ULP, rtol=BF16_ULP)
        assert (f32(out) == ref).mean() > 0.99
    else:
        np.testing.assert_allclose(f32(out), ref, atol=atol)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_scale_matches(scale, dtype, rng):
    from kuzu.ops.flash_attention import xla_attention

    arrs = _qkv(rng, 4, 48, 32)
    ref = f32(xla_attention(*(jnp.asarray(a, dtype) for a in arrs), scale=scale))
    out = t_fa.xla_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
                             scale=scale)
    tol = 2e-6 if dtype == "float32" else 2e-2  # bf16: P is rounded before P V on both sides
    np.testing.assert_allclose(f32(out), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("min_seq", [8192, 128])
def test_flash_attention_auto_on_cpu_takes_xla_path(min_seq, rng):
    """On the CPU both packages take the materialised path, whatever N and
    min_seq, and the port launches nothing and runs no plain flash version."""
    from kuzu.ops.flash_attention import flash_attention_auto

    arrs = _qkv(rng, 2, 256, 32)
    ref = f32(flash_attention_auto(*(jnp.asarray(a) for a in arrs), min_seq=min_seq))
    fn = t_fa.flash_attention
    before = (fn.launches, fn.plain_calls)
    out = t_fa.flash_attention_auto(*(torch.from_numpy(a) for a in arrs), min_seq=min_seq)
    assert (fn.launches, fn.plain_calls) == before
    np.testing.assert_allclose(f32(out), ref, atol=2e-6)
    np.testing.assert_array_equal(f32(out), f32(t_fa.xla_attention(
        *(torch.from_numpy(a) for a in arrs))))


def test_package_exports_flash_entry_points():
    import kuzu_torch.ops as ops

    assert ops.flash_attention is t_fa.flash_attention
    assert ops.flash_attention_auto is t_fa.flash_attention_auto


@pytest.mark.parametrize("n", [200, 1040])
def test_flash_attention_raises_where_jax_asserts(n):
    from kuzu.ops.flash_attention import flash_attention

    q = np.zeros((1, n, 32), np.float32)
    with pytest.raises(AssertionError):
        flash_attention(q, q, q, interpret=True)
    with pytest.raises(ValueError, match="N % 128"):
        t_fa.flash_attention(*(torch.from_numpy(q),) * 3)


def test_flash_smem_within_a_block():
    for d in t_fa.FLASH_DS:
        for dt in (torch.bfloat16, torch.float32):
            assert t_fa.flash_attention_smem_bytes(d, dt) <= t_fa.SMEM_LIMIT


# ------------------------------------------------------------------- C3k2


@pytest.fixture(scope="module")
def c3k2_case():
    """The JAX test's C3k2(48, n=2, c3k=True, e=0.25) on 24 input channels
    (tests/test_yolo_infer.py:85-103) as a port module with seeded weights
    and random BatchNorm parameters and statistics, and the same weights as
    a flax tree."""
    rng = np.random.default_rng(5)
    mod = TM.C3k2(24, 48, n=2, c3k=True, e=0.25)
    TM.init_weights(mod, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, (lo, hi) in ((m.weight, (0.5, 1.5)), (m.running_var, (0.5, 1.5))):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
    return mod, flax_variables(mod)


def _jax_weights(variables):
    from kuzu.ops.fused_c3k2 import c3k2_weights

    return c3k2_weights(variables["params"], variables["batch_stats"])


def test_c3k2_weights_match(c3k2_case):
    """The same folding arithmetic before the bf16 cast; XLA's rsqrt on the
    CPU differs from torch's by an f32 ulp about a third of the time, which
    moves a bias by a few f32 ulps and a weight by at most one bf16 ulp."""
    mod, variables = c3k2_case
    jw = _jax_weights(variables)
    tw = t_c3.c3k2_weights(mod)
    assert len(jw) == len(tw) == 2 * t_c3.N_CONVS
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert b.dtype == (torch.float32 if i % 2 else torch.bfloat16), i
        if i % 2:
            np.testing.assert_allclose(f32(b), f32(a), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(f32(b), f32(a), rtol=BF16_ULP, atol=0)
            assert (f32(b) == f32(a)).mean() > 0.99, i


@pytest.mark.parametrize("h", [32, 24])  # 24: tile 16 halves to bands of 8 rows
def test_fused_c3k2_plain_matches_pallas(h, c3k2_case):
    from kuzu.ops.fused_c3k2 import fused_c3k2

    assert t_c3.band_rows(h, 16) == (16 if h == 32 else 8)
    _, variables = c3k2_case
    jw = _jax_weights(variables)
    x = np.random.default_rng(h).normal(0, 1, (2, h, 32, 24)).astype(np.float32)
    ref = f32(fused_c3k2(jnp.asarray(x, jnp.bfloat16), tuple(jw), n=2, tile=16,
                         interpret=True))
    tw = [torch.tensor(f32(a)).to(torch.float32 if i % 2 else torch.bfloat16)
          for i, a in enumerate(jw)]  # JAX's own weights: the same inputs on both sides
    before = t_c3.fused_c3k2.plain_calls
    out = t_c3.fused_c3k2(torch.from_numpy(x).to(torch.bfloat16), tw, n=2, tile=16)
    assert t_c3.fused_c3k2.plain_calls == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (2, h, 32, 48)
    np.testing.assert_allclose(f32(out), ref, atol=BF16_ULP, rtol=BF16_ULP)
    assert (f32(out) == ref).mean() > 0.999


def test_fused_c3k2_plain_matches_executor(c3k2_case):
    """The plain version against the port's BN-folded executor ``c3k2`` on
    the same module, under tests/test_yolo_infer.py:101-103's tolerance."""
    from kuzu_torch.models.yolo.infer import _P, c3k2, fold_graph

    mod, _ = c3k2_case
    holder = torch.nn.Module()
    holder.add_module("n2_C3k2", mod)
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (2, 32, 32, 24))
                         .astype(np.float32)).to(torch.bfloat16)
    nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = f32(c3k2(_P(fold_graph(holder), "n2_C3k2"), nchw, 2, True).permute(0, 2, 3, 1))
        out = f32(t_c3.fused_c3k2_plain(x, t_c3.c3k2_weights(mod)))
    np.testing.assert_allclose(out, ref, atol=0.08, rtol=0.08)
    assert np.isclose(out, ref, atol=0.05, rtol=0.05).mean() > 0.999


def test_fused_c3k2_takes_only_its_variant(c3k2_case):
    mod, _ = c3k2_case
    w = t_c3.c3k2_weights(mod)
    x = torch.zeros((1, 8, 8, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="c3k=True"):
        t_c3.c3k2_weights(TM.C3k2(24, 48, n=2, c3k=False, e=0.25))
    with pytest.raises(ValueError, match="c3k=True"):
        t_c3.c3k2_weights(TM.C3k2(24, 48, n=1, c3k=True, e=0.25))
    with pytest.raises(ValueError, match="n=2"):
        t_c3.fused_c3k2(x, w, n=1)
    with pytest.raises(ValueError, match="tensors"):
        t_c3.fused_c3k2(x, w[:-2])
    with pytest.raises(ValueError, match="conv 0"):
        t_c3.fused_c3k2(torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16), w)


@pytest.mark.parametrize("cin,c,hid,c2,fits", [
    (192, 96, 48, 384, True),     # yolov12x@640 node 2
    (384, 192, 96, 768, True),    # node 4
    (1536, 384, 192, 768, True),  # node 20
    (24, 12, 6, 48, False),       # the widths above: not multiples of 8
])
def test_fused_c3k2_fits_yolov12x_nodes(cin, c, hid, c2, fits):
    assert t_c3.fused_c3k2_fits(cin, c, hid, c2) is fits


@pytest.mark.parametrize("fn", ["flash_attention", "fused_c3k2"])
def test_wrappers_raise_off_cpu_and_cuda(fn, c3k2_case):
    """A wrapper runs the plain version only for a CPU tensor; any other
    device gets the kernel or an error, never a silent fallback."""
    if fn == "flash_attention":
        m = torch.empty((2, 128, 32), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="CPU or CUDA"):
            t_fa.flash_attention(m, m, m)
    else:
        w = [t.to("meta") for t in t_c3.c3k2_weights(c3k2_case[0])]
        with pytest.raises(ValueError, match="CPU or CUDA"):
            t_c3.fused_c3k2(torch.empty((1, 8, 8, 24), dtype=torch.bfloat16, device="meta"), w)
