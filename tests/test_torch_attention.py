"""Parity of the port's attention kernels' plain versions with the Pallas
kernels (interpret mode), and the routing gates at the main path's shapes.

Both sides compute in f32 from bf16 inputs and round the output to bf16
once; only the order of f32 sums (and exp's last ulp) differs. So outputs
agree to one bf16 rounding: atol/rtol 2e-2 on values of order 1, and most
entries are bit-identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module itself: the package attribute of that name is the function it exports
t_fa = importlib.import_module("kuzu_torch.ops.flash_attention")
from kuzu_torch.ops import fused_ablock as t_fb
from kuzu_torch.testing import ATTN_TOL, attention_faults, attention_over, f32
from torch_parity import numpy_tree


def _bf16_pair(rng, shape, scale=1.0):
    a = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def test_area_attention_plain_matches_pallas(rng):
    from kuzu.ops.flash_attention import area_attention

    g, n, heads, hd = 3, 64, 4, 32
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (g, n, heads * hd)) for _ in range(3))
    ref = f32(area_attention(jq, jk, jv, heads, interpret=True))
    before = t_fa.area_attention.plain_calls
    out = t_fa.area_attention(tq, tk, tv, heads)
    assert t_fa.area_attention.plain_calls == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (g, n, heads * hd)
    np.testing.assert_allclose(f32(out), ref, atol=2e-2, rtol=2e-2)
    assert (f32(out) == ref).mean() > 0.9


# (kernel, G or BH, N, C, heads): N=400 is one ragged key block on the TPU and
# seven 64-key tiles on the card (the last 16 keys); N=128 and 256 stream whole tiles
ATTN_CASES = {
    "k3_n400": ("area", 2, 400, 64, 2),
    "k3_n128": ("area", 2, 128, 64, 2),
    "k5_n400": ("flash", 2, 400, 32, 1),
    "k5_n256": ("flash", 2, 256, 64, 1),
}


@pytest.fixture(scope="module", params=list(ATTN_CASES))
def attn_case(request):
    """Inputs, the Pallas kernel's output (interpret mode) and the port's
    plain version's, for one of ``ATTN_CASES``."""
    j_fa = importlib.import_module("kuzu.ops.flash_attention")

    kind, g, n, c, heads = ATTN_CASES[request.param]
    rng = np.random.default_rng(11)
    pairs = [_bf16_pair(rng, (g, n, c)) for _ in range(3)]
    jq, jk, jv = (p[0] for p in pairs)
    tq, tk, tv = (p[1] for p in pairs)
    if kind == "area":
        ref = j_fa.area_attention(jq, jk, jv, heads, interpret=True)
        out = t_fa.area_attention(tq, tk, tv, heads)
    else:
        ref = j_fa.flash_attention(jq, jk, jv, interpret=True)
        out = t_fa.flash_attention(tq, tk, tv)
    return (tq, tk, tv, heads), torch.from_numpy(f32(ref)).to(torch.bfloat16), out


def test_attention_plain_meets_the_kernels_tolerance(attn_case):
    """The plain versions of K3 and K5 against the Pallas kernels, under the
    bf16 tolerance the card holds the kernels to (ATTN_TOL)."""
    _, ref, out = attn_case
    err, n_over, _ = attention_over(out, ref)
    assert n_over == 0, f"{n_over} over {ATTN_TOL}, max error {err}"


def test_attention_faults_exceed_the_tolerance(attn_case):
    """Each planted fault (last key tile skipped, a head's columns read one
    head over, the 128-lane padded scale) puts outputs over ATTN_TOL, at
    N=400 and at a streamed N, so the card's check would catch it."""
    (q, k, v, heads), ref, _ = attn_case
    faults = attention_faults(q, k, v, heads)
    assert len(faults) == (3 if heads > 1 else 2)
    for name, out in faults.items():
        err, n_over, total = attention_over(out, ref)
        assert n_over > total // 10, f"{name}: only {n_over} of {total} over, max error {err}"


def test_area_attention_takes_column_slices(rng):
    """q and k as column slices of one qk tensor, as the executor passes them."""
    g, n, c, heads = 2, 32, 64, 2
    _, qk = _bf16_pair(rng, (g, n, 2 * c))
    _, v = _bf16_pair(rng, (g, n, c))
    q, k = qk[..., :c], qk[..., c:]
    out = t_fa.area_attention(q, k, v, heads)
    ref = t_fa.area_attention_plain(q.contiguous(), k.contiguous(), v, heads, (c // heads) ** -0.5)
    assert torch.equal(out, ref)


def test_xla_attention_matches(rng):
    from kuzu.ops.flash_attention import xla_attention

    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (4, 48, 32)) for _ in range(3))
    np.testing.assert_allclose(
        f32(t_fa.xla_attention(tq, tk, tv)), f32(xla_attention(jq, jk, jv)),
        atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def ablock_case():
    """flax ABlock(64, heads 2, mlp 1.5, area 4) at the shapes of
    tests/test_yolo_infer.py:106 and the same weights in the port's module."""
    from kuzu.models.yolo import modules as JM

    from kuzu_torch.bridge import from_flax
    from kuzu_torch.models.yolo import modules as TM

    rng = np.random.default_rng(1)
    mod = JM.ABlock(64, num_heads=2, mlp_ratio=1.5, area=4, dtype=jnp.bfloat16)
    x = rng.normal(0, 1, (2, 8, 8, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    variables = mod.init(jax.random.key(0), jx, False)
    tmod = TM.ABlock(64, 1.5)
    from_flax(tmod, numpy_tree(variables))
    return variables, jx, tmod


def test_ablock_weights_match(ablock_case):
    """Folding is the same f32 arithmetic before the bf16 cast; rsqrt may
    differ by an f32 ulp, which moves a weight by at most one bf16 ulp."""
    from kuzu.ops.fused_ablock import ablock_weights

    variables, _, tmod = ablock_case
    jw = ablock_weights(variables["params"], variables["batch_stats"])
    tw = t_fb.ablock_weights(tmod)
    assert len(jw) == len(tw) == 8
    for i, (a, b) in enumerate(zip(jw, tw)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert b.dtype == (torch.float32 if i % 2 else torch.bfloat16)
        np.testing.assert_allclose(f32(b), f32(a), rtol=8e-3, atol=1e-6)


def test_fused_ablock_plain_matches_pallas(ablock_case):
    from kuzu.models.yolo.infer import _P, conv
    from kuzu.ops.fused_ablock import ablock_weights, fused_ablock

    variables, jx, tmod = ablock_case
    attn_p = _P(variables["params"], variables["batch_stats"]).child("attn")
    jv = conv(attn_p.child("v"), jx, act=False)
    jpe = conv(attn_p.child("pe"), jv, g=64, act=False)
    jw = ablock_weights(variables["params"], variables["batch_stats"])
    ref = f32(fused_ablock(jx.reshape(2, 64, 64), jv.reshape(2, 64, 64),
                           jpe.reshape(2, 64, 64), tuple(jw), 4, 2, interpret=True))

    def t(a):
        return torch.from_numpy(f32(a)).to(torch.bfloat16).reshape(2, 64, 64)

    before = t_fb.fused_ablock.plain_calls
    out = t_fb.fused_ablock(t(jx), t(jv), t(jpe), t_fb.ablock_weights(tmod), 4, 2)
    assert t_fb.fused_ablock.plain_calls == before + 1
    # same inputs and (up to a bf16 ulp) the same weights: the residual stream
    # is O(1)-O(10), so one bf16 rounding of an intermediate moves it < 0.08
    np.testing.assert_allclose(f32(out), ref, atol=0.08, rtol=0.02)
    assert np.isclose(f32(out), ref, atol=0.02, rtol=0.01).mean() > 0.999


@pytest.mark.parametrize(
    "na,c,heads,hidden,fused,attn",
    [
        (400, 384, 12, 576, True, True),    # yolov12x@640 nodes 6 and 8
        (400, 128, 4, 256, True, True),     # yolov12n@640 node 8
        (400, 64, 2, 128, False, True),     # yolov12n@640 node 6: the K3 route
        (16, 64, 2, 128, False, True),      # yolov12n@128 node 6
        (100, 128, 4, 256, False, False),   # 320 px: na % 16 fails both
        (1600, 384, 12, 576, False, False),  # one area at 1280 px: past JAX's 8 MiB of scores
        (1024, 64, 2, 128, False, True),    # inside 8 MiB: K3 and K4 on both sides
        (1024, 384, 12, 576, True, True),
        (1440, 384, 12, 576, True, True),   # the last na % 16 == 0 inside 8 MiB
        (1456, 64, 2, 128, False, False),   # the first outside it
        (1456, 384, 12, 576, False, False),
        (1600, 64, 2, 128, False, False),
    ],
)
def test_gates_at_main_path_shapes(na, c, heads, hidden, fused, attn):
    """The gates route every node as the reference executor's terms do
    (``kuzu/models/yolo/infer.py:279-283`` and ``:315-321``) at head widths
    the kernels take. The training gate is the forward gate: the backward
    kernels stream their tiles, so their block does not grow with N and fits
    at every head width, and the training route takes the kernels wherever
    ``area_attention_trainable`` takes its own. K2's gate has no GEMM-width
    terms."""
    hd = c // heads
    jax_attn = na % 16 == 0 and na * na * 4 <= 8 * 2**20
    jax_fused = c % 128 == 0 and hd % 8 == 0 and jax_attn
    assert t_fb.fused_ablock_fits(na, c, heads, hidden) is fused is jax_fused
    assert t_fa.area_attention_fwd_fits(na, c, heads) is attn is jax_attn
    assert t_fa.area_attention_train_fits(na, c, heads) is attn
    assert t_fa.area_attention_train_fits is t_fa.area_attention_fwd_fits
    assert max(t_fa.attn_bwd_smem_bytes(d) for d in t_fa.FWD_DS) <= t_fa.SMEM_LIMIT
    # widths past the old GEMM's 768-column limit take the kernel where JAX does
    assert t_fb.fused_ablock_fits(na, 512, 16, 1024) is jax_attn


def test_backward_faults_exceed_the_tolerance():
    """Each planted fault of K4 (last query tile skipped in dK/dV, D taken
    as 0, another group's lse, dQ without scale) puts entries of one of dq,
    dk, dv over BWD_TOL against the plain version, so the card's check would
    catch it; the plain version given the forward's statistics stays within
    it of the exact function."""
    from kuzu_torch.testing import BWD_TOL, attention_bwd_exact, attention_bwd_faults, bwd_over

    rng = np.random.default_rng(17)
    g, n, heads, c = 3, 80, 2, 64
    (_, qk), (_, v), (_, do) = (_bf16_pair(rng, (g, n, w)) for w in (2 * c, c, c))
    q, k = qk[..., :c], qk[..., c:]
    stats = t_fa.area_attention(q, k, v, heads, return_lse=True)
    ref = t_fa.area_attention_bwd(q, k, v, do, heads, *stats)
    for a, b in zip(ref, attention_bwd_exact(q, k, v, do, heads)):
        assert bwd_over(a, b)[1] == 0, BWD_TOL
    faults = attention_bwd_faults(q, k, v, do, heads, stats[1])
    assert len(faults) == 4
    for name, outs in faults.items():
        assert max(bwd_over(a, b)[1] for a, b in zip(outs, ref)) > 0, name


def test_ablock_faults_exceed_the_tolerance():
    """Each planted fault in K2's epilogues (bias dropped, SiLU skipped, pe
    not added, residual dropped) falls outside ABLOCK_TOL against the plain
    version, which ablock_exact reproduces. Random weights and biases, as
    the card's check uses (a freshly initialised block's folded biases are
    zero, where a dropped bias cannot show)."""
    from kuzu_torch.testing import ABLOCK_TOL, ablock_exact, ablock_faults, ablock_over

    rng = np.random.default_rng(2)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.normal(0, 1, shape) * scale).astype(np.float32))

    x, v, pe = (t((2, 64, 64)).to(torch.bfloat16) for _ in range(3))
    weights = []
    for cin, cout in ((64, 128), (64, 64), (64, 96), (96, 64)):
        weights += [t((cin, cout), cin**-0.5).to(torch.bfloat16), t((1, cout), 0.1)]
    ref = t_fb.fused_ablock_plain(x, v, pe, weights, 4, 2)
    err, over, close = ablock_over(ablock_exact(x, v, pe, weights, 4, 2), ref)
    assert over == 0 and close > 0.999, ABLOCK_TOL
    for name, out in ablock_faults(x, v, pe, weights, 4, 2).items():
        err, over, close = ablock_over(out, ref)
        assert over > 0 or close <= 0.999, name


def test_ablock_scaled_tolerance():
    """ABLOCK_SCALED_TOL on a residual stream of O(50): s covers every
    value that reaches the output; one bf16 ulp of s at an entry where the
    terms cancel breaks ABLOCK_TOL's first bound but not the scaled one; the
    planted faults still fall outside the scaled tolerance."""
    from kuzu_torch.testing import ABLOCK_SCALED_TOL, ablock_exact, ablock_faults, ablock_over

    rng = np.random.default_rng(3)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.normal(0, 1, shape) * scale).astype(np.float32))

    x = (t((2, 64, 64)) * 50).to(torch.bfloat16)
    v, pe = (t((2, 64, 64)).to(torch.bfloat16) for _ in range(2))
    weights = []
    for cin, cout in ((64, 128), (64, 64), (64, 96), (96, 64)):
        weights += [t((cin, cout), cin**-0.5).to(torch.bfloat16), t((1, cout), 0.1)]
    ref = t_fb.fused_ablock_plain(x, v, pe, weights, 4, 2)
    scale = ablock_exact(x, v, pe, weights, 4, 2, scale=True)
    assert (scale >= ref.float().abs()).all() and (scale >= x.float().abs()).all()
    assert ablock_over(ablock_exact(x, v, pe, weights, 4, 2), ref, scale)[1] == 0
    i = int(torch.argmax(scale / ref.float().abs().clamp(min=1e-3)))
    ulp = 2.0 ** (np.floor(np.log2(float(scale.flatten()[i]))) - 7)
    flipped = ref.float().flatten().clone()
    flipped[i] += ulp
    flipped = flipped.reshape(ref.shape)
    assert ablock_over(flipped, ref)[1] == 1
    assert ablock_over(flipped, ref, scale)[1] == 0, ABLOCK_SCALED_TOL
    for name, out in ablock_faults(x, v, pe, weights, 4, 2).items():
        _, over, close = ablock_over(out, ref, scale)
        assert over > 0 or close <= 0.999, name


@pytest.mark.parametrize("hidden", [128, 576, 640, 704, 1280, 1344, 4096])
def test_ablock_gemm_smem_fits_at_any_depth(hidden):
    """K2's GEMM streams A and W through its ring at any depth, so its block
    does not grow with the widths and the gate has no width term: a wide
    MLP takes the kernel."""
    assert t_fb.ablock_smem_bytes(384, 12) <= t_fa.SMEM_LIMIT
    assert t_fb.fused_ablock_fits(400, 384, 12, hidden)
    assert t_fb.fused_ablock_fits(400, 384, 12, hidden + 4) is False  # TMA's 16-byte rows


@pytest.mark.parametrize("fn", ["area_attention", "fused_ablock", "suppress"])
def test_wrappers_raise_off_cpu_and_cuda(fn):
    """A wrapper runs the plain version only for a CPU tensor; any other
    device gets the kernel or an error, never a silent fallback."""
    from kuzu_torch.ops.nms_kernel import batched_suppress

    m = torch.empty((2, 32, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        if fn == "area_attention":
            t_fa.area_attention(m, m, m, 2)
        elif fn == "fused_ablock":
            t_fb.fused_ablock(m, m, m, [m] * 8, 1, 2)
        else:
            batched_suppress(torch.empty((1, 8, 4), device="meta"),
                     torch.empty((1, 8), dtype=torch.bool, device="meta"), 0.5)
