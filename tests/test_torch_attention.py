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
from kuzu_torch.testing import f32
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
        (1600, 384, 12, 576, False, False),  # one area at 1280 px: too big for smem
    ],
)
def test_gates_at_main_path_shapes(na, c, heads, hidden, fused, attn):
    assert t_fb.fused_ablock_fits(na, c, heads, hidden) is fused
    assert t_fa.area_attention_fits(na, c, heads) is attn


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
