"""The port's CPU bf16 convolution (``kuzu_torch/ops/conv.py``) where torch's
own kernel fails: a strided axis that comes out 1 wide (the CRNN's stage 3
on a 16-wide crop). There the port computes in f32 over the bf16 operands
and rounds once: XLA's CPU result (the JAX reference) to the bit, or, at 64
input channels, but for one bf16 unit in 2 of 4096 outputs (a tie that
XLA's f32 sum, taken in another order, rounds the other way)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kuzu_torch.ops.conv import conv2d, cpu_bf16_faulty

CASES = [  # (input NCHW, cout, stride)
    ((4, 16, 16, 2), 16, (1, 2)),  # the CRNN's stage 3 on a 64 x 16 crop
    ((4, 64, 16, 2), 64, (1, 2)),  # 64 channels: torch's kernel gives inf / NaN
    ((2, 16, 16, 1), 16, (2, 2)),
    ((2, 16, 16, 4), 16, (1, 2)),  # output 2 wide: torch's kernel, unchanged
]


def _operands(shape, cout):
    rng = np.random.default_rng(sum(shape) + cout)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((cout, shape[1], 3, 3)) * 0.2).astype(np.float32)
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()


@pytest.mark.parametrize("shape,cout,stride", CASES)
def test_cpu_bf16_conv_is_f32_rounded_once_and_equals_xla(shape, cout, stride):
    x, w = _operands(shape, cout)
    got = conv2d(x, w, None, stride, 1)
    assert got.dtype == torch.bfloat16
    want = F.conv2d(x.float(), w.float(), None, stride, 1).bfloat16()
    faulty = cpu_bf16_faulty(x, w, stride, 1, 1)
    assert faulty == (got.shape[3] == 1)
    if faulty:  # the repaired route: f32 over the bf16 operands, rounded once
        assert torch.equal(got, want)
        xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
        wj = jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()).astype(jnp.bfloat16)
        yj = jax.lax.conv_general_dilated(xj, wj, stride, ((1, 1), (1, 1)),
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"))
        xla = torch.from_numpy(np.asarray(yj.astype(jnp.float32))).permute(0, 3, 1, 2)
        diff = (got.float() - xla).abs()
        assert (diff > 0).sum() <= got.numel() // 1000
        assert (diff <= 2 ** -7 * xla.abs()).all()  # at most one bf16 unit
    else:  # torch's own kernel, within a bf16 rounding of f32-then-round
        assert torch.equal(got, F.conv2d(x, w, None, stride, 1))
        assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
