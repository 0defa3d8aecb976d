"""The arithmetic of the f32 attention kernels (K3's and K4's f32 routes on
the tensor cores, 3xTF32) against the JAX package on the CPU.

The kernels split every operand of a product into two TF32 parts and take
three TF32 products (``kuzu_torch.testing.tf32_split``, ``tf32_matmul``).
Their emulations (``attention_tf32``, ``attention_bwd_tf32``) run here
against JAX's ``area_attention_trainable`` in interpret mode (its Pallas
forward and its Pallas backward through ``jax.vjp``), on numpy inputs at two
scales: 3xTF32 must lie within the f32 tolerances the kernels are held to
(``ATTN_F32_TOL``, ``BWD_F32_TOL``), and plain TF32 (hi x hi alone) must
lie outside them, so the tolerances tell the two apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuzu.ops.flash_attention import area_attention_trainable as jax_trainable
from kuzu_torch.testing import (
    attention_bwd_tf32,
    attention_f32_over,
    attention_tf32,
    bwd_f32_over,
)

G, N, C, HEADS = 2, 64, 128, 2


@jax.jit
def _jax_pair(q, k, v, do):
    """JAX's output and (dq, dk, dv), Pallas in interpret mode."""
    out, vjp = jax.vjp(lambda a, b, c: jax_trainable(a, b, c, HEADS, True), q, k, v)
    return (out, *vjp(do))


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_tf32_passes_against_f32_tolerances(scale, passes):
    """3xTF32 (``passes=3``): the output within ``ATTN_F32_TOL`` and each
    gradient within ``BWD_F32_TOL`` of JAX's f32; plain TF32 (``passes=1``):
    the output and every gradient over them."""
    rng = np.random.default_rng(int(10 * scale))
    arrs = [rng.normal(0.0, scale, (G, N, C)).astype(np.float32) for _ in range(4)]
    want = [torch.from_numpy(np.array(x)) for x in _jax_pair(*(jnp.asarray(a) for a in arrs))]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, _ = attention_tf32(q, k, v, HEADS, passes)
    grads = attention_bwd_tf32(q, k, v, do, HEADS, passes)
    over = [attention_f32_over(out, want[0])[1]]
    over += [bwd_f32_over(got, ref)[1] for got, ref in zip(grads, want[1:])]
    if passes == 3:
        assert over == [0, 0, 0, 0], over
    else:
        assert all(o > 0 for o in over), over
