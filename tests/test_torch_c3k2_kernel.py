"""What the fused C3k2 kernel (K6, ``kuzu_torch/csrc/fused_c3k2.cu`` over
``csrc/conv.cuh``) takes from its wrapper, on the CPU where the kernel cannot
run: the weight re-layout (each C3k's cv1 and bypass cv2 side by side as
one product's weight; the others as given) turned back into the plain
version's inputs gives the same weights and a bit-identical block, and the
shared-memory gate follows the kernel's block."""

import numpy as np
import pytest
import torch

from kuzu_torch.models.yolo import modules as TM
from kuzu_torch.ops import fused_c3k2 as t_c3


@pytest.fixture(scope="module")
def weights():
    """C3k2(24, 48, n=2, c3k=True, e=0.25) with seeded weights and random
    BatchNorm parameters and statistics, folded."""
    rng = np.random.default_rng(11)
    mod = TM.C3k2(24, 48, n=2, c3k=True, e=0.25)
    TM.init_weights(mod, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
    return t_c3.c3k2_weights(mod)


def _back(kw: list[torch.Tensor], hid: int) -> list[torch.Tensor]:
    """The kernel's 14 launches' (W, bias) back into c3k2_weights' 16 (W, b)."""
    ws, bs = kw[0::2], kw[1::2]

    def pair(w, b):
        return [w.contiguous(), b.reshape(1, -1)]

    out = pair(ws[0], bs[0])
    for j in range(t_c3.N_C3K):
        i = 1 + 6 * j  # merged, four 3x3, cv3
        merged, mb = ws[i], bs[i]
        out += pair(merged[:, :hid], mb[:hid])
        for k in range(i + 1, i + 5):
            out += pair(ws[k], bs[k])
        out += pair(merged[:, hid:], mb[hid:]) + pair(ws[i + 5], bs[i + 5])
    return out + pair(ws[-1], bs[-1])


def test_kernel_weights_layout(weights):
    kw = t_c3.kernel_weights(weights)
    assert len(kw) == 2 * t_c3.N_LAUNCHES == 28
    c, hid, c2 = 12, 6, 48
    shapes = [(24, 2 * c)]
    for _ in range(t_c3.N_C3K):
        shapes += [(c, 2 * hid)] + [(9 * hid, hid)] * 4 + [(2 * hid, c)]
    shapes.append((4 * c, c2))
    for i, shp in enumerate(shapes):
        w, b = kw[2 * i], kw[2 * i + 1]
        assert tuple(w.shape) == shp and w.dtype == torch.bfloat16 and w.is_contiguous(), i
        assert tuple(b.shape) == (shp[1],) and b.dtype == torch.float32, i
    # no copy but the merged pairs: the 3x3 weights are the tensors given
    assert kw[4].data_ptr() == weights[4].data_ptr()


def test_kernel_weights_turned_back_give_the_same_block(weights):
    back = _back(t_c3.kernel_weights(weights), hid=6)
    assert len(back) == len(weights)
    for i, (a, b) in enumerate(zip(back, weights)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 16, 16, 24))
                         .astype(np.float32)).to(torch.bfloat16)
    want = t_c3.fused_c3k2_plain(x, weights)
    got = t_c3.fused_c3k2_plain(x, back)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bn,k3,want", [
    # the 1x1 convs' block is K2's GEMM's (two 64-column blocks to an SM)
    (64, False, 1024 + 3 * (128 + 64) * 128 + 128 * 128 + 512 + 128),
    (128, False, 1024 + 6 * (128 + 128) * 128 + 128 * 256 + 1024 + 128),
    (192, False, 1024 + 4 * (128 + 192) * 128 + 128 * 384 + 1536 + 128),
    # W of hid <= 128 (two 64-channel slabs x 9 taps) resident at bn = 64
    (64, True, 1024 + 2 * 26624 + 19 * 64 * 128 + 128 * 128 + 512 + 512),
    (192, True, 1024 + 2 * 26624 + 5 * 192 * 128 + 128 * 384 + 1536 + 512),
])
def test_fused_c3k2_smem_bytes(bn, k3, want):
    assert t_c3.fused_c3k2_smem_bytes(bn, k3) == want
    assert t_c3.fused_c3k2_smem_bytes(bn, k3) <= 232448  # what a block can opt into
    assert bn in t_c3.COLUMN_TILES
