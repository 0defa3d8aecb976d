"""Space-to-depth rewrites of strided convolutions (counterpart of
``kuzu/ops/s2d.py``): a math option, off by default.

A k3 / s2 convolution computes y[i, j] = sum over di, dj in {-1, 0, 1} of
w[di, dj] x[2i + di, 2j + dj]. Packing 2 x 2 pixel blocks into channels,
X[(u, v, c), p, q] = x[c, 2p + u, 2q + v], turns it into a dense k2 / s1
convolution over X, padded by one row and one column at the top and the
left: the same products, summed in another order. The JAX package took it
for the TPU's matrix units; the port keeps it because the JAX package
exposes it.

The port's activations are NCHW and its kernels OIHW, but the packed
channel order is JAX's ``(u, v, c)`` whatever the layout, so packed tensors
compare with JAX's after a transpose alone. The tap mapping (JAX's, in
OIHW): W2[o, (u, v, c), P, Q] = w[o, c, 2P + u - 1, 2Q + v - 1] where the
index is in range, else zero (P, Q, u, v in {0, 1}).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kuzu_torch.ops.conv import conv2d


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, block^2 C, H / block, W / block), channel order
    (u, v, c) with u the row and v the column inside a block; the result
    in ``channels_last``."""
    b, c, h, w = x.shape
    n = block
    x = x.reshape(b, c, h // n, n, w // n, n).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, n * n * c, h // n, w // n).contiguous(memory_format=torch.channels_last)


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """A (cout, cin, 3, 3) kernel as the (cout, 4 cin, 2, 2) kernel of the
    dense convolution over :func:`space_to_depth`'s packing. A gather on the
    weight (differentiable: the gradient reaches the 3 x 3 layout)."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d_kernel takes a 3 x 3 kernel, got {tuple(w.shape)}")
    wp = F.pad(w, (1, 0, 1, 0))  # tap -2 lands on the zero row / column
    # wp[o, c, 2P + u, 2Q + v] -> (o, u, v, c, P, Q)
    wp = wp.reshape(cout, cin, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
    return wp.reshape(cout, 4 * cin, 2, 2)


def dense_k2(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The dense k2 / s1 convolution of a packed tensor, padded by one at
    the top and the left (``[(1, 0), (1, 0)]``; torch's ``conv2d`` pads both
    sides alike, so the pad is explicit)."""
    return conv2d(F.pad(x, (1, 0, 1, 0)), w2)


def s2d_strided_conv(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """A k3 / s2 / p1 convolution of x (even H and W) with the OIHW kernel
    ``w`` (``(cout, cin / groups, 3, 3)``) as a dense k2 convolution over
    the packing; a grouped convolution runs as one dense convolution a
    group, then a concatenation (JAX's ``_S2dStridedConv``). x and ``w``
    in one dtype."""
    cin, cout = x.shape[1], w.shape[0]
    cin_g, cout_g = cin // groups, cout // groups
    outs = [dense_k2(space_to_depth(x[:, j * cin_g:(j + 1) * cin_g]),
                     s2d_kernel(w[j * cout_g:(j + 1) * cout_g]))
            for j in range(groups)]
    return outs[0] if groups == 1 else torch.cat(outs, dim=1)
