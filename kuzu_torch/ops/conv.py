"""The port's 2-D convolution: ``F.conv2d`` with one repair on the CPU.

torch's CPU convolution in bf16 (2.13) is wrong where a strided axis comes
out 1 wide: a 3 x 3 kernel at stride (1, 2) over a 2-wide input is off by
whole units, and at 64 input channels gives inf / NaN. A bf16 convolution
promises the product of the bf16 operands summed in f32 and rounded once,
and that is what XLA's CPU convolution (the JAX reference) returns there to
the bit. So on the CPU a bf16 convolution with such an output computes in
f32 over its bf16 operands and rounds the output once to bf16. Elsewhere it
stays torch's own bf16 kernel, which matches XLA's at least as closely
(both part from the f32-then-round result in a few ties of a 1e5 outputs,
summed in another order). The card's route (cuDNN) is never changed.

A second CPU repair: torch 2.13's CPU backward of a strided, unpadded 1 x 1
convolution over a ``channels_last`` input corrupts the heap (a YOLO-NAS
QARepVGG's 1 x 1 branch at stride 2 over 128 x 128 RGB aborts the process).
Such a convolution reads every ``stride``-th pixel, so on the CPU it runs at
stride 1 over the input sliced to those pixels: the same products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def cpu_bf16_faulty(x: torch.Tensor, w: torch.Tensor, stride, padding, dilation) -> bool:
    """Whether torch's CPU bf16 kernel would take this call's fault: a bf16
    input on the CPU whose output is 1 wide or high along a strided axis."""
    if x.device.type != "cpu" or x.dtype != torch.bfloat16:
        return False
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    for ax in (0, 1):
        size = x.shape[2 + ax] + 2 * p[ax] - d[ax] * (w.shape[2 + ax] - 1) - 1
        if s[ax] > 1 and size // s[ax] + 1 == 1:
            return True
    return False


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, stride=1,
           padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` in x's dtype; a bf16 call that :func:`cpu_bf16_faulty`
    names computes in f32 over the bf16 operands, rounded once."""
    if (x.device.type == "cpu" and tuple(w.shape[2:]) == (1, 1) and _pair(padding) == (0, 0)
            and _pair(stride) != (1, 1)):
        s = _pair(stride)
        x, stride = x[:, :, ::s[0], ::s[1]], 1
    if cpu_bf16_faulty(x, w, stride, padding, dilation):
        y = F.conv2d(x.float(), w.float(), None if bias is None else bias.float(), stride,
                     padding, dilation, groups)
        return y.to(x.dtype)
    return F.conv2d(x, w, bias, stride, padding, dilation, groups)
