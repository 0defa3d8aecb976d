"""Tensor ops and the hand-written CUDA kernels behind them."""

from kuzu_torch.ops.flash_attention import flash_attention, flash_attention_auto  # noqa: F401
from kuzu_torch.ops.letterbox import (  # noqa: F401
    KUZUSHIJI_MEAN,
    KUZUSHIJI_STD,
    letterbox,
    normalize_image,
    resize_keep_aspect,
)
from kuzu_torch.ops.nms import nms_padded, nms_padded_batch, non_max_suppression  # noqa: F401
