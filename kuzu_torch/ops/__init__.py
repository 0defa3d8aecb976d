"""Tensor ops and the hand-written CUDA kernels behind them."""

from kuzu_torch.ops.flash_attention import flash_attention, flash_attention_auto  # noqa: F401
