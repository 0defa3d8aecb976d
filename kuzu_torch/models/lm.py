"""Character-level masked language model, RoBERTa-style (counterpart of
``kuzu/models/lm.py``'s ``CharMLM``): a transformer encoder over char
tokens with learned positions and an MLM head, f32, every product with TF32
off. Inference only: ``apply_mlm_masking`` and the LM trainer wait for
their slice (ROADMAP section 1 item 14).

:meth:`CharMLM.features` and :meth:`CharMLM.head` split the forward so
that a caller that needs one position's logits (the cascade's
pseudo-log-likelihood) runs the MLM head on that position only: the same
arithmetic for the rows it computes.
"""

from __future__ import annotations

import torch
from torch import nn

from kuzu_torch.models.layers import Mlp, MultiHeadAttention, f32_products, layer_norm


class _MaskedEncoderBlock(nn.Module):
    """Pre-norm encoder block whose self-attention takes a padding mask."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask=mask)
        return x + self.mlp(self.norm2(x))


class CharMLM(nn.Module):
    def __init__(self, vocab_size: int, max_len: int = 256, dim: int = 256, depth: int = 6,
                 num_heads: int = 8, mlp_ratio: float = 4.0):
        super().__init__()
        self.depth = depth
        self.embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(depth):
            self.add_module(f"block{i}", _MaskedEncoderBlock(dim, num_heads, mlp_ratio))
        self.norm = layer_norm(dim)
        self.head_transform = nn.Linear(dim, dim)
        self.head_norm = layer_norm(dim)
        self.lm_head = nn.Linear(dim, vocab_size)

    def features(self, tokens: torch.Tensor,
                 attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T) tokens, (B, T) attention mask (1 = real) -> the encoder's
        normalised output (B, T, dim); padded keys masked out."""
        with f32_products():
            x = self.embed(tokens) + self.pos_embed[None, : tokens.shape[1]]
            mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
            for i in range(self.depth):
                x = getattr(self, f"block{i}")(x, mask)
            return self.norm(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The MLM head over features (..., dim) -> logits (..., V)."""
        with f32_products():
            x = nn.functional.gelu(self.head_transform(x), approximate="tanh")
            return self.lm_head(self.head_norm(x))

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Logits (B, T, V)."""
        return self.head(self.features(tokens, attention_mask))
