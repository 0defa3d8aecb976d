"""Character-level masked language model, RoBERTa-style (counterpart of
``kuzu/models/lm.py``): ``CharMLM``, a transformer encoder over char tokens
with learned positions and an MLM head, in ``dtype`` with flax's meaning
(``models/layers.py``: f32 parameters, the MLM head's last projection in
f32), every f32 product with TF32 off; and ``apply_mlm_masking``, the
BERT-style dynamic masking of the LM trainer's step.

:meth:`CharMLM.features` and :meth:`CharMLM.head` split the forward so
that a caller that needs one position's logits (the cascade's
pseudo-log-likelihood) runs the MLM head on that position only: the same
arithmetic for the rows it computes.
"""

from __future__ import annotations

import torch
from torch import nn

from kuzu_torch.models.layers import (
    Dense,
    Embed,
    Mlp,
    MultiHeadAttention,
    f32_products,
    layer_norm,
)


class _MaskedEncoderBlock(nn.Module):
    """Pre-norm encoder block whose self-attention takes a padding mask."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = layer_norm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dropout=dropout, dtype=dtype)
        self.norm2 = layer_norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask=mask, train=train, rng=rng)
        return x + self.mlp(self.norm2(x), train, rng)


class CharMLM(nn.Module):
    def __init__(self, vocab_size: int, max_len: int = 256, dim: int = 256, depth: int = 6,
                 num_heads: int = 8, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.max_len = depth, max_len
        self.embed = Embed(vocab_size, dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(depth):
            self.add_module(f"block{i}", _MaskedEncoderBlock(dim, num_heads, mlp_ratio, dropout,
                                                             dtype))
        self.norm = layer_norm(dim, dtype)
        self.head_transform = Dense(dim, dim, dtype)
        self.head_norm = layer_norm(dim, dtype)
        self.lm_head = Dense(dim, vocab_size)  # f32, as the reference's

    def features(self, tokens: torch.Tensor, attention_mask: torch.Tensor | None = None,
                 train: bool = False, rng: torch.Generator | None = None) -> torch.Tensor:
        """(B, T) tokens, (B, T) attention mask (1 = real) -> the encoder's
        normalised output (B, T, dim); padded keys masked out; dropout with
        ``train``, drawing from ``rng``."""
        with f32_products():
            x = self.embed(tokens)
            x = x + self.pos_embed[None, : tokens.shape[1]].to(x.dtype)
            mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
            for i in range(self.depth):
                x = getattr(self, f"block{i}")(x, mask, train, rng)
            return self.norm(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The MLM head over features (..., dim) -> logits (..., V), f32."""
        with f32_products():
            x = nn.functional.gelu(self.head_transform(x), approximate="tanh")
            return self.lm_head(self.head_norm(x))

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor | None = None,
                train: bool = False, rng: torch.Generator | None = None) -> torch.Tensor:
        """Logits (B, T, V)."""
        return self.head(self.features(tokens, attention_mask, train, rng))


def mlm_draws(shape, generator: torch.Generator, vocab_size: int, special_until: int = 5,
              device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three draws of :func:`apply_mlm_masking`, in the reference's
    order (select, kind, random token): two uniforms in [0, 1) of ``shape``
    and a random token in [special_until, vocab_size)."""
    select = torch.rand(shape, generator=generator, device=device)
    kind = torch.rand(shape, generator=generator, device=device)
    rand_tok = torch.randint(special_until, vocab_size, shape, generator=generator,
                             device=device)
    return select, kind, rand_tok


def mask_from_draws(tokens: torch.Tensor, select: torch.Tensor, kind: torch.Tensor,
                    rand_tok: torch.Tensor, mask_id: int, special_until: int = 5,
                    mlm_prob: float = 0.15) -> tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of ``kuzu/models/lm.py::apply_mlm_masking`` on given
    draws: positions with ``select < mlm_prob`` among ids >= ``special_until``
    are selected; of those, ``kind < 0.8`` become ``mask_id``, ``kind >= 0.9``
    the random token, the rest stay. Returns ``(masked, labels)``, labels the
    original id at selected positions and -100 elsewhere."""
    sel = (select < mlm_prob) & (tokens >= special_until)
    masked = torch.where(sel & (kind < 0.8), torch.full_like(tokens, mask_id),
                         torch.where(sel & (kind >= 0.9), rand_tok.to(tokens.dtype), tokens))
    return masked, torch.where(sel, tokens, torch.full_like(tokens, -100))


def apply_mlm_masking(tokens: torch.Tensor, generator: torch.Generator, mask_id: int,
                      vocab_size: int, special_until: int = 5, mlm_prob: float = 0.15,
                      pad_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """BERT-style dynamic masking (the reference collator's 15%, 80% [MASK],
    10% a random char, 10% unchanged; specials and padding never masked),
    drawn from ``generator``: :func:`mlm_draws` then
    :func:`mask_from_draws`. Returns ``(masked_tokens, labels)``."""
    draws = mlm_draws(tokens.shape, generator, vocab_size, special_until, tokens.device)
    return mask_from_draws(tokens, *draws, mask_id=mask_id, special_until=special_until,
                           mlm_prob=mlm_prob)
