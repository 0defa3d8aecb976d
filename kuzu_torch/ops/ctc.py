"""Greedy CTC decoding (counterpart of ``kuzu/ops/ctc.py``'s
``ctc_greedy_decode``). Blank is 0, as in the reference's vocabulary
(``<pad>`` doubles as the CTC blank). ``ctc_loss`` waits for the recognizer's
training slice.
"""

from __future__ import annotations

import torch


def ctc_greedy_decode(
    logits: torch.Tensor, logit_lengths: torch.Tensor | None = None, blank: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax, collapse repeats, strip blanks: (sequences (B, T) 0-padded,
    lengths (B,)). Fixed shape, with no loop over the batch: each kept label
    scatters to its rank among the kept ones, the rest to a spill column."""
    b, t, _ = logits.shape
    preds = logits.argmax(dim=-1)  # the first index among ties, as jnp.argmax
    if logit_lengths is None:
        logit_lengths = torch.full((b,), t, device=logits.device)
    t_idx = torch.arange(t, device=logits.device)
    prev = torch.cat([torch.full_like(preds[:, :1], -1), preds[:, :-1]], dim=1)
    keep = (preds != blank) & (preds != prev) & (t_idx[None, :] < logit_lengths[:, None])
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, torch.full_like(preds, t))
    out = torch.zeros((b, t + 1), dtype=preds.dtype, device=logits.device)
    out.scatter_(1, pos, torch.where(keep, preds, torch.zeros_like(preds)))
    return out[:, :t], keep.sum(dim=1)
