"""CTC loss and greedy decoding (counterpart of ``kuzu/ops/ctc.py``). Blank
is 0, as in the reference's vocabulary (``<pad>`` doubles as the CTC
blank).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank: int = 0,
             reduction: str = "mean") -> torch.Tensor:
    """Batched CTC negative log-likelihood of raw ``logits`` (B, T, C),
    log-softmax inside, labels (B, L) 0-padded, as ``kuzu/ops/ctc.py::
    ctc_loss`` (its forward recursion is a ``lax.scan``; here
    ``F.ctc_loss``, in f32). ``reduction="none"`` gives the per-sample
    loss, ``"sum"`` their sum, ``"mean"`` each divided by its label length
    (at least 1), then the batch mean.

    A label with no alignment in its T frames (length plus adjacent repeats
    over T) has an infinite loss here (the reference's recursion gives
    ~1e30): it comes back as 0 with a zero gradient (``zero_infinity``), so
    callers mask such rows by the feasibility test, as the recognize
    trainer does."""
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, C)
    losses = F.ctc_loss(logp, labels.long(), logit_lengths.long(), label_lengths.long(),
                        blank=blank, reduction="none", zero_infinity=True)
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    return (losses / label_lengths.to(losses.dtype).clamp(min=1)).mean()


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
