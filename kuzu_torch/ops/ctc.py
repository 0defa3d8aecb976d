"""CTC loss and greedy decoding (counterpart of ``kuzu/ops/ctc.py``). Blank
is 0, as in the reference's vocabulary (``<pad>`` doubles as the CTC
blank).

``ctc_loss`` runs ``F.ctc_loss``; ``ctc_loss_recursion`` is the reference's
own log-semiring recursion (``NEG_INF`` = -1e30 for log 0), for the rows
``F.ctc_loss`` cannot give the reference's answer on: a label with no
alignment in its frames, where the recursion's loss is exactly 1e30 and its
gradient is not zero (``jnp.logaddexp``'s gradient ``exp(x - out)`` is 1 to
both of two equal inputs once ``out`` rounds to them, so every path that
never left -1e30 carries gradient).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the reference recursion's log 0
FIRST_CHAR_ID = 5  # token ids below are the tokenizer's specials: CTC labels are the rest


def pack_labels(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tokens (B, L) -> (CTC labels (B, L): the characters (ids >= 5)
    left-packed by a stable sort, 0-padded; their lengths (B,))."""
    text = tokens >= FIRST_CHAR_ID
    labels = torch.where(text, tokens, torch.zeros_like(tokens))
    order = torch.argsort((~text).to(torch.int8), dim=1, stable=True)
    return torch.take_along_dim(labels, order, dim=1), text.sum(1)


def label_repeats(labels: torch.Tensor) -> torch.Tensor:
    """Adjacent repeats in left-packed, 0-padded labels (B, L): each needs
    one frame more (a blank between the two)."""
    return ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] != 0)).sum(1)


def ctc_alignable(labels: torch.Tensor, label_lengths: torch.Tensor,
                  logit_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the label has an alignment in its frames (length plus
    adjacent repeats within them)."""
    return label_lengths + label_repeats(labels) <= logit_lengths


def _log_probs(logits: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the classes in at least f32."""
    return torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, logit_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank: int = 0,
             reduction: str = "mean") -> torch.Tensor:
    """Batched CTC negative log-likelihood of raw ``logits`` (B, T, C),
    log-softmax inside, labels (B, L) 0-padded, as ``kuzu/ops/ctc.py::
    ctc_loss`` (its forward recursion is a ``lax.scan``; here
    ``F.ctc_loss``, in at least f32). ``reduction="none"`` gives the per-sample
    loss, ``"sum"`` their sum, ``"mean"`` each divided by its label length
    (at least 1), then the batch mean.

    A label with no alignment in its T frames (length plus adjacent repeats
    over T) has an infinite loss here (the reference's recursion gives
    ~1e30): it comes back as 0 with a zero gradient (``zero_infinity``), so
    callers mask such rows by the feasibility test, as the recognize
    trainer does."""
    logp = _log_probs(logits).transpose(0, 1)  # (T, B, C)
    losses = F.ctc_loss(logp, labels.long(), logit_lengths.long(), label_lengths.long(),
                        blank=blank, reduction="none", zero_infinity=True)
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    return (losses / label_lengths.to(losses.dtype).clamp(min=1)).mean()


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp``: the gradient to each input is ``exp(x - out)``
    (its custom JVP), not torch's ``1 / (1 + exp(other - x))``; they part
    where ``out`` rounds to both inputs."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss_recursion(logits: torch.Tensor, labels: torch.Tensor,
                       logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
                       blank: int = 0) -> torch.Tensor:
    """Per-sample CTC loss (B,) by ``kuzu/ops/ctc.py::_ctc_loss_single``'s
    forward recursion over the extended labels (S = 2 L + 1), op for op: a
    Python loop over the T frames, so it serves only batches that hold a row
    ``F.ctc_loss`` cannot (no alignment)."""
    lae = _LogAddExp.apply
    logp = _log_probs(logits)
    b, t, _ = logp.shape
    s = 2 * labels.shape[1] + 1
    labels = labels.long()
    ext = torch.full((b, s), blank, dtype=torch.long, device=logits.device)
    ext[:, 1::2] = labels
    is_label = (torch.arange(s, device=logits.device) % 2) == 1
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]], dim=1)
    allow_skip = is_label & (ext != ext_m2)
    emit = logp.gather(2, ext[:, None, :].expand(b, t, s))  # (B, T, S)
    neg = torch.full((b, s), NEG_INF, dtype=logp.dtype, device=logits.device)
    alpha = torch.cat([emit[:, 0, :1], torch.where((label_lengths > 0)[:, None],
                                                   emit[:, 0, 1:2], neg[:, :1]), neg[:, 2:]], 1)
    for i in range(1, t):
        shift1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        shift2 = torch.where(allow_skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), neg)
        new = lae(lae(alpha, shift1), shift2) + emit[:, i]
        alpha = torch.where((i < logit_lengths)[:, None], new, alpha)
    ext_len = 2 * label_lengths.long() + 1
    last = alpha.gather(1, (ext_len - 1).clamp(0, s - 1)[:, None])[:, 0]
    second = alpha.gather(1, (ext_len - 2).clamp(0, s - 1)[:, None])[:, 0]
    second = torch.where(ext_len >= 2, second, neg[:, 0])
    return -lae(last, second)


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
