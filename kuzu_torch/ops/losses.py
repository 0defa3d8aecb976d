"""optax's elementwise losses on tensors, in its arithmetic (the port may
not import optax): the sigmoid binary cross-entropy and the softmax
cross-entropy with integer labels."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: ``-y log s(x) - (1 - y)
    log s(-x)``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``: (..., C), (...)
    -> (...), ``logsumexp(x) - x[label]`` over the max-shifted logits."""
    shifted = logits - logits.detach().amax(dim=-1, keepdim=True)
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(shifted, dim=-1) - picked
