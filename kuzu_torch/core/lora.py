"""LoRA: low-rank adapter fine-tuning for every trainer (counterpart of
``kuzu/core/lora.py``).

The adapters are a tree ``{path: {"a": (d_in, r), "b": (r, d_out)}}`` keyed
by the flax parameter paths ('.'-joined, no collection), as JAX's: the
``lora_targets`` regex (default ``(^|\\.)kernel$``, every 2-D Dense kernel)
runs over the flax name of each port parameter, taken from the bridge's
mapping (``kuzu_torch.bridge.param_slots``). So a Dense kernel ``(d_in,
d_out)`` is an ``nn.Linear.weight`` ``(d_out, d_in)`` and its adapter merges
transposed; each of a flax LSTM cell's eight gate kernels is a row block of
``nn.LSTM``'s stacked ``weight_ih`` / ``weight_hh`` and its adapter merges
into its own gate's rows; embeddings and 4-D conv kernels stay out, as in
JAX. The merged weight is ``W + (alpha / r) a @ b`` in f32.

Training (``BaseTrainer`` with ``lora_rank``) wraps the task's model in a
:class:`LoRAModel`: the base's parameters are frozen (``requires_grad``
off: JAX's ``stop_gradient``), the loss runs on the base with the merged
weights swapped in (``torch.func.functional_call``), so the adapters alone
have gradients, and the optimizer steps them alone (optax's
``multi_transform`` with ``set_to_zero`` on the base: clip and decay see the
adapters only); the EMA covers base and adapters, BatchNorm statistics
still move. A checkpoint holds base and adapters (each adapter's slot in
its extra state), and :func:`maybe_merge` fuses them at load time.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from kuzu_torch.bridge import Slot, param_slots

DEFAULT_TARGETS = r"(^|\.)kernel$"
BASE, LORA = "base.", "lora."


def lora_slots(model: nn.Module, targets: str | None = None) -> dict[str, Slot]:
    """The 2-D flax parameters of ``model`` whose '.'-joined path matches
    ``targets``, in the order ``jax.tree_util`` flattens the params tree
    (sorted keys); raises where none matches, as JAX's ``init_lora``."""
    pat = re.compile(targets or DEFAULT_TARGETS)
    hits = {".".join(path): slot for path, slot in sorted(param_slots(model).items())
            if len(slot.shape) == 2 and pat.search(".".join(path))}
    if not hits:
        raise ValueError(f"lora: no parameters matched targets={targets or DEFAULT_TARGETS!r}")
    return hits


def init_lora(generator: torch.Generator, model: nn.Module, rank: int,
              targets: str | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """An adapter per matched kernel: ``a`` ~ N(0, 1 / rank) ``(d_in,
    rank)``, ``b`` = 0 ``(rank, d_out)``, so the merged model starts at the
    base weights. Drawn on the CPU from ``generator`` in the slots' order
    (JAX draws from its own key: tests hand JAX's draws over)."""
    out = {}
    for path, slot in lora_slots(model, targets).items():
        d_in, d_out = slot.shape
        a = torch.randn((d_in, rank), generator=generator) / np.float32(np.sqrt(rank))
        out[path] = {"a": a, "b": torch.zeros((rank, d_out))}
    return out


def _delta(a: torch.Tensor, b: torch.Tensor, alpha: float, slot: Slot) -> torch.Tensor:
    d = (alpha / a.shape[1]) * (a.float() @ b.float())
    return d.T if slot.transpose else d


def merged_tensor(base: torch.Tensor, parts: list[tuple[Slot, torch.Tensor, torch.Tensor]],
                  alpha: float) -> torch.Tensor:
    """``base`` with every adapter of ``parts`` (slot, a, b) added into its
    slot: the whole tensor, or its row block (an LSTM gate)."""
    out = base.float()
    whole = [p for p in parts if p[0].rows is None]
    for slot, a, b in whole:
        out = out + _delta(a, b, alpha, slot)
    rows = [p for p in parts if p[0].rows is not None]
    if rows:
        delta = torch.zeros_like(out)
        for slot, a, b in rows:
            delta[slot.rows[0]:slot.rows[1]] = _delta(a, b, alpha, slot)
        out = out + delta
    return out.to(base.dtype)


def merge_lora(base: dict[str, torch.Tensor], lora: dict[str, dict[str, torch.Tensor]],
               alpha: float, slots: dict[str, Slot]) -> dict[str, torch.Tensor]:
    """``W + (alpha / r) a @ b`` for every adapted tensor of the state dict
    ``base``; the rest passes through. Differentiable in the adapters."""
    by_param: dict[str, list] = {}
    for path, ab in lora.items():
        slot = slots[path]
        by_param.setdefault(slot.param, []).append((slot, ab["a"], ab["b"]))
    out = dict(base)
    for name, parts in by_param.items():
        out[name] = merged_tensor(base[name], parts, alpha)
    return out


class Adapter(nn.Module):
    """One kernel's adapter ``a``, ``b``; its flax path and slot travel in
    the checkpoint as the module's extra state."""

    def __init__(self, path: str, slot: Slot, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.path, self.slot = path, slot
        self.a, self.b = nn.Parameter(a.clone()), nn.Parameter(b.clone())

    def get_extra_state(self) -> dict:
        s = self.slot
        return {"path": self.path, "param": s.param, "rows": list(s.rows) if s.rows else None,
                "transpose": s.transpose, "shape": list(s.shape)}

    def set_extra_state(self, state: dict) -> None:
        self.path, self.slot = state["path"], _slot(state)


def _slot(state: dict) -> Slot:
    rows = state["rows"]
    return Slot(state["param"], tuple(rows) if rows else None, bool(state["transpose"]),
                tuple(state["shape"]))


class _Bound(nn.Module):
    """``fn(base, *args)`` as a module's forward, for functional_call."""

    def __init__(self, base: nn.Module, fn: Callable):
        super().__init__()
        self.base, self.fn = base, fn

    def forward(self, *args):
        return self.fn(self.base, *args)


class LoRAModel(nn.Module):
    """The trainable tree (JAX's ``combine``): the frozen ``base`` model and
    its ``lora`` adapters, one module (parameters ``base.*`` and
    ``lora.<path with '/'>.a|b``)."""

    def __init__(self, base: nn.Module, adapters: dict[str, dict[str, torch.Tensor]],
                 alpha: float, slots: dict[str, Slot]):
        super().__init__()
        self.base = base.requires_grad_(False)
        dev = next(base.parameters()).device
        self.lora = nn.ModuleDict({
            path.replace(".", "/"): Adapter(path, slots[path], ab["a"].to(dev), ab["b"].to(dev))
            for path, ab in adapters.items()})
        self.alpha = float(alpha)

    def adapters(self) -> dict[str, dict[str, torch.Tensor]]:
        return {m.path: {"a": m.a, "b": m.b} for m in self.lora.values()}

    def merged_parameters(self) -> dict[str, torch.Tensor]:
        """The adapted base parameters, merged (gradients to the adapters)."""
        slots = {m.path: m.slot for m in self.lora.values()}
        names = {s.param for s in slots.values()}
        base = {n: p for n, p in self.base.named_parameters() if n in names}
        return merge_lora(base, self.adapters(), self.alpha, slots)

    def call(self, fn: Callable, *args):
        """``fn(base, *args)`` with the merged weights in the base's place
        for the call (every method ``fn`` reaches sees them; buffers, the
        BatchNorm statistics, are the base's own and move in place)."""
        merged = {f"base.{n}": t for n, t in self.merged_parameters().items()}
        return torch.func.functional_call(_Bound(self.base, fn), merged, args)

    def merge_state_dict(self, sd: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A state dict of this module -> the base's, adapters fused."""
        return merge_state_dict(sd, self.alpha)


def lora_loss(loss_fn: Callable) -> Callable:
    """A trainer's ``loss_fn(model, batch, rng)`` as the loss of a
    :class:`LoRAModel`: run on its base with the merged weights."""

    def fn(model: LoRAModel, batch: dict, rng: torch.Generator | None = None):
        return model.call(loss_fn, batch, rng)

    return fn


def combine(base: nn.Module, lora: dict[str, dict[str, torch.Tensor]], alpha: float,
            slots: dict[str, Slot]) -> LoRAModel:
    """The trainable tree: frozen base + adapters, one module."""
    return LoRAModel(base, lora, alpha, slots)


def is_lora_state(sd: dict[str, Any]) -> bool:
    """True for the state dict of a :class:`LoRAModel`."""
    return any(k.startswith(LORA) for k in sd) and any(k.startswith(BASE) for k in sd)


def lora_rank(sd: dict[str, Any]) -> int:
    return next(v.shape[1] for k, v in sd.items() if k.startswith(LORA) and k.endswith(".a"))


def merge_state_dict(sd: dict[str, Any], alpha: float) -> dict[str, torch.Tensor]:
    """A :class:`LoRAModel` state dict -> the base's plain state dict with
    every adapter (slot from its extra state) fused."""
    base = {k[len(BASE):]: v for k, v in sd.items() if k.startswith(BASE)}
    lora, slots = {}, {}
    for k, v in sd.items():
        if k.startswith(LORA) and k.endswith("._extra_state"):
            key = k[:-len("_extra_state")]
            lora[v["path"]] = {"a": sd[key + "a"], "b": sd[key + "b"]}
            slots[v["path"]] = _slot(v)
    with torch.no_grad():
        return merge_lora(base, lora, alpha, slots)


def resolve_alpha(cfg: Any, rank: int) -> float:
    a = cfg.get("lora_alpha") if hasattr(cfg, "get") else None
    return float(a) if a not in (None, "", 0, "None") else 2.0 * rank


def maybe_merge(sd: dict[str, Any], cfg: Any = None) -> dict[str, torch.Tensor]:
    """Fuse adapters if ``sd`` is a LoRA state dict, else pass it through:
    a LoRA run's checkpoint loads as a plain model, indistinguishable from
    full fine-tuning; ``alpha`` from the run's config (``lora_alpha``,
    default 2 rank)."""
    if not is_lora_state(sd):
        return sd
    rank = lora_rank(sd)
    return merge_state_dict(sd, resolve_alpha(cfg, rank) if cfg is not None else 2.0 * rank)


def label_tree(model: nn.Module) -> dict[str, str]:
    """'freeze' / 'train' per parameter of a :class:`LoRAModel`: the
    optimizer holds moments for the 'train' ones (the adapters) only."""
    return {n: "train" if p.requires_grad else "freeze" for n, p in model.named_parameters()}


def trainable_count(model: nn.Module) -> tuple[int, int]:
    """(trainable, total) parameter counts."""
    ps = list(model.parameters())
    return sum(p.numel() for p in ps if p.requires_grad), sum(p.numel() for p in ps)
