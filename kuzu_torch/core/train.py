"""Training engine: the train step, the optimizer chain, the EMA of the
parameters (counterpart of ``kuzu/core/train.py``).

The JAX package folds the whole step into one jitted function over pytrees;
here the model is an ``nn.Module`` whose BatchNorm statistics move in place
during its training forward, and the step is eager. What stays the same:

- the optimizer is optax's chain, written out: global-norm clipping at
  ``grad_clip`` first, then weight decay added to the gradient of the params
  with ``ndim >= 2`` only (two parameter groups), then SGD with Nesterov
  momentum (``torch.optim.SGD(nesterov=True, dampening=0)`` keeps optax's
  trace) or Adam (``adam`` / ``adamw``, the recognize, LM and CTC trainers'
  auto optimizer: ``optax.adam(b1=momentum, b2=0.999, eps=1e-8)`` after the
  decay, which ``torch.optim.Adam``'s L2 ``weight_decay`` is) or RAdam
  (``radam`` and ``radam_schedulefree``, which JAX builds alike:
  ``optax.radam(b1=momentum)``, :class:`RAdam`); only parameters with
  ``requires_grad`` are stepped (LoRA's frozen base is not);
- the learning rate of update ``n`` is the schedule at ``n`` *before* it is
  counted, as optax evaluates it, so with warmup the first update has lr 0;
- the EMA averages the parameters only, not the BatchNorm statistics, with
  decay ``ema_decay * (1 - exp(-step / ema_tau))`` at the new step;
- ``accumulate`` runs micro-batches in order (each one's BatchNorm update
  lands), sums their gradients and scales the sum, the loss and the metrics
  by ``1 / accumulate``; the metrics hold ``loss`` and ``grad_norm``, the
  norm of the unclipped gradients;
- the backward runs with TF32 off (``f32_products``), as the f32 models'
  forwards do: cuDNN's TF32 default would keep about three digits of an f32
  convolution's gradients.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from kuzu_torch.models.layers import f32_products


class TrainState:
    """The step count, the model (parameters and BatchNorm statistics), the
    optimizer and the EMA of the parameters (``None`` when EMA is off)."""

    def __init__(self, model: nn.Module, optimizer: "Optimizer", use_ema: bool = True):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema = (
            {n: p.detach().clone() for n, p in model.named_parameters()} if use_ema else None
        )

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with the EMA in place of the parameters and
        the live BatchNorm statistics (what validation folds); a LoRA model's
        with its adapters fused into the base (JAX's ``_val_view``)."""
        sd = dict(self.model.state_dict())
        if self.ema is not None:
            sd.update(self.ema)
        merge = getattr(self.model, "merge_state_dict", None)
        return merge(sd) if merge is not None else sd

    def state_dict(self) -> dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(), "ema": self.ema,
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, d: dict[str, Any]) -> None:
        self.step = int(d["step"])
        self.model.load_state_dict(d["model"])
        if self.ema is not None and d.get("ema") is not None:
            for n, t in d["ema"].items():
                self.ema[n].copy_(t)
        self.optimizer.load_state_dict(d["optimizer"])


# ---------------------------------------------------------------- optimizers


def lr_schedule(cfg: Any, steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup over ``warmup_epochs``, then linear or cosine decay to
    ``lr0 * lrf`` over ``epochs``; evaluated in f32 as the JAX schedule."""
    f32 = np.float32
    total = max(int(cfg.epochs * steps_per_epoch), 1)
    warmup = int(float(cfg.get("warmup_epochs", 0.0)) * steps_per_epoch)
    lr0, lrf = f32(cfg.lr0), f32(cfg.lrf)
    cos = bool(cfg.get("cos_lr", False))

    def sched(count: int) -> float:
        step = f32(count)
        wu = np.clip(step / f32(max(warmup, 1)), f32(0), f32(1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)), f32(0), f32(1))
        if cos:
            decay = lrf + (f32(1) - lrf) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        else:
            decay = f32(1) - frac * (f32(1) - lrf)
        return float(f32(lr0 * (wu if warmup > 0 else f32(1)) * decay))

    return sched


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``):
    one foreach launch on the card; on the CPU the squares summed by
    ``torch.sum``, since torch's f32 ``vector_norm`` there sums in a
    running accumulator (8e-4 low at 2.4M entries: the CTC head's
    gradient), where XLA's reduction and ``torch.sum`` are accurate."""
    if tensors and tensors[0].device.type == "cpu":
        return torch.stack([(t * t).sum() for t in tensors]).sum().sqrt()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """The optax chain ``clip_by_global_norm -> add_decayed_weights -> sgd``
    (or ``adam``) over one module's parameters; ``step(count, grad_norm)``
    applies one update with the learning rate of ``count``."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float],
                 grad_clip: float):
        self.inner, self.schedule, self.grad_clip = inner, schedule, grad_clip

    def params(self) -> list[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int, grad_norm: torch.Tensor) -> None:
        grads = [p.grad for p in self.params() if p.grad is not None]
        if self.grad_clip > 0:
            # optax: g if norm < max else (g / norm) * max, without a host sync
            keep = grad_norm < self.grad_clip
            one = torch.ones((), dtype=grad_norm.dtype, device=grad_norm.device)
            torch._foreach_div_(grads, torch.where(keep, one, grad_norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        lr = self.schedule(count)
        for g in self.inner.param_groups:
            g["lr"] = lr
        self.inner.step()

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self.inner.load_state_dict(d)


def f32_pow(base: float, n: int) -> np.float32:
    """``base ** n`` for an integer ``n`` as XLA computes a float raised to
    an int32 (optax's ``decay ** count``): square and multiply in f32."""
    out, x = np.float32(1), np.float32(base)
    while n:
        if n & 1:
            out = np.float32(out * x)
        x, n = np.float32(x * x), n >> 1
    return out


class RAdam(torch.optim.Optimizer):
    """``optax.radam(lr, b1, b2=0.999, eps=1e-8)`` (threshold 5, no
    ``eps_root``) after optax's ``add_decayed_weights``: per group the
    decay ``weight_decay * p`` added to the gradient, then with ``t`` the
    update's count and f32 scalars as optax computes them

        mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
        ro = ro_inf - 2 t b2^t / (1 - b2^t),  ro_inf = 2 / (1 - b2) - 1,
        p -= lr mu_hat                                    if ro < 5,
        p -= lr r mu_hat / (sqrt(nu_hat) + eps)           otherwise,
        r = sqrt((ro - 4)(ro - 2) ro_inf / ((ro_inf - 4)(ro_inf - 2) ro)),

    ``mu_hat = mu / (1 - b1^t)``, ``nu_hat = nu / (1 - b2^t)``.
    ``torch.optim.RAdam`` scales eps by ``sqrt(1 - b2^t)`` and tests ``ro >
    5``, so it is not this rule."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            st = [self.state[p] for p in params]
            for s, p in zip(st, params):
                if not s:
                    s["step"] = 0
                    s["mu"], s["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            t = st[0]["step"] + 1
            for s in st:
                s["step"] = t
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            mus, nus = [s["mu"] for s in st], [s["nu"] for s in st]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, float(f32(1 - b1))))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        float(f32(1 - b2))))
            b1t, b2t = f32_pow(b1, t), f32_pow(b2, t)
            ro_inf = 2.0 / (1.0 - b2) - 1.0  # a double, cast where optax casts it
            ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
            mu_hat = torch._foreach_div(mus, float(f32(1) - b1t))
            if ro >= f32(group["threshold"]):
                r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                            / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
                den = torch._foreach_sqrt(torch._foreach_div(nus, float(f32(1) - b2t)))
                torch._foreach_add_(den, group["eps"])
                upd = torch._foreach_div(torch._foreach_mul(mu_hat, float(f32(r))), den)
            else:
                upd = mu_hat
            torch._foreach_add_(params, torch._foreach_mul(upd, -group["lr"]))


def build_optimizer(cfg: Any, model: nn.Module, steps_per_epoch: int = 100) -> Optimizer:
    """The optimizer rules of ``kuzu/core/train.py::build_optimizer``:
    ``auto``/``sgd``, ``adam``/``adamw`` and ``radam``/``radam_schedulefree``
    (each with the decay added to the gradient, as optax's chain does; the
    JAX package builds ``radam_schedulefree`` as plain RAdam, and so does
    the port), over the parameters that have ``requires_grad``."""
    name = str(cfg.get("optimizer", "auto")).lower()
    wd = float(cfg.get("weight_decay", 0.0))
    mom = float(cfg.get("momentum", 0.937))
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [
        {"params": [p for p in params if p.ndim >= 2], "weight_decay": wd},
        {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0},
    ]
    if name in ("auto", "sgd"):
        inner = torch.optim.SGD(groups, lr=0.0, momentum=mom, dampening=0.0, nesterov=True)
    elif name in ("adam", "adamw"):
        inner = torch.optim.Adam(groups, lr=0.0, betas=(mom, 0.999), eps=1e-8)
    elif name in ("radam", "radam_schedulefree"):
        inner = RAdam(groups, lr=0.0, betas=(mom, 0.999), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(inner, lr_schedule(cfg, steps_per_epoch), float(cfg.get("grad_clip", 10.0)))


# ---------------------------------------------------------------------- EMA


def ema_decay_at(step: int, decay: float, tau: float) -> float:
    """Ramped decay ``decay * (1 - exp(-step / tau))`` in f32."""
    f32 = np.float32
    return float(f32(decay) * (f32(1) - np.exp(-f32(step) / f32(tau))))


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, d: float) -> None:
    """``ema = ema * d + param * (1 - d)`` for every parameter, in place."""
    names = list(ema)
    params = dict(model.named_parameters())
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul([params[n].detach() for n in names],
                                              float(np.float32(1) - np.float32(d))))


# --------------------------------------------------------------- train step


def make_train_step(
    loss_fn: Callable[..., tuple[torch.Tensor, dict]],
    tx: Optimizer,
    ema_decay: float = 0.9999,
    ema_tau: float = 2000.0,
    accumulate: int = 1,
) -> Callable[..., dict[str, torch.Tensor]]:
    """``step(state, batch, rng=None) -> metrics``: one update of ``state``
    in place.

    ``loss_fn(model, batch) -> (loss, metrics)`` sees a (micro-)batch of
    tensors on the model's device, and with ``rng`` (a ``torch.Generator``,
    the step's randomness: the JAX step's ``rng``)
    ``loss_fn(model, batch, rng)``, the micro-batches drawing from it in
    turn; the model is in training mode, so its BatchNorm statistics move
    with every micro-batch. Metrics come back as 0-d tensors on the device
    (no host sync)."""

    def step_fn(state: TrainState, batch: dict,
                rng: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        model = state.model
        model.train()
        tx.zero_grad()
        n = next(iter(batch.values())).shape[0]
        if n % accumulate:
            raise ValueError(f"batch {n} does not divide into accumulate={accumulate}")
        m = n // accumulate
        loss_sum, metrics_sum = None, {}
        for i in range(accumulate):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()} if accumulate > 1 else batch
            loss, metrics = loss_fn(model, mb) if rng is None else loss_fn(model, mb, rng)
            with f32_products():
                loss.backward()  # gradients sum over the micro-batches
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in metrics.items():
                v = v.detach()
                metrics_sum[k] = v if k not in metrics_sum else metrics_sum[k] + v
        grads = [p.grad for p in tx.params() if p.grad is not None]
        if accumulate > 1:
            inv = 1.0 / accumulate
            torch._foreach_mul_(grads, inv)
            loss_sum = loss_sum * inv
            metrics_sum = {k: v * inv for k, v in metrics_sum.items()}
        grad_norm = global_norm(grads)
        tx.step(state.step, grad_norm)
        state.step += 1
        if state.ema is not None:
            ema_update(state.ema, model, ema_decay_at(state.step, ema_decay, ema_tau))
        return {**metrics_sum, "loss": loss_sum, "grad_norm": grad_norm}

    return step_fn
