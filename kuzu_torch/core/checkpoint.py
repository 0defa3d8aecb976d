"""Checkpoint / resume with best/last tracking (counterpart of
``kuzu/core/checkpoint.py``, written with ``torch.save`` instead of orbax).

A checkpoint is ``<dir>/<name>/state.pt`` holding the train state's
``state_dict()`` (step, model with its BatchNorm statistics, EMA, optimizer)
beside ``kuzu_meta.json`` (epoch, fitness); ``last`` is written every epoch
and copied to ``best`` when its fitness is the highest so far.
``load_inference_params`` restores a model's weights for prediction;
``partial_load`` grafts the name- and shape-matching tensors of one state
dict onto another (``pretrained=``, the LM -> decoder graft). A LoRA run's
checkpoint holds the frozen base and the adapters (``base.*``, ``lora.*``);
``load_inference_params`` fuses them by the run's ``lora_rank`` /
``lora_alpha``, so predictors, validators and the cascade see a plain model,
while ``restore`` into the train state (``resume``) keeps both.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import torch


class CheckpointManager:
    """``save(state, fitness, metadata)`` into ``last`` (and ``best``);
    ``restore``, ``exists``, ``metadata`` by name."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best_fitness = -float("inf")
        self._meta_path = self.dir / "meta.json"
        if self._meta_path.exists():
            meta = json.loads(self._meta_path.read_text())
            self.best_fitness = meta.get("best_fitness", -float("inf"))

    def save(self, state: Any, fitness: float | None = None, metadata: dict | None = None,
             name: str = "last") -> None:
        """Write ``state.state_dict()`` to ``<dir>/<name>``; update ``best``."""
        target = self.dir / name
        tmp = self.dir / f".tmp_{name}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / "state.pt")
        meta = dict(metadata or {})
        if fitness is not None:
            meta["fitness"] = float(fitness)
        (tmp / "kuzu_meta.json").write_text(json.dumps(meta))
        if target.exists():
            shutil.rmtree(target)
        tmp.rename(target)
        if fitness is not None and fitness >= self.best_fitness:
            self.best_fitness = float(fitness)
            best = self.dir / "best"
            if best.exists():
                shutil.rmtree(best)
            shutil.copytree(target, best)
        self._meta_path.write_text(json.dumps({"best_fitness": self.best_fitness}))

    def restore(self, name: str = "last", like: Any | None = None) -> Any:
        """The saved state dict; with ``like`` (a train state) loaded into it
        in place and ``like`` returned."""
        sd = torch.load(self.dir / name / "state.pt", map_location="cpu", weights_only=True)
        if like is None:
            return sd
        like.load_state_dict(sd)
        return like

    def metadata(self, name: str = "last") -> dict:
        p = self.dir / name / "kuzu_meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def exists(self, name: str = "last") -> bool:
        return (self.dir / name / "state.pt").exists()


def load_inference_params(
    mgr: CheckpointManager, name: str | None = None, train_cfg: Any = None
) -> dict[str, torch.Tensor]:
    """The model's state dict for inference, EMA-preferred: ``best`` when it
    exists, else ``last`` (or ``name``); the EMA's parameters over the live
    ones, with the live buffers (BatchNorm statistics) beside them, as the
    trainer's ``TrainState.ema_state_dict`` builds it. A LoRA run's adapters
    are fused into the base with ``train_cfg``'s ``lora_alpha`` (the run's
    ``args.yaml``; default 2 rank)."""
    from kuzu_torch.core.lora import maybe_merge

    if name is None:
        name = "best" if mgr.exists("best") else "last"
    sd = mgr.restore(name)
    out = dict(sd["model"])
    if sd.get("ema") is not None:
        out.update(sd["ema"])
    return maybe_merge(out, train_cfg)


def partial_load(target: dict[str, torch.Tensor], source: dict[str, torch.Tensor],
                 verbose: bool = False) -> tuple[dict[str, torch.Tensor], int, int]:
    """Graft the tensors of ``source`` whose name and shape match onto
    ``target`` (state dicts), as ``kuzu/core/checkpoint.py::partial_load``
    grafts a flax tree by path; each grafted tensor is cast to the target's
    dtype and device. Returns ``(state dict, n_loaded, n_total)``, n_total
    the number of tensors in ``target``."""
    out, loaded = {}, 0
    for name, leaf in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(leaf.shape):
            out[name] = src.detach().to(dtype=leaf.dtype, device=leaf.device)
            loaded += 1
        else:
            out[name] = leaf
    if verbose:
        print(f"partial_load: transferred {loaded}/{len(target)} tensors")
    return out, loaded, len(target)
