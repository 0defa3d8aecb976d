"""Weight bridge: a flax ``{params, batch_stats}`` tree into the port's modules.

The flax tree comes as nested dicts of numpy arrays. Names map one to one:

- ``params .../conv/kernel`` (HWIO, grouped ``(kh, kw, cin/g, cout)``) ->
  ``....conv.weight`` (OIHW ``(cout, cin/g, kh, kw)``); a bare Detect leaf
  ``params .../box0_2/kernel|bias`` -> ``....box0_2.weight|bias``;
- ``params .../up1/kernel`` of a flax ``ConvTranspose`` (``(kh, kw, cin,
  cout)``) -> ``....up1.weight`` of an ``nn.ConvTranspose2d`` (``(cin,
  cout, kh, kw)``) with both spatial axes flipped: flax does not flip the
  kernel (``transpose_kernel=False``), so its output pixel ``2i + t``
  takes tap ``1 - t`` of a 2 x 2 stride-2 kernel where torch's takes ``t``;
- ``params .../head/kernel|bias`` (a ``Dense``, kernel ``(in, out)``) ->
  ``....head.weight`` (``(out, in)``, transposed) ``|bias``;
- ``params .../bn/scale|bias`` -> ``....bn.weight|bias``;
  ``batch_stats .../bn/mean|var`` -> ``....bn.running_mean|running_var``;
- ``params .../gamma`` (and any other bare parameter, e.g. a decoder's
  ``pos_embed``) -> ``....gamma`` as is, or in the layout the module's
  ``flax_layouts`` names (QARepVGG's ``w3`` / ``w1``: HWIO -> OIHW); the
  buffers a module lists in ``flax_batch_stats`` (QARepVGG's hand-written
  BatchNorm statistics) <- ``batch_stats .../<name>``;
- ``params .../norm1/scale|bias`` (a ``LayerNorm`` or ``GroupNorm``) ->
  ``....norm1.weight|bias``;
- ``params .../embed/embedding`` (an ``Embed``) -> ``....embed.weight``.

The CRNN's BiLSTM (:func:`crnn_from_flax`) maps many to one: flax's two
``OptimizedLSTMCell``s (``_0`` forward, ``_1`` the reversed ``nn.RNN``)
each hold eight ``Dense`` layers, ``ii/if/ig/io`` on the input (no bias) and
``hi/hf/hg/ho`` on the hidden state; ``nn.LSTM`` stacks them by gate in the
order i, f, g, o into ``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_hh_l0``
(``..._reverse`` for the second cell), and ``bias_ih_l0`` is zero.

Every flax leaf is consumed exactly once and every port tensor is filled;
anything left over or missing raises.

:func:`param_slots` lists, for every flax ``params`` leaf, the port
parameter it lands in (a row block of a stacked LSTM weight for a gate's
kernel) and whether it lands transposed: LoRA (``kuzu_torch.core.lora``)
selects its targets by the flax paths and merges each adapter into its
slot. :func:`lora_from_flax` carries a flax adapter tree across as is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

GATES = "ifgo"  # nn.LSTM's row blocks, flax's gate suffixes


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _targets(root: nn.Module):
    """(flax path, port tensor, layout) for every tensor the port holds but
    an LSTM's; layout "conv" is an HWIO kernel, "conv_transpose" a flax
    ``ConvTranspose`` kernel, "dense" an (in, out) one, None a leaf taken
    as is."""
    for name, m in root.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, nn.LSTM):
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            yield ("params", *path, "kernel"), m.weight, (
                "conv" if isinstance(m, nn.Conv2d) else
                "conv_transpose" if isinstance(m, nn.ConvTranspose2d) else "dense")
            if m.bias is not None:
                yield ("params", *path, "bias"), m.bias, None
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            yield ("params", *path, "scale"), m.weight, None
            yield ("params", *path, "bias"), m.bias, None
        elif isinstance(m, nn.Embedding):
            yield ("params", *path, "embedding"), m.weight, None
        elif isinstance(m, nn.BatchNorm2d):
            yield ("params", *path, "scale"), m.weight, None
            yield ("params", *path, "bias"), m.bias, None
            yield ("batch_stats", *path, "mean"), m.running_mean, None
            yield ("batch_stats", *path, "var"), m.running_var, None
        layouts = getattr(m, "flax_layouts", {})  # e.g. QARepVGG's HWIO w3 / w1
        for pname, p in m.named_parameters(recurse=False):
            if pname not in ("weight", "bias"):  # e.g. A2C2f.gamma
                yield ("params", *path, pname), p, layouts.get(pname)
        for bname in getattr(m, "flax_batch_stats", ()):  # hand-written BatchNorm statistics
            yield ("batch_stats", *path, bname), getattr(m, bname), None


def _to_port(arr: np.ndarray, layout: str | None) -> np.ndarray:
    """A flax leaf in the port's layout."""
    if layout == "conv":
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if layout == "conv_transpose":  # (kh, kw, in, out), unflipped -> (in, out, kh, kw)
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if layout == "dense":
        return arr.T
    return arr


def _lstm_leaves(lstm: nn.LSTM, cells: tuple[str, str]) -> list[tuple[list, str, torch.Tensor]]:
    """([flax paths], kind, port tensor) of a one-layer bidirectional LSTM
    whose directions are the flax cells ``cells`` (forward, reverse)."""
    if lstm.num_layers != 1 or not lstm.bidirectional or not lstm.batch_first:
        raise ValueError("the bridge maps a one-layer, bidirectional, batch-first LSTM")
    out = []
    for cell, sfx in zip(cells, ("", "_reverse")):
        p = ("params", cell)
        out.append(([(*p, f"i{g}", "kernel") for g in GATES], "stack",
                    getattr(lstm, f"weight_ih_l0{sfx}")))
        out.append(([(*p, f"h{g}", "kernel") for g in GATES], "stack",
                    getattr(lstm, f"weight_hh_l0{sfx}")))
        out.append(([(*p, f"h{g}", "bias") for g in GATES], "cat",
                    getattr(lstm, f"bias_hh_l0{sfx}")))
        out.append(([], "zero", getattr(lstm, f"bias_ih_l0{sfx}")))
    return out


def _copy(tensor: torch.Tensor, arr: np.ndarray, what: str) -> None:
    if tuple(arr.shape) != tuple(tensor.shape):
        raise ValueError(f"{what}: flax {arr.shape} vs port {tuple(tensor.shape)}")
    tensor.copy_(torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32))


@dataclass(frozen=True)
class Slot:
    """Where a flax ``params`` leaf lives in the port: ``param``, the port
    parameter's name; ``rows``, the row block of it (a gate of a stacked
    LSTM weight) or None for the whole tensor; ``transpose``, whether the
    flax leaf lands transposed (a Dense or LSTM kernel, ``(in, out)``);
    ``shape``, the flax leaf's shape; ``layout``, the bridge's layout of
    the leaf (``"conv"``, ``"conv_transpose"``, ``"dense"``, or None)."""
    param: str
    rows: tuple[int, int] | None
    transpose: bool
    shape: tuple[int, ...]
    layout: str | None = None


def param_slots(root: nn.Module, lstm_cells: dict | None = None) -> dict[tuple, Slot]:
    """Every flax ``params`` leaf of ``root``'s flax counterpart (path
    without the collection, as ``jax.tree_util`` walks the params tree) ->
    its :class:`Slot`. ``lstm_cells`` as in :func:`from_flax` (default:
    ``root.flax_lstm_cells``)."""
    names = {id(p): n for n, p in root.named_parameters()}
    out = {}
    for path, tensor, layout in _targets(root):
        if path[0] != "params":
            continue
        shape = tuple(tensor.shape)
        if layout == "conv":
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif layout == "conv_transpose":
            shape = (shape[2], shape[3], shape[0], shape[1])
        elif layout == "dense":
            shape = shape[::-1]
        out[path[1:]] = Slot(names[id(tensor)], None, layout == "dense", shape, layout)
    cells = lstm_cells if lstm_cells is not None else getattr(root, "flax_lstm_cells", None)
    for name, pair in (cells or {}).items():
        lstm = root.get_submodule(name)
        h = lstm.hidden_size
        for paths, kind, tensor in _lstm_leaves(lstm, pair):
            if kind == "zero":
                continue
            for g, path in enumerate(paths):
                rows = (g * h, (g + 1) * h)
                if kind == "stack":
                    out[path[1:]] = Slot(names[id(tensor)], rows, True,
                                         (tensor.shape[1], h))
                else:
                    out[path[1:]] = Slot(names[id(tensor)], rows, False, (h,))
    return out


def lora_from_flax(adapters: dict) -> dict[str, dict[str, torch.Tensor]]:
    """A flax adapter tree (``kuzu/core/lora.py::init_lora``: ``{path:
    {"a": (d_in, r), "b": (r, d_out)}}``, numpy leaves) as the port's
    adapters, the same layout and paths, f32."""
    return {path: {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in ab.items()}
            for path, ab in adapters.items()}


@torch.no_grad()
def from_flax(root: nn.Module, variables: dict, lstm_cells: dict | None = None) -> nn.Module:
    """Fill ``root`` in place from a flax variables tree and return it:
    conv kernels HWIO -> OIHW, Dense kernels transposed into ``nn.Linear``,
    ``Embed`` tables, LayerNorm scale/bias, BatchNorm statistics, free
    parameters (a ``pos_embed``) as they are; every leaf on both sides used
    once. ``lstm_cells`` names, per port LSTM module, the flax cells of its
    two directions (default: ``root.flax_lstm_cells``, as the CRNN has)."""
    if lstm_cells is None:
        lstm_cells = getattr(root, "flax_lstm_cells", None)
    leaves = _flatten({k: variables[k] for k in ("params", "batch_stats") if k in variables})
    used: set[tuple] = set()
    missing = []

    def take(path: tuple) -> np.ndarray | None:
        if path not in leaves:
            missing.append("/".join(path))
            return None
        if path in used:
            raise ValueError(f"flax leaf {'/'.join(path)} consumed twice")
        used.add(path)
        return leaves[path]

    for path, tensor, layout in _targets(root):
        arr = take(path)
        if arr is not None:
            _copy(tensor, _to_port(arr, layout), "/".join(path))
    for name, cells in (lstm_cells or {}).items():
        for paths, kind, tensor in _lstm_leaves(root.get_submodule(name), cells):
            if kind == "zero":
                tensor.zero_()
                continue
            arrs = [take(p) for p in paths]
            if any(a is None for a in arrs):
                continue
            arr = (np.concatenate([a.T for a in arrs], 0) if kind == "stack"
                   else np.concatenate(arrs, 0))
            _copy(tensor, arr, f"{name} <- {'/'.join(paths[0][:2])}")
    left = sorted("/".join(p) for p in leaves.keys() - used)
    if missing or left:
        raise ValueError(f"flax/port mismatch: missing in flax {missing[:10]}, "
                         f"unused flax leaves {left[:10]}")
    return root


def crnn_from_flax(model: nn.Module, variables: dict) -> nn.Module:
    """Fill a ``kuzu_torch.models.crnn.CRNN`` (with or without its box
    head) from the JAX CRNN's variables (numpy leaves) and return it. Its
    BiLSTM's cells are flax's ``OptimizedLSTMCell_0`` (forward) and
    ``OptimizedLSTMCell_1`` (reverse): the cells are built in
    ``CRNN.__call__``'s scope, so they carry the parent's automatic names,
    not ``lstm_fwd`` / ``lstm_bwd`` (``CRNN.flax_lstm_cells``)."""
    return from_flax(model, variables)
