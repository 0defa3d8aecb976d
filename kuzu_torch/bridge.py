"""Weight bridge: a flax ``{params, batch_stats}`` tree into the port's modules.

The flax tree comes as nested dicts of numpy arrays. Names map one to one:

- ``params .../conv/kernel`` (HWIO, grouped ``(kh, kw, cin/g, cout)``) ->
  ``....conv.weight`` (OIHW ``(cout, cin/g, kh, kw)``); a bare Detect leaf
  ``params .../box0_2/kernel|bias`` -> ``....box0_2.weight|bias``;
- ``params .../bn/scale|bias`` -> ``....bn.weight|bias``;
  ``batch_stats .../bn/mean|var`` -> ``....bn.running_mean|running_var``;
- ``params .../gamma`` -> ``....gamma`` as is.

Every flax leaf is consumed exactly once and every port tensor is filled;
anything left over or missing raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _targets(root: nn.Module):
    """(flax path, port tensor, is-conv-kernel) for every tensor the port holds."""
    for name, m in root.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, nn.Conv2d):
            yield ("params", *path, "kernel"), m.weight, True
            if m.bias is not None:
                yield ("params", *path, "bias"), m.bias, False
        elif isinstance(m, nn.BatchNorm2d):
            yield ("params", *path, "scale"), m.weight, False
            yield ("params", *path, "bias"), m.bias, False
            yield ("batch_stats", *path, "mean"), m.running_mean, False
            yield ("batch_stats", *path, "var"), m.running_var, False
        for pname, p in m.named_parameters(recurse=False):
            if pname not in ("weight", "bias"):  # e.g. A2C2f.gamma
                yield ("params", *path, pname), p, False


@torch.no_grad()
def from_flax(root: nn.Module, variables: dict) -> None:
    """Fill ``root`` (a ``YoloGraph``) in place from a flax variables tree."""
    leaves = _flatten({k: variables[k] for k in ("params", "batch_stats") if k in variables})
    used: set[tuple] = set()
    missing = []
    for path, tensor, is_kernel in _targets(root):
        if path not in leaves:
            missing.append("/".join(path))
            continue
        if path in used:
            raise ValueError(f"flax leaf {'/'.join(path)} consumed twice")
        used.add(path)
        arr = leaves[path]
        if is_kernel:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: flax {arr.shape} vs port "
                             f"{tuple(tensor.shape)}")
        tensor.copy_(torch.tensor(arr, dtype=torch.float32))
    left = sorted("/".join(p) for p in leaves.keys() - used)
    if missing or left:
        raise ValueError(f"flax/port mismatch: missing in flax {missing[:10]}, "
                         f"unused flax leaves {left[:10]}")
