"""Helpers for the parity tests of the PyTorch port against the JAX package.

A JAX model is initialised on the CPU from a fixed key and its flax
variables are loaded into the port through ``kuzu_torch.bridge``, so both
sides run the same weights. Inputs are made with numpy and handed to both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kuzu_torch.testing import MAP_CLOSE_SHARE, MAP_MAX_REL, maps_agreement


def numpy_tree(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def flax_variables(graph) -> dict:
    """The inverse of ``kuzu_torch.bridge.from_flax``: a port module's
    weights as a flax ``{params, batch_stats}`` tree of numpy arrays, so a
    JAX model can run the port's seeded weights without a JAX init."""
    from kuzu_torch.bridge import _targets

    tree: dict = {}
    for path, tensor, is_kernel in _targets(graph):
        arr = tensor.detach().float().cpu().numpy()
        if is_kernel:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def jax_and_port_detector(name: str, nc: int = 3, imgsz: int = 128, seed: int = 0):
    """(JAX YoloDetector, its variables, port YoloDetector on the CPU with the
    same weights)."""
    from kuzu.models.yolo.detector import YoloDetector as JaxDetector

    from kuzu_torch.models.yolo.detector import YoloDetector

    jdet = JaxDetector(name, nc=nc, dtype=jnp.bfloat16, imgsz=imgsz)
    variables = jdet.init(jax.random.key(seed), imgsz=imgsz)
    tdet = YoloDetector(name, nc=nc, imgsz=imgsz, device="cpu")
    tdet.load_flax(numpy_tree(variables))
    return jdet, variables, tdet


def assert_maps_close(ref, out) -> None:
    """The raw-map criteria of ``tests/test_yolo_infer.py:35-40``, as
    ``kuzu_torch.testing.maps_match`` states them."""
    rel, share = maps_agreement(ref, out)
    assert rel < MAP_MAX_REL, rel
    assert share > MAP_CLOSE_SHARE, share
