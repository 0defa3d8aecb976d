"""The detector path's kernels as PyTorch operators (``kuzu_torch::``).

``torch.export`` traces with fake tensors, which have no storage, so it
cannot pass through a wrapper that hands raw pointers to a kernel. Each
kernel an exported detector runs is therefore an operator of its own:

- ``nms_keep(boxes, valid, iou)``: K1, the greedy keep-mask of
  ``nms_kernel.batched_suppress`` (``csrc/nms.cu``);
- ``fused_ablock(x, v, pe, weights, area, heads)``: K2, one whole
  area-attention block (``csrc/fused_ablock.cu``);
- ``area_attention(q, k, v, num_heads)``: K3's forward without the
  log-sum-exp, bf16 and f32 (``csrc/area_attention.cu``).

Each has a CPU implementation (the plain PyTorch version, counted in the
wrapper's ``plain_calls``), a CUDA implementation (the kernel launch,
counted in ``launches`` / ``f32_launches``) and a fake implementation that
gives the output's shape, dtype and device and allocates nothing. The
wrappers keep their gates (shapes, dtypes, the kernels' ``*_fits``) before
the operator call, reading static shapes only; a CUDA tensor a kernel
refuses raises there and never reaches the plain version. An exported graph
holds these operators as nodes, so a ``.pt2`` needs ``import kuzu_torch``
(whose ``__init__`` imports this module) before it loads.

K3 with its log-sum-exp and K4 (training), K5 and K6 (no model calls them)
are on no exportable path and are not registered.

Each operator also has a flop formula for ``torch.utils.flop_counter``: the
count of its matrix products, the same whichever implementation runs.
"""

from __future__ import annotations

import importlib

import torch
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

from kuzu_torch.ops import fused_ablock as _ab
from kuzu_torch.ops import nms_kernel as _nms

# kuzu_torch.ops exports a function named flash_attention over the module
_fa = importlib.import_module("kuzu_torch.ops.flash_attention")

NAMESPACE = "kuzu_torch"
OPERATORS = ("nms_keep", "fused_ablock", "area_attention")


# ------------------------------------------------------------------ K1
@custom_op("kuzu_torch::nms_keep", mutates_args=(), device_types="cpu")
def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou: float) -> torch.Tensor:
    _nms.batched_suppress.plain_calls += 1
    return _nms.suppress_reference(boxes, valid, iou)


@nms_keep.register_kernel("cuda")
def _(boxes, valid, iou):
    return _nms.launch(boxes, valid, iou)


@nms_keep.register_fake
def _(boxes, valid, iou):
    return valid.new_empty(valid.shape, dtype=torch.bool)


@register_flop_formula(torch.ops.kuzu_torch.nms_keep)
def _(boxes_shape, valid_shape, iou, *, out_shape=None, **kwargs) -> int:
    return 0  # comparisons only


# ------------------------------------------------------------------ K2
@custom_op("kuzu_torch::fused_ablock", mutates_args=(), device_types="cpu")
def fused_ablock(x: torch.Tensor, v: torch.Tensor, pe: torch.Tensor,
                 weights: list[torch.Tensor], area: int, heads: int) -> torch.Tensor:
    _ab.fused_ablock.plain_calls += 1
    return _ab.fused_ablock_plain(x, v, pe, weights, area, heads)


@fused_ablock.register_kernel("cuda")
def _(x, v, pe, weights, area, heads):
    return _ab.launch(x, v, pe, weights, area, heads)


@fused_ablock.register_fake
def _(x, v, pe, weights, area, heads):
    return x.new_empty(x.shape)


@register_flop_formula(torch.ops.kuzu_torch.fused_ablock)
def _(x_shape, v_shape, pe_shape, weights_shape, area, heads, *, out_shape=None,
      **kwargs) -> int:
    b, n, c = x_shape
    hidden = weights_shape[4][1]
    m = b * n
    # qk, proj, mlp1, mlp2 products, then q k^T and p v over each area's tokens
    return 2 * m * c * (2 * c + c + 2 * hidden) + 4 * m * (n // area) * c


# ------------------------------------------------------------------ K3
@custom_op("kuzu_torch::area_attention", mutates_args=(), device_types="cpu")
def area_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    _fa.area_attention.plain_calls += 1
    return _fa.area_attention_plain(q, k, v, num_heads, _fa.attention_scale(q, num_heads))


@area_attention.register_kernel("cuda")
def _(q, k, v, num_heads):
    return _fa.launch_area_attention(q, k, v, num_heads)


@area_attention.register_fake
def _(q, k, v, num_heads):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.kuzu_torch.area_attention)
def _(q_shape, k_shape, v_shape, num_heads, *, out_shape=None, **kwargs) -> int:
    g, n, c = q_shape
    return 4 * g * n * n * c  # q k^T and p v, every head


def graph_operators(graph_module: torch.fx.GraphModule) -> dict[str, int]:
    """How many nodes of each ``kuzu_torch::`` operator a graph holds."""
    counts = dict.fromkeys(OPERATORS, 0)
    for node in graph_module.graph.nodes:
        target = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(target):
            name = target()  # "kuzu_torch::nms_keep"
            ns, _, op = name.partition("::")
            if ns == NAMESPACE and op in counts:
                counts[op] += 1
    return counts
