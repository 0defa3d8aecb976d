"""Anchor-free grid utilities (counterpart of ``kuzu/ops/anchors.py``).

Anchor order is the NHWC row-major flatten per level: row y outer, column
x inner, levels concatenated in order.
"""

from __future__ import annotations

import torch


def make_anchors(
    feat_shapes: list[tuple[int, int]],
    strides: list[int],
    grid_cell_offset: float = 0.5,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centers (A, 2) in grid units and per-anchor strides (A, 1)."""
    points, stride_out = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        stride_out.append(
            torch.full((h * w, 1), float(s), dtype=torch.float32, device=device)
        )
    return torch.cat(points, dim=0), torch.cat(stride_out, dim=0)


def dist2bbox(
    distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True
) -> torch.Tensor:
    """(l, t, r, b) distances + anchor centers -> boxes, (..., A, 4).

    A bf16 ``distance`` is promoted to the anchors' f32 here, as in JAX."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(
    bbox: torch.Tensor, anchor_points: torch.Tensor, reg_max: float
) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances clamped to [0, reg_max - 0.01],
    the DFL targets."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return dist.clamp(0, reg_max - 0.01)
