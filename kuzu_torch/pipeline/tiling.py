"""Overlap tiling and the cross-tile merge (counterpart of
``kuzu/pipeline/tiling.py``).

A page splits into a 2x2 (or g x g) grid of normalised cells whose interior
edges extend by overlap / 2; each tile's padded detections map back to the
page frame and one batched NMS (K1, ``kuzu_torch.ops.nms.nms_padded_batch``)
merges them per page. The frame arithmetic is the reference's numpy (f64,
cast to f32 at the end), so page-frame boxes are bit-equal to JAX's.
``tile_image`` letterboxes each tile with ``letterbox_np`` (cv2's resize to
the byte) on the page's device; the ship-once cascade derives its tiles on
the device with ``device_pages.device_tiles`` instead (``F.interpolate``,
JAX's ``jax.image.resize``).
"""

from __future__ import annotations

import numpy as np
import torch

from kuzu_torch.data.yolo_dataset import letterbox_np
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.ops.nms import nms_padded_batch


def grid_bounds(grid: int, overlap: float = 0.15) -> list[tuple[float, float, float, float]]:
    """Normalized (x1, y1, x2, y2) per tile, row-major."""
    tile = 1.0 / grid
    half = overlap / 2.0
    out = []
    for row in range(grid):
        for col in range(grid):
            x1 = col * tile - (half if col > 0 else 0.0)
            y1 = row * tile - (half if row > 0 else 0.0)
            x2 = (col + 1) * tile + (half if col < grid - 1 else 0.0)
            y2 = (row + 1) * tile + (half if row < grid - 1 else 0.0)
            out.append((max(x1, 0.0), max(y1, 0.0), min(x2, 1.0), min(y2, 1.0)))
    return out


def tile_image(
    image, grid: int = 2, overlap: float = 0.15, tile_size: int = 640
) -> tuple[np.ndarray | torch.Tensor, list[dict]]:
    """Split an (H, W, 3) uint8 page (an ndarray, or a tensor on any device)
    into letterboxed tiles. Returns (tiles (G*G, S, S, 3) uint8 of the page's
    kind, metas): each meta holds the tile's page-frame origin and its
    letterbox gain and pad."""
    h, w = image.shape[:2]
    tiles, metas = [], []
    for x1, y1, x2, y2 in grid_bounds(grid, overlap):
        px1, py1 = int(x1 * w), int(y1 * h)
        px2, py2 = int(x2 * w), int(y2 * h)
        canvas, gain, (pad_x, pad_y) = letterbox_np(image[py1:py2, px1:px2], tile_size)
        tiles.append(canvas)  # uint8; the detector normalizes on the device
        metas.append({"origin": (px1, py1), "gain": gain, "pad": (pad_x, pad_y)})
    if isinstance(image, np.ndarray):
        return np.stack(tiles), metas
    return torch.stack(tiles), metas


def rewrite_boxes_for_tile(
    boxes: np.ndarray,  # (N, 4) xyxy page pixels
    tile_bound_px: tuple[int, int, int, int],
    require_contained: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Map page boxes into one tile's frame; keep fully-contained boxes
    (the reference's dataset conversion), or with ``require_contained`` off
    every box that overlaps the tile. Returns (tile_boxes, keep_mask)."""
    x1, y1, x2, y2 = tile_bound_px
    if require_contained:
        keep = (
            (boxes[:, 0] >= x1)
            & (boxes[:, 1] >= y1)
            & (boxes[:, 2] <= x2)
            & (boxes[:, 3] <= y2)
        )
    else:
        keep = (boxes[:, 2] > x1) & (boxes[:, 0] < x2) & (boxes[:, 3] > y1) & (boxes[:, 1] < y2)
    out = boxes.copy()
    out[:, [0, 2]] -= x1
    out[:, [1, 3]] -= y1
    return out, keep


def _nms_bucket(n: int) -> int:
    """Candidate-count bucket of the cross-tile NMS: a few static K for the
    kernel, as the reference pads for one compiled program per bucket."""
    for b in (256, 1024, 4096, 16384):
        if n <= b:
            return b
    return int(2 ** int(np.ceil(np.log2(n))))


def _tiles_to_page_frame(
    per_tile: list[dict],
    metas: list[dict],
    page_shape: tuple[int, int] | None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undo each tile's letterbox and offset; concat valid candidates."""
    all_boxes, all_scores, all_classes = [], [], []
    for det, meta in zip(per_tile, metas):
        v = np.asarray(det["valid"], bool)
        boxes = np.asarray(det["boxes"])[v]
        pad_x, pad_y = meta["pad"]
        boxes = (boxes - [pad_x, pad_y, pad_x, pad_y]) / meta["gain"]
        ox, oy = meta["origin"]
        boxes += [ox, oy, ox, oy]
        if page_shape is not None:
            h, w = page_shape
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        all_boxes.append(boxes)
        all_scores.append(np.asarray(det["scores"])[v])
        all_classes.append(np.asarray(det["classes"])[v])
    if not all_boxes or sum(len(b) for b in all_boxes) == 0:
        return (
            np.zeros((0, 4), np.float32),
            np.zeros((0,), np.float32),
            np.zeros((0,), np.int32),
        )
    return (
        np.concatenate(all_boxes).astype(np.float32),
        np.concatenate(all_scores).astype(np.float32),
        np.concatenate(all_classes).astype(np.int32),
    )


def merge_tile_detections(
    per_tile: list[dict],  # each: {boxes (K,4), scores (K,), classes (K,), valid (K,)}
    metas: list[dict],
    iou_thres: float = 0.55,
    max_det: int = 2000,
    page_shape: tuple[int, int] | None = None,  # (h, w) to clip into
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """Per-tile padded detections -> page frame -> cross-tile NMS on
    ``device`` (the card when None)."""
    return merge_tile_detections_pages(
        [per_tile], [metas], iou_thres=iou_thres, max_det=max_det,
        page_shapes=None if page_shape is None else [page_shape], device=device,
    )[0]


def merge_tile_detections_pages(
    per_tile_by_page: list[list[dict]],
    metas_by_page: list[list[dict]],
    iou_thres: float = 0.55,
    max_det: int = 2000,
    page_shapes: list[tuple[int, int]] | None = None,
    device: torch.device | str | None = None,
) -> list[dict[str, np.ndarray]]:
    """Cross-tile NMS for a whole page batch in one ``nms_padded_batch`` call
    on ``device`` (the card when None): every page's candidates pad to one
    shared bucket of K."""
    device = resolve_device(device)
    pages = [
        _tiles_to_page_frame(
            pt, mt, None if page_shapes is None else page_shapes[i]
        )
        for i, (pt, mt) in enumerate(zip(per_tile_by_page, metas_by_page))
    ]
    counts = [len(b) for b, _, _ in pages]
    empty = {
        "boxes": np.zeros((0, 4), np.float32),
        "scores": np.zeros((0,), np.float32),
        "classes": np.zeros((0,), np.int32),
    }
    if max(counts, default=0) == 0:
        return [dict(empty) for _ in pages]
    m = _nms_bucket(max(counts))
    bs = len(pages)
    boxes = np.zeros((bs, m, 4), np.float32)
    scores = np.zeros((bs, m), np.float32)
    classes = np.zeros((bs, m), np.int32)
    valid = np.zeros((bs, m), bool)
    for i, (b, s, c) in enumerate(pages):
        boxes[i, : len(b)] = b
        scores[i, : len(b)] = s
        classes[i, : len(b)] = c
        valid[i, : len(b)] = True
    out = nms_padded_batch(
        *(torch.from_numpy(x).to(device) for x in (boxes, scores, classes, valid)),
        iou_threshold=iou_thres,
        score_threshold=0.0,
        max_det=min(max_det, m),
        max_nms=m,
    )
    ob, os_, oc, ov = (x.cpu().numpy() for x in out)
    return [
        {"boxes": ob[i][ov[i]], "scores": os_[i][ov[i]], "classes": oc[i][ov[i]]}
        if counts[i]
        else dict(empty)
        for i in range(bs)
    ]
