"""Fixed-shape non-maximum suppression and yolov10's NMS-free selection
(counterpart of ``kuzu/ops/nms.py``).

Candidates are reduced to the top ``max_nms`` by score, the greedy keep-mask
comes from :func:`kuzu_torch.ops.nms_kernel.batched_suppress` (the CUDA kernel on
the card, the plain recurrence on the CPU), and outputs are padded to
``max_det`` with a validity mask. Multi-class NMS uses the class-offset
trick (``max_wh`` per class).

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so every top-k here is a stable
descending sort, sliced.
"""

from __future__ import annotations

import torch

from kuzu_torch.ops.boxes import xywh2xyxy
from kuzu_torch.ops.nms_kernel import batched_suppress


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_padded_batch(
    boxes: torch.Tensor,  # (B, N, 4) xyxy
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N) int
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_det: int = 300,
    max_nms: int = 2048,
    agnostic: bool = False,
    max_wh: int = 7680,
    return_indices: bool = False,
):
    """Padded, score-sorted (boxes (B, max_det, 4), scores, classes, valid),
    plus the kept candidates' input indices when ``return_indices``."""
    n = boxes.shape[1]
    scores = torch.where(valid & (scores > score_threshold), scores,
                         torch.full_like(scores, -1.0))
    k = min(max_nms, n)
    top_scores, order = _top_k(scores, k)
    top_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, order)
    top_valid = top_scores > 0.0

    if agnostic:
        off_boxes = top_boxes
    else:
        off_boxes = top_boxes + (top_classes.to(top_boxes.dtype) * max_wh)[..., None]

    keep = batched_suppress(off_boxes, top_valid, iou_threshold) & top_valid

    kept_scores = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    out_scores, kept_order = _top_k(kept_scores, min(max_det, k))
    out_boxes = torch.gather(top_boxes, 1, kept_order[..., None].expand(-1, -1, 4))
    out_classes = torch.gather(top_classes, 1, kept_order)
    out_valid = out_scores > 0.0
    pad = max_det - k
    if pad > 0:  # pad up if max_det exceeds the candidate pool
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    out_scores = torch.where(out_valid, out_scores, torch.zeros_like(out_scores))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_classes = torch.where(out_valid, out_classes, torch.zeros_like(out_classes))
    if return_indices:
        out_idx = torch.gather(order, 1, kept_order)
        if pad > 0:
            out_idx = torch.nn.functional.pad(out_idx, (0, pad))
        out_idx = torch.where(out_valid, out_idx, torch.zeros_like(out_idx))
        return out_boxes, out_scores, out_classes, out_valid, out_idx
    return out_boxes, out_scores, out_classes, out_valid


def non_max_suppression(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 2048,
    agnostic: bool = False,
    multi_label: bool = False,
    in_format: str = "xywh",
    return_indices: bool = False,
) -> dict[str, torch.Tensor]:
    """Batched NMS over raw detector output (B, 4 + nc, A).

    Returns padded ``boxes`` (B, max_det, 4) xyxy, ``scores`` (B, max_det),
    ``classes`` (B, max_det) int32, ``valid`` (B, max_det) bool, and
    ``indices`` (anchor indices) when ``return_indices``."""
    pred = prediction.transpose(1, 2)  # (B, A, 4+nc)
    boxes = pred[..., :4]
    if in_format == "xywh":
        boxes = xywh2xyxy(boxes)
    cls_scores = pred[..., 4:]
    nc = cls_scores.shape[-1]
    if multi_label and nc > 1:
        b, a, _ = cls_scores.shape
        boxes = boxes.repeat_interleave(nc, dim=1)
        scores = cls_scores.reshape(b, a * nc)
        classes = torch.arange(nc, dtype=torch.int32, device=pred.device).repeat(b, a)
    elif nc == 1:
        scores = cls_scores[..., 0]
        classes = torch.zeros(scores.shape, dtype=torch.int32, device=pred.device)
    else:
        scores, classes = cls_scores.max(dim=-1)  # first index among ties
        classes = classes.to(torch.int32)
    valid = torch.ones(scores.shape, dtype=torch.bool, device=pred.device)

    out = nms_padded_batch(
        boxes.contiguous(), scores.contiguous(), classes, valid,
        iou_threshold=iou_thres, score_threshold=conf_thres, max_det=max_det,
        max_nms=max_nms, agnostic=agnostic, return_indices=return_indices,
    )
    res = {"boxes": out[0], "scores": out[1], "classes": out[2], "valid": out[3]}
    if return_indices:
        idx = out[4]
        res["indices"] = idx // nc if multi_label and nc > 1 else idx
    return res


def nms_free_select(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    max_det: int = 300,
) -> dict[str, torch.Tensor]:
    """NMS-free selection for yolov10's one2one head (``kuzu/ops/nms.py::
    nms_free_select``): the top ``max_det`` anchors by their best class
    score, then a top-k over those anchors' (anchor, class) scores, no
    suppression. Ties go to the lower index, as ``jax.lax.top_k`` takes
    them. The padded output contract of :func:`non_max_suppression`, but
    scores and boxes under ``conf_thres`` stay in place with ``valid``
    false, as JAX's."""
    pred = prediction.transpose(1, 2)  # (B, A, 4+nc)
    boxes = xywh2xyxy(pred[..., :4])
    scores = pred[..., 4:]
    b, a, nc = scores.shape
    k = min(max_det, a)
    _, anc_idx = _top_k(scores.amax(dim=-1), k)
    sel_boxes = torch.gather(boxes, 1, anc_idx[..., None].expand(-1, -1, 4))
    sel_scores = torch.gather(scores, 1, anc_idx[..., None].expand(-1, -1, nc))
    vals, flat_idx = _top_k(sel_scores.reshape(b, k * nc), k)
    out_boxes = torch.gather(sel_boxes, 1, (flat_idx // nc)[..., None].expand(-1, -1, 4))
    classes = (flat_idx % nc).to(torch.int32)
    valid = vals > conf_thres
    pad = max_det - k
    if pad > 0:  # pad to the static contract
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        vals = torch.nn.functional.pad(vals, (0, pad))
        classes = torch.nn.functional.pad(classes, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return {"boxes": out_boxes, "scores": vals, "classes": classes, "valid": valid}


BACKENDS = ("auto", "pallas")  # JAX's names of its routes; the port's one route is K1


def nms_padded(
    boxes: torch.Tensor,  # (N, 4) xyxy
    scores: torch.Tensor,  # (N,)
    classes: torch.Tensor,  # (N,) int
    valid: torch.Tensor,  # (N,) bool
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_det: int = 300,
    max_nms: int = 2048,
    agnostic: bool = False,
    max_wh: int = 7680,
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-image NMS on padded candidates (:func:`nms_padded_batch` over
    a batch of one): (boxes (max_det, 4), scores, classes, valid).

    ``backend`` keeps JAX's signature: ``"auto"`` and ``"pallas"`` both take
    the keep-mask from the K1 kernel on a CUDA tensor (its plain version on
    a CPU one); JAX's scan route has no counterpart, so any other name
    raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port's NMS runs K1 (one of {BACKENDS})")
    ob, os_, oc, ov = nms_padded_batch(
        boxes[None], scores[None], classes[None], valid[None],
        iou_threshold=iou_threshold, score_threshold=score_threshold, max_det=max_det,
        max_nms=max_nms, agnostic=agnostic, max_wh=max_wh)
    return ob[0], os_[0], oc[0], ov[0]
