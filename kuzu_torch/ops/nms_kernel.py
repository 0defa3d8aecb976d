"""Greedy NMS keep-mask: the CUDA kernel ``csrc/nms.cu`` and its plain version.

Replaces ``kuzu/ops/pallas_nms.py::pallas_suppress`` (behind
``kuzu/ops/nms.py::batched_suppress``). :func:`batched_suppress` calls the
operator ``kuzu_torch::nms_keep`` (``ops/registry.py``), which runs the
plain PyTorch recurrence :func:`suppress_reference` for a CPU tensor and
launches the kernel (:func:`launch`) for a CUDA tensor; there is no fallback
between them.
"""

from __future__ import annotations

import ctypes

import torch

from kuzu_torch import _build


def suppress_reference(
    boxes: torch.Tensor,  # (B, K, 4) f32, score-descending
    valid: torch.Tensor,  # (B, K) bool
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy keep-mask as the scan of ``kuzu/ops/nms.py:29-46``: row i is
    kept iff it is valid and no kept row j < i overlaps it above the
    threshold. The IoU is the f32 expression of the TPU kernel,
    ``inter / (area_i + area_j - inter + 1e-7)``."""
    b, k, _ = boxes.shape
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
    inter = iw * ih
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    over = (iou > iou_threshold) & later & valid[:, None, :] & valid[:, :, None]
    suppressed = torch.zeros(b, k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        kept_i = valid[:, i] & ~suppressed[:, i]
        suppressed |= over[:, i, :] & kept_i[:, None]
    return valid & ~suppressed


WORD = 64  # boxes per chunk and bits per mask word (csrc/nms.cu kWord)
SWEEP_CAP = 128  # words per chunk row the sweep keeps in shared memory (kCap)
SMEM_LIMIT = 232448  # shared memory a block can opt into on the H100


def mask_words(k: int) -> int:
    """Mask scratch words per image (``mask_words`` in ``csrc/nms.cu``): the
    words on and above the diagonal, 64 rows x W (W + 1) / 2 for W =
    ceil(K / 64); the words below it are never written nor read."""
    w = -(-k // WORD)
    return WORD * w * (w + 1) // 2


def sweep_smem_bytes(k: int) -> int:
    """Shared memory of the sweep block (``sweep_smem_bytes`` in
    ``csrc/nms.cu``): two chunk windows of min(W, 128) words x 64 rows, and
    the removed and valid words."""
    w = -(-k // WORD)
    return 2 * min(w, SWEEP_CAP) * WORD * 8 + 2 * w * 8


def _kernel_fn():
    return _build.function("nms", "kuzu_nms", [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def batched_suppress(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Batched greedy keep-mask (B, K) bool for score-sorted (B, K, 4) boxes,
    through the operator ``kuzu_torch::nms_keep`` (``ops/registry.py``): the
    plain recurrence for CPU tensors, the kernel for CUDA tensors.

    Any K: the kernel masks the ragged tail itself, so the 128-padding the
    TPU kernel needs is gone."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"bad shapes {tuple(boxes.shape)} / {tuple(valid.shape)}")
    if boxes.device.type != "cpu":
        if boxes.device.type != "cuda" or valid.device != boxes.device:
            raise ValueError(f"batched_suppress takes CPU or CUDA tensors, got {boxes.device}")
        if sweep_smem_bytes(boxes.shape[1]) > SMEM_LIMIT:
            raise ValueError(f"batched_suppress kernel takes K <= 405504, got K={boxes.shape[1]}")
    return torch.ops.kuzu_torch.nms_keep(boxes, valid, float(iou_threshold))


def launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The kernel on CUDA tensors that :func:`batched_suppress` has checked
    (the operator's CUDA implementation)."""
    b, k, _ = boxes.shape
    boxes = boxes.float().contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    mask = torch.empty((b, mask_words(k)), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.uint8, device=boxes.device)
    err = _kernel_fn()(
        _build.ptr(boxes), _build.ptr(valid_u8), _build.ptr(mask), _build.ptr(keep),
        b, k, float(iou_threshold), _build.stream_ptr(boxes),
    )
    _build.check(err, "kuzu_nms")
    batched_suppress.launches += 1
    return keep.bool()


batched_suppress.launches = 0
batched_suppress.plain_calls = 0
