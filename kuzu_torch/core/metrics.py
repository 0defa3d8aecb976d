"""Detection metrics: mAP (101-point and 11-point), IoU matching, the
recognizer's edit distance and corpus CER, and the IoU-matched character
accuracy (copied from ``kuzu/core/metrics.py``: the port may not import it).

Capability parity with the reference's two metric stacks:
- engine metrics (``yolov12/ultralytics/utils/metrics.py``): ``box_iou``,
  101-point ``compute_ap``, ``ap_per_class``, ``DetMetrics`` fitness =
  0.1*mAP50 + 0.9*mAP50-95, and the validator's IoU-threshold
  prediction<->GT matching (``engine/validator.py:222``);
- project metrics (``src/utils/metrics.py:81-251``): 11-point interpolated
  mAP, character accuracy via IoU matching, CER via edit distance
  (``scripts/ocr_model.py:236``).

Matching/accumulation runs host-side in numpy over the padded arrays produced
by the jit'd NMS — mAP is off the hot path; the device only emits padded
detections.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, xyxy, (N,4) x (M,4) -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), dtype=np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def match_predictions(
    pred_boxes: np.ndarray,
    pred_classes: np.ndarray,
    gt_boxes: np.ndarray,
    gt_classes: np.ndarray,
    iou_thresholds: np.ndarray,
    use_scipy: bool = False,
    iou: np.ndarray | None = None,
) -> np.ndarray:
    """IoU matching of score-sorted predictions to GT per threshold.

    Returns ``correct`` (n_pred, n_thr) bool — reference
    ``validator.match_predictions`` semantics: each GT matches at most one
    prediction, classes must agree. ``use_scipy=False`` (default) matches
    greedily by IoU (highest pair first); ``use_scipy=True`` solves the
    optimal assignment with ``scipy.optimize.linear_sum_assignment``,
    mirroring the reference's optional branch
    (``yolov12/ultralytics/engine/validator.py:222-238`` — maximize total
    IoU over candidate pairs above the threshold).

    ``iou`` replaces the axis-aligned box IoU with a precomputed
    (n_gt, n_pred) similarity matrix — how the reference's OBB (probIoU,
    ``models/yolo/obb/val.py``) and Pose (OKS, ``pose/val.py:193``)
    validators reuse the same mAP machinery.
    """
    n_pred, n_thr = len(pred_boxes), len(iou_thresholds)
    correct = np.zeros((n_pred, n_thr), dtype=bool)
    if n_pred == 0 or len(gt_boxes) == 0:
        return correct
    if iou is None:
        iou = box_iou_np(gt_boxes, pred_boxes)
    iou = iou * (gt_classes[:, None] == pred_classes[None, :])
    for t, thr in enumerate(iou_thresholds):
        cand = iou >= thr
        if not cand.any():
            continue
        if use_scipy:
            import scipy.optimize

            cost = np.where(cand, iou, 0.0)
            g_idx, p_idx = scipy.optimize.linear_sum_assignment(
                cost, maximize=True
            )
            valid = cost[g_idx, p_idx] > 0
            correct[p_idx[valid], t] = True
            continue
        # greedy by IoU: repeatedly take the best (gt, pred) pair
        m = np.where(cand, iou, 0.0).copy()
        while True:
            g, p = np.unravel_index(np.argmax(m), m.shape)
            if m[g, p] <= 0:
                break
            correct[p, t] = True
            m[g, :] = 0.0
            m[:, p] = 0.0
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray, method: str = "interp101"):
    """AP from a recall/precision curve.

    ``interp101``: 101-point interpolation (engine ``compute_ap``, metrics.py:505).
    ``interp11``: 11-point interpolation (project ``compute_ap``, metrics.py:132).
    """
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    if method == "interp11":
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = mrec >= t
            ap += (mpre[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap), mpre, mrec
    x = np.linspace(0, 1, 101)
    ap = float(np.trapezoid(np.interp(x, mrec, mpre), x))
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (n_pred, n_thr) bool
    conf: np.ndarray,  # (n_pred,)
    pred_cls: np.ndarray,  # (n_pred,)
    target_cls: np.ndarray,  # (n_gt,)
    eps: float = 1e-16,
) -> dict:
    """Per-class AP over IoU thresholds + P/R at max-F1 conf.

    Mirrors engine ``ap_per_class`` (metrics.py:537) math on padded-free
    numpy arrays collected across the eval set.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, n_gt_per_class = np.unique(target_cls, return_counts=True)
    n_thr = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((len(classes), n_thr))
    p_out = np.zeros(len(classes))
    r_out = np.zeros(len(classes))
    for ci, c in enumerate(classes):
        mask = pred_cls == c
        n_gt = n_gt_per_class[ci]
        if not mask.any() or n_gt == 0:
            continue
        fpc = (~tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_gt + eps)
        precision = tpc / (tpc + fpc)
        for t in range(n_thr):
            ap[ci, t], _, _ = compute_ap(recall[:, t], precision[:, t])
        # P/R at max F1 for the IoU=0.5 column
        f1 = 2 * precision[:, 0] * recall[:, 0] / (precision[:, 0] + recall[:, 0] + eps)
        best = int(np.argmax(f1))
        p_out[ci], r_out[ci] = precision[best, 0], recall[best, 0]
    return {
        "classes": classes,
        "ap": ap,
        "precision": p_out,
        "recall": r_out,
        "map50": float(ap[:, 0].mean()) if len(classes) else 0.0,
        "map": float(ap.mean()) if len(classes) else 0.0,
    }


@dataclass
class DetMetrics:
    """Streaming detection-metric accumulator over padded NMS outputs."""

    iou_thresholds: np.ndarray = field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10)
    )
    # optimal (Hungarian) matching instead of greedy — the reference
    # validator's optional scipy branch (engine/validator.py:222)
    use_scipy: bool = False
    _tp: list = field(default_factory=list)
    _conf: list = field(default_factory=list)
    _pred_cls: list = field(default_factory=list)
    _target_cls: list = field(default_factory=list)

    def update(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_classes: np.ndarray,
        pred_valid: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        gt_valid: np.ndarray,
        iou_matrix: np.ndarray | None = None,
    ) -> None:
        """Add one image (padded arrays straight off the device).

        ``iou_matrix``: optional precomputed (n_valid_gt, n_valid_pred)
        similarity (probIoU for OBB, OKS for pose) replacing box IoU.
        """
        pb = np.asarray(pred_boxes)[np.asarray(pred_valid, bool)]
        ps = np.asarray(pred_scores)[np.asarray(pred_valid, bool)]
        pc = np.asarray(pred_classes)[np.asarray(pred_valid, bool)]
        gb = np.asarray(gt_boxes)[np.asarray(gt_valid, bool)]
        gc = np.asarray(gt_classes)[np.asarray(gt_valid, bool)]
        self._tp.append(
            match_predictions(
                pb, pc, gb, gc, self.iou_thresholds, use_scipy=self.use_scipy,
                iou=iou_matrix,
            )
        )
        self._conf.append(ps)
        self._pred_cls.append(pc)
        self._target_cls.append(gc)

    def compute(self) -> dict:
        if not self._tp:
            return {"map50": 0.0, "map": 0.0, "precision": 0.0, "recall": 0.0, "fitness": 0.0}
        res = ap_per_class(
            np.concatenate(self._tp),
            np.concatenate(self._conf),
            np.concatenate(self._pred_cls),
            np.concatenate(self._target_cls),
        )
        out = {
            "map50": res["map50"],
            "map": res["map"],
            "precision": float(res["precision"].mean()) if len(res["classes"]) else 0.0,
            "recall": float(res["recall"].mean()) if len(res["classes"]) else 0.0,
        }
        # fitness = 0.1*mAP50 + 0.9*mAP50-95 (engine DetMetrics.fitness)
        out["fitness"] = 0.1 * out["map50"] + 0.9 * out["map"]
        return out

    def reset(self) -> None:
        self._tp.clear()
        self._conf.clear()
        self._pred_cls.clear()
        self._target_cls.clear()


def levenshtein(a, b) -> int:
    """Edit distance over sequences (chars or token-id lists)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def character_error_rate(preds: list, targets: list) -> float:
    """Corpus CER = sum(edit) / sum(len(target)) (reference ``calculate_cer``)."""
    total_edit, total_len = 0, 0
    for p, t in zip(preds, targets):
        total_edit += levenshtein(p, t)
        total_len += len(t)
    return total_edit / max(total_len, 1)


def character_accuracy(
    pred_boxes: np.ndarray,
    pred_labels: np.ndarray,
    gt_boxes: np.ndarray,
    gt_labels: np.ndarray,
    iou_threshold: float = 0.5,
) -> float:
    """Fraction of ground-truth characters matched, greedily in their order,
    by an unused prediction of IoU >= ``iou_threshold`` (the best one) with
    the same label; the prediction is used up either way."""
    if len(gt_boxes) == 0:
        return 0.0
    iou = box_iou_np(gt_boxes, pred_boxes)
    correct = 0
    used = np.zeros(len(pred_boxes), bool)
    for g in range(len(gt_boxes)):
        cand = np.where((iou[g] >= iou_threshold) & ~used)[0]
        if len(cand) == 0:
            continue
        best = cand[np.argmax(iou[g, cand])]
        if pred_labels[best] == gt_labels[g]:
            correct += 1
        used[best] = True
    return correct / len(gt_boxes)
