"""Results container: detection outputs with their views and export helpers
(a copy of ``kuzu/api/results.py``, which the port may not import).

``Boxes`` (xyxy / xywh / normalised views, indexing), ``Results`` (dict-style
access, iteration, ``filter``, ``save_txt``, ``to_json``, ``summary``),
``Masks``, ``Keypoints`` and ``OBBoxes`` (the segment, pose and OBB
predictors' extras; JAX keeps the last two in ``kuzu/tasks/pose.py`` and
``kuzu/tasks/obb.py``) hold numpy arrays, as the reference's do. ``Masks.full`` repeats
cv2's ``INTER_NEAREST`` with index arithmetic. ``Results.plot`` and
``save`` draw and write with cv2 (its rectangles, Hershey font and PNG /
JPEG writer), as JAX's do; where cv2 is not installed they raise an
``ImportError`` naming it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} draws and writes with OpenCV (cv2), which is not "
                          "installed") from e
    return cv2


class Boxes:
    def __init__(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
                 orig_shape: tuple[int, int], ids: np.ndarray | None = None):
        self.data = np.asarray(boxes, np.float32).reshape(-1, 4)
        self.conf = np.asarray(scores, np.float32).reshape(-1)
        self.cls = np.asarray(classes).reshape(-1).astype(int)
        self.orig_shape = orig_shape  # (h, w)
        # track ids from Model.track (reference Boxes.id); None on predict
        self.id = None if ids is None else np.asarray(ids).reshape(-1).astype(int)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xyxy(self) -> np.ndarray:
        return self.data

    @property
    def xywh(self) -> np.ndarray:
        out = self.data.copy()
        out[:, 2:] = self.data[:, 2:] - self.data[:, :2]
        out[:, :2] = self.data[:, :2] + out[:, 2:] / 2
        return out

    @property
    def xyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.data / [w, h, w, h]

    @property
    def xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xywh / [w, h, w, h]

    def __getitem__(self, idx) -> "Boxes":
        return Boxes(
            self.data[idx], self.conf[idx], self.cls[idx], self.orig_shape,
            None if self.id is None else self.id[idx],
        )


class Masks:
    """Per-detection binary masks at prototype resolution (reference
    ``engine/results.py`` Masks; composed by the segment predictor)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = data  # (n, Hp, Wp) bool
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def full(self) -> np.ndarray:
        """Masks resized (nearest) to the original image frame: cv2's
        ``INTER_NEAREST`` takes source index ``floor(d * (1 / (dsize /
        ssize)))`` (in double), clipped to the last row or column."""
        h, w = self.orig_shape
        if not len(self.data):
            return np.zeros((0, h, w), bool)
        hp, wp = self.data.shape[1:3]
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / hp))).astype(np.int64), hp - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / wp))).astype(np.int64), wp - 1)
        return np.asarray(self.data, bool)[:, ys[:, None], xs[None, :]]


class Keypoints:
    """Per-detection keypoints in the original image frame (reference
    ``engine/results.py`` Keypoints; set by the pose predictor)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = data  # (n, K, D): xy px (+ visibility probability)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xy(self) -> np.ndarray:
        return self.data[..., :2]

    @property
    def conf(self) -> np.ndarray | None:
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class OBBoxes:
    """Rotated detections (reference ``engine/results.py`` OBB; set by the
    OBB predictor)."""

    def __init__(self, data: np.ndarray, conf: np.ndarray, cls: np.ndarray):
        self.data = data  # (n, 5) xywhr
        self.conf = conf
        self.cls = cls

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xywhr(self) -> np.ndarray:
        return self.data

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """(n, 4, 2) corner points."""
        import torch

        from kuzu_torch.ops.obb import rbox_corners

        return rbox_corners(torch.as_tensor(np.asarray(self.data))).numpy()


class Results:
    def __init__(
        self,
        orig_img: np.ndarray | None,
        path: str,
        names: dict[int, str],
        boxes: Boxes,
        speed: dict[str, float] | None = None,
        masks: "Masks | None" = None,
    ):
        self.orig_img = orig_img
        self.path = path
        self.names = names
        self.boxes = boxes
        self.speed = speed or {}
        self.masks = masks
        self.keypoints = None  # set by the pose predictor
        self.obb = None  # set by the OBB predictor

    def __len__(self) -> int:
        return len(self.boxes)

    def __getitem__(self, key: str) -> Any:
        """dict-style access kept for pipeline/serving compatibility."""
        if key == "boxes":
            return self.boxes.xyxy
        if key == "scores":
            return self.boxes.conf
        if key == "classes":
            return self.boxes.cls
        if key == "path":
            return self.path
        raise KeyError(key)

    def __iter__(self) -> Iterator["Results"]:
        for i in range(len(self)):
            yield Results(
                self.orig_img, self.path, self.names, self.boxes[i : i + 1], self.speed
            )

    def filter(self, min_conf: float = 0.0, classes: list[int] | None = None) -> "Results":
        keep = self.boxes.conf >= min_conf
        if classes is not None:
            keep &= np.isin(self.boxes.cls, classes)
        return Results(self.orig_img, self.path, self.names, self.boxes[keep], self.speed)

    def plot(self, line_width: int = 2, font_scale: float = 0.5) -> np.ndarray:
        """Annotated RGB image: each box as cv2's rectangle and its label in
        ``FONT_HERSHEY_SIMPLEX`` with ``LINE_AA``, in a colour a class, by
        JAX's formula."""
        cv2 = _cv2("Results.plot")
        img = (
            self.orig_img.copy()
            if self.orig_img is not None
            else np.full((*self.boxes.orig_shape, 3), 255, np.uint8)
        )
        for (x1, y1, x2, y2), s, c in zip(
            self.boxes.xyxy.astype(int), self.boxes.conf, self.boxes.cls
        ):
            color = (int(37 * (c + 1)) % 255, int(91 * (c + 2)) % 255, 60)
            cv2.rectangle(img, (x1, y1), (x2, y2), color, line_width)
            label = f"{self.names.get(int(c), c)} {s:.2f}"
            cv2.putText(
                img, label, (x1, max(y1 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                font_scale, color, 1, cv2.LINE_AA,
            )
        return img

    def save(self, out_path: str | Path) -> Path:
        """:meth:`plot`'s image written by ``cv2.imwrite`` (its format from
        the suffix)."""
        cv2 = _cv2("Results.save")
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out_path), cv2.cvtColor(self.plot(), cv2.COLOR_RGB2BGR))
        return out_path

    def save_txt(self, out_path: str | Path, save_conf: bool = True) -> Path:
        """YOLO-format lines: cls cx cy w h [conf], normalized."""
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        lines = []
        for row, s, c in zip(self.boxes.xywhn, self.boxes.conf, self.boxes.cls):
            vals = [str(int(c))] + [f"{v:.6f}" for v in row]
            if save_conf:
                vals.append(f"{s:.4f}")
            lines.append(" ".join(vals))
        out_path.write_text("\n".join(lines))
        return out_path

    def to_json(self) -> str:
        return json.dumps(
            [
                {
                    "name": self.names.get(int(c), str(int(c))),
                    "class": int(c),
                    "confidence": round(float(s), 5),
                    "box": {k: round(float(v), 2) for k, v in
                            zip(("x1", "y1", "x2", "y2"), b)},
                }
                for b, s, c in zip(self.boxes.xyxy, self.boxes.conf, self.boxes.cls)
            ]
        )

    def summary(self) -> list[dict[str, Any]]:
        return json.loads(self.to_json())
