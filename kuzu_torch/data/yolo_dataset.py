"""YOLO-format detection data: the folder dataset and its host-side
augmentations, and the Segment, Pose and OBB datasets (counterpart of
``kuzu/data/yolo_dataset.py``).

``dataset.yaml`` (path / train / val / names), label files next to an
``images`` dir's ``labels`` twin, the label cache, rect buckets, the image
cache, and the v8 recipe: a 4-image mosaic on a 2S canvas, the random
perspective / affine with the box rewrite and candidate filter, mixup,
copy-paste, HSV jitter, the photometric extras and the flips, targets padded
to ``max_boxes``.

Every cv2 call of the reference is ``data/image_io.py``'s counterpart, the
same bytes: the decode (``imread_rgb(backend="cv2")``), ``resize_linear_u8``,
``warp_affine_u8`` / ``warp_perspective_u8``, ``rotation_matrix_2d``, the HSV
conversions and ``lut_u8``; PIL's ``Image.open(p).size`` is ``image_size``.
The random draws are the reference's, in its order, from
``numpy.random.Generator`` seeded per sample by ``(seed 1_000_003 + epoch
7919 + idx) mod 2^31``, so a sample equals the JAX package's byte for byte.
The augmentations run on the host, in the loader's threads, as the
reference's do, each sample's torch ops on one intra-op thread
(``loader.one_thread``); the images stay numpy uint8 and the model
normalises them on the device.
"""

from __future__ import annotations

import hashlib
import logging
import math
from pathlib import Path

import numpy as np
import torch
import yaml

from kuzu_torch.data import image_io as io
from kuzu_torch.data.image_io import resize_linear_u8
from kuzu_torch.data.loader import one_thread

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def load_dataset_yaml(path: str | Path) -> dict:
    """A ``dataset.yaml`` as ``root``, ``train``, ``val``, ``names`` (int keys)
    and ``nc`` (the count of names when absent); ``kpt_shape``, ``flip_idx``
    and ``test`` pass through."""
    with open(path) as f:
        d = yaml.safe_load(f)
    root = Path(d.get("path", Path(path).parent))
    if not root.is_absolute():
        root = Path(path).parent / root
    names = d.get("names", {})
    if isinstance(names, list):
        names = dict(enumerate(names))
    out = {
        "root": root,
        "train": d.get("train", "images/train"),
        "val": d.get("val", "images/val"),
        "names": {int(k): v for k, v in names.items()},
        "nc": int(d.get("nc", len(names) or 1)),
    }
    for k in ("kpt_shape", "flip_idx", "test"):
        if k in d:
            out[k] = d[k]
    return out


def _label_path(img_path: Path) -> Path:
    """The label file of an image: the last ``images`` part -> ``labels``,
    suffix ``.txt``."""
    parts = list(img_path.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return Path(*parts).with_suffix(".txt")


def read_yolo_labels(path: Path) -> np.ndarray:
    """(N, 5) rows of (cls, cx, cy, w, h) normalized; empty -> (0, 5)."""
    if not path.exists():
        return np.zeros((0, 5), np.float32)
    rows = []
    for line in path.read_text().splitlines():
        vals = line.split()
        if len(vals) >= 5:
            rows.append([float(v) for v in vals[:5]])
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)


def letterbox_np(img, size: int | tuple[int, int], fill: int = 114):
    """Letterbox an (H, W, 3) uint8 image (an ndarray, or a tensor on any
    device) to (size, size) or (h, w): resized by the gain min(th / H, tw /
    W) to (round(H gain), round(W gain)) (at least 1), centred on a ``fill``
    canvas. Returns (canvas of the input's kind, gain, (pad_x, pad_y))."""
    th, tw = (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))
    h, w = img.shape[:2]
    gain = min(th / h, tw / w)
    nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
    resized = resize_linear_u8(img, (nh, nw))
    px, py = (tw - nw) // 2, (th - nh) // 2
    if isinstance(img, np.ndarray):
        canvas = np.full((th, tw, 3), fill, np.uint8)
    else:
        canvas = torch.full((th, tw, 3), fill, dtype=torch.uint8, device=img.device)
    canvas[py:py + nh, px:px + nw] = resized
    return canvas, gain, (px, py)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator, h=0.015, s=0.7, v=0.4) -> np.ndarray:
    """Random hue / saturation / value gains through 8-bit HSV and a LUT per
    channel (the reference's tables, built in numpy)."""
    if h == s == v == 0:
        return img
    r = rng.uniform(-1, 1, 3) * [h, s, v] + 1
    lut_h = ((np.arange(256) * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(np.arange(256) * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(np.arange(256) * r[2], 0, 255).astype(np.uint8)
    hsv = io.lut_u8(io.rgb_to_hsv_u8(img), np.stack([lut_h, lut_s, lut_v], 1))
    return io.hsv_to_rgb_u8(hsv)


def random_affine(
    img: np.ndarray,
    boxes: np.ndarray,  # (N, 4) xyxy pixels
    labels: np.ndarray,
    rng: np.random.Generator,
    size: int,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
    fill: int = 114,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random perspective / rotation / scale / shear / translation with the box
    rewrite and the candidate filter: M = T S R P C, the perspective warp
    where ``perspective`` is nonzero, else the affine one, to (size, size)
    with ``fill`` outside; boxes from their warped corners, clipped, kept
    where wider and higher than 2 px, over a tenth of their scaled area and
    of aspect below 100."""
    h, w = img.shape[:2]
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R = np.eye(3)
    R[:2] = io.rotation_matrix_2d((0.0, 0.0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size
    M = T @ S @ R @ P @ C
    if perspective:
        out = io.warp_perspective_u8(img, M, (size, size), border_value=(fill,) * 3)
    else:
        out = io.warp_affine_u8(img, M[:2], (size, size), border_value=(fill,) * 3)
    if len(boxes) == 0:
        return out, boxes, labels
    corners = np.concatenate(
        [boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [2, 3]], boxes[:, [0, 3]]], axis=0)
    ones = np.ones((len(corners), 1))
    warped = np.concatenate([corners, ones], 1) @ M.T  # (4N, 3)
    if perspective:
        warped = warped[:, :2] / np.maximum(warped[:, 2:3], 1e-9)
    else:
        warped = warped[:, :2]
    warped = warped.reshape(4, -1, 2)
    new = np.concatenate([warped.min(axis=0), warped.max(axis=0)], axis=1).astype(np.float32)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, size)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, size)
    wh = new[:, 2:] - new[:, :2]
    old_wh = (boxes[:, 2:] - boxes[:, :2]) * s
    ar = np.maximum(wh[:, 0] / np.maximum(wh[:, 1], 1e-9), wh[:, 1] / np.maximum(wh[:, 0], 1e-9))
    keep = (wh > 2).all(1) & (wh.prod(1) / np.maximum(old_wh.prod(1), 1e-6) > 0.1) & (ar < 100)
    return out, new[keep], labels[keep]


def mixup(img1: np.ndarray, boxes1: np.ndarray, labels1: np.ndarray,
          img2: np.ndarray, boxes2: np.ndarray, labels2: np.ndarray,
          rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Beta(32, 32) blend of two images in float32, truncated to uint8, the
    targets concatenated."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1.0 - r)).astype(np.uint8)
    boxes = np.concatenate([boxes1, boxes2]).astype(np.float32)
    labels = np.concatenate([labels1, labels2]).astype(labels1.dtype)
    return img, boxes, labels


def copy_paste(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
               rng: np.random.Generator, p: float = 0.5):
    """Flip-mode copy-paste: a fraction ``p`` of the instances (a permutation
    drawn) duplicated, as mirrored box patches, at the horizontally mirrored
    place where that place covers every instance so far by IoA < 0.30."""
    n = len(boxes)
    if n == 0 or p <= 0:
        return img, boxes, labels
    h, w = img.shape[:2]
    k = max(int(round(p * n)), 1)
    out = img.copy()
    new_boxes, new_labels = [], []
    all_boxes = boxes
    for i in rng.permutation(n)[:k]:
        x1, y1, x2, y2 = boxes[i]
        mx1, mx2 = w - x2, w - x1
        cand = np.array([mx1, y1, mx2, y2], np.float32)
        ix1 = np.maximum(all_boxes[:, 0], cand[0])
        iy1 = np.maximum(all_boxes[:, 1], cand[1])
        ix2 = np.minimum(all_boxes[:, 2], cand[2])
        iy2 = np.minimum(all_boxes[:, 3], cand[3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = max((cand[2] - cand[0]) * (cand[3] - cand[1]), 1e-6)
        if len(all_boxes) and (inter / area).max() >= 0.30:
            continue
        sy1, sy2 = int(y1), int(y2)
        sx1, sx2 = int(x1), int(x2)
        dx1, dx2 = int(mx1), int(mx1) + (sx2 - sx1)
        if sy2 <= sy1 or sx2 <= sx1 or dx2 > w or dx1 < 0:
            continue
        out[sy1:sy2, dx1:dx2] = img[sy1:sy2, sx1:sx2][:, ::-1]
        new_boxes.append(cand)
        new_labels.append(labels[i])
        all_boxes = np.concatenate([all_boxes, cand[None]])
    if new_boxes:
        boxes = np.concatenate([boxes, np.stack(new_boxes)]).astype(np.float32)
        labels = np.concatenate([labels, np.asarray(new_labels, labels.dtype)])
    return out, boxes, labels


class YoloDetectionDataset:
    """Detection samples with the v8 augmentation recipe, padded targets:
    ``image`` uint8 (S, S, 3) (rect: the image's bucket), ``gt_boxes`` (M, 4)
    xyxy px, ``gt_labels`` (M,), ``mask_gt`` (M,)."""

    def __init__(
        self,
        spec: str | Path | dict,
        split: str = "train",
        imgsz: int = 640,
        max_boxes: int = 300,
        augment: bool = True,
        hyp: dict | None = None,
        seed: int = 0,
        rect: bool = False,
        stride: int = 32,
        cache: bool = True,
        cache_images: str | None = None,  # 'ram' | 'disk' | None
    ):
        if isinstance(spec, (str, Path)):
            spec = load_dataset_yaml(spec)
        self.spec = spec
        self.imgsz = imgsz
        self.max_boxes = max_boxes
        self.augment = augment and split == "train"
        self.hyp = {
            "mosaic": 1.0, "fliplr": 0.5, "flipud": 0.0,
            "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
            "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0,
            "mixup": 0.0, "copy_paste": 0.0,
            # photometric extras (default off)
            "noise": 0.0, "blur": 0.0, "jpeg": 0.0, "distort": 0.0, "erasing": 0.0,
            **(hyp or {}),
        }
        self.seed = seed
        img_dir = self.spec["root"] / self.spec[split]
        self.images = sorted(p for p in Path(img_dir).rglob("*") if p.suffix.lower() in IMG_EXTS)
        if not self.images:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.nc = self.spec["nc"]
        self._epoch = 0
        # rect: per-image (h, w) buckets on the stride grid (validation only)
        self.rect = rect and not self.augment
        self.stride = stride
        self._rect_shapes = [self._bucket_shape(p) for p in self.images] if self.rect else None
        self._labels = self._load_label_cache() if cache else None
        self.cache_images = cache_images if cache_images in ("ram", "disk") else None
        self._img_cache = [None] * len(self.images) if self.cache_images == "ram" else None
        if self.cache_images == "ram":
            try:
                w, h = io.image_size(self.images[0])
            except (OSError, ValueError, ImportError):
                w = h = 0
            est = w * h * 3 * len(self.images) / 1e9
            if est > 4.0:
                logging.getLogger("kuzu").warning(
                    f"cache_images=ram: ~{est:.1f} GB of decoded images")

    def _label_cache_file(self) -> Path:
        return _label_path(self.images[0]).parent / "labels.cache.npz"

    def _load_label_cache(self) -> list[np.ndarray]:
        """Every image's (N_i, 5) normalized rows, through ``labels.cache.npz``
        while its sha1 of the label files' names, mtimes and sizes matches."""
        paths = [_label_path(p) for p in self.images]
        h = hashlib.sha1()
        for p in paths:
            st = p.stat() if p.exists() else None
            h.update(f"{p.name}:{st.st_mtime_ns if st else 0}:"
                     f"{st.st_size if st else -1};".encode())
        key = h.hexdigest()
        cache_file = self._label_cache_file()
        try:
            z = np.load(cache_file, allow_pickle=False)
            if str(z["key"]) == key:
                rows, counts = z["rows"], z["counts"]
                off = np.concatenate([[0], np.cumsum(counts)])
                return [rows[off[i]:off[i + 1]].astype(np.float32) for i in range(len(counts))]
        except (OSError, KeyError, ValueError):
            pass
        labels = [read_yolo_labels(p) for p in paths]
        try:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache_file, key=key,
                     rows=np.concatenate(labels) if labels else np.zeros((0, 5), np.float32),
                     counts=np.asarray([len(x) for x in labels], np.int64))
        except OSError:
            pass  # a read-only dataset dir keeps the labels in memory only
        return labels

    def _bucket_shape(self, path: Path) -> tuple[int, int]:
        """(h, w) for one image: the long side ``imgsz``, the short side
        rounded up to a stride multiple."""
        w, h = io.image_size(path)
        s, st = self.imgsz, self.stride
        if h >= w:
            short = min(-(-int(s * w / h) // st) * st, s)
            return (s, max(short, st))
        short = min(-(-int(s * h / w) // st) * st, s)
        return (max(short, st), s)

    def batch_shape_key(self, idx: int) -> tuple[int, int]:
        """The loader's grouping key: the rect bucket (else one square)."""
        if self._rect_shapes is None:
            return (self.imgsz, self.imgsz)
        return self._rect_shapes[idx]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def close_mosaic(self) -> None:
        self.hyp["mosaic"] = 0.0

    def __len__(self) -> int:
        return len(self.images)

    def _mosaic_affine(self, idx: int, rng: np.random.Generator):
        hyp = self.hyp
        img, boxes, labels = self._mosaic(idx, rng)
        return random_affine(img, boxes, labels, rng, self.imgsz, hyp["degrees"],
                             hyp["translate"], hyp["scale"], hyp["shear"], hyp["perspective"])

    def _decode(self, idx: int) -> np.ndarray:
        """Decoded uint8 RGB for one image, through the configured cache. As
        the reference, a file that does not decode gives a 114-filled
        ``imgsz`` square; a format this machine has no codec for raises its
        ``ImportError`` instead (a blank image would train as background)."""
        path = self.images[idx]
        if self._img_cache is not None:
            img = self._img_cache[idx]
            if img is not None:
                return img
        elif self.cache_images == "disk":
            npy = path.with_suffix(".cache.npy")
            if npy.exists():
                try:
                    return np.load(npy, allow_pickle=False)
                except (OSError, ValueError):
                    pass
        try:
            img = io.imread_rgb(path, backend="cv2")
        except ImportError:
            raise
        except Exception:
            img = np.full((self.imgsz, self.imgsz, 3), 114, np.uint8)
        if self._img_cache is not None:
            self._img_cache[idx] = img
        elif self.cache_images == "disk":
            try:
                np.save(path.with_suffix(".cache.npy"), img)
            except OSError:
                pass
        return img

    def _load_raw(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image uint8 RGB, boxes xyxy pixels, labels."""
        img = self._decode(idx)
        h, w = img.shape[:2]
        rows = (self._labels[idx] if self._labels is not None
                else read_yolo_labels(_label_path(self.images[idx])))
        labels = rows[:, 0].astype(np.int32)
        cxcywh = rows[:, 1:5] * [w, h, w, h]
        boxes = np.concatenate([cxcywh[:, :2] - cxcywh[:, 2:] / 2,
                                cxcywh[:, :2] + cxcywh[:, 2:] / 2], axis=1).astype(np.float32)
        return img, boxes, labels

    def _mosaic(self, idx: int, rng: np.random.Generator):
        """4-image mosaic on a 2S x 2S canvas of 114, its centre drawn in
        [S / 2, 3 S / 2); each image resized by min(S / h, S / w) (cv2's
        INTER_LINEAR, truncated sizes) into its quadrant."""
        s = self.imgsz
        canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
        cx = int(rng.uniform(0.5 * s, 1.5 * s))
        cy = int(rng.uniform(0.5 * s, 1.5 * s))
        idxs = [idx] + list(rng.integers(0, len(self.images), 3))
        all_boxes, all_labels = [], []
        for i, im_idx in enumerate(idxs):
            img, boxes, labels = self._load_raw(int(im_idx))
            h, w = img.shape[:2]
            gain = min(s / h, s / w)
            img = resize_linear_u8(img, (int(h * gain), int(w * gain)))
            h, w = img.shape[:2]
            if i == 0:  # top left, its bottom-right corner at (cx, cy)
                x1, y1, x2, y2 = max(cx - w, 0), max(cy - h, 0), cx, cy
                sx1, sy1 = w - (x2 - x1), h - (y2 - y1)
            elif i == 1:  # top right
                x1, y1, x2, y2 = cx, max(cy - h, 0), min(cx + w, 2 * s), cy
                sx1, sy1 = 0, h - (y2 - y1)
            elif i == 2:  # bottom left
                x1, y1, x2, y2 = max(cx - w, 0), cy, cx, min(cy + h, 2 * s)
                sx1, sy1 = w - (x2 - x1), 0
            else:  # bottom right
                x1, y1, x2, y2 = cx, cy, min(cx + w, 2 * s), min(cy + h, 2 * s)
                sx1, sy1 = 0, 0
            canvas[y1:y2, x1:x2] = img[sy1:sy1 + (y2 - y1), sx1:sx1 + (x2 - x1)]
            if len(boxes):
                b = boxes * gain
                b[:, [0, 2]] += x1 - sx1
                b[:, [1, 3]] += y1 - sy1
                all_boxes.append(b)
                all_labels.append(labels)
        boxes = (np.concatenate(all_boxes).astype(np.float32) if all_boxes
                 else np.zeros((0, 4), np.float32))
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int32)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
        return canvas, boxes, labels

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        with one_thread():
            return self._sample(idx)

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self._epoch * 7919 + idx) % (2**31))
        hyp = self.hyp
        if self.augment and rng.uniform() < hyp["mosaic"]:
            img, boxes, labels = self._mosaic_affine(idx, rng)
            if rng.uniform() < hyp["mixup"]:  # blends two mosaic outputs
                idx2 = int(rng.integers(0, len(self.images)))
                img2, boxes2, labels2 = self._mosaic_affine(idx2, rng)
                img, boxes, labels = mixup(img, boxes, labels, img2, boxes2, labels2, rng)
        else:
            img, boxes, labels = self._load_raw(idx)
            target = self._rect_shapes[idx] if self._rect_shapes is not None else self.imgsz
            img, gain, (px, py) = letterbox_np(img, target)
            if len(boxes):
                boxes = boxes * gain + [px, py, px, py]
        if self.augment:
            if hyp["copy_paste"] > 0:
                img, boxes, labels = copy_paste(img, boxes, labels, rng, p=hyp["copy_paste"])
            img = hsv_jitter(img, rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
            if any(hyp.get(k, 0) for k in ("noise", "blur", "jpeg", "distort", "erasing")):
                from kuzu_torch.data.augment_extra import apply_photometric

                img = apply_photometric(img, rng, p_noise=hyp["noise"], p_blur=hyp["blur"],
                                        p_jpeg=hyp["jpeg"], p_distort=hyp["distort"],
                                        p_dropout=hyp["erasing"])
            if rng.uniform() < hyp["fliplr"]:
                img = img[:, ::-1]
                if len(boxes):
                    boxes[:, [0, 2]] = img.shape[1] - boxes[:, [2, 0]]
            if rng.uniform() < hyp["flipud"]:
                img = img[::-1]
                if len(boxes):
                    boxes[:, [1, 3]] = img.shape[0] - boxes[:, [3, 1]]
        m = self.max_boxes
        out_boxes = np.zeros((m, 4), np.float32)
        out_labels = np.zeros((m,), np.int32)
        n = min(len(boxes), m)
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
        mask = np.zeros((m,), bool)
        mask[:n] = True
        return {"image": np.ascontiguousarray(img, np.uint8), "gt_boxes": out_boxes,
                "gt_labels": out_labels, "mask_gt": mask}


def read_yolo_segments(path: Path) -> list[tuple[int, np.ndarray]]:
    """Segment-format labels, ``cls x1 y1 x2 y2 ... xn yn`` (a normalised
    polygon an instance, at least 3 points): [(cls, (n, 2) float32)]."""
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        vals = line.split()
        if len(vals) < 7:  # cls + >=3 points
            continue
        cls = int(float(vals[0]))
        pts = np.asarray(vals[1:], np.float32).reshape(-1, 2)
        out.append((cls, pts))
    return out


class YoloSegmentDataset(YoloDetectionDataset):
    """Instance-segmentation samples: polygons -> boxes and one overlap-index
    ``masks`` map an image ((S / mask_ratio)^2 int32, pixel i + 1 for
    instance i, later instances over earlier ones), filled by
    ``image_io.fill_poly`` (cv2's ``fillPoly``) from the int32 vertices
    ``(p / mask_ratio).astype(int32)``. Augmentation: HSV and the flips (no
    mosaic or warp, as JAX's)."""

    def __init__(self, *args, mask_ratio: int = 4, **kwargs):
        kwargs.setdefault("cache", False)  # polygon rows aren't (cls, xywh)
        super().__init__(*args, **kwargs)
        self.mask_ratio = mask_ratio
        self.hyp["mosaic"] = 0.0

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self._epoch * 7919 + idx) % (2**31))
        path = self.images[idx]
        img = self._decode(idx)
        h, w = img.shape[:2]
        segs = read_yolo_segments(_label_path(path))
        polys = [pts * [w, h] for _, pts in segs]
        labels = np.asarray([c for c, _ in segs], np.int32)

        img, gain, (px, py) = letterbox_np(img, self.imgsz)
        polys = [p * gain + [px, py] for p in polys]
        if self.augment:
            img = hsv_jitter(img, rng, self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"])
            if rng.uniform() < self.hyp["fliplr"]:
                img = img[:, ::-1]
                polys = [np.stack([img.shape[1] - p[:, 0], p[:, 1]], 1) for p in polys]
            if rng.uniform() < self.hyp["flipud"]:
                img = img[::-1]
                polys = [np.stack([p[:, 0], img.shape[0] - p[:, 1]], 1) for p in polys]

        boxes = np.asarray([[p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
                            for p in polys], np.float32).reshape(-1, 4)
        mh, mw = img.shape[0] // self.mask_ratio, img.shape[1] // self.mask_ratio
        mask = np.zeros((mh, mw), np.int32)
        for i, p in enumerate(polys[: self.max_boxes]):
            io.fill_poly(mask, [(p / self.mask_ratio).astype(np.int32)], i + 1)

        out = _padded(boxes, labels, self.max_boxes)
        out["image"] = np.ascontiguousarray(img, np.uint8)
        out["masks"] = mask
        return out


class YoloPoseDataset(YoloDetectionDataset):
    """Keypoint samples from ``cls cx cy w h (x y v)*K`` rows (normalised):
    ``gt_kpts`` (max_boxes, K, D) px beside the detect fields. HSV and
    fliplr only; fliplr permutes the keypoints by the spec's ``flip_idx``
    where it has one."""

    def __init__(self, *args, kpt_shape: tuple[int, int] = (17, 3), **kwargs):
        kwargs.setdefault("cache", False)  # keypoint rows parse in _load_pose
        super().__init__(*args, **kwargs)
        self.kpt_shape = tuple(self.spec.get("kpt_shape", kpt_shape))
        self.flip_idx = list(self.spec.get("flip_idx", []))
        self.hyp["mosaic"] = 0.0

    def _load_pose(self, idx: int):
        img = self._decode(idx)
        h, w = img.shape[:2]
        k, d = self.kpt_shape
        labels, boxes, kpts = [], [], []
        lp = _label_path(self.images[idx])
        if lp.exists():
            for line in lp.read_text().splitlines():
                vals = np.asarray(line.split(), np.float32)
                if len(vals) != 5 + k * d:
                    continue
                labels.append(int(vals[0]))
                cx, cy, bw, bh = vals[1:5] * [w, h, w, h]
                boxes.append([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])
                kp = vals[5:].reshape(k, d)
                kp[:, 0] *= w
                kp[:, 1] *= h
                kpts.append(kp)
        return (img, np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(labels, np.int32),
                np.asarray(kpts, np.float32).reshape(-1, k, d))

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self._epoch * 7919 + idx) % (2**31))
        img, boxes, labels, kpts = self._load_pose(idx)
        img, gain, (px, py) = letterbox_np(img, self.imgsz)
        if len(boxes):
            boxes = boxes * gain + [px, py, px, py]
            kpts[..., 0] = kpts[..., 0] * gain + px
            kpts[..., 1] = kpts[..., 1] * gain + py
        if self.augment:
            img = hsv_jitter(img, rng, self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"])
            if rng.uniform() < self.hyp["fliplr"]:
                img = img[:, ::-1]
                if len(boxes):
                    boxes[:, [0, 2]] = img.shape[1] - boxes[:, [2, 0]]
                    kpts[..., 0] = img.shape[1] - kpts[..., 0]
                    if self.flip_idx:
                        kpts = kpts[:, self.flip_idx]
        k, d = self.kpt_shape
        out = _padded(boxes, labels, self.max_boxes)
        out_kpts = np.zeros((self.max_boxes, k, d), np.float32)
        n = min(len(boxes), self.max_boxes)
        out_kpts[:n] = kpts[:n]
        out["image"] = np.ascontiguousarray(img, np.uint8)
        out["gt_kpts"] = out_kpts
        return out


def read_yolo_obb(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """OBB labels (DOTA / ultralytics), ``cls x1 y1 ... x4 y4`` normalised
    corners -> (labels (N,), rboxes (N, 5) normalised xywhr): the centre the
    corners' mean, w and h the first two edges' lengths, theta their first
    edge's float64 ``arctan2`` moved into [-pi/4, 3 pi/4)."""
    if not path.exists():
        return np.zeros((0,), np.int32), np.zeros((0, 5), np.float32)
    labels, rboxes = [], []
    for line in path.read_text().splitlines():
        vals = line.split()
        if len(vals) != 9:
            continue
        labels.append(int(float(vals[0])))
        pts = np.asarray(vals[1:], np.float32).reshape(4, 2)
        ctr = pts.mean(0)
        e1 = pts[1] - pts[0]
        e2 = pts[3] - pts[0]
        w, h = float(np.hypot(*e1)), float(np.hypot(*e2))
        r = float(np.arctan2(e1[1], e1[0]))
        while r >= 3 * np.pi / 4:  # the head's range
            r -= np.pi
        while r < -np.pi / 4:
            r += np.pi
        rboxes.append([ctr[0], ctr[1], w, h, r])
    return np.asarray(labels, np.int32), np.asarray(rboxes, np.float32)


class YoloOBBDataset(YoloDetectionDataset):
    """Oriented-box samples: corner labels -> ``gt_rboxes`` (max_boxes, 5)
    xywhr px. HSV only (a flip would have to move the angle)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("cache", False)  # corner rows aren't (cls, xywh)
        super().__init__(*args, **kwargs)
        self.hyp["mosaic"] = 0.0

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + self._epoch * 7919 + idx) % (2**31))
        img = self._decode(idx)
        h, w = img.shape[:2]
        labels, rb = read_yolo_obb(_label_path(self.images[idx]))
        rb = rb * [w, h, w, h, 1.0] if len(rb) else rb
        img, gain, (px, py) = letterbox_np(img, self.imgsz)
        if len(rb):
            rb = rb * [gain, gain, gain, gain, 1.0] + [px, py, 0, 0, 0]
        if self.augment:
            img = hsv_jitter(img, rng, self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"])
        m = self.max_boxes
        out_rb = np.zeros((m, 5), np.float32)
        out_labels = np.zeros((m,), np.int32)
        n = min(len(rb), m)
        out_rb[:n] = rb[:n]
        out_labels[:n] = labels[:n]
        vmask = np.zeros((m,), bool)
        vmask[:n] = True
        return {"image": np.ascontiguousarray(img, np.uint8), "gt_rboxes": out_rb,
                "gt_labels": out_labels, "mask_gt": vmask}


def _padded(boxes: np.ndarray, labels: np.ndarray, m: int) -> dict[str, np.ndarray]:
    """``gt_boxes`` (m, 4), ``gt_labels`` (m,) and ``mask_gt`` (m,), the
    first min(N, m) rows filled."""
    out_boxes = np.zeros((m, 4), np.float32)
    out_labels = np.zeros((m,), np.int32)
    n = min(len(boxes), m)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    mask = np.zeros((m,), bool)
    mask[:n] = True
    return {"gt_boxes": out_boxes, "gt_labels": out_labels, "mask_gt": mask}
