"""Comparison rules and the synthetic dataset shared by the parity tests and
``chip_smoke.py``.

Two runs of the detector that differ only in where bf16 rounds (the JAX
package against the port, or the card against the CPU) are held to these
rules; each function returns the numbers it decides on, so the caller can
print them beside their limits.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32(x) -> np.ndarray:
    """A torch tensor or array-like as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# Raw maps: the criteria of tests/test_yolo_infer.py:35-40. bf16 rounding and
# reassociation allow 5% relative error (relative to max(|ref|, 1)) on every
# entry and agreement within 5% on 99.9% of them.
MAP_MAX_REL = 0.05
MAP_CLOSE_SHARE = 0.999


def maps_agreement(ref, out) -> tuple[float, float]:
    """(max relative error, share of entries within atol=rtol=0.05)."""
    r, o = f32(ref), f32(out)
    if r.shape != o.shape:
        raise ValueError(f"shapes differ: {r.shape} vs {o.shape}")
    rel = float((np.abs(r - o) / np.maximum(np.abs(r), 1.0)).max())
    return rel, float(np.isclose(r, o, atol=0.05, rtol=0.05).mean())


def maps_match(ref, out) -> bool:
    rel, share = maps_agreement(ref, out)
    return rel < MAP_MAX_REL and share > MAP_CLOSE_SHARE


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) IoU of xyxy boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def detections_match(ref: dict, out: dict, min_iou: float = 0.5) -> float:
    """Share of ``ref``'s valid detections that have a detection of the same
    class with IoU >= ``min_iou`` in ``out`` (padded NMS outputs).

    Maps that differ by bf16 rounding can swap which of two overlapping
    near-equal boxes survives NMS, so detections are not compared exactly;
    such a swap still leaves a same-class match above 0.5 IoU."""
    hit = total = 0
    for b in range(f32(ref["valid"]).shape[0]):
        rv, ov = f32(ref["valid"][b]) > 0, f32(out["valid"][b]) > 0
        rb, ob = f32(ref["boxes"][b])[rv], f32(out["boxes"][b])[ov]
        rc, oc = f32(ref["classes"][b])[rv], f32(out["classes"][b])[ov]
        if len(rb) and len(ob):
            iou = iou_matrix(rb, ob) * (rc[:, None] == oc[None, :])
            hit += int((iou.max(1) >= min_iou).sum())
        total += len(rb)
    return hit / max(total, 1)


class SyntheticDetectionDataset:
    """Seeded synthetic character pages, to the ``Dataset`` protocol of
    ``kuzu_torch.data.loader``: glyph-like dark rectangles of 8-40 px on a
    light page, 100-300 per 640x640 image (scaled by area at other sizes, at
    least one), so the assigner sees a character page's number of GTs.

    Sample ``i`` is drawn from ``seed`` and ``i`` alone: ``image`` uint8
    (imgsz, imgsz, 3), ``gt_boxes`` (max_boxes, 4) xyxy px, ``gt_labels``
    (max_boxes,) int32 and ``mask_gt`` (max_boxes,) bool, zero-padded."""

    def __init__(self, n: int, imgsz: int = 640, max_boxes: int = 400, nc: int = 1,
                 seed: int = 0, boxes: tuple[int, int] = (100, 300),
                 size: tuple[int, int] = (8, 40)):
        self.n, self.imgsz, self.max_boxes, self.nc, self.seed = n, imgsz, max_boxes, nc, seed
        frac = (imgsz / 640) ** 2
        self.boxes = (max(1, round(boxes[0] * frac)), max(1, round(boxes[1] * frac)))
        self.size = (size[0], min(size[1], imgsz // 2))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        s = self.imgsz
        img, drawn = glyph_page(rng, (s, s), self.boxes, self.size, max_boxes=self.max_boxes)
        k = len(drawn)
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros((self.max_boxes,), np.int32)
        mask = np.zeros((self.max_boxes,), bool)
        boxes[:k] = drawn
        labels[:k] = rng.integers(0, self.nc, k)
        mask[:k] = True
        return {"image": img, "gt_boxes": boxes, "gt_labels": labels, "mask_gt": mask}



def synthetic_texts(n: int, chars: str, max_chars: int, seed: int = 0,
                    min_chars: int = 1) -> list[str]:
    """``n`` seeded texts of ``min_chars``-``max_chars`` characters drawn
    from ``chars``: the recognize trainer's labels and the LM's corpus."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_chars, max_chars + 1, n)
    return ["".join(chars[j] for j in rng.integers(0, len(chars), m)) for m in lens]


class SyntheticLineDataset:
    """Seeded decoded column crops with their texts, to the recognize and
    CTC trainers' dataset protocol: ``image`` uint8 (H, W, 3), light paper
    with one dark block per character, top to bottom (the gray level and
    width from the character's id), and ``tokens`` (max_length,) int32, the
    text encoded by ``tokenizer`` with BOS, EOS and padding; with
    ``max_boxes`` also ``boxes`` (max_boxes, 4) f32, the first blocks' xyxy
    px, zero-padded, and ``num_boxes`` int32 (the CRNN's box head)."""

    def __init__(self, texts: list[str], tokenizer, image_size=(1024, 64),
                 max_length: int = 128, seed: int = 0, max_boxes: int = 0):
        self.texts, self.tokenizer = texts, tokenizer
        self.h, self.w = int(image_size[0]), int(image_size[1])
        self.max_length, self.seed, self.max_boxes = max_length, seed, max_boxes

    def __len__(self) -> int:
        return len(self.texts)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        img = rng.integers(215, 250, (self.h, self.w, 3), dtype=np.uint8)
        tokens = self.tokenizer.encode(self.texts[i], max_length=self.max_length)
        ids = tokens[1:][(tokens[1:] >= 5)]  # the characters that fit
        cell = max(self.h // max(len(ids), 1), 1)
        boxes = []
        for j, t in enumerate(ids):
            w = self.w // 4 + int(t) % (self.w // 2)
            x0 = (self.w - w) // 2
            y0, y1 = j * cell + cell // 8, (j + 1) * cell - cell // 8
            img[y0:y1, x0:x0 + w] = 10 + int(t) * 37 % 80
            boxes.append((x0, y0, x0 + w, y1))
        out = {"image": img, "tokens": tokens}
        if self.max_boxes:
            n = min(len(boxes), self.max_boxes)
            out["boxes"] = np.zeros((self.max_boxes, 4), np.float32)
            out["boxes"][:n] = np.asarray(boxes[:n], np.float32).reshape(-1, 4)
            out["num_boxes"] = np.int32(n)
        return out


def column_pages(n: int, size: int, seed: int = 0) -> np.ndarray:
    """Seeded synthetic manuscript pages for the cascade, (n, size, size, 3)
    uint8 RGB: warm paper with grain, and right to left vertical columns of
    dark glyph blocks (a column every ~size/16 px, glyphs 0.55-0.95 of the
    column's width tall with gaps between them, a column at times split in
    two segments), drawn from one ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)

    def ints(lo: int, hi: int, shape=()) -> np.ndarray:  # in [lo, hi]
        return torch.randint(lo, hi + 1, shape, generator=g).numpy()

    pages = np.empty((n, size, size, 3), np.uint8)
    pitch = max(size // 16, 12)
    col_w = max(pitch * 5 // 8, 6)
    for i in range(n):
        page = ints(225, 250, (size, size, 1)) - ints(0, 12, (1, 1, 3))  # paper tint
        x = size - pitch
        while x - col_w > pitch // 2:
            y, y_end = int(ints(size // 32, size // 8)), size - int(ints(size // 32, size // 6))
            split = int(ints(0, 3)) == 0
            gap_at = int(ints(size // 3, 2 * size // 3))
            while y < y_end:
                h = max(int(col_w * (0.55 + 0.4 * float(torch.rand((), generator=g)))), 3)
                if y + h > y_end:
                    break
                if not (split and gap_at <= y < gap_at + 2 * col_w):
                    w = col_w - int(ints(0, col_w // 4))
                    page[y:y + h, x - w:x] = ints(15, 90)  # ink
                y += h + int(ints(1, max(col_w // 5, 1)))
            x -= pitch
        pages[i] = page.clip(0, 255).astype(np.uint8)
    return pages


def mixed_pages(shapes: list[tuple[int, int]], seed: int = 0) -> list[np.ndarray]:
    """Seeded synthetic pages of the given (H, W) shapes, uint8 RGB: page i
    is the top-left (H, W) of a ``column_pages`` page of side max(H, W)
    drawn from ``seed + i``."""
    return [np.ascontiguousarray(column_pages(1, max(h, w), seed=seed + i)[0][:h, :w])
            for i, (h, w) in enumerate(shapes)]


def page_files(root, pages, paeth: tuple[int, ...] = ()) -> list:
    """Write ``pages`` (uint8 (H, W, 3) RGB) as ``page{i:02d}.png`` under
    ``root`` with ``image_io.write_png``: filter Sub, Paeth for the indices
    in ``paeth``. Returns the paths in order."""
    from pathlib import Path

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    return [write_png(root / f"page{i:02d}.png", np.asarray(p),
                      filter="paeth" if i in paeth else "sub")
            for i, p in enumerate(pages)]


def glyph_page(rng: np.random.Generator, hw: tuple[int, int], n_boxes: tuple[int, int],
               size: tuple[int, int] = (8, 40),
               max_boxes: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A light page of (H, W) (paper and grain) with dark glyph-like
    rectangles of ``size`` px a side (at most half the page's side), their
    count drawn in ``n_boxes`` (then cut to ``max_boxes``): (uint8 (H, W,
    3), xyxy px (k, 4) f32)."""
    h, w = hw
    img = rng.integers(215, 250, (h, w, 3), dtype=np.uint8)
    k = int(rng.integers(n_boxes[0], n_boxes[1] + 1))
    k = k if max_boxes is None else min(k, max_boxes)
    wh = rng.integers(size[0], min(size[1], h // 2, w // 2) + 1, (k, 2))
    x1 = (rng.random(k) * (w - wh[:, 0])).astype(np.int64)
    y1 = (rng.random(k) * (h - wh[:, 1])).astype(np.int64)
    for j in range(k):
        img[y1[j]:y1[j] + wh[j, 1], x1[j]:x1[j] + wh[j, 0]] = rng.integers(10, 90)
    boxes = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], 1).astype(np.float32)
    return img, boxes


def write_yolo_folder(root, counts: dict, hw=(120, 160), n_boxes=(3, 12), size=(8, 40),
                      nc: int = 1, seed: int = 0, shapes: list | None = None,
                      workers: int = 1):
    """A seeded YOLO folder under ``root``: ``images/<split>/im{i:03d}.png``
    (``image_io.write_png``) of glyph pages (:func:`glyph_page`), their
    labels ``labels/<split>/im{i:03d}.txt`` (class, cx, cy, w, h normalized)
    and ``dataset.yaml``; ``counts`` maps a split to its image count,
    ``shapes`` (optional) gives the images' (H, W) in turn. The pages are
    drawn in order, their PNGs written by ``workers`` threads. Returns the
    yaml's path."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import yaml

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    k = 0
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        pending = []
        for split, n in counts.items():
            (root / "images" / split).mkdir(parents=True, exist_ok=True)
            (root / "labels" / split).mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = shapes[k % len(shapes)] if shapes else hw
                k += 1
                img, boxes = glyph_page(rng, (h, w), n_boxes, size)
                cls = rng.integers(0, nc, len(boxes))
                pending.append(pool.submit(write_png, root / "images" / split / f"im{i:03d}.png",
                                           img))
                cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2 / w, (boxes[:, 1] + boxes[:, 3]) / 2 / h
                bw, bh = (boxes[:, 2] - boxes[:, 0]) / w, (boxes[:, 3] - boxes[:, 1]) / h
                (root / "labels" / split / f"im{i:03d}.txt").write_text("".join(
                    f"{c} {a:.6f} {b:.6f} {d:.6f} {e:.6f}\n"
                    for c, a, b, d, e in zip(cls, cx, cy, bw, bh)))
        for f in pending:
            f.result()
    spec = {"path": ".", "train": "images/train", "val": "images/val",
            "names": {i: f"c{i}" for i in range(nc)}}
    (root / "dataset.yaml").write_text(yaml.safe_dump(spec))
    return root / "dataset.yaml"


COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def head_sample(rng: np.random.Generator, task: str, hw: tuple[int, int], n_inst: tuple[int, int],
                nc: int = 1, kpt_shape: tuple[int, int] = (17, 3)) -> tuple[np.ndarray, list[str]]:
    """One seeded page of (H, W) for the ``segment``, ``pose`` or ``obb``
    task and its label rows (normalised): dark polygons of 3-8 vertices
    about a centre (some concave; segment), glyph boxes with ``kpt_shape``
    keypoints inside them, visibility 0-2 (pose), or rotated rectangles at
    any angle (obb), each drawn with ``image_io.fill_poly``."""
    from kuzu_torch.data.image_io import fill_poly

    h, w = hw
    img = rng.integers(215, 250, (h, w, 3), dtype=np.uint8)
    k = int(rng.integers(n_inst[0], n_inst[1] + 1))
    rows = []
    for _ in range(k):
        c = int(rng.integers(0, nc))
        r = rng.uniform(0.06, 0.2) * min(h, w)
        cx, cy = rng.uniform(r, w - r), rng.uniform(r, h - r)
        if task == "obb":
            bw, bh, th = 2 * r, rng.uniform(0.4, 1.0) * r, rng.uniform(-np.pi, np.pi)
            u = np.array([np.cos(th), np.sin(th)]) * bw / 2
            v = np.array([-np.sin(th), np.cos(th)]) * bh / 2
            pts = np.stack([-u - v, u - v, u + v, -u + v]) + [cx, cy]
        elif task == "segment":
            n = int(rng.integers(3, 9))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = r * rng.uniform(0.4, 1.0, n)
            pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        else:
            pts = np.array([[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r], [cx - r, cy + r]])
        fill_poly(img[..., 0], [pts.astype(np.int32)], int(rng.integers(10, 90)))
        img[..., 1] = np.minimum(img[..., 1], img[..., 0])
        if task == "pose":
            kk, d = kpt_shape
            kp = np.stack([rng.uniform(cx - r, cx + r, kk) / w, rng.uniform(cy - r, cy + r, kk) / h],
                          1)
            vals = [f"{c} {cx / w:.6f} {cy / h:.6f} {2 * r / w:.6f} {2 * r / h:.6f}"]
            for j in range(kk):
                vals.append(f"{kp[j, 0]:.6f} {kp[j, 1]:.6f}"
                            + (f" {int(rng.integers(0, 3))}" if d == 3 else ""))
            rows.append(" ".join(vals))
        else:
            rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts))
    return img, rows


def write_head_folder(root, task: str, counts: dict, hw=(120, 160), n_inst=(2, 6), nc: int = 1,
                      seed: int = 0, kpt_shape: tuple[int, int] = (17, 3)):
    """A seeded YOLO folder of :func:`head_sample` pages for ``task``
    (``images/<split>/im{i:03d}.png``, ``labels/<split>/im{i:03d}.txt``,
    ``dataset.yaml``; a pose folder's yaml carries ``kpt_shape`` and
    ``flip_idx``). Returns the yaml's path."""
    from pathlib import Path

    import yaml

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, rows = head_sample(rng, task, hw, n_inst, nc, kpt_shape)
            write_png(root / "images" / split / f"im{i:03d}.png", img)
            (root / "labels" / split / f"im{i:03d}.txt").write_text("\n".join(rows) + "\n")
    spec = {"path": ".", "train": "images/train", "val": "images/val",
            "names": {i: f"c{i}" for i in range(nc)}, "nc": nc}
    if task == "pose":
        kk = kpt_shape[0]
        spec["kpt_shape"] = list(kpt_shape)
        spec["flip_idx"] = COCO_FLIP_IDX if kk == 17 else list(range(kk))[::-1]
    (root / "dataset.yaml").write_text(yaml.safe_dump(spec))
    return root / "dataset.yaml"


def write_glyph_folder(root, splits: dict, n_classes: int = 4, hw=(40, 52), seed: int = 0):
    """A seeded glyph folder, ``root/<split>/c{j}/g{i:03d}.png`` (``splits``
    maps a split to its images a class), each class a dark block at its own
    place and gray on a light page, so that a classifier can learn them."""
    from pathlib import Path

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in splits.items():
        for j in range(n_classes):
            d = root / split / f"c{j}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                img = rng.integers(200, 250, (h, w, 3), dtype=np.uint8)
                y0 = (j * h // (2 * n_classes) + int(rng.integers(0, 3))) % (h // 2)
                img[y0:y0 + h // 2, w // 4:3 * w // 4] = 20 + 40 * (j % 4)
                write_png(d / f"g{i:03d}.png", img)
    return root


def line_crop(rng: np.random.Generator, text_ids, hw: tuple[int, int]) -> np.ndarray:
    """A light column crop of (H, W) with one dark block per character id,
    top to bottom (the gray level and width from the id)."""
    h, w = hw
    img = rng.integers(215, 250, (h, w, 3), dtype=np.uint8)
    cell = max(h // max(len(text_ids), 1), 1)
    for j, t in enumerate(text_ids):
        bw = w // 4 + int(t) % max(w // 2, 1)
        x0 = (w - bw) // 2
        img[j * cell + cell // 8:(j + 1) * cell - cell // 8, x0:x0 + bw] = 10 + int(t) * 37 % 80
    return img


def write_column_csv(root, texts: list[str], hw=((120, 200), (24, 40)), seed: int = 0):
    """A seeded ``column_info.csv`` under ``root`` (``column_image`` relative
    paths, ``unicode_ids`` as ``U+XXXX`` words) over PNG crops of
    :func:`line_crop`, each's H and W drawn in the ranges ``hw``. Returns the
    CSV's path."""
    import csv
    from pathlib import Path

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    (root / "crops").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i, text in enumerate(texts):
        h, w = int(rng.integers(*hw[0])), int(rng.integers(*hw[1]))
        write_png(root / "crops" / f"c{i:04d}.png", line_crop(rng, [ord(c) for c in text], (h, w)))
        rows.append((f"crops/c{i:04d}.png", " ".join(f"U+{ord(c):04X}" for c in text)))
    path = root / "column_info.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("column_image", "unicode_ids"), *rows])
    return path


def write_oneline_folder(root, splits: dict, hw=((120, 200), (24, 40)), seed: int = 0,
                         books: int = 2, boxes: bool = False):
    """A seeded one-line folder under ``root``: per split (``splits`` maps it
    to its texts) ``{split}/images/book{b}/l{i:03d}.png`` crops of
    :func:`line_crop` with ``labels/book{b}/l{i:03d}.txt``, and with
    ``boxes`` ``bounding_boxes/book{b}/l{i:03d}.json`` (the blocks' xyxy,
    every third file missing). Returns ``root``."""
    import json
    from pathlib import Path

    from kuzu_torch.data.image_io import write_png

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, texts in splits.items():
        for i, text in enumerate(texts):
            book = f"book{i % books}"
            for d in ("images", "labels", "bounding_boxes"):
                (root / split / d / book).mkdir(parents=True, exist_ok=True)
            h, w = int(rng.integers(*hw[0])), int(rng.integers(*hw[1]))
            write_png(root / split / "images" / book / f"l{i:03d}.png",
                      line_crop(rng, [ord(c) for c in text], (h, w)))
            (root / split / "labels" / book / f"l{i:03d}.txt").write_text(text + "\n",
                                                                           encoding="utf-8")
            if boxes and i % 3:
                cell = h // max(len(text), 1)
                bx = [[2, j * cell, w - 2, (j + 1) * cell] for j in range(len(text))]
                (root / split / "bounding_boxes" / book / f"l{i:03d}.json").write_text(
                    json.dumps(bx))
    return root


@torch.no_grad()
def calibrate_batch_norm(module: torch.nn.Module, images) -> None:
    """Set every BatchNorm's running statistics in ``module`` (a
    ``YoloGraph`` or a ``CRNN``) to those of one batch: a train-mode forward
    on ``images``. At init the statistics are the identity and a seeded
    network's activations shrink with depth: a detector then scores every
    anchor sigmoid(-4.6), a recognizer's logits barely depend on the crop.
    Calibrated, the activations stay O(1), and the scores and texts depend
    on the input as a trained network's do. A ``YoloDetector`` refolds
    after it (``det.load_state_dict(det.graph.state_dict())``, or
    :func:`box_head`)."""
    from kuzu_torch.models.yolo import modules

    bns = [m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    old = modules.BN_MOMENTUM, [m.momentum for m in bns]
    modules.BN_MOMENTUM = 0.0  # the flax BatchNorm of YoloGraph: 0 * running + 1 * batch
    for m in bns:
        m.momentum = 1.0  # nn.BatchNorm2d: (1 - 1) * running + 1 * batch
    try:
        module.train()
        module(images)
    finally:
        modules.BN_MOMENTUM = old[0]
        for m, mom in zip(bns, old[1]):
            m.momentum = mom
        module.eval()


@torch.no_grad()
def box_head(detector, ltrb: tuple[int, int, int, int]):
    """Set a ``YoloDetector``'s Detect biases, then refold; returns the
    detector. The box biases make every anchor's DFL distances ``ltrb``
    bins (a stand-in for a trained head: tall thin columns, small
    characters); the class biases are set to flax's init, -4.6, as the
    seeded init has them, so that at init every anchor scores
    sigmoid(-4.6) on any device."""
    from kuzu_torch.models.yolo.modules import Detect

    rm = detector.spec.reg_max
    for m in detector.graph.modules():
        if isinstance(m, Detect):
            for i in range(m.nl):
                bias = getattr(m, f"box{i}_2").bias.view(4, rm)
                bias.fill_(-8.0)
                bias[torch.arange(4), torch.tensor(ltrb)] = 8.0
                getattr(m, f"cls{i}_2").bias.fill_(-4.6)
    return detector.load_state_dict(detector.graph.state_dict())

# Attention in bf16 (K3, K5): both sides are f32 arithmetic rounded once to
# bf16, but the kernel sums in another order, runs an online softmax over
# 64-key tiles and feeds P to the tensor cores as one bf16 part, so a sum on
# a rounding edge flips an ulp: two ulps of the largest output plus one of
# the value. At N=400 the outputs are ~0.05 in size, so an absolute 1e-2
# would let a kernel that skips its last key tile pass; this does not.
ATTN_TOL = "2^-7 max|ref| + 2^-8|ref|"


def attention_over(out, ref) -> tuple[float, int, int]:
    """(max abs error, entries over ``ATTN_TOL``, entries) of ``out``
    against ``ref`` (torch tensors of one shape)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    tol = 2.0**-7 * float(r.abs().max()) + 2.0**-8 * r.abs()
    return float(err.max()), int((err > tol).sum()), err.numel()


# Attention in f32 (K3's f32 route; K5's f32 path keeps its own absolute
# 2e-5): the kernel's f32 FMAs sum in another order than the plain
# version's products (TF32 off on both) and its softmax is online over
# 64-key tiles, so the two part by f32 rounding grown over hd- and N-term
# sums: 2e-5 of the output's scale (O(1) for unit-normal inputs; the
# encoder's own inputs are held relative to their largest output).
ATTN_F32_TOL = "2e-5 max(1, max|ref|)"


def attention_f32_over(out, ref) -> tuple[float, int, int]:
    """(max abs error, entries over ``ATTN_F32_TOL``, entries) of ``out``
    against ``ref``."""
    err = (out.float() - ref.float()).abs()
    tol = 2e-5 * max(1.0, float(ref.float().abs().max()))
    return float(err.max()), int((err > tol).sum()), err.numel()


def attention_exact(q, k, v, num_heads: int, scale: float, p_bf16: bool = False):
    """softmax(scale q_h k_h^T) v_h over head-packed (G, N, C) tensors in f32
    with one maximum over all keys, rounded once to q's dtype: the function
    both kernels compute. ``p_bf16`` rounds P to bf16 before P V (reported
    beside the tolerance, not a fault: it is what the kernel does)."""
    import torch

    g, n, c = q.shape
    hd = c // num_heads
    outs = []
    for i in range(0, g, 4):  # 4 groups at a time: N x N in f32

        def heads(t):
            return t[i:i + 4].float().reshape(-1, t.shape[1], num_heads, hd).transpose(1, 2)

        s = (heads(q) * scale) @ heads(k).transpose(-1, -2)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        o = (pv @ heads(v)) / p.sum(-1, keepdim=True)
        outs.append(o.transpose(1, 2).reshape(-1, n, c))
    return torch.cat(outs).to(q.dtype)


def attention_faults(q, k, v, num_heads: int, keys: int = 64) -> dict:
    """Outputs of kernels with a fault, each computed exactly (f32, rounded
    once to q's dtype) on the inputs of a check, keyed by the fault; each
    must exceed ``ATTN_TOL`` against the sound output:

    - the last key tile (``keys`` keys, or the ragged rest of N) skipped;
    - each head's columns read one head over (the last head wraps to the
      first; only where there is more than one head);
    - the scale of a head padded to the TPU's 128 lanes, 128^-1/2, in place
      of hd^-1/2 (where hd < 128)."""
    import torch

    n, c = q.shape[1], q.shape[2]
    hd = c // num_heads
    scale = hd**-0.5
    last = (n - 1) // keys * keys  # first key of the last tile
    out = {"last key tile skipped": attention_exact(q, k[:, :last], v[:, :last], num_heads,
                                                    scale)}
    if num_heads > 1:
        def shift(t):
            return torch.roll(t, -hd, dims=-1)

        # head h's output columns hold head h + 1's attention
        out["head columns read one head over"] = attention_exact(shift(q), shift(k), shift(v),
                                                                 num_heads, scale)
    if hd < 128:
        out["padded scale 128^-1/2"] = attention_exact(q, k, v, num_heads, 128**-0.5)
    return out


# Area-attention backward in bf16 (K4): both sides are f32 arithmetic
# rounded once to bf16; the kernels sum in another order and feed P and dS
# to the tensor cores as two bf16 parts (~16 significant bits), so they stay
# one bf16 rounding (2^-8 relative) apart, plus f32-size absolute noise where
# a sum cancels. Per tensor:
BWD_TOL = "1e-2 |ref| + 1e-3 max|ref|"


def bwd_over(out, ref) -> tuple[float, int]:
    """(max abs error, entries over ``BWD_TOL``) of ``out`` against ``ref``."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    tol = 1e-2 * r.abs() + 1e-3 * float(r.abs().max())
    return float(err.max()), int((err > tol).sum())


# Area-attention backward in f32 (K4's f32 route): the kernels' f32 FMAs sum
# in another order than the plain version's products (TF32 off on both), and
# both take P from the forward's lse (exp2 of an f32 difference), so the two
# part by f32 rounding grown over the N- and hd-term sums of dQ, dK, dV:
# 2e-5 of each tensor's largest entry.
BWD_F32_TOL = "2e-5 max|ref|"


def bwd_f32_over(out, ref) -> tuple[float, int]:
    """(max abs error, entries over ``BWD_F32_TOL``) of ``out`` against
    ``ref``."""
    err = (out.float() - ref.float()).abs()
    return float(err.max()), int((err > 2e-5 * float(ref.float().abs().max())).sum())


# K4 f32 on a path's own inputs whose gradient sums cancel (dQ of attention
# over many near-identical tokens, blank page patches in SAM2's encoder:
# dQ_i = scale sum_j dS_ij K_j with sum_j dS_ij = 0): there the plain f32
# version's own rounding takes much of BWD_F32_TOL, and a 3xTF32 product's
# unit roundoff is 4x f32's (the lo x lo term dropped: 2^-22 against
# 2^-24). A tensor over BWD_F32_TOL is then held against the same
# arithmetic in f64 (attention_bwd_f64): the kernel's largest error no more
# than BWD_F32_COND times the plain f32 version's, and every planted fault
# farther than that (or over BWD_F32_TOL in another tensor).
BWD_F32_COND = 4.0


def attention_bwd_f64(q, k, v, do, num_heads: int, out, lse):
    """(dq, dk, dv) in f64 by ``area_attention_bwd_plain``'s arithmetic on
    the same inputs: P = exp2(log2(e) S - lse) from the forward's base-2
    ``lse``, D = rowsum(dO o out) from its ``out``."""
    g, n, c = q.shape
    hd = c // num_heads
    scale = hd**-0.5

    def heads(t):
        return t.double().reshape(g, n, num_heads, hd).transpose(1, 2)

    qh, kh, vh, doh = heads(q) * scale, heads(k), heads(v), heads(do)
    p = torch.exp2(qh @ kh.transpose(-1, -2) / math.log(2.0) - lse.double()[..., None])
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * heads(out)).sum(-1, keepdim=True))

    def back(t):
        return t.transpose(1, 2).reshape(g, n, c)

    return back((ds @ kh) * scale), back(ds.transpose(-1, -2) @ qh), \
        back(p.transpose(-1, -2) @ doh)


def attention_bwd_exact(q, k, v, do, num_heads: int, lse=None, *, tile: int = 64,
                        skip_last_query_tile: bool = False, d_zero: bool = False,
                        dq_scale: bool = True, one_part: bool = False,
                        d_from_out: bool = False):
    """(dq, dk, dv) of area attention over head-packed (G, N, C) tensors in
    f32, each rounded once to q's dtype: the function K4 computes, with P the
    softmax of S or, given ``lse`` (base 2, (G, heads, N)), exp2(log2(e) S -
    lse). The flags compute what a kernel with a fault (or another design)
    would: the last ``tile`` query rows left out of dK and dV; D taken as 0;
    dQ without ``scale``; P and dS rounded to one bf16 part before their
    products; D = rowsum(dO o O) from the output O rounded to one bf16 part
    (the kernels take it from two)."""
    import torch

    g, n, c = q.shape
    hd = c // num_heads
    scale = hd**-0.5
    last = (n - 1) // tile * tile  # first query of the last tile
    outs = ([], [], [])
    for i in range(0, g, 4):  # 4 groups at a time: N x N in f32

        def heads(t):
            return t[i:i + 4].float().reshape(-1, n, num_heads, hd).transpose(1, 2)

        qh, kh, vh, doh = (heads(t) for t in (q, k, v, do))
        s = (qh * scale) @ kh.transpose(-1, -2)
        if lse is None:
            p = torch.softmax(s, dim=-1)
        else:
            p = torch.exp2(s * (1.0 / math.log(2.0)) - lse[i:i + 4].float()[..., None])
        dp = doh @ vh.transpose(-1, -2)
        if d_zero:
            d = 0.0
        elif d_from_out:
            d = (doh * (p @ vh).to(q.dtype).float()).sum(-1, keepdim=True)
        else:
            d = (dp * p).sum(-1, keepdim=True)
        ds = p * (dp - d)
        if one_part:
            p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        dq = (ds @ kh) * (scale if dq_scale else 1.0)
        if skip_last_query_tile:
            p, ds = p.clone(), ds.clone()
            p[..., last:, :] = 0.0
            ds[..., last:, :] = 0.0
        dk = (ds.transpose(-1, -2) @ qh) * scale
        dv = p.transpose(-1, -2) @ doh
        for acc, t in zip(outs, (dq, dk, dv)):
            acc.append(t.transpose(1, 2).reshape(-1, n, c))
    return tuple(torch.cat(t).to(q.dtype) for t in outs)


def attention_bwd_faults(q, k, v, do, num_heads: int, lse) -> dict:
    """Outputs (dq, dk, dv) of backward kernels with a fault, each computed
    exactly (:func:`attention_bwd_exact`), keyed by the fault; each must put
    one of its tensors over ``BWD_TOL`` against the sound output: the last
    query tile skipped in dK and dV; D taken as 0; a stale lse (another
    group's row statistics); dQ without ``scale``."""
    import torch

    return {
        "last query tile skipped in dK/dV": attention_bwd_exact(
            q, k, v, do, num_heads, lse, skip_last_query_tile=True),
        "D taken as 0": attention_bwd_exact(q, k, v, do, num_heads, lse, d_zero=True),
        "stale lse (another group's)": attention_bwd_exact(
            q, k, v, do, num_heads, torch.roll(lse, 1, dims=0)),
        "dQ without scale": attention_bwd_exact(q, k, v, do, num_heads, lse, dq_scale=False),
    }


# 3xTF32 (K3's and K4's f32 kernels on the tensor cores): every operand of a
# product split into two TF32 parts, hi + lo, and three TF32 products summed.
# The emulations below take each product exactly (a TF32 x TF32 product fits
# in f32) and sum in f32, as the tensor core does up to its order of sums;
# with ``passes=1`` only hi x hi, plain TF32, which the f32 tolerances must
# reject. No kernel or model calls them: the tests and chip_smoke.py's
# planted faults do.


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``x`` as the kernels split it: hi =
    cvt.rna.tf32.f32(x), rounded to nearest (ties away from zero) to TF32's
    10 mantissa bits, and lo the same rounding of x - hi (exact in f32)."""

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b in f32 from TF32 parts: lo hi + hi lo + hi hi (the cross terms
    first, as the kernels issue them) with ``passes=3``, hi hi alone with
    ``passes=1``."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _tf32_heads(t, num_heads: int):
    g, n, c = t.shape
    return t.float().reshape(g, n, num_heads, c // num_heads).transpose(1, 2)  # (G, H, N, hd)


def _tf32_back(t):
    g, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(g, n, h * hd)


def attention_tf32(q, k, v, num_heads: int, passes: int = 3):
    """``area_attention``'s f32 function with its two products taken as
    :func:`tf32_matmul` (q scaled first, exact softmax): (out, lse) with the
    base-2 log-sum-exp (G, heads, N) of the scaled scores."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    s = tf32_matmul(_tf32_heads(q, num_heads) * scale,
                    _tf32_heads(k, num_heads).transpose(-1, -2), passes)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = tf32_matmul(p, _tf32_heads(v, num_heads), passes) / p.sum(-1, keepdim=True)
    return _tf32_back(o), torch.logsumexp(s, dim=-1) / math.log(2.0)


def attention_bwd_tf32(q, k, v, do, num_heads: int, passes: int = 3):
    """(dq, dk, dv) of area attention in f32 with its five products taken
    as :func:`tf32_matmul`, the way K4's f32 kernels take them: P from the
    (emulated) forward's base-2 lse, D = rowsum(dO o O) from its output."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    out, lse = attention_tf32(q, k, v, num_heads, passes)
    qh = _tf32_heads(q, num_heads) * scale
    kh, vh, doh = (_tf32_heads(t, num_heads) for t in (k, v, do))
    s = tf32_matmul(qh, kh.transpose(-1, -2), passes)
    p = torch.exp2(s * (1.0 / math.log(2.0)) - lse[..., None])
    dp = tf32_matmul(doh, vh.transpose(-1, -2), passes)
    ds = p * (dp - (doh * _tf32_heads(out, num_heads)).sum(-1, keepdim=True))
    dq = tf32_matmul(ds, kh, passes) * scale
    dk = tf32_matmul(ds.transpose(-1, -2), qh, passes)
    dv = tf32_matmul(p.transpose(-1, -2), doh, passes)
    return _tf32_back(dq), _tf32_back(dk), _tf32_back(dv)


# The fused ABlock (K2) in bf16: the same rounding points on both sides; an
# f32 sum on a bf16 rounding edge flips one ulp of an intermediate, which the
# O(1)-O(10) residual stream carries: every entry within 0.08 + 0.02|ref|,
# and 99.9% within 0.02 + 0.01|ref| (tests/test_yolo_infer.py's criteria).
ABLOCK_TOL = "0.08 + 0.02|ref|, and > 0.999 within 0.02 + 0.01|ref|"
# Where the residual stream is larger than the output (an entry whose
# x + attn and MLP terms cancel), one flipped ulp of such a term is larger
# than the output's: there the first bound takes s, the largest magnitude
# among the values whose bf16 rounding reaches the entry (ablock_exact's
# ``scale``), in place of |ref|.
ABLOCK_SCALED_TOL = "0.08 + 0.02 max(|ref|, s), and > 0.999 within 0.02 + 0.01|ref|"


def ablock_over(out, ref, scale=None) -> tuple[float, int, float]:
    """(max abs error, entries over 0.08 + 0.02|ref|, share within 0.02 +
    0.01|ref|) of ``out`` against ``ref``; within ``ABLOCK_TOL`` when the
    count is 0 and the share above 0.999. With ``scale`` (s), the count is
    of entries over 0.08 + 0.02 max(|ref|, s): ``ABLOCK_SCALED_TOL``."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    big = r.abs() if scale is None else r.abs().maximum(scale.float())
    over = int((err > 0.08 + 0.02 * big).sum())
    return float(err.max()), over, float((err <= 0.02 + 0.01 * r.abs()).float().mean())


def ablock_exact(x, v, pe, weights, area: int, heads: int, *, bias: bool = True,
                 silu: bool = True, use_pe: bool = True, residual: bool = True,
                 scale: bool = False):
    """The fused ABlock with the reference's bf16 rounding points
    (``kuzu/ops/fused_ablock.py:52-85``): f32 products of bf16 operands,
    every intermediate rounded where the reference rounds it. The flags
    compute what a kernel with a fault in an epilogue would: every bias
    dropped; SiLU skipped; pe not added to the attention output; both
    residual adds dropped. With ``scale``, per output entry the largest
    magnitude among x, the attention branch, x + attn, the MLP branch and
    the output (f32), in place of the output."""
    import torch

    wqk, bqk, wp, bp, w1, b1, w2, b2 = weights
    b_, n, c = x.shape
    g, na, hd, dt = b_ * area, n // area, c // heads, x.dtype

    def mm(a, w, b):
        return a.float() @ w.float() + (b if bias else 0.0)

    xs = x.reshape(g, na, c)
    qk = mm(xs, wqk, bqk).to(dt)

    def split(t):  # (G', na, C) -> (G', H, na, hd)
        return t.float().reshape(t.shape[0], na, heads, hd).transpose(1, 2)

    outs = []
    for i in range(0, g, 4):  # 4 chunks at a time: na x na in f32
        s = (split(qk[i:i + 4, :, :c]) * hd**-0.5) @ split(qk[i:i + 4, :, c:]).transpose(-1, -2)
        o = (torch.softmax(s, dim=-1) @ split(v.reshape(g, na, c)[i:i + 4])).to(dt)
        outs.append(o.transpose(1, 2).reshape(-1, na, c))
    o = torch.cat(outs)
    a = o + pe.reshape(g, na, c) if use_pe else o
    attn = mm(a, wp, bp).to(dt)
    x1 = xs + attn if residual else attn
    y = mm(x1, w1, b1)
    hmid = (y * torch.sigmoid(y) if silu else y).to(dt)
    y2 = mm(hmid, w2, b2).to(dt)
    out = x1 + y2 if residual else y2
    if scale:
        out = torch.stack([t.float().abs() for t in (xs, attn, x1, y2, out)]).amax(0)
    return out.reshape(b_, n, c)


def ablock_faults(x, v, pe, weights, area: int, heads: int) -> dict:
    """Outputs of fused-ABlock kernels with a fault in an epilogue, each
    computed by :func:`ablock_exact`, keyed by the fault; each must fall
    outside ``ABLOCK_TOL`` against the sound output."""
    return {name: ablock_exact(x, v, pe, weights, area, heads, **{flag: False})
            for name, flag in (("bias dropped", "bias"), ("SiLU skipped", "silu"),
                               ("pe not added", "use_pe"), ("residual dropped", "residual"))}
