"""The recognizers' image-file data (counterpart of
``kuzu/data/ocr_datasets.py``): the crop reader ``load_letterboxed``, the
``column_info.csv`` dataset, the one-line folder dataset and the tokenizer
built from them.

PIL's decode and ``BILINEAR`` resize are reproduced to the byte by
``image_io`` (``imread_rgb(backend="pil")``, ``resize_pil_bilinear_u8``), and
the CSV is read with the standard library as pandas reads it, so neither
PIL nor pandas is needed. Augmented samples draw from the reference's
per-sample generator, ``(seed 1_000_003 + epoch 7919 + idx) mod 2^31``.
"""

from __future__ import annotations

import csv
import json
import re
from pathlib import Path

import numpy as np
import torch

from kuzu_torch.data.image_io import imread_rgb, resize_pil_bilinear_u8
from kuzu_torch.data.loader import next_bucket, one_thread
from kuzu_torch.data.tokenizer import CharTokenizer, decode_unicode_ids

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _decoded(path) -> np.ndarray:
    if isinstance(path, np.ndarray):
        return path
    if hasattr(path, "convert") and hasattr(path, "size"):  # a PIL image
        return np.array(path.convert("RGB"))
    return imread_rgb(path, backend="pil")


def load_letterboxed(
    path: str | Path | np.ndarray,
    out_h: int,
    out_w: int,
    fill: int = 255,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Read -> aspect resize (PIL's BILINEAR) -> paste at the top left of a
    ``fill`` canvas -> uint8 (out_h, out_w, 3).

    ``path`` is an image file, a decoded uint8 (H, W, 3) RGB array or a PIL
    image. With ``rng``, the reference's geometric train-time jitter: the
    gain times U(0.82, 1.0), then the paste offset x in [0, out_w - nw] and
    y in [0, min(out_h - nh, 12)], drawn in that order.

    As the reference, a file that fails to read or resize gives the blank
    canvas (``except Exception``). An ``ImportError`` is raised instead: it
    says that this machine lacks the format's codec (JPEG, TIFF, WebP
    without PIL), not that the file is bad, and a blank crop would read as
    empty text."""
    try:
        img = _decoded(path)
        h, w = img.shape[:2]
        gain = min(out_h / h, out_w / w)
        ox = oy = 0
        if rng is not None:
            gain *= float(rng.uniform(0.82, 1.0))
            nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
            ox = int(rng.integers(0, max(out_w - nw, 0) + 1))
            oy = int(rng.integers(0, min(max(out_h - nh, 0), 12) + 1))
        nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
        resized = resize_pil_bilinear_u8(img, (nh, nw))
        arr = np.full((out_h, out_w, 3), fill, np.uint8)
        arr[oy:oy + nh, ox:ox + nw] = resized[:out_h - oy, :out_w - ox]
    except ImportError:
        raise
    except Exception:
        arr = np.full((out_h, out_w, 3), fill, np.uint8)
    return arr


def letterboxed_batch(source, image_size, min_bucket: int = 1) -> tuple[torch.Tensor, int]:
    """A recognizer predictor's input: one image (a path, or a decoded array)
    or a list of them, each through :func:`load_letterboxed` at
    ``image_size`` (H, W), the count padded with zero images to
    ``next_bucket``. Returns (uint8 (bucket, H, W, 3) on the CPU, the count
    of real images)."""
    items = list(source) if isinstance(source, (list, tuple)) else [source]
    images = np.stack([load_letterboxed(p, *image_size) for p in items])
    n = len(images)
    npad = next_bucket(n, min_bucket=min_bucket)
    if npad > n:
        images = np.concatenate([images, np.zeros_like(images[:1]).repeat(npad - n, 0)])
    return torch.from_numpy(images), n


# pandas' default NA strings (``read_csv``'s ``na_values``)
PANDAS_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
             "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+")


def _as_float(v: str) -> float | None:
    try:
        return float(v)
    except ValueError:
        return None


def read_csv_columns(path: str | Path) -> dict[str, list[str]]:
    """A CSV's columns as ``pandas.read_csv(path)[col].astype(str)`` gives
    them, with the standard library: a UTF-8 BOM dropped, blank lines
    skipped, quoted fields as the csv module reads them, pandas' NA strings
    as ``"nan"`` (pandas leaves a float NaN there, which the reference's
    ``decode_unicode_ids`` reads as the text ``"nan"``), a column whose every other value is an integer as
    ``str(int)`` (``"x.0"`` where it also holds an NA), one of numbers as
    ``str(float)``, a column of ``true`` / ``false`` (any case) as
    ``"True"`` / ``"False"``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    cols: dict[str, list[str]] = {}
    for j, name in enumerate(header):
        vals = [r[j] if j < len(r) else "" for r in body]
        na = [v in PANDAS_NA for v in vals]
        known = [v for v, n in zip(vals, na) if not n]
        if known and all(_INT.fullmatch(v) for v in known):
            out = [str(float(int(v))) if any(na) else str(int(v)) for v in known]
        elif known and all(_as_float(v) is not None for v in known):
            out = [str(float(v)) for v in known]
        elif known and not any(na) and all(v.lower() in ("true", "false") for v in known):
            out = [str(v.lower() == "true") for v in known]
        else:
            out = known
        it = iter(out)
        cols[name] = ["nan" if n else next(it) for n in na]
    return cols


def _sample_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    return np.random.default_rng((seed * 1_000_003 + epoch * 7919 + idx) % (2**31))


class ColumnInfoDataset:
    """``column_info.csv`` (``column_image`` paths, ``unicode_ids`` labels
    ``'U+XXXX ...'``) with the reference's in-file split: the first 80% train,
    the next 10% val, the rest test. Samples: ``image`` uint8 (H, W, 3)
    letterboxed on white (the geometric jitter with ``augment``), ``tokens``
    (``max_length``,), ``length``. ``cache_images="ram"`` keeps each decoded
    crop."""

    def __init__(self, csv_path: str | Path, tokenizer: CharTokenizer | None,
                 split: str = "train", image_size: tuple[int, int] = (1024, 64),
                 max_length: int = 128, image_root: str | Path | None = None,
                 split_fracs: tuple[float, float] = (0.8, 0.1), augment: bool = False,
                 seed: int = 0, cache_images: str | None = None):
        self.cache_images = cache_images if cache_images == "ram" else None
        self.csv_path = Path(csv_path)
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_length = max_length
        self.image_root = Path(image_root) if image_root else self.csv_path.parent
        self.augment = augment
        self.seed = seed
        self._epoch = 0
        cols = read_csv_columns(self.csv_path)
        texts = [decode_unicode_ids(u) for u in cols["unicode_ids"]]
        paths = [self._resolve(p) for p in cols["column_image"]]
        n = len(paths)
        n_train = int(n * split_fracs[0])
        n_val = int(n * split_fracs[1])
        sl = {"train": slice(0, n_train), "val": slice(n_train, n_train + n_val),
              "test": slice(n_train + n_val, n)}[split]
        self.items = list(zip(paths[sl], texts[sl]))
        self._img_cache = [None] * len(self.items) if self.cache_images else None

    def _resolve(self, p: str) -> Path:
        q = Path(p)
        return q if q.is_absolute() else self.image_root / q

    def _source(self, idx: int):
        """The image source of one item: its path, or its cached decode."""
        path = self.items[idx][0]
        if self._img_cache is None:
            return path
        img = self._img_cache[idx]
        if img is None:
            try:
                img = imread_rgb(path, backend="pil")
            except (OSError, ValueError):
                return path  # load_letterboxed gives its blank canvas
            self._img_cache[idx] = img
        return img

    def texts(self) -> list[str]:
        return [t for _, t in self.items]

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        with one_thread():
            return self._sample(idx)

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        _, text = self.items[idx]
        rng = _sample_rng(self.seed, self._epoch, idx) if self.augment else None
        image = load_letterboxed(self._source(idx), *self.image_size, rng=rng)
        tokens = self.tokenizer.encode(text, max_length=self.max_length)
        return {"image": image, "tokens": tokens,
                "length": np.int32((tokens != self.tokenizer.pad_id).sum())}


class OneLineDataset:
    """``{split}/{images,labels[,bounding_boxes]}/{book}/*`` (or flat): an
    image with its ``.txt`` label (and, ``with_boxes``, a JSON list of its
    character boxes, up to ``max_boxes``, as ``boxes`` / ``num_boxes``).
    Augmentation is gated off with boxes: the jitter would move the pixels
    under them."""

    def __init__(self, root: str | Path, tokenizer: CharTokenizer | None, split: str = "train",
                 image_size: tuple[int, int] = (1024, 64), max_length: int = 128,
                 with_boxes: bool = False, max_boxes: int = 64, augment: bool = False,
                 seed: int = 0):
        self.root = Path(root) / split
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_length = max_length
        self.with_boxes = with_boxes
        self.max_boxes = max_boxes
        self.augment = augment and not with_boxes
        self.seed = seed
        self._epoch = 0
        img_root, lbl_root = self.root / "images", self.root / "labels"
        self.items: list[tuple[Path, str, Path | None]] = []
        img_dirs = ([d for d in sorted(img_root.iterdir()) if d.is_dir()] or [img_root]
                    if img_root.exists() else [])
        for d in img_dirs:
            book = d.name if d != img_root else ""
            for img in sorted(d.iterdir()):
                if img.suffix.lower() not in IMG_EXTS:
                    continue
                lbl = lbl_root / book / (img.stem + ".txt")
                if not lbl.exists():
                    continue
                text = lbl.read_text(encoding="utf-8").strip()
                bbox = None
                if with_boxes:
                    cand = self.root / "bounding_boxes" / book / (img.stem + ".json")
                    bbox = cand if cand.exists() else None
                self.items.append((img, text, bbox))

    def texts(self) -> list[str]:
        return [t for _, t, _ in self.items]

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        with one_thread():
            return self._sample(idx)

    def _sample(self, idx: int) -> dict[str, np.ndarray]:
        path, text, bbox_path = self.items[idx]
        rng = _sample_rng(self.seed, self._epoch, idx) if self.augment else None
        out: dict[str, np.ndarray] = {"image": load_letterboxed(path, *self.image_size, rng=rng)}
        if self.tokenizer is not None:
            tokens = self.tokenizer.encode(text, max_length=self.max_length)
            out["tokens"] = tokens
            out["length"] = np.int32((tokens != self.tokenizer.pad_id).sum())
        if self.with_boxes:
            boxes = np.zeros((self.max_boxes, 4), np.float32)
            n = 0
            if bbox_path is not None:
                try:
                    raw = json.loads(Path(bbox_path).read_text())
                    arr = np.asarray(raw, np.float32).reshape(-1, 4)[: self.max_boxes]
                    boxes[: len(arr)] = arr
                    n = len(arr)
                except Exception:  # a bad box file: no boxes, as the reference
                    pass
            out["boxes"] = boxes
            out["num_boxes"] = np.int32(n)
        return out


def build_tokenizer_from_datasets(*datasets, min_freq: int = 1) -> CharTokenizer:
    texts: list[str] = []
    for ds in datasets:
        texts.extend(ds.texts())
    return CharTokenizer.train(texts, min_freq=min_freq)
