"""Page -> text cascade (counterpart of ``kuzu/pipeline/cascade.py``'s
``KuzushijiPipeline``).

Pages are image files (decoded on the host by ``data.image_io.imread_rgb``,
cv2's decode to the byte) or decoded uint8 RGB arrays. With ``tile_grid >
1``, :meth:`KuzushijiPipeline.process_pages` is the production path:

1. column detection on the full pages, then same-region dedup;
2. character detection over every page's overlap tiles in one forward,
   merged per page by one batched cross-tile NMS
   (``tiling.merge_tile_detections_pages``, K1);
3. on the host, in numpy as the reference: each column snapped to its
   character support, orphan character segments made columns, dedup again;
4. every column's crop letterboxed and read in one batch: by the CTC CRNN
   with greedy CTC decoding, or by the TrOCR (greedy, ``beam``, or
   ``beam_lm``: beam n-best reranked by the char-LM's pseudo-log-likelihood);
5. with a char-LM and ``lm_mode="annotate"``, each column's text scored by
   that pseudo-log-likelihood (``lm_score``).

Equal-shape pages go to the device once (``ship_once``, optionally as luma
and pooled chroma, ``transport="yc"``) and their letterbox, tiles and crops
derive there (``device_pages``). Pages of mixed shapes, or
``ship_once=False``, take the reference's host path: each page letterboxed
(``letterbox_np``) and tiled (``tiling.tile_image``) on its own, with cv2's
resize to the byte, on the pipeline's device. ``tile_grid <= 1`` is the
reference-shaped flow (``scripts/inference.py:94-118``): columns, each
column's crop read, and its characters detected inside the crop.

The column geometry below is a copy of the reference's numpy (f64 where it
is f64), so boxes agree to the bit where the detections do. ``dp`` (the
data-parallel mesh) is not ported and raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml
from torch.profiler import record_function

from kuzu_torch.core.config import load_config
from kuzu_torch.data.image_io import imread_rgb, resize_linear_u8
from kuzu_torch.data.loader import next_bucket
from kuzu_torch.data.yolo_dataset import letterbox_np
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.pipeline.device_pages import (
    device_crops,
    device_letterbox,
    device_tiles,
    pack_yc,
    unpack_yc,
)
from kuzu_torch.pipeline.tiling import merge_tile_detections_pages, tile_image
from kuzu_torch.tasks.ctc import CTCPredictor
from kuzu_torch.tasks.detect import DetectPredictor
from kuzu_torch.tasks.lm import LMPredictor
from kuzu_torch.tasks.recognize import RecognizePredictor


def sort_columns_right_to_left(boxes: np.ndarray) -> np.ndarray:
    """Reading order for vertical Japanese: right-most column first."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    return np.argsort(-(boxes[:, 0] + boxes[:, 2]) / 2)


def dedup_columns(
    boxes: np.ndarray,
    scores: np.ndarray,
    x_frac: float = 0.6,
    y_frac: float = 0.45,
) -> np.ndarray:
    """Indices of column boxes that survive same-region suppression.

    Tall thin columns produce duplicate detections that survive box-IoU
    NMS (a partial-height duplicate of a tall column has low corner IoU
    but reads the same text twice downstream). Walking by descending
    score, a box is dropped when its x-interval overlaps a kept box by
    more than ``x_frac`` of the narrower AND its y-interval by more than
    ``y_frac`` of the shorter — "reads largely the same region". This is
    suppression, not union-merge: the reference merges columns at ETL
    time (``data_preprocessv2.py:699``) where GT segments are known, but
    at inference the segments must stay separate (measured: union-merge
    costs ~170/334 matched columns on the dense val pages; this rule at
    conf 0.002 keeps 330/334 matched with 3 spurious — the (0.6, 0.45)
    fractions swept on cached detections, see PERFORMANCE.md).
    """
    order = np.argsort(-scores)
    keep: list[int] = []
    for i in order:
        b = boxes[i]
        dup = False
        for j in keep:
            a = boxes[j]
            ox = min(a[2], b[2]) - max(a[0], b[0])
            oy = min(a[3], b[3]) - max(a[1], b[1])
            if (
                ox > x_frac * max(min(a[2] - a[0], b[2] - b[0]), 1e-6)
                and oy > y_frac * max(min(a[3] - a[1], b[3] - b[1]), 1e-6)
            ):
                dup = True
                break
        if not dup:
            keep.append(i)
    return np.array(sorted(keep), np.int64)


def refine_columns_by_chars(
    col_boxes: np.ndarray,  # (C, 4) xyxy
    char_boxes: np.ndarray,  # (K, 4) xyxy, full-page frame
    pad: float = 4.0,
    gap_frac: float = 1.0,
    min_chars: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Snap column boxes to their character-detection support.

    The column detector localizes the segment roughly (a partial-height
    box can match GT at IoU 0.5 yet crop away 30% of the text — measured:
    GT-box crops read at CER 0.031 while detected-box crops read at 0.096,
    so box *extent* is the matched-column error, not crop margins). The
    char detector is near-perfect (mAP50 0.995), so each column snaps to
    the chars it actually contains: chars whose center-x falls in the
    column's x-band are merged bottom-up into vertical segments (split
    where the inter-char gap exceeds ``gap_frac`` x the band's median char
    height — intra-column gaps are a few px, inter-segment gaps tens), the
    column takes the segment it overlaps most, and its box becomes that
    segment's char union +- ``pad`` (the training-crop convention).
    Columns with no char support are dropped (keep mask False): nothing
    to read. Returns (refined (C, 4), keep (C,) bool).
    """
    col_boxes = np.asarray(col_boxes, np.float64)
    refined = col_boxes.copy()
    keep = np.zeros(len(col_boxes), bool)
    if len(char_boxes) == 0:
        return refined, keep
    ch = np.asarray(char_boxes, np.float64)
    cx = (ch[:, 0] + ch[:, 2]) / 2
    for i, (x1, y1, x2, y2) in enumerate(col_boxes):
        band = np.where((cx >= x1) & (cx <= x2))[0]
        if len(band) < min_chars:
            continue
        b = ch[band]
        gap = gap_frac * float(np.median(b[:, 3] - b[:, 1]))
        segs = _char_segments(b, gap)
        # the segment this column overlaps most, vertically
        best, best_ov = None, 0.0
        for s in segs:
            ov = min(s[1], y2) - max(s[0], y1)
            if ov > best_ov:
                best, best_ov = s, ov
        if best is None or len(best[4]) < min_chars:
            continue
        refined[i] = [
            best[2] - pad, best[0] - pad, best[3] + pad, best[1] + pad,
        ]
        keep[i] = True
    return refined, keep


def _char_segments(boxes: np.ndarray, gap: float) -> list[list]:
    """Merge char boxes (any order) into vertical segments: consecutive
    y-sorted chars join one segment while the inter-char gap stays within
    ``gap``. Returns [y_lo, y_hi, x_lo, x_hi, member_row_indices] per
    segment (rows index into ``boxes``)."""
    segs: list[list] = []
    for i in np.argsort(boxes[:, 1]):
        bx1, by1, bx2, by2 = boxes[i]
        if segs and by1 - segs[-1][1] <= gap:
            s = segs[-1]
            s[1] = max(s[1], by2)
            s[2] = min(s[2], bx1)
            s[3] = max(s[3], bx2)
            s[4].append(i)
        else:
            segs.append([by1, by2, bx1, bx2, [i]])
    return segs


def columns_from_orphan_chars(
    char_boxes: np.ndarray,  # (K, 4) xyxy
    char_scores: np.ndarray,  # (K,)
    col_boxes: np.ndarray,  # (C, 4) kept columns; orphans lie outside these
    pad: float = 4.0,
    gap_frac: float = 1.0,
    min_chars: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthesize column boxes for char detections no column claims.

    The column detector can miss a segment outright (never proposed at any
    confidence) while the char detector still reads every glyph in it.
    Chars whose center falls inside no kept column are grouped into
    x-bands (greedy: a char joins a band when its x-interval overlaps the
    band by half the narrower width — a column's chars stack at nearly
    equal x), each band splits into vertical segments by the same
    median-height gap rule as ``refine_columns_by_chars``, and every
    segment with at least ``min_chars`` support becomes a column whose
    score is its chars' mean detection score. Returns (boxes (N, 4),
    scores (N,)); the caller dedups against the kept columns.
    """
    ch = np.asarray(char_boxes, np.float64)
    sc = np.asarray(char_scores, np.float64)
    empty = np.zeros((0, 4), np.float64), np.zeros((0,), np.float64)
    if len(ch) == 0:
        return empty
    cx = (ch[:, 0] + ch[:, 2]) / 2
    cy = (ch[:, 1] + ch[:, 3]) / 2
    orphan = np.ones(len(ch), bool)
    for x1, y1, x2, y2 in np.asarray(col_boxes, np.float64):
        orphan &= ~((cx >= x1) & (cx <= x2) & (cy >= y1) & (cy <= y2))
    if orphan.sum() < min_chars:
        return empty
    ch, sc = ch[orphan], sc[orphan]
    # x-band grouping
    bands: list[list[float]] = []  # [x_lo, x_hi, member indices...]
    members: list[list[int]] = []
    for i in np.argsort(ch[:, 0]):
        x1, _, x2, _ = ch[i]
        placed = False
        for b, m in zip(bands, members):
            ov = min(b[1], x2) - max(b[0], x1)
            if ov >= 0.5 * min(b[1] - b[0], x2 - x1):
                b[0], b[1] = min(b[0], x1), max(b[1], x2)
                m.append(i)
                placed = True
                break
        if not placed:
            bands.append([x1, x2])
            members.append([i])
    boxes, scores = [], []
    for m in members:
        if len(m) < min_chars:
            continue
        b = ch[m]
        gap = gap_frac * float(np.median(b[:, 3] - b[:, 1]))
        for s in _char_segments(b, gap):
            if len(s[4]) < min_chars:
                continue
            boxes.append([s[2] - pad, s[0] - pad, s[3] + pad, s[1] + pad])
            scores.append(float(np.mean(sc[np.asarray(m)[s[4]]])))
    if not boxes:
        return empty
    return np.asarray(boxes, np.float64), np.asarray(scores, np.float64)


def _run_task(run_dir: str | Path, default: str = "recognize") -> str:
    """Task recorded in a training run's args.yaml snapshot."""
    args = Path(str(run_dir)) / "args.yaml"
    if args.exists():
        try:
            return str((yaml.safe_load(args.read_text()) or {}).get("task", default))
        except yaml.YAMLError:
            pass
    return default


def _bucket_floor(predictor, base: int = 8) -> int:
    """Smallest multiple of the predictor's mesh size >= ``base``, so that
    bucket sizes stay divisible by the data axis; the port's predictors have
    no mesh (``dp`` is not ported), so this is ``base``."""
    m = max(1, getattr(predictor, "min_bucket", 1))
    return m * -(-base // m)


STAGES = ("columns", "tiles", "cross-tile NMS", "geometry", "crops", "recognizer")
LM_STAGE = "lm"  # after "recognizer", where the LM annotates the texts
DECODE_STAGE = "decode"  # first, where entries are image files


def _stage(name: str) -> record_function:
    """The profiler range of one cascade stage, ``cascade/<name>``."""
    return record_function(f"cascade/{name}")


def _is_path(entry) -> bool:
    return isinstance(entry, (str, Path))


def _stack(images: list, pages) -> torch.Tensor:
    """A (B, H, W, 3) uint8 tensor of equal-shape decoded pages (the caller's
    batch tensor itself where it gave one)."""
    if isinstance(pages, torch.Tensor):
        stack = pages
    else:
        stack = torch.stack([torch.as_tensor(im) for im in images])
    if stack.dtype != torch.uint8 or stack.dim() != 4 or stack.shape[-1] != 3:
        raise ValueError(f"pages are (B, H, W, 3) uint8 RGB, got {tuple(stack.shape)} "
                         f"{stack.dtype}")
    return stack


class KuzushijiPipeline:
    """Column detector + character detector + recognizer (+ char-LM).

    ``column_model`` / ``char_model`` are port run dirs or
    ``DetectPredictor``s, ``recognizer`` a run dir or a ``CTCPredictor`` /
    ``RecognizePredictor``, ``lm`` a run dir or an ``LMPredictor``; a
    recognizer run dir is a ``CTCTrainer`` or a ``RecognizeTrainer`` run
    (its ``args.yaml`` task says which), loaded at first use (a LoRA run's
    adapters fused). Pages are image paths or decoded uint8 RGB arrays.
    Every stage runs on ``device`` (the card when None): letterboxes, tiles,
    crops and the networks; the column geometry is the host's numpy. Each
    stage runs inside a ``torch.profiler.record_function`` range named
    ``cascade/<stage>`` (``DECODE_STAGE`` where pages are files, then
    ``STAGES`` on the tiled path, or columns, crops, characters and
    recognizer on the per-column one; ``LM_STAGE`` where the LM annotates),
    which costs nothing without a profiler.

    ``tile_grid > 1`` is the production path. Equal-shape pages with
    ``ship_once`` go to the device once and derive their letterbox, tiles
    and crops there (``transport="yc"``: full-resolution luma and 4x4-pooled
    chroma, RGB rebuilt on the device); pages of mixed shapes, or
    ``ship_once=False``, take the reference's host path (each page
    letterboxed and tiled by ``letterbox_np`` and cropped on its own), as
    the reference routes them. ``tile_grid <= 1`` is the reference-shaped
    flow: columns, then the characters detected inside each column crop."""

    def __init__(
        self,
        column_model: str | Path | DetectPredictor | None = None,
        char_model: str | Path | DetectPredictor | None = None,
        recognizer: str | Path | CTCPredictor | RecognizePredictor | None = None,
        lm: str | Path | LMPredictor | None = None,
        tile_grid: int = 0,  # 0 = no tiling
        tile_overlap: float = 0.15,
        conf: float = 0.25,
        margin: float = 0.05,  # column crop margin (reference padding ratio)
        decode: str = "greedy",  # 'beam': num_beams beams; 'beam_lm': n-best + LM rerank
        num_beams: int = 4,
        max_det: int = 300,  # production char detection: 2000
        lm_weight: float = 0.3,  # beam_lm: score = beam + lm_weight * PLL
        dp: int = 0,
        col_conf: float | None = None,  # column-stage conf (default: conf)
        col_dedup: bool = True,  # same-region column suppression
        col_refine: bool = True,  # snap column boxes to char-detection support
        col_recover: bool = True,  # columns for char segments no column claims
        lm_mode: str = "annotate",  # 'annotate': an lm_score per column; 'off'
        ship_once: bool = True,  # equal-shape pages to the device once (tiled path)
        transport: str = "rgb",  # 'yc': luma + 4x-subsampled chroma (ship-once path)
        col_imgsz: int | None = None,  # column letterbox side (None: the model's)
        device: torch.device | str | None = None,
    ):
        if dp:
            raise NotImplementedError("data-parallel serving (dp > 0) is not ported "
                                      "(ROADMAP section 1 item 12)")
        self.device = resolve_device(device)
        self.tile_grid = tile_grid
        self.tile_overlap = tile_overlap
        self.margin = margin
        self.decode = decode
        self.num_beams = num_beams
        self.max_det = max_det
        self.lm_weight = lm_weight
        self.lm_mode = lm_mode
        self.ship_once = ship_once
        self.transport = transport
        self.col_imgsz = int(col_imgsz) if col_imgsz else None
        self.col_dedup = col_dedup
        self.col_refine = col_refine
        self.col_recover = col_recover
        self.column_det = self.char_det = self.recognizer = self.lm = None
        if column_model is not None:
            self.column_det = self._detector(
                column_model, conf=conf if col_conf is None else col_conf)
        if char_model is not None:
            self.char_det = self._detector(char_model, conf=conf, max_det=max_det)
        self.rec_task = "ctc"
        if isinstance(recognizer, (CTCPredictor, RecognizePredictor)):
            self.recognizer = recognizer
            self.rec_task = "ctc" if isinstance(recognizer, CTCPredictor) else "recognize"
        elif recognizer is not None:
            # the run dir's args.yaml says whether it is an AR TrOCR run
            # (task=recognize) or a CTC CRNN run (task=ctc)
            self.rec_task = _run_task(recognizer)
            cls = CTCPredictor if self.rec_task == "ctc" else RecognizePredictor
            self.recognizer = cls(load_config(overrides={"model": str(recognizer)}),
                                  device=self.device)
        if isinstance(lm, LMPredictor):
            self.lm = lm
        elif lm is not None:
            self.lm = LMPredictor(load_config(overrides={"model": str(lm)}), device=self.device)

    def _detector(self, model, **overrides) -> DetectPredictor:
        if isinstance(model, DetectPredictor):
            return model
        return DetectPredictor(load_config(overrides={"model": str(model), **overrides}),
                               device=self.device)

    # ------------------------------------------------------------- pages
    def _read(self, entries: list) -> list:
        """Each entry decoded: an image file through ``imread_rgb`` (cv2's
        decode, to the byte), an array or tensor as it is."""
        if not any(_is_path(e) for e in entries):
            return entries
        with _stage(DECODE_STAGE):
            return [imread_rgb(e) if _is_path(e) else e for e in entries]

    def _on_device(self, image) -> torch.Tensor:
        return torch.as_tensor(image).to(self.device)

    @staticmethod
    def _names(entries: list, names: list | None) -> list:
        """Each result's ``"image"``: the ``names`` entry, else the path,
        else the page's index."""
        if names is not None:
            return list(names)
        return [str(e) if _is_path(e) else i for i, e in enumerate(entries)]

    # ------------------------------------------------------------ stages
    def detect_columns(self, image) -> dict[str, np.ndarray]:
        """Columns are page-scale objects: always detected on the full page
        (an image path or a decoded page), then same-region dedup."""
        assert self.column_det is not None, "no column model configured"
        with _stage("columns"):
            r = self.column_det([image])[0]
            return self._dedup(r)

    def _dedup(self, det) -> dict:
        """Same-region column suppression (``dedup_columns``) on one
        detection (a dict or ``Results``, both index by key); returns a plain
        dict of boxes/scores/classes. No-op when ``col_dedup`` is off."""
        out = {k: np.asarray(det[k]) for k in ("boxes", "scores", "classes")}
        if not self.col_dedup or len(out["boxes"]) == 0:
            return out
        keep = dedup_columns(out["boxes"], out["scores"])
        return {k: v[keep] for k, v in out.items()}

    def detect_chars(self, image) -> dict[str, np.ndarray]:
        """Characters of a whole page: over its overlap tiles with
        ``tile_grid > 1``, else on the page letterboxed."""
        assert self.char_det is not None, "no char model configured"
        if self.tile_grid > 1:
            return self._detect_tiled(self.char_det, image)
        with _stage("characters"):
            r = self.char_det([image])[0]
            return {k: r[k] for k in ("boxes", "scores", "classes")}

    def _detect_tiled(self, predictor: DetectPredictor, image) -> dict[str, np.ndarray]:
        """One page's tiles through one forward, merged by the cross-tile NMS."""
        return self._tiled_pages(predictor, [self._on_device(self._read([image])[0])])[0]

    def _tiled_pages(self, predictor: DetectPredictor, pages: list) -> list[dict]:
        """Every page's overlap tiles (``tile_image`` on the device) through
        one forward (the count padded to a bucket), merged per page by one
        batched cross-tile NMS."""
        if not predictor.ready:
            predictor._setup()
        with _stage("tiles"):
            tiles_all, metas_all, spans = [], [], []
            for page in pages:
                tiles, metas = tile_image(page, grid=self.tile_grid, overlap=self.tile_overlap,
                                          tile_size=predictor.imgsz)
                spans.append((len(tiles_all), len(tiles_all) + len(tiles)))
                tiles_all.extend(tiles)
                metas_all.extend(metas)
            stack = torch.stack(tiles_all)
            pad = next_bucket(len(stack), min_bucket=_bucket_floor(predictor)) - len(stack)
            if pad:
                stack = torch.cat([stack, stack.new_zeros((pad, *stack.shape[1:]))])
            out = {k: v.cpu().numpy() for k, v in predictor._fwd(stack).items()}
        with _stage("cross-tile NMS"):
            return self._merge(out, spans, metas_all, [tuple(p.shape[:2]) for p in pages])

    def _column_bounds(
        self, shape: tuple[int, ...], boxes: np.ndarray
    ) -> list[tuple[int, int, int, int]]:
        """Margin-expanded integer crop bounds per column box."""
        h, w = shape[:2]
        out = []
        for x1, y1, x2, y2 in boxes:
            mw = (x2 - x1) * self.margin
            mh = (y2 - y1) * self.margin
            xa, ya = max(int(x1 - mw), 0), max(int(y1 - mh), 0)
            xb, yb = min(int(x2 + mw), w), min(int(y2 + mh), h)
            out.append((xa, ya, xb, yb))
        return out

    @staticmethod
    def _crop(image: torch.Tensor, bound: tuple[int, int, int, int]) -> torch.Tensor:
        """One column window of a page; a detection clipped to a sliver at the
        page's edge gives a blank 8 x 8 crop, so indices stay aligned."""
        xa, ya, xb, yb = bound
        if xb <= xa or yb <= ya:
            return torch.full((8, 8, 3), 255, dtype=torch.uint8, device=image.device)
        return image[ya:yb, xa:xb]

    def crop_columns(self, image, boxes: np.ndarray) -> list[torch.Tensor]:
        """The margin-expanded window of every column box (views of the page,
        an array or a tensor, as tensors on its device)."""
        image = torch.as_tensor(image)
        return [self._crop(image, bd) for bd in self._column_bounds(image.shape, boxes)]

    def detect_chars_in_columns(self, image, boxes: np.ndarray) -> list[dict[str, np.ndarray]]:
        """Per-column character detection, reference-shaped: each column's
        crop letterboxed (``letterbox_np``, on the page's device), all columns
        through one forward (the count padded to a bucket), the boxes mapped
        back to the page, clipped to the crop and ordered top to bottom."""
        assert self.char_det is not None, "no char model configured"
        if not self.char_det.ready:
            self.char_det._setup()
        if len(boxes) == 0:
            return []
        size = self.char_det.imgsz
        bounds = self._column_bounds(image.shape, boxes)
        with _stage("crops"):
            tiles, metas = [], []
            for bd in bounds:
                canvas, gain, (px, py) = letterbox_np(self._crop(image, bd), size)
                tiles.append(canvas)  # uint8; the detector normalizes on the device
                metas.append((bd[0], bd[1], gain, px, py))
            n = len(tiles)
            nb = next_bucket(n, min_bucket=_bucket_floor(self.char_det))
            tiles.extend([torch.zeros_like(tiles[0])] * (nb - n))
            stack = torch.stack(tiles)
        with _stage("characters"):
            out = {k: v.cpu().numpy() for k, v in self.char_det._fwd(stack).items()}
            per_col = []
            for i, ((xa, ya, gain, px, py), (_, _, xb, yb)) in enumerate(zip(metas, bounds)):
                v = out["valid"][i]
                b = (out["boxes"][i][v] - [px, py, px, py]) / gain
                b += [xa, ya, xa, ya]
                # clip into the column's crop region (stays within the page)
                b[:, [0, 2]] = b[:, [0, 2]].clip(xa, max(xb, xa))
                b[:, [1, 3]] = b[:, [1, 3]].clip(ya, max(yb, ya))
                s = out["scores"][i][v]
                c = out["classes"][i][v]
                order = np.argsort(b[:, 1] + b[:, 3])  # top -> bottom
                per_col.append({"boxes": b[order], "scores": s[order], "classes": c[order]})
        return per_col

    def recognize_crops(self, crops: list) -> list[str]:
        """Read column crops (arrays or tensors): each letterboxed by
        :meth:`_letterbox_crop` on its device, the count padded to a bucket,
        one recognizer batch."""
        assert self.recognizer is not None, "no recognizer configured"
        if not self.recognizer.ready:
            self.recognizer._setup()
        if not crops:
            return []
        size = self.recognizer.image_size
        with _stage("crops"):
            batch = [self._letterbox_crop(torch.as_tensor(c), size) for c in crops]
            n = len(batch)
            nb = next_bucket(n, min_bucket=_bucket_floor(self.recognizer))
            batch.extend([torch.zeros_like(batch[0])] * (nb - n))
            images = torch.stack(batch).to(self.recognizer.device)
        with _stage("recognizer"):
            return self._decode_crop_batch(images, n)

    @staticmethod
    def _letterbox_crop(crop: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
        """The recognizer's crop letterbox: resized (cv2's INTER_LINEAR) by
        min(out_h / h, out_w / w) to (int(h gain), int(w gain)) (truncated,
        where ``letterbox_np`` rounds), at the top left of a white canvas."""
        out_h, out_w = size
        h, w = crop.shape[:2]
        gain = min(out_h / max(h, 1), out_w / max(w, 1))
        nw, nh = max(int(w * gain), 1), max(int(h * gain), 1)
        canvas = torch.full((out_h, out_w, 3), 255, dtype=torch.uint8, device=crop.device)
        canvas[:nh, :nw] = resize_linear_u8(crop, (nh, nw))
        return canvas  # uint8; the recognizer normalizes on the device
    def recognize_boxes_device(self, pages_dev, page_idx, boxes) -> list[str]:
        """Crop-letterbox every column on the device from the resident page
        batch and decode. ``boxes`` are margin-expanded page-pixel windows;
        degenerate (sliver) windows read as empty text."""
        assert self.recognizer is not None, "no recognizer configured"
        if not self.recognizer.ready:
            self.recognizer._setup()
        n = len(page_idx)
        if n == 0:
            return []
        boxes = np.asarray(boxes, np.float32)
        degenerate = (boxes[:, 2] - boxes[:, 0] < 1) | (
            boxes[:, 3] - boxes[:, 1] < 1
        )
        nb = next_bucket(n, min_bucket=_bucket_floor(self.recognizer))
        idx_p = np.zeros((nb,), np.int32)
        idx_p[:n] = np.asarray(page_idx, np.int32)
        box_p = np.tile(np.array([0, 0, 2, 2], np.float32), (nb, 1))
        box_p[:n] = np.where(degenerate[:, None], [0, 0, 2, 2], boxes)
        h, w = self.recognizer.image_size
        with _stage("crops"):
            images = device_crops(
                pages_dev, torch.from_numpy(idx_p).to(pages_dev.device),
                torch.from_numpy(box_p).to(pages_dev.device), out_h=int(h), out_w=int(w),
            )
        with _stage("recognizer"):
            texts = self._decode_crop_batch(images, n)
        return ["" if degenerate[i] else t for i, t in enumerate(texts)]

    def _decode_crop_batch(self, images: torch.Tensor, n: int) -> list[str]:
        """Decode a device-resident letterboxed crop batch (first n real)."""
        tok = self.recognizer.tokenizer
        if self.rec_task == "ctc":
            if self.decode == "beam_lm":
                raise ValueError(
                    "decode='beam_lm' reranks AR beam candidates; the CTC "
                    "recognizer decodes greedily (use decode='greedy')"
                )
            (seqs, lens), _ = self.recognizer._fwd(images)
            seqs, lens = seqs[:n].cpu().numpy(), lens[:n].cpu().numpy()
            return [tok.decode(s[:m]) for s, m in zip(seqs, lens)]
        if self.decode == "beam_lm":
            # n-best reranking: beam candidates rescored by the char-LM's
            # masked pseudo-log-likelihood
            if self.lm is None:
                raise ValueError("decode='beam_lm' needs an LM")
            tokens, norm = self.recognizer._fwd(images, num_beams=self.num_beams,
                                                return_nbest=True)
            tokens, norm = tokens[:n].cpu().numpy(), norm[:n].cpu().numpy()  # (n, K, T), (n, K)
            k = tokens.shape[1]
            cand = [tok.batch_decode(tokens[i]) for i in range(n)]  # n lists of K texts
            pll = np.asarray(self.rescore_texts([t for group in cand for t in group])).reshape(n, k)
            best = (norm + self.lm_weight * pll).argmax(1)  # in f64, as the reference
            return [cand[i][int(best[i])] for i in range(n)]
        out = self.recognizer._fwd(images, decode=self.decode, num_beams=self.num_beams)
        return tok.batch_decode(out[:n].cpu().numpy())

    @torch.no_grad()
    def rescore_texts(self, texts: list[str]) -> list[float]:
        """Masked pseudo-log-likelihood per text by the char-LM, all texts in
        one batch: for each position p, p masked in every text at once and
        the log-probability of its character read at p, summed over each
        text's characters (BOS and EOS excluded) and divided by their count;
        0.0 for a text of no character.

        As the reference, token rows are cut to a length bucket (next_bucket
        of the longest, at least 16, at most the LM's ``max_len``). It pads
        the text count to a bucket for its compiled program; here the rows
        are taken as they come, and positions where no text has a character
        are skipped (they add 0). The MLM head runs at position p only
        (``CharMLM.head``), the same arithmetic for the rows it computes."""
        if self.lm is None:
            raise ValueError("no LM configured")
        if not self.lm.ready:
            self.lm._setup()
        if not texts:
            return []
        tok, model = self.lm.tokenizer, self.lm.model
        ids = np.stack([tok.encode(t, max_length=self.lm.max_len) for t in texts])
        lens = (ids != tok.pad_id).sum(1).astype(np.int32)
        width = min(next_bucket(int(lens.max()), min_bucket=16), self.lm.max_len)
        ids = torch.from_numpy(ids[:, :width]).long().to(self.lm.device)
        lens_t = torch.from_numpy(lens).to(self.lm.device)
        attn = (ids != tok.pad_id).float()
        total = torch.zeros(len(texts), dtype=torch.float32, device=ids.device)
        for p in range(1, int(lens.max()) - 1):  # the characters' positions
            masked = ids.clone()
            masked[:, p] = torch.where(ids[:, p] != tok.pad_id, tok.mask_id, ids[:, p])
            logits = model.head(model.features(masked, attn)[:, p])
            lp = logits.gather(1, ids[:, p, None])[:, 0] - torch.logsumexp(logits, dim=-1)
            total += lp * (p < lens_t - 1).float()
        scores = (total / (lens_t - 2).clamp(min=1).float()).cpu().numpy()
        return [float(scores[i]) if lens[i] > 2 else 0.0 for i in range(len(texts))]

    # ------------------------------------------------ ship-once device path
    def _detect_pages_device(
        self, predictor: DetectPredictor, pages_dev: torch.Tensor, hw, imgsz: int | None = None
    ) -> list[dict]:
        """Full-page detection over the resident uint8 page batch: letterbox
        on the device, the predictor's forward + NMS; boxes unscale to page
        pixels on the host as the reference does. ``imgsz`` overrides the
        predictor's input side."""
        if not predictor.ready:
            predictor._setup()
        imgsz = int(imgsz or predictor.imgsz)
        out = predictor._fwd(device_letterbox(pages_dev, imgsz)[0])
        out = {k: v.cpu().numpy() for k, v in out.items()}
        h, w = hw
        gain = min(imgsz / h, imgsz / w)
        nw, nh = max(int(round(w * gain)), 1), max(int(round(h * gain)), 1)
        px, py = (imgsz - nw) // 2, (imgsz - nh) // 2
        dets = []
        for i in range(len(out["boxes"])):
            v = out["valid"][i].astype(bool)
            b = (out["boxes"][i][v] - [px, py, px, py]) / gain
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
            dets.append(
                {
                    "boxes": b,
                    "scores": out["scores"][i][v],
                    "classes": out["classes"][i][v],
                }
            )
        return dets

    def _detect_tiles_device(self, pages_dev: torch.Tensor):
        """Char detection over the overlap tiles of the resident page batch
        (one forward over B*T tiles). Returns (padded NMS output over the
        tiles as numpy, the tile metas of one page)."""
        predictor = self.char_det
        tiles, metas = device_tiles(pages_dev, self.tile_grid, self.tile_overlap,
                                    predictor.imgsz)
        out = {k: v.cpu().numpy() for k, v in predictor._fwd(tiles).items()}
        return out, metas

    def _refine_columns(self, col_dets: list[dict], char_pages: list[dict], shapes) -> None:
        """Snap each page's columns to its char support (refined duplicates
        collapse onto the same segment, so dedup again), then recover the
        char segments no column claims as columns; in place. ``shapes``:
        each page's (H, W)."""
        for pi, det in enumerate(col_dets):
            ph, pw = shapes[pi]
            boxes = np.asarray(det["boxes"])
            cb = np.asarray(char_pages[pi]["boxes"])
            if len(boxes):
                ref, ok = refine_columns_by_chars(boxes, cb)
                # char-union +- pad can step past the page edge
                ref[:, [0, 2]] = ref[:, [0, 2]].clip(0, pw)
                ref[:, [1, 3]] = ref[:, [1, 3]].clip(0, ph)
                det = self._dedup(
                    {
                        "boxes": ref[ok],
                        "scores": np.asarray(det["scores"])[ok],
                        "classes": np.asarray(det["classes"])[ok],
                    }
                )
            if self.col_recover and len(cb):
                # char segments no column claims become columns
                ob, osc = columns_from_orphan_chars(
                    cb,
                    np.asarray(char_pages[pi]["scores"]),
                    np.asarray(det["boxes"]),
                )
                if len(ob):
                    ob[:, [0, 2]] = ob[:, [0, 2]].clip(0, pw)
                    ob[:, [1, 3]] = ob[:, [1, 3]].clip(0, ph)
                    det = self._dedup(
                        {
                            "boxes": np.concatenate(
                                [np.asarray(det["boxes"]), ob]
                            ),
                            "scores": np.concatenate(
                                [np.asarray(det["scores"]), osc]
                            ),
                            "classes": np.concatenate(
                                [
                                    np.asarray(det["classes"]),
                                    np.zeros(len(ob), np.int32),
                                ]
                            ),
                        }
                    )
            col_dets[pi] = det

    def _page_results(self, names: list, col_dets: list[dict], char_pages, shapes):
        """Per page: columns in reading order with their characters, and the
        margin-expanded crop window of every column as (page, bounds)."""
        results: list[dict] = []
        all_crops: list[tuple[int, tuple]] = []
        crop_spans: list[tuple[int, int]] = []
        for pi, (name, det) in enumerate(zip(names, col_dets)):
            order = sort_columns_right_to_left(np.asarray(det["boxes"]))
            boxes = np.asarray(det["boxes"])[order]
            scores = np.asarray(det["scores"])[order]
            result: dict[str, Any] = {
                "image": name,
                "columns": [
                    {"box": b.tolist(), "score": float(s)}
                    for b, s in zip(boxes, scores)
                ],
            }
            if char_pages is not None:
                chars = char_pages[pi]
                result["characters"] = {
                    "boxes": chars["boxes"].tolist(),
                    "scores": chars["scores"].tolist(),
                }
                # per-column assignment by center containment (reading order)
                if len(boxes):
                    cx = (chars["boxes"][:, 0] + chars["boxes"][:, 2]) / 2
                    cy = (chars["boxes"][:, 1] + chars["boxes"][:, 3]) / 2
                    for col, cb in zip(result["columns"], boxes):
                        inside = (
                            (cx >= cb[0]) & (cx <= cb[2])
                            & (cy >= cb[1]) & (cy <= cb[3])
                        )
                        cb_boxes = chars["boxes"][inside]
                        cb_scores = chars["scores"][inside]
                        top = np.argsort(
                            cb_boxes[:, 1] + cb_boxes[:, 3]
                        )  # top -> bottom
                        col["chars"] = {
                            "boxes": cb_boxes[top].tolist(),
                            "scores": cb_scores[top].tolist(),
                        }
            if self.recognizer is not None:
                bounds = self._column_bounds(shapes[pi], boxes)
                crop_spans.append((len(all_crops), len(all_crops) + len(bounds)))
                all_crops.extend((pi, bd) for bd in bounds)
            else:
                crop_spans.append((0, 0))
            results.append(result)
        return results, all_crops, crop_spans

    def _read_columns(self, names: list, col_dets: list[dict], char_pages, shapes,
                      read) -> list[dict]:
        """The tiled path's tail: columns refined on their characters, the
        results in reading order, and every column's crop window (page,
        bounds) read by ``read`` in one batch."""
        with _stage("geometry"):
            if char_pages is not None and self.col_refine:
                self._refine_columns(col_dets, char_pages, shapes)
            results, all_crops, crop_spans = self._page_results(names, col_dets, char_pages,
                                                                shapes)
        if self.recognizer is not None and all_crops:
            self._attach_texts(results, crop_spans, read(all_crops), self._lm_on)
        return results

    @property
    def _lm_on(self) -> bool:
        return self.lm is not None and self.lm_mode != "off"

    def _attach_texts(self, results: list[dict], crop_spans, texts: list[str],
                      rescore: bool) -> None:
        """Each column's text, each page's lines, and with ``rescore`` each
        column's LM score (all texts in one LM batch)."""
        scores = None
        if rescore:
            with _stage(LM_STAGE):
                scores = self.rescore_texts(texts)
        for result, (lo, hi) in zip(results, crop_spans):
            page_texts = texts[lo:hi]
            for col, t in zip(result["columns"], page_texts):
                col["text"] = t
            result["text"] = "\n".join(page_texts)
            if scores is not None:
                for col, sc in zip(result["columns"], scores[lo:hi]):
                    col["lm_score"] = sc

    # --------------------------------------------------------------- e2e
    def process_page(self, image, name: Any = None) -> dict[str, Any]:
        """One page (an image path or a decoded (H, W, 3) uint8 page). With
        ``tile_grid > 1`` the batched production path for a single page;
        otherwise the reference-shaped flow of :meth:`process_pages` (columns
        on the full page, each column's crop read by the recognizer and its
        characters detected inside it), every text annotated by the LM where
        there is one (whatever ``lm_mode`` says, as the reference's page
        flow), and the page's characters: its columns' together, or, where
        it has no column, the page's own. The result's ``"image"`` is
        ``name``, else the path, else 0."""
        names = None if name is None else [name]
        if self.tile_grid > 1:
            return self.process_pages([image], names=names)[0]
        page = self._on_device(self._read([image])[0])
        result = self._flat_pages([page], self._names([image], names),
                                  rescore=self.lm is not None)[0]
        if self.recognizer is not None:
            result.setdefault("text", "")
        if self.char_det is not None:
            if result["columns"]:
                chars = [c["chars"] for c in result["columns"]]
                result["characters"] = {"boxes": [b for c in chars for b in c["boxes"]],
                                        "scores": [v for c in chars for v in c["scores"]]}
            else:
                chars = self.detect_chars(page)
                result["characters"] = {"boxes": chars["boxes"].tolist(),
                                        "scores": chars["scores"].tolist()}
        return result

    def process_pages(self, pages, names: list | None = None) -> list[dict]:
        """Batched cascade over pages: a list of image paths or decoded
        (H, W, 3) uint8 RGB arrays (any mix, any shapes), or a (B, H, W, 3)
        uint8 tensor. Each result's ``"image"`` is the page's entry of
        ``names``, else its path, else its index.

        With ``tile_grid > 1`` the production path (see the class);
        otherwise columns for all pages in batches, each page's column crops
        and their characters, then one recognizer batch over every page's
        crops and one LM batch over their texts (``lm_mode``)."""
        if len(pages) == 0:
            return []
        entries = list(pages)  # paths, pages, or the pages of a (B, H, W, 3) batch
        names = self._names(entries, names)
        images = self._read(entries)
        if self.tile_grid > 1:
            return self._process_pages_tiled(images, pages, names)
        return self._flat_pages([self._on_device(im) for im in images], names, self._lm_on)

    def _flat_pages(self, on_dev: list[torch.Tensor], names: list, rescore: bool) -> list[dict]:
        """The reference-shaped flow over pages on the device: one column
        batch, each page's columns cropped and their characters detected
        inside them, one recognizer batch over every crop (LM scores with
        ``rescore``)."""
        assert self.column_det is not None, "no column model configured"
        with _stage("columns"):
            detections = [self._dedup(d) for d in self.column_det(on_dev)]
        results: list[dict] = []
        all_crops: list = []
        crop_spans: list[tuple[int, int]] = []
        for name, page, det in zip(names, on_dev, detections):
            order = sort_columns_right_to_left(det["boxes"])
            boxes = det["boxes"][order]
            scores = det["scores"][order]
            result = {
                "image": name,
                "columns": [
                    {"box": b.tolist(), "score": float(s)}
                    for b, s in zip(boxes, scores)
                ],
            }
            if self.recognizer is not None:
                crops = self.crop_columns(page, boxes)
                crop_spans.append((len(all_crops), len(all_crops) + len(crops)))
                all_crops.extend(crops)
            else:
                crop_spans.append((0, 0))
            if self.char_det is not None and len(boxes):
                per_col = self.detect_chars_in_columns(page, boxes)
                for col, ch in zip(result["columns"], per_col):
                    col["chars"] = {
                        "boxes": ch["boxes"].tolist(),
                        "scores": ch["scores"].tolist(),
                    }
            results.append(result)
        if self.recognizer is not None and all_crops:
            # one batch for every page's crops
            self._attach_texts(results, crop_spans, self.recognize_crops(all_crops), rescore)
        return results

    def _process_pages_tiled(self, images: list, pages, names: list) -> list[dict]:
        """Batched production cascade: one full-page forward for columns, ONE
        forward over all pages' tiles for characters (merged per page with
        cross-tile NMS), one recognizer batch for all column crops. The
        ship-once route for equal-shape pages; else the host path."""
        assert self.column_det is not None, "no column model configured"
        if self.ship_once and len({tuple(im.shape) for im in images}) == 1:
            return self._ship_once(_stack(images, pages), names)
        on_dev = [self._on_device(im) for im in images]
        with _stage("columns"):
            col_dets = [self._dedup(d) for d in self.column_det(on_dev)]
        # characters: all pages' tiles through one forward
        char_pages = (None if self.char_det is None
                      else self._tiled_pages(self.char_det, on_dev))
        return self._read_columns(
            names, col_dets, char_pages, [tuple(im.shape[:2]) for im in images],
            lambda crops: self.recognize_crops([self._crop(on_dev[pi], bd) for pi, bd in crops]))

    def _merge(self, out: dict, spans, metas_all: list, shapes) -> list[dict]:
        """Every page's tiles merged by one batched cross-tile NMS."""
        return merge_tile_detections_pages(
            [
                [
                    {k: out[k][i] for k in ("boxes", "scores", "classes", "valid")}
                    for i in range(lo, hi)
                ]
                for lo, hi in spans
            ],
            [metas_all[lo:hi] for lo, hi in spans],
            page_shapes=list(shapes),
            max_det=self.max_det,
            device=self.device,
        )

    def _ship_once(self, stack: torch.Tensor, names: list) -> list[dict]:
        """Equal-shape pages to the device once (padded to a bucket); the
        column letterbox, the tiles and the crops derive there. With
        ``transport="yc"`` (pages whose sides are multiples of 4) the host
        packs luma and 4x4-pooled chroma and the device rebuilds RGB."""
        b = len(stack)
        nb = next_bucket(b, min_bucket=1)
        h0, w0 = stack.shape[1:3]
        if self.transport == "yc" and h0 % 4 == 0 and w0 % 4 == 0:
            y, c = pack_yc(stack)
            pages_dev = unpack_yc(y.to(self.device), c.to(self.device))
        else:
            pages_dev = stack.to(self.device)
        if nb > b:
            pages_dev = torch.cat([pages_dev, pages_dev.new_zeros((nb - b, *stack.shape[1:]))])
        hw = (h0, w0)
        with _stage("columns"):
            col_dets = [
                self._dedup(d)
                for d in self._detect_pages_device(
                    self.column_det, pages_dev, hw, imgsz=self.col_imgsz
                )[:b]
            ]

        # characters: all pages' tiles through one forward
        char_pages: list[dict] | None = None
        if self.char_det is not None:
            if not self.char_det.ready:
                self.char_det._setup()
            with _stage("tiles"):
                out, metas = self._detect_tiles_device(pages_dev)
            t = len(metas)
            with _stage("cross-tile NMS"):
                char_pages = self._merge(out, [(i * t, (i + 1) * t) for i in range(b)],
                                         metas * b, [hw] * b)

        return self._read_columns(
            names, col_dets, char_pages, [hw] * b,
            lambda crops: self.recognize_boxes_device(
                pages_dev, [pi for pi, _ in crops], [bd for _, bd in crops]))

    def save_result(self, result: dict, out_path: str | Path) -> None:
        """One result as YAML (unicode kept, keys in order)."""
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            yaml.safe_dump(result, f, allow_unicode=True, sort_keys=False)
