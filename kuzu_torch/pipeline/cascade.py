"""Page -> text cascade, the ship-once tiled path (counterpart of
``kuzu/pipeline/cascade.py``'s ``KuzushijiPipeline``).

One call of :meth:`KuzushijiPipeline.process_pages` takes a batch of
equal-shape decoded pages (uint8 RGB) to the device once, then:

1. column detection on the full pages, letterboxed on the device
   (``device_pages.device_letterbox``), then same-region dedup;
2. character detection over every page's overlap tiles in one forward
   (``device_pages.device_tiles``), merged per page by one batched
   cross-tile NMS (``tiling.merge_tile_detections_pages``, K1);
3. on the host, in numpy as the reference: each column snapped to its
   character support, orphan character segments made columns, dedup again;
4. every column's crop letterboxed on the device from the resident pages
   (``device_pages.device_crops``) and read in one batch: by the CTC CRNN
   with greedy CTC decoding, or by the TrOCR (greedy, ``beam``, or
   ``beam_lm``: beam n-best reranked by the char-LM's pseudo-log-likelihood);
5. with a char-LM and ``lm_mode="annotate"``, each column's text scored by
   that pseudo-log-likelihood (``lm_score``).

The column geometry below is a copy of the reference's numpy (f64 where it
is f64), so boxes agree to the bit where the detections do. The host path
(cv2 tiling for mixed page shapes, ``ship_once=False``), ``process_page``'s
reference-shaped flow (``tile_grid <= 1``), the ``yc`` transport and ``dp``
are not ported and raise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml
from torch.profiler import record_function

from kuzu_torch.core.config import load_config
from kuzu_torch.data.loader import next_bucket
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.pipeline.device_pages import device_crops, device_letterbox, device_tiles
from kuzu_torch.pipeline.tiling import merge_tile_detections_pages
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


def _stage(name: str) -> record_function:
    """The profiler range of one cascade stage, ``cascade/<name>``."""
    return record_function(f"cascade/{name}")


def _pages_tensor(pages) -> torch.Tensor:
    """A (B, H, W, 3) uint8 tensor from a list of equal-shape (H, W, 3) uint8
    arrays or from such a tensor."""
    if isinstance(pages, torch.Tensor):
        stack = pages
    else:
        shapes = {tuple(np.shape(p)) for p in pages}
        if len(shapes) > 1:
            raise NotImplementedError(
                f"pages of mixed shapes {sorted(shapes)}: the reference's host path "
                "(cv2 tiling and crops) is not ported (ROADMAP section 1 item 9); "
                "pass equal-shape pages")
        stack = torch.from_numpy(np.stack([np.asarray(p) for p in pages]))
    if stack.dtype != torch.uint8 or stack.dim() != 4 or stack.shape[-1] != 3:
        raise ValueError(f"pages are (B, H, W, 3) uint8 RGB, got {tuple(stack.shape)} "
                         f"{stack.dtype}")
    return stack


class KuzushijiPipeline:
    """Column detector + tiled character detector + recognizer (+ char-LM).

    ``column_model`` / ``char_model`` are port run dirs or
    ``DetectPredictor``s, ``recognizer`` a run dir or a ``CTCPredictor`` /
    ``RecognizePredictor``, ``lm`` a run dir or an ``LMPredictor``; a
    recognizer run dir is a ``CTCTrainer`` or a ``RecognizeTrainer`` run
    (its ``args.yaml`` task says which), loaded at first use (a LoRA run's
    adapters fused). Everything runs on ``device`` (the card when
    None). Each stage runs inside a ``torch.profiler.record_function``
    range named ``cascade/<stage>`` (``STAGES``, then ``LM_STAGE`` where the
    LM annotates), which costs nothing without a profiler."""

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
        ship_once: bool = True,
        transport: str = "rgb",
        col_imgsz: int | None = None,  # column letterbox side (None: the model's)
        device: torch.device | str | None = None,
    ):
        if dp:
            raise NotImplementedError("data-parallel serving (dp > 0) is not ported "
                                      "(ROADMAP section 1 item 12)")
        if not ship_once:
            raise NotImplementedError(
                "the host path (ship_once=False: cv2 tiling and crops) is not ported "
                "(ROADMAP section 1 item 9)")
        if transport != "rgb":
            raise NotImplementedError(
                f"transport={transport!r}: the chroma-subsampled transport needs cv2 "
                "(pack_yc) and is not ported (ROADMAP section 1 item 7)")
        self.device = resolve_device(device)
        self.tile_grid = tile_grid
        self.tile_overlap = tile_overlap
        self.margin = margin
        self.decode = decode
        self.num_beams = num_beams
        self.max_det = max_det
        self.lm_weight = lm_weight
        self.lm_mode = lm_mode
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

    def _dedup(self, det) -> dict:
        """Same-region column suppression (``dedup_columns``) on one
        detection; returns a plain dict of boxes/scores/classes. No-op when
        ``col_dedup`` is off."""
        out = {k: np.asarray(det[k]) for k in ("boxes", "scores", "classes")}
        if not self.col_dedup or len(out["boxes"]) == 0:
            return out
        keep = dedup_columns(out["boxes"], out["scores"])
        return {k: v[keep] for k, v in out.items()}

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

    def _refine_columns(self, col_dets: list[dict], char_pages: list[dict], hw) -> None:
        """Snap each page's columns to its char support (refined duplicates
        collapse onto the same segment, so dedup again), then recover the
        char segments no column claims as columns; in place."""
        ph, pw = hw
        for pi, det in enumerate(col_dets):
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

    def _page_results(self, names: list, col_dets: list[dict], char_pages, hw):
        """Per page: columns in reading order with their characters, and the
        margin-expanded crop window of every column."""
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
                bounds = self._column_bounds(hw, boxes)
                crop_spans.append((len(all_crops), len(all_crops) + len(bounds)))
                all_crops.extend((pi, bd) for bd in bounds)
            else:
                crop_spans.append((0, 0))
            results.append(result)
        return results, all_crops, crop_spans

    # --------------------------------------------------------------- e2e
    def process_page(self, image, name: Any = 0) -> dict[str, Any]:
        """One page (H, W, 3) uint8 through the tiled batched path."""
        return self.process_pages([image], names=[name])[0]

    def process_pages(self, pages, names: list | None = None) -> list[dict]:
        """Batched cascade over decoded pages: a list of equal-shape (H, W, 3)
        uint8 RGB arrays or a (B, H, W, 3) uint8 tensor. Each result's
        ``"image"`` is the page's entry of ``names`` (its index when None)."""
        if len(pages) == 0:
            return []
        if self.tile_grid <= 1:
            raise NotImplementedError(
                "tile_grid <= 1 (process_page's reference-shaped flow: per-column "
                "char detection on cv2 crops) is not ported (ROADMAP section 1 item "
                "9); the production cascade runs tile_grid=2")
        stack = _pages_tensor(pages)
        names = list(range(len(stack))) if names is None else list(names)
        return self._process_pages_tiled(stack, names)

    def _process_pages_tiled(self, stack: torch.Tensor, names: list) -> list[dict]:
        """Batched production cascade: one full-page forward for columns, ONE
        forward over all pages' tiles for characters (merged per page with
        cross-tile NMS), one recognizer batch for all column crops."""
        assert self.column_det is not None, "no column model configured"
        b = len(stack)
        nb = next_bucket(b, min_bucket=1)
        pages_dev = stack.to(self.device)
        if nb > b:
            pages_dev = torch.cat([pages_dev, pages_dev.new_zeros((nb - b, *stack.shape[1:]))])
        hw = tuple(stack.shape[1:3])
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
            spans = [(i * t, (i + 1) * t) for i in range(b)]
            with _stage("cross-tile NMS"):
                char_pages = merge_tile_detections_pages(
                    [
                        [
                            {
                                k: out[k][i]
                                for k in ("boxes", "scores", "classes", "valid")
                            }
                            for i in range(lo, hi)
                        ]
                        for lo, hi in spans
                    ],
                    [metas] * b,
                    page_shapes=[hw] * b,
                    max_det=self.max_det,
                    device=self.device,
                )

        with _stage("geometry"):
            if char_pages is not None and self.col_refine:
                self._refine_columns(col_dets, char_pages, hw)
            results, all_crops, crop_spans = self._page_results(names, col_dets, char_pages, hw)
        if self.recognizer is not None and all_crops:
            texts = self.recognize_boxes_device(
                pages_dev,
                [pi for pi, _ in all_crops],
                [bd for _, bd in all_crops],
            )
            scores = None
            if self.lm is not None and self.lm_mode != "off":
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
        return results
