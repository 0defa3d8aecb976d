"""SAM task (counterpart of ``kuzu/tasks/sam.py``): promptable-segmentation
training, prediction and automatic mask generation.

``SAMTrainer`` trains SAM-lite (``models/sam.py``) on YOLO-seg polygon
folders: one sampled instance an image a step, prompted by a foreground
point and, half the time, its box; the loss is the best of the K masks on
BCE + dice, plus MSE of the IoU head against each mask's thresholded IoU,
weighted by whether the image holds an instance. AdamW by default; the
validation runs the EMA weights and returns the mean IoU of the mask the
IoU head picks. ``SAMPredictor`` segments from point and box prompts in
the letterboxed frame; :meth:`SAMPredictor.everything` prompts a point
grid in one decode and deduplicates the masks on the host, in numpy, as
JAX's does.

The model is built as JAX's task builds it, with the einsum attention: the
K3 / K4 kernel route is ``SAM(attn_impl=...)``'s switch, which callers set.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from kuzu_torch.api.model import register_task
from kuzu_torch.core.checkpoint import CheckpointManager, load_inference_params
from kuzu_torch.core.config import load_config
from kuzu_torch.core.train import TrainState
from kuzu_torch.data.image_io import imread_rgb
from kuzu_torch.data.loader import DataLoader
from kuzu_torch.data.yolo_dataset import YoloSegmentDataset, letterbox_np, load_dataset_yaml
from kuzu_torch.models.sam import BG, BOX_BR, BOX_TL, FG, PAD, SAM, init_sam_
from kuzu_torch.models.yolo.detector import resolve_device
from kuzu_torch.tasks.base import BaseTrainer, resolve_val_batches

N_PROMPTS = 4  # [fg point, box_tl, box_br, pad]: the static prompt width


class SAMPromptDataset:
    """YOLO-seg polygons -> (image, prompt, instance mask) samples, over
    ``YoloSegmentDataset`` (64 instance slots, overlap masks at ratio 4);
    the prompt's draws come from ``default_rng((seed * 9176 + epoch * 7919
    + idx) % 2**31)`` in JAX's order."""

    def __init__(self, spec, split: str, imgsz: int, seed: int = 0, augment: bool = False):
        self.base = YoloSegmentDataset(spec, split=split, imgsz=imgsz, max_boxes=64,
                                       augment=augment, seed=seed)
        self.imgsz = imgsz
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, e: int) -> None:
        self._epoch = e
        self.base.set_epoch(e)

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        s = self.base[idx]
        rng = np.random.default_rng((self.seed * 9176 + self._epoch * 7919 + idx) % (2**31))
        overlap = s["masks"]  # (S / r, S / r) int32, pixel i + 1 = instance i
        n = int(s["mask_gt"].sum())
        points = np.zeros((N_PROMPTS, 2), np.float32)
        labels = np.full((N_PROMPTS,), PAD, np.int32)
        mh, mw = overlap.shape
        mask = np.zeros((mh, mw), np.float32)
        if n > 0:
            i = int(rng.integers(n))
            mask = (overlap == i + 1).astype(np.float32)
            ys, xs = np.nonzero(mask)
            if len(ys):
                j = int(rng.integers(len(ys)))
                points[0] = ((xs[j] + 0.5) / mw, (ys[j] + 0.5) / mh)  # mask grid -> [0, 1]
                labels[0] = FG
            if rng.random() < 0.5:
                x1, y1, x2, y2 = s["gt_boxes"][i] / self.imgsz
                points[1] = (x1, y1)
                points[2] = (x2, y2)
                labels[1], labels[2] = BOX_TL, BOX_BR
        return {"image": s["image"], "points": points, "labels": labels, "mask": mask,
                "has_instance": np.float32(n > 0)}


def build_sam(cfg, dtype: torch.dtype = torch.float32) -> SAM:
    """SAM at a config's widths (``imgsz``, ``dim``, ``enc_depth``,
    ``enc_heads``, ``num_masks``, ``encoder``), JAX's defaults where the
    config has none."""
    return SAM(img_size=int(cfg.get("imgsz", 256)), dim=int(cfg.get("dim", 256)),
               enc_depth=int(cfg.get("enc_depth", 6)), enc_heads=int(cfg.get("enc_heads", 8)),
               num_masks=int(cfg.get("num_masks", 3)), dtype=dtype,
               encoder_kind=str(cfg.get("encoder", "vit")))


def mask_losses(logits: torch.Tensor, gt: torch.Tensor):
    """(B, K, h, w) logits against (B, h, w) targets -> per mask (B, K): the
    mean sigmoid BCE (optax's), the dice loss and the IoU of the mask
    thresholded at logit 0 (no gradient)."""
    gt = gt[:, None]
    bce = (-gt * F.logsigmoid(logits) - (1.0 - gt) * F.logsigmoid(-logits)).mean((-2, -1))
    p = torch.sigmoid(logits)
    inter = (p * gt).sum((-2, -1))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum((-2, -1)) + gt.sum((-2, -1)) + 1.0)
    hard = (logits > 0).float()
    hi = (hard * gt).sum((-2, -1))
    iou = hi / torch.clamp(hard.sum((-2, -1)) + gt.sum((-2, -1)) - hi, min=1.0)
    return bce, dice, iou


def resize_gt(gt: torch.Tensor, hw) -> torch.Tensor:
    """GT masks onto the decoder's grid where they differ: JAX's ``nearest``
    resize samples at half-pixel centres, torch's ``nearest-exact``."""
    if tuple(gt.shape[-2:]) == tuple(hw):
        return gt
    return F.interpolate(gt[:, None], size=tuple(hw), mode="nearest-exact")[:, 0]


class SAMTrainer(BaseTrainer):
    auto_optimizer = "adamw"

    def build_datasets(self):
        cfg = self.cfg
        imgsz = int(cfg.get("imgsz", 256))
        spec = load_dataset_yaml(cfg.data)
        self.train_ds = SAMPromptDataset(spec, "train", imgsz, seed=int(cfg.get("seed", 0)),
                                         augment=bool(cfg.get("augment", True)))
        try:
            self.val_ds = SAMPromptDataset(spec, "val", imgsz)
        except FileNotFoundError:
            self.val_ds = SAMPromptDataset(spec, "train", imgsz)
        batch = int(cfg.get("batch", 8))
        workers = int(cfg.get("workers", 4))
        return (DataLoader(self.train_ds, batch, shuffle=True, seed=int(cfg.get("seed", 0)),
                           num_workers=workers),
                DataLoader(self.val_ds, batch, shuffle=False, pad_last=True,
                           num_workers=workers))

    def build_model(self) -> SAM:
        """SAM at the config's widths and dtype, seeded from ``seed``; a
        second copy (eval mode) for the validation's EMA weights."""
        cfg = self.cfg
        dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32
        model = init_sam_(build_sam(cfg, dtype), torch.Generator().manual_seed(
            int(cfg.get("seed", 0))))
        self._val_model = build_sam(cfg, dtype).to(self.device).eval()
        return model.to(self.device)

    def loss_fn(self, model, batch: dict, rng: torch.Generator | None = None):
        """Best-of-K BCE + dice on the masks, MSE of the IoU head against
        each mask's thresholded IoU, weighted by ``has_instance``;
        ``best_iou`` is the IoU of the best mask (the first on ties)."""
        logits, iou_pred = model(batch["image"], batch["points"], batch["labels"], train=True)
        gt = resize_gt(batch["mask"], logits.shape[-2:])
        bce, dice, iou = mask_losses(logits, gt)
        per = bce + dice  # (B, K)
        has = batch["has_instance"]
        denom = torch.clamp(has.sum(), min=1.0)
        loss_mask = (per.min(dim=1).values * has).sum() / denom
        loss_iou = (((iou_pred - iou) ** 2).mean(1) * has).sum() / denom
        best_iou = (torch.gather(iou, 1, per.argmin(1)[:, None])[:, 0] * has).sum() / denom
        return loss_mask + loss_iou, {"mask_loss": loss_mask.detach(),
                                      "iou_loss": loss_iou.detach(),
                                      "best_iou": best_iou.detach()}

    @torch.no_grad()
    def validate(self, state: TrainState) -> dict[str, float]:
        """The mean IoU (the fitness) of the mask the IoU head ranks first,
        EMA weights, over the validation split (``val_batches`` caps it);
        padded rows of the last batch count for nothing."""
        model = self._val_model
        model.load_state_dict(state.ema_state_dict())
        tot = cnt = 0.0
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            sm = batch.pop("sample_mask", None)
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in batch.items()}
            has = b["has_instance"]
            if sm is not None:
                has = has * torch.from_numpy(np.asarray(sm, np.float32)).to(self.device)
            logits, iou_pred = model(b["image"], b["points"], b["labels"])
            _, _, iou = mask_losses(logits, resize_gt(b["mask"], logits.shape[-2:]))
            best = torch.gather(iou, 1, iou_pred.argmax(1)[:, None])[:, 0]
            tot += float((best * has).sum())
            cnt += float(has.sum())
        miou = tot / max(cnt, 1.0)
        return {"miou": miou, "fitness": miou}


class SAMPredictor:
    """Prompted segmentation and automatic mask generation from a trained
    SAM run dir (its ``args.yaml`` widths, EMA weights preferred), f32 as
    JAX's predictor builds it, on ``device`` (the card when None).
    :meth:`from_model` wraps a built model."""

    def __init__(self, cfg, device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ready = False

    @classmethod
    def from_model(cls, model: SAM) -> "SAMPredictor":
        """A predictor over ``model`` on its device (eval mode)."""
        dev = next(model.parameters()).device
        self = cls({}, device=dev)
        self.model, self.imgsz, self.ready = model.eval(), model.img_size, True
        return self

    def _setup(self) -> None:
        run_dir = Path(str(self.cfg.get("model")))
        args = run_dir / "args.yaml"
        tc = load_config(args if args.exists() else None)
        self.imgsz = int(tc.get("imgsz", 256))
        self.model = build_sam(tc)
        self.model.load_state_dict(load_inference_params(CheckpointManager(run_dir / "weights"),
                                                         train_cfg=tc))
        self.model.to(self.device).eval()
        self.ready = True

    def _load(self, source) -> tuple[np.ndarray, tuple[int, int]]:
        img = imread_rgb(source) if isinstance(source, (str, Path)) else np.asarray(source)
        hw = img.shape[:2]
        canvas, gain, pad = letterbox_np(img, self.imgsz)
        self._geom = (gain, pad, hw)
        return canvas, hw

    @torch.no_grad()
    def encode(self, canvas: np.ndarray) -> torch.Tensor:
        """The memory of one letterboxed (S, S, 3) uint8 canvas, (1, N, dim)."""
        return self.model.encode(torch.from_numpy(np.ascontiguousarray(canvas[None])).to(
            self.device))

    @torch.no_grad()
    def decode(self, mem: torch.Tensor, pts: np.ndarray, lbl: np.ndarray):
        """(logits (P, K, S / 4, S / 4), IoU (P, K)) as numpy for P prompt
        sets over one memory."""
        n = len(pts)
        logits, iou = self.model.decode(mem.expand(n, -1, -1),
                                        torch.from_numpy(pts).to(self.device),
                                        torch.from_numpy(lbl).to(self.device))
        return logits.cpu().numpy(), iou.cpu().numpy()

    def __call__(self, source, points=None, labels=None, bboxes=None):
        """Segment from prompts: points and boxes in the original image's
        pixels; returns (masks (N, S / 4, S / 4) bool in the letterboxed
        frame, IoU predictions (N,)), one mask a prompt (the best by its
        IoU prediction)."""
        if not self.ready:
            self._setup()
        canvas, _ = self._load(source)
        mem = self.encode(canvas)
        gain, (px, py), _ = self._geom
        s = self.imgsz
        prompts = []
        if points is not None:
            pts = np.atleast_2d(np.asarray(points, np.float32))
            lbl = np.ones(len(pts), np.int32) if labels is None else np.asarray(labels, np.int32)
            for p, lab in zip(pts, lbl):
                q = np.zeros((N_PROMPTS, 2), np.float32)
                m = np.full((N_PROMPTS,), PAD, np.int32)
                q[0] = ((p[0] * gain + px) / s, (p[1] * gain + py) / s)
                m[0] = FG if lab else BG
                prompts.append((q, m))
        if bboxes is not None:
            for b in np.atleast_2d(np.asarray(bboxes, np.float32)):
                q = np.zeros((N_PROMPTS, 2), np.float32)
                m = np.full((N_PROMPTS,), PAD, np.int32)
                q[0] = ((b[0] * gain + px) / s, (b[1] * gain + py) / s)
                q[1] = ((b[2] * gain + px) / s, (b[3] * gain + py) / s)
                m[0], m[1] = BOX_TL, BOX_BR
                prompts.append((q, m))
        if not prompts:
            raise ValueError("provide points= and/or bboxes= (or use everything())")
        logits, iou = self.decode(mem, np.stack([q for q, _ in prompts]),
                                  np.stack([m for _, m in prompts]))
        rows = np.arange(len(prompts))
        best = iou.argmax(1)
        return logits[rows, best] > 0, iou[rows, best]

    def everything(self, source, grid: int = 8, iou_thresh: float = 0.7,
                   dedup_iou: float = 0.7):
        """Automatic mask generation: a grid x grid point lattice prompts
        the decoder in one batch; masks below ``iou_thresh`` predicted
        quality drop; duplicates are suppressed by mask IoU, best quality
        first, on the host. Returns (masks (M, S / 4, S / 4) bool, IoUs)."""
        if not self.ready:
            self._setup()
        canvas, _ = self._load(source)
        mem = self.encode(canvas)
        n = grid * grid
        xs, ys = np.meshgrid((np.arange(grid) + 0.5) / grid, (np.arange(grid) + 0.5) / grid)
        pts = np.zeros((n, N_PROMPTS, 2), np.float32)
        lbl = np.full((n, N_PROMPTS), PAD, np.int32)
        pts[:, 0, 0] = xs.ravel()
        pts[:, 0, 1] = ys.ravel()
        lbl[:, 0] = FG
        logits, iou = self.decode(mem, pts, lbl)
        return dedup_masks(logits, iou, iou_thresh, dedup_iou)


def dedup_masks(logits: np.ndarray, iou: np.ndarray, iou_thresh: float, dedup_iou: float):
    """JAX's host-side mask generation after the decode: each prompt's best
    mask by predicted IoU, the quality filter, then greedy suppression by
    mask IoU in descending quality (masks under 4 pixels dropped)."""
    rows = np.arange(len(iou))
    best = iou.argmax(1)
    masks = logits[rows, best] > 0
    quality = iou[rows, best]
    keep = quality >= iou_thresh
    masks, quality = masks[keep], quality[keep]
    out, out_q = [], []
    for i in np.argsort(-quality):
        m = masks[i]
        if m.sum() < 4:
            continue
        if not any((m & o).sum() / max((m | o).sum(), 1) > dedup_iou for o in out):
            out.append(m)
            out_q.append(quality[i])
    return (np.stack(out) if out else np.zeros((0, *masks.shape[1:]), bool),
            np.asarray(out_q, np.float32))


register_task("sam", trainer=SAMTrainer, predictor=SAMPredictor)
