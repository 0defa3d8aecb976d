"""Pose (keypoint) task (counterpart of ``kuzu/tasks/pose.py``): the detect
stack plus per-anchor keypoints, the OKS location loss, the visibility BCE,
box and OKS pose mAP in validation, and keypoints on the predict Results.

The dataset's ``kpt_shape`` overrides the model yaml's (the reference's
PoseModel), in the trainer and, from the run's ``data_spec.yaml``, in the
predictor. Keypoints of the NMS survivors are gathered by their anchor
indices (NMS on the K1 kernel on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from kuzu_torch.api.model import register_task
from kuzu_torch.api.results import Keypoints
from kuzu_torch.core.metrics import DetMetrics
from kuzu_torch.data.yolo_dataset import YoloPoseDataset, load_dataset_yaml
from kuzu_torch.models.yolo.graph import parse_model_yaml, resolve_model_spec
from kuzu_torch.models.yolo.modules import kpts_decode
from kuzu_torch.ops.anchors import make_anchors
from kuzu_torch.ops.pose_loss import OKS_SIGMA_17, pose_loss
from kuzu_torch.tasks.base import resolve_val_batches
from kuzu_torch.tasks.detect import DetectPredictor, DetectTrainer, DetectValidator


def _with_kpt_shape(spec, ks):
    """``spec`` with its Pose nodes' ``kpt_shape`` set to ``ks`` (only where
    the model has a Pose node: else the head check must still see a detect
    head)."""
    pose_nodes = [n for n in spec.nodes if n.module == "Pose"]
    if ks and pose_nodes:
        for node in pose_nodes:
            node.args[1] = list(ks)
        spec.kpt_shape = tuple(ks)
    return spec


def decode_keypoints(detector, outputs: dict, out: dict) -> torch.Tensor:
    """The kept detections' keypoints (B, max_det, K, D) in letterbox
    pixels: xy decoded and scaled by the anchor's stride, the other values
    through a sigmoid, gathered by ``out["indices"]``."""
    shapes = [(f.shape[1], f.shape[2]) for f in outputs["det"]]
    anchor_points, stride_t = make_anchors(shapes, detector.strides,
                                           device=outputs["kpts_raw"].device)
    kp = kpts_decode(anchor_points, outputs["kpts_raw"])
    kp_px = torch.cat([kp[..., :2] * stride_t[None, :, None, :], torch.sigmoid(kp[..., 2:])],
                      dim=-1)
    k, d = kp_px.shape[-2:]
    return torch.gather(kp_px, 1, out["indices"][..., None, None].expand(-1, -1, k, d))


class PoseTrainer(DetectTrainer):
    head_kind = "pose"

    def build_datasets(self):
        """(train, val) loaders over ``cfg.data``'s pose folder (HSV and
        fliplr with ``flip_idx`` on the training split)."""
        cfg = self.cfg
        imgsz = int(cfg.get("imgsz", 640))
        max_boxes = int(cfg.get("max_boxes", 300))
        spec = load_dataset_yaml(cfg.data)

        def mk(split, augment):
            return YoloPoseDataset(spec, split=split, imgsz=imgsz, max_boxes=max_boxes,
                                   augment=augment, seed=int(cfg.get("seed", 0)))

        train_ds = mk("train", bool(cfg.get("augment", True)))
        try:
            val_ds = mk("val", False)
        except FileNotFoundError:
            val_ds = mk("train", False)
        return self.make_loaders(train_ds, val_ds, spec["nc"], spec["names"],
                                 kpt_shape=spec.get("kpt_shape"))

    def _resolve_model(self, name: str):
        path, scale = resolve_model_spec(name)
        spec = parse_model_yaml(path, scale=scale, nc=self.data_spec["nc"])
        return _with_kpt_shape(spec, self.data_spec.get("kpt_shape"))

    def loss_fn(self, model, batch: dict, rng: torch.Generator | None = None):
        outputs = model(batch["image"])
        return pose_loss(
            outputs, batch["gt_labels"], batch["gt_boxes"], batch["gt_kpts"], batch["mask_gt"],
            nc=self.nc, imgsz=self.imgsz, strides=self.strides,
            box_w=float(self.cfg.get("box", 7.5)),
            cls_w=float(self.cfg.get("cls", 0.5)),
            dfl_w=float(self.cfg.get("dfl", 1.5)),
            pose_w=float(self.cfg.get("pose", 12.0)),
            kobj_w=float(self.cfg.get("kobj", 1.0)),
            reg_max=self.spec.reg_max,
        )

    @torch.no_grad()
    def validate(self, state) -> dict[str, float]:
        """Box mAP and OKS pose mAP (single-label NMS keeping anchor indices
        for the keypoint gather; OKS with the 0.53 area factor as the
        matching similarity); fitness is their sum."""
        det = self._val_det.load_state_dict(state.ema_state_dict())
        conf = float(self.cfg.get("conf") or 0.001)
        iou_t = float(self.cfg.get("iou", 0.7))
        max_det = int(self.cfg.get("max_det", 300))
        use_scipy = bool(self.cfg.get("val_scipy", False))
        dm_box, dm_pose = DetMetrics(use_scipy=use_scipy), DetMetrics(use_scipy=use_scipy)
        sigma = OKS_SIGMA_17.numpy()
        max_batches = resolve_val_batches(self.cfg, self.val_loader)
        for bi, batch in enumerate(self.val_loader):
            if bi >= max_batches:
                break
            mask = batch.pop("sample_mask", np.ones(len(batch["image"]), np.float32))
            outputs = det.infer(torch.from_numpy(batch["image"]))
            out = det.select(det.decode(outputs), conf, iou_t, max_det, return_indices=True)
            out["kpts"] = decode_keypoints(det, outputs, out)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for i in range(len(batch["image"])):
                if mask[i] == 0:
                    continue
                pv = np.asarray(out["valid"][i], bool)
                pb, ps, pc, pk = (out[k][i][pv] for k in ("boxes", "scores", "classes", "kpts"))
                gv = np.asarray(batch["mask_gt"][i], bool)
                gb = np.asarray(batch["gt_boxes"][i])[gv]
                gc = np.asarray(batch["gt_labels"][i])[gv]
                gk = np.asarray(batch["gt_kpts"][i])[gv]
                ones_p, ones_g = np.ones(len(pb), bool), np.ones(len(gb), bool)
                dm_box.update(pb, ps, pc, ones_p, gb, gc, ones_g)
                dm_pose.update(pb, ps, pc, ones_p, gb, gc, ones_g,
                               iou_matrix=oks_matrix(gk, pk, gb, sigma))
        box, pose = dm_box.compute(), dm_pose.compute()
        return {
            "map50": box["map50"], "map": box["map"],
            "precision": box["precision"], "recall": box["recall"],
            "pose_map50": pose["map50"], "pose_map": pose["map"],
            "fitness": box["fitness"] + pose["fitness"],
        }


def oks_matrix(gt_kpts: np.ndarray, pred_kpts: np.ndarray, gt_boxes: np.ndarray,
               sigma17: np.ndarray) -> np.ndarray:
    """(n_gt, n_pred) Object Keypoint Similarity (cocoeval's Gaussian, box
    area x 0.53; a GT keypoint of visibility 0, or of zero coordinates
    without a visibility, does not count)."""
    n_gt, n_pred = len(gt_kpts), len(pred_kpts)
    if n_gt == 0 or n_pred == 0:
        return np.zeros((n_gt, n_pred), np.float32)
    k = gt_kpts.shape[1]
    sigma = (np.asarray(sigma17, np.float32) if k == 17
             else np.full((k,), 1.0 / k, np.float32))
    d2 = ((gt_kpts[:, None, :, :2] - pred_kpts[None, :, :, :2]) ** 2).sum(-1)
    if gt_kpts.shape[-1] == 3:
        vis = gt_kpts[..., 2] != 0
    else:
        vis = np.abs(gt_kpts[..., :2]).sum(-1) > 0
    wh = gt_boxes[:, 2:4] - gt_boxes[:, :2]
    area = wh[:, 0] * wh[:, 1] * 0.53
    e = d2 / ((2 * sigma[None, None]) ** 2 * (area[:, None, None] + 1e-7) * 2)
    return (np.exp(-e) * vis[:, None]).sum(-1) / (vis.sum(-1)[:, None] + 1e-7)


class PosePredictor(DetectPredictor):
    """The detect predictor whose forward also returns the kept boxes'
    keypoints (pixels, sigmoid visibility); ``Results.keypoints`` holds
    them in the frame's pixels."""

    def _resolve_arch(self, name: str, data_spec: dict):
        path, scale = resolve_model_spec(name)
        spec = parse_model_yaml(path, scale=scale, nc=data_spec["nc"])
        return _with_kpt_shape(spec, data_spec.get("kpt_shape"))

    @torch.no_grad()
    def _fwd(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        if not self.ready:
            self._setup()
        det = self.detector
        outputs = det.infer(images)
        out = det.select(det.decode(outputs), self.conf, self.iou, self.max_det,
                         return_indices=True)
        out["kpts"] = decode_keypoints(det, outputs, out)
        return out

    def _attach_extras(self, result, out, i, valid, orig_shape, gain, pad) -> None:
        kp = np.asarray(out["kpts"][i][valid]).copy()
        if len(kp):
            kp[..., 0] = (kp[..., 0] - pad[0]) / gain
            kp[..., 1] = (kp[..., 1] - pad[1]) / gain
        result.keypoints = Keypoints(kp, orig_shape)


class PoseValidator(DetectValidator):
    """The standalone validation of a pose run (box and pose mAP), through
    the pose trainer (JAX's builds a ``DetectTrainer`` and refuses)."""

    trainer_cls = PoseTrainer


register_task("pose", trainer=PoseTrainer, validator=PoseValidator, predictor=PosePredictor)
