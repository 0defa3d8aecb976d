"""ByteTrack multi-object tracker with a constant-velocity Kalman filter,
and BoT-SORT with camera-motion compensation (a copy of
``kuzu/pipeline/tracker.py``, which the port may not import): two-stage
association (high-confidence detections matched first by IoU, then the
low-confidence rest rescues unmatched tracks), the track lifecycle (new ->
tracked -> lost -> removed after ``track_buffer`` frames) and a cxcyah
Kalman filter. Host numpy, frame by frame; the detector runs on the card.

Greedy IoU matching, as JAX's. BoT-SORT's :class:`GMC` needs OpenCV's
sparse optical flow: it imports cv2 when it is built and raises an
ImportError naming cv2 where cv2 is not installed, rather than tracking
without motion compensation. :class:`ByteTracker` needs no cv2.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from kuzu_torch.core.metrics import box_iou_np


class KalmanFilterCXCYAH:
    """Constant-velocity KF over (cx, cy, aspect, height) + velocities."""

    def __init__(self) -> None:
        self.F = np.eye(8)
        self.F[:4, 4:] = np.eye(4)  # x' = x + v
        self.H = np.eye(4, 8)
        self._std_pos = 1.0 / 20
        self._std_vel = 1.0 / 160

    def initiate(self, meas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        mean = np.zeros(8)
        mean[:4] = meas
        h = meas[3]
        std = np.array(
            [2 * self._std_pos * h] * 2 + [1e-2, 2 * self._std_pos * h]
            + [10 * self._std_vel * h] * 2 + [1e-5, 10 * self._std_vel * h]
        )
        return mean, np.diag(std**2)

    def predict(self, mean: np.ndarray, cov: np.ndarray):
        h = mean[3]
        q = np.array(
            [self._std_pos * h] * 2 + [1e-2, self._std_pos * h]
            + [self._std_vel * h] * 2 + [1e-5, self._std_vel * h]
        )
        mean = self.F @ mean
        cov = self.F @ cov @ self.F.T + np.diag(q**2)
        return mean, cov

    def update(self, mean: np.ndarray, cov: np.ndarray, meas: np.ndarray):
        h = mean[3]
        r = np.array([self._std_pos * h] * 2 + [1e-1, self._std_pos * h])
        S = self.H @ cov @ self.H.T + np.diag(r**2)
        K = cov @ self.H.T @ np.linalg.inv(S)
        innov = meas - self.H @ mean
        mean = mean + K @ innov
        cov = (np.eye(8) - K @ self.H) @ cov
        return mean, cov


def xyxy_to_cxcyah(b: np.ndarray) -> np.ndarray:
    w = b[2] - b[0]
    h = max(b[3] - b[1], 1e-6)
    return np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, w / h, h])


def cxcyah_to_xyxy(s: np.ndarray) -> np.ndarray:
    h = s[3]
    w = s[2] * h
    return np.array([s[0] - w / 2, s[1] - h / 2, s[0] + w / 2, s[1] + h / 2])


@dataclass
class Track:
    track_id: int
    mean: np.ndarray
    cov: np.ndarray
    score: float
    cls: int
    state: str = "new"  # new | tracked | lost
    frames_lost: int = 0
    hits: int = 1
    history: list = field(default_factory=list)

    @property
    def box(self) -> np.ndarray:
        return cxcyah_to_xyxy(self.mean[:4])


def _greedy_match(iou: np.ndarray, thresh: float
                  ) -> tuple[list[tuple[int, int]], list[int], list[int]]:
    """Greedy max-IoU matching. Returns (pairs, unmatched_a, unmatched_b)."""
    pairs = []
    if iou.size:
        m = iou.copy()
        while True:
            a, b = np.unravel_index(np.argmax(m), m.shape)
            if m[a, b] < thresh:
                break
            pairs.append((int(a), int(b)))
            m[a, :] = -1
            m[:, b] = -1
    ua = [i for i in range(iou.shape[0]) if i not in {a for a, _ in pairs}]
    ub = [j for j in range(iou.shape[1]) if j not in {b for _, b in pairs}]
    return pairs, ua, ub


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "BoT-SORT's camera-motion compensation (GMC) needs OpenCV (cv2), which is not "
            "installed: track with tracker='bytetrack', or install opencv-python") from e
    return cv2


class GMC:
    """Global (camera) motion compensation by sparse optical flow:
    goodFeaturesToTrack + pyramidal LK between consecutive frames, a robust
    partial-affine fit; the affine warps track predictions into the current
    frame before association."""

    def __init__(self, max_corners: int = 200):
        self._cv2 = _cv2()
        self.max_corners = max_corners
        self._prev_gray = None

    def update(self, frame_rgb: np.ndarray) -> np.ndarray:
        """Returns a 2x3 affine mapping previous-frame coords -> current."""
        cv2 = self._cv2
        gray = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY)
        M = np.eye(2, 3, dtype=np.float32)
        if self._prev_gray is not None:
            pts = cv2.goodFeaturesToTrack(
                self._prev_gray, maxCorners=self.max_corners,
                qualityLevel=0.01, minDistance=8,
            )
            if pts is not None and len(pts) >= 8:
                nxt, status, _ = cv2.calcOpticalFlowPyrLK(self._prev_gray, gray, pts, None)
                good = status.ravel() == 1
                if good.sum() >= 8:
                    A, _ = cv2.estimateAffinePartial2D(pts[good], nxt[good], method=cv2.RANSAC)
                    if A is not None:
                        M = A.astype(np.float32)
        self._prev_gray = gray
        return M

    @staticmethod
    def warp_box(box: np.ndarray, M: np.ndarray) -> np.ndarray:
        pts = np.array([[box[0], box[1]], [box[2], box[3]]], np.float32)
        warped = pts @ M[:, :2].T + M[:, 2]
        return np.array(
            [
                min(warped[0, 0], warped[1, 0]),
                min(warped[0, 1], warped[1, 1]),
                max(warped[0, 0], warped[1, 0]),
                max(warped[0, 1], warped[1, 1]),
            ],
            np.float32,
        )


class ByteTracker:
    def __init__(
        self,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        match_thresh: float = 0.8,
        new_track_thresh: float = 0.6,
        track_buffer: int = 30,
    ):
        self.kf = KalmanFilterCXCYAH()
        self.high = track_high_thresh
        self.low = track_low_thresh
        self.match_iou = 1.0 - match_thresh  # match_thresh is a cost bound
        self.new_thresh = new_track_thresh
        self.buffer = track_buffer
        self.tracks: list[Track] = []
        self._next_id = 1

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray) -> list[Track]:
        """One frame of detections (xyxy) -> active tracks."""
        for t in self.tracks:
            t.mean, t.cov = self.kf.predict(t.mean, t.cov)

        hi = scores >= self.high
        lo = (scores >= self.low) & ~hi
        det_hi, det_lo = boxes[hi], boxes[lo]
        sc_hi, sc_lo = scores[hi], scores[lo]
        cl_hi = classes[hi]

        active = [t for t in self.tracks if t.state in ("tracked", "new")]
        lost = [t for t in self.tracks if t.state == "lost"]

        # stage 1: active + lost tracks vs high-confidence detections
        pool = active + lost
        track_boxes = np.stack([t.box for t in pool]) if pool else np.zeros((0, 4))
        iou1 = box_iou_np(track_boxes, det_hi)
        pairs1, un_t1, un_d1 = _greedy_match(iou1, max(self.match_iou, 0.1))
        for ti, di in pairs1:
            t = pool[ti]
            t.mean, t.cov = self.kf.update(t.mean, t.cov, xyxy_to_cxcyah(det_hi[di]))
            t.score = float(sc_hi[di])
            t.cls = int(cl_hi[di])
            t.state = "tracked"
            t.frames_lost = 0
            t.hits += 1
            t.history.append(t.box.copy())

        # stage 2: leftover *active* tracks vs low-confidence detections (BYTE)
        rem_tracks = [pool[i] for i in un_t1 if pool[i].state in ("tracked", "new")]
        tb2 = np.stack([t.box for t in rem_tracks]) if rem_tracks else np.zeros((0, 4))
        iou2 = box_iou_np(tb2, det_lo)
        pairs2, _, _ = _greedy_match(iou2, 0.3)
        for ti, di in pairs2:
            t = rem_tracks[ti]
            t.mean, t.cov = self.kf.update(t.mean, t.cov, xyxy_to_cxcyah(det_lo[di]))
            t.score = float(sc_lo[di])
            t.state = "tracked"
            t.frames_lost = 0
            t.hits += 1

        # unmatched tracks -> lost / removed
        matched_ids = {id(pool[ti]) for ti, _ in pairs1} | {id(rem_tracks[ti]) for ti, _ in pairs2}
        kept = []
        for t in self.tracks:
            if id(t) in matched_ids:
                kept.append(t)
                continue
            t.frames_lost += 1
            t.state = "lost"
            if t.frames_lost <= self.buffer:
                kept.append(t)
        self.tracks = kept

        # unmatched high-confidence detections -> new tracks
        for di in un_d1:
            if sc_hi[di] >= self.new_thresh:
                mean, cov = self.kf.initiate(xyxy_to_cxcyah(det_hi[di]))
                self.tracks.append(Track(self._next_id, mean, cov, float(sc_hi[di]),
                                         int(cl_hi[di]), state="tracked"))
                self._next_id += 1

        return [t for t in self.tracks if t.state == "tracked"]


class BoTSORT(ByteTracker):
    """ByteTrack + camera-motion compensation. Call ``update(boxes, scores,
    classes, frame=rgb)``: the GMC affine warps every track's predicted box
    into the current frame before association. Building one raises an
    ImportError naming cv2 where OpenCV is not installed."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gmc = GMC()

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray,
               frame: np.ndarray | None = None) -> list[Track]:
        if frame is not None:
            M = self.gmc.update(frame)
            if not np.allclose(M, np.eye(2, 3)):
                for t in self.tracks:
                    t.mean[:4] = xyxy_to_cxcyah(GMC.warp_box(t.box, M))
        return super().update(boxes, scores, classes)
