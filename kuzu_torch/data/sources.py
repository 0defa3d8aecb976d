"""Prediction input sources (counterpart of ``kuzu/data/sources.py``): image
paths, directories, globs, in-memory arrays and tensors, normalised into an
iterator of :class:`Frame` (RGB uint8 + provenance), which the predictor
consumes in groups of its batch size.

Images decode on the host through ``image_io.imread_rgb`` (cv2's decode,
to the byte, without cv2). Video files, webcam indices and stream URLs need
a video decoder (cv2's ``VideoCapture`` in the reference), which the GPU
machine lacks: they raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import glob as _glob
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from kuzu_torch.data.image_io import imread_rgb

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp"}
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg",
               "ts", "wmv", "webm"}


@dataclass
class Frame:
    """One unit of prediction work: an RGB image plus provenance."""

    image: np.ndarray | torch.Tensor  # (H, W, 3) uint8 RGB
    path: str = ""  # source file
    frame_idx: int = 0  # index within its batch array (0 for images)
    stream: bool = False  # True when from a live stream (unbounded)
    meta: dict = field(default_factory=dict)


def _video(source: Any) -> NotImplementedError:
    return NotImplementedError(
        f"{source!r}: video files, webcams and streams need a video decoder (cv2's "
        "VideoCapture in the reference), which the port does not have; see ROADMAP.md "
        "section 1 item 9")


def resolve_source(
    source: Any, vid_stride: int = 1, max_frames: int | None = None
) -> Iterator[Frame]:
    """Normalise a prediction source into a Frame iterator, in the
    reference's order and provenance: an ndarray or uint8 tensor ((H, W, 3)
    frame or (B, H, W, 3) batch, ``frame_idx`` its index), a PIL image, a
    list / tuple of any of these, an image path, a directory (its image
    files sorted) or a glob pattern (sorted). ``vid_stride`` and
    ``max_frames`` belong to the video and stream sources, which raise."""
    if hasattr(source, "convert") and hasattr(source, "size"):  # PIL
        yield Frame(image=np.array(source.convert("RGB")))
        return
    if isinstance(source, (np.ndarray, torch.Tensor)):
        if source.ndim == 3:
            yield Frame(image=source)
        elif source.ndim == 4:
            for i, f in enumerate(source):
                yield Frame(image=f, frame_idx=i)
        else:
            raise ValueError(f"bad source array shape {tuple(source.shape)}")
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from resolve_source(s, vid_stride, max_frames)
        return
    if isinstance(source, int) or (isinstance(source, str) and source.isdigit()):
        raise _video(source)  # a webcam index
    s = str(source)
    low = s.lower()
    if low.startswith(("rtsp://", "rtmp://", "tcp://")):
        raise _video(source)
    if low.startswith(("http://", "https://")):
        if low.rsplit(".", 1)[-1] in IMG_FORMATS:
            raise ValueError(
                "remote image URLs need network access (unavailable); "
                "download first and pass the local path"
            )
        raise _video(source)
    p = Path(s)
    if p.is_dir():
        files = sorted(
            f for f in p.iterdir()
            if f.suffix.lower().lstrip(".") in IMG_FORMATS | VID_FORMATS
        )
        for f in files:
            yield from resolve_source(f, vid_stride, max_frames)
        return
    if "*" in s:
        for f in sorted(_glob.glob(s)):
            yield from resolve_source(f, vid_stride, max_frames)
        return
    if p.suffix.lower().lstrip(".") in VID_FORMATS:
        raise _video(source)
    yield Frame(image=imread_rgb(p), path=s)


def batched_frames(
    frames: Iterator[Frame], batch: int = 8
) -> Iterator[list[Frame]]:
    """Group frames into host batches of at most ``batch`` (the predictor
    pads each group to a bucket on top of this)."""
    buf: list[Frame] = []
    for f in frames:
        buf.append(f)
        if len(buf) >= batch:
            yield buf
            buf = []
    if buf:
        yield buf
