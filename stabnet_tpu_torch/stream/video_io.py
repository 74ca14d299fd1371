"""Host video I/O around the device streaming engine.

Reference equivalent: deploy_bundle.py's direct cv2.VideoCapture/VideoWriter
usage (deploy_bundle.py:188-215,366-371).  OpenCV is optional and imported
only inside the functions that need it; the array-backed reader and writer
work without it.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def optional_cv2():
    """The cv2 module, or None where OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _require_cv2():
    cv2 = optional_cv2()
    if cv2 is None:
        raise RuntimeError("OpenCV not available; use ArrayVideoReader/Writer")
    return cv2


def to_gray_train(frame_bgr: np.ndarray, height: int, width: int,
                  crop_rate: float = 1.0) -> np.ndarray:
    """BGR uint8 -> (H, W) float32 in [-0.5, 0.5] model scale.

    Reference: config.py:6-21 `cvt_img2train` (grayscale, bilinear resize,
    optional crop-zoom when crop_rate != 1).  Without OpenCV: BT.601 luma and
    a nearest-neighbour resize.
    """
    cv2 = optional_cv2()
    if cv2 is not None:
        gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
        if crop_rate != 1.0:
            h = int(height / crop_rate)
            w = int(width / crop_rate)
            dh = (h - height) // 2
            dw = (w - width) // 2
            gray = cv2.resize(gray, (w, h), interpolation=cv2.INTER_LINEAR)
            gray = gray[dh: dh + height, dw: dw + width]
        else:
            gray = cv2.resize(gray, (width, height), interpolation=cv2.INTER_LINEAR)
    else:
        b, g, r = (frame_bgr[..., i].astype(np.float32) for i in range(3))
        gray = (0.114 * b + 0.587 * g + 0.299 * r).astype(np.uint8)
        gray = _resize_nearest(gray, height, width)
    return gray.astype(np.float32) / 255.0 - 0.5


def from_gray_train(img: np.ndarray) -> np.ndarray:
    """(H, W) model-scale float -> uint8 (reference: deploy_bundle.py:75)."""
    return np.clip((img + 0.5) * 255.0, 0, 255).astype(np.uint8)


def _resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    ys = (np.arange(height) * img.shape[0] / height).astype(np.int64)
    xs = (np.arange(width) * img.shape[1] / width).astype(np.int64)
    return img[ys[:, None], xs[None, :]]


class VideoReader:
    """Sequential BGR frame reader from a file (cv2) with fps halving.

    The reference drops every other frame when fps > 40
    (deploy_bundle.py:190-195,309-311); `half_rate` reproduces that.
    """

    def __init__(self, path: str, allow_half_rate: bool = True):
        cv2 = _require_cv2()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.cap = cv2.VideoCapture(path)
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.half_rate = allow_half_rate and self.fps > 40
        if self.half_rate:
            self.fps /= 2

    def read(self) -> Optional[np.ndarray]:
        if self.half_rate:
            ok, _ = self.cap.read()
            if not ok:
                return None
        ok, frame = self.cap.read()
        return frame if ok else None

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self):
        self.cap.release()


class ArrayVideoReader:
    """Frame reader over an in-memory (T, H, W, 3) uint8 clip."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0):
        self.frames = frames
        self.fps = fps
        self.half_rate = False
        self._t = 0

    def read(self) -> Optional[np.ndarray]:
        if self._t >= len(self.frames):
            return None
        f = self.frames[self._t]
        self._t += 1
        return f

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self):
        pass


class VideoWriter:
    """MJPG .avi writer (reference: deploy_bundle.py:197-198)."""

    def __init__(self, path: str, fps: float,
                 size_hw: Optional[Tuple[int, int]] = None):
        """`size_hw=None` opens the file at the first frame, at its size."""
        self._cv2 = _require_cv2()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path, self.fps = path, fps
        self.size_hw: Optional[Tuple[int, int]] = None
        self.writer = None
        if size_hw is not None:
            self._open(tuple(size_hw))

    def _open(self, size_hw: Tuple[int, int]):
        cv2 = self._cv2
        self.size_hw = size_hw
        h, w = size_hw
        self.writer = cv2.VideoWriter(
            self.path, cv2.VideoWriter_fourcc("M", "J", "P", "G"), self.fps, (w, h))

    def write(self, frame_bgr: np.ndarray):
        if self.writer is None:
            self._open(tuple(frame_bgr.shape[:2]))
        self.writer.write(frame_bgr)

    def close(self):
        if self.writer is not None:
            self.writer.release()


class ArrayVideoWriter:
    """Collects frames in memory."""

    def __init__(self):
        self.frames = []

    def write(self, frame_bgr: np.ndarray):
        self.frames.append(np.asarray(frame_bgr))

    def close(self):
        pass

    def stack(self) -> np.ndarray:
        return np.stack(self.frames) if self.frames else np.zeros((0,))
