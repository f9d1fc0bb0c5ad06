"""Video decode backends (copy of rspnet_tpu/data/video_reader.py).

The reference decodes with decord (C++/FFmpeg) per __getitem__
(reference: datasets/classification/video.py:55-80). Decode stays on the
CPU host behind a small backend interface:

- ``RspVideoReader``: the C++ FFmpeg decoder (``native/``), built with
  ``g++`` at first use; it mirrors decord's open/get_batch contract.
- ``CvVideoReader``: OpenCV decode (sequential grab/retrieve), where the
  native decoder cannot be built; ``cv2`` is imported lazily, so the
  synthetic path runs without OpenCV.
- ``SyntheticVideoReader``: procedural frames for tests/benchmarks.

``open_video(path)`` picks the backend: synthetic:// URLs -> synthetic,
else the native decoder when it builds, else OpenCV (the build error is
logged once).
"""
from __future__ import annotations

import logging
import urllib.parse
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class VideoReaderBase:
    num_frames: int = 0
    fps: float = 30.0

    def get_batch(self, indices: Sequence[int],
                  out_wh: Optional[tuple] = None) -> np.ndarray:
        """-> uint8 [N, H, W, C] in RGB order. ``out_wh=(w, h)`` resizes
        during decode (the native backend rides its sws_scale pass; others
        resize after decode)."""
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _maybe_resize(frames: np.ndarray, out_wh: Optional[tuple]) -> np.ndarray:
    """Post-decode bilinear resize for backends without decode-time scaling
    (matches the native backend's sws BILINEAR output semantics)."""
    if out_wh is None or (frames.shape[2], frames.shape[1]) == tuple(out_wh):
        return frames
    import cv2
    w, h = int(out_wh[0]), int(out_wh[1])
    out = np.empty((frames.shape[0], h, w, 3), np.uint8)
    for t in range(frames.shape[0]):
        out[t] = cv2.resize(frames[t], (w, h),
                            interpolation=cv2.INTER_LINEAR)
    return out


class SyntheticVideoReader(VideoReaderBase):
    """Deterministic procedural video: a bright square moves across a noisy
    background. The class signal is MOTION-ONLY — color statistics are
    class-independent (class-coded colors would leak label information that
    color-invariance augmentation then destroys, confounding any transfer
    experiment).

    Two class modes, selected by the URL:
    - direction (default): movement angle = 2*pi*cls/10; speed fixed.
    - speed (``&speed=<v>`` present): movement speed carries the class;
      direction is instance-specific (seed-derived). Speed survives flips,
      crops, and every color augmentation, so it is the right probe target
      for RSP (relative speed) pretraining transfer.
    """

    def __init__(self, url: str):
        q = urllib.parse.urlparse(url)
        params = dict(urllib.parse.parse_qsl(q.query))
        self.seed = int(q.netloc or 0)
        self.num_frames = int(params.get("frames", 64))
        self.height = int(params.get("h", 128))
        self.width = int(params.get("w", 171))
        self.cls = int(params.get("cls", 0))
        self.fps = 30.0
        rng = np.random.RandomState(self.seed % (2 ** 31))
        self._bg = rng.randint(0, 80, (self.height, self.width, 3), np.uint8)
        if "speed" in params:
            speed = float(params["speed"])
            ang = rng.rand() * 2 * np.pi          # instance, not class
        else:
            speed = 0.8
            # quarter-class offset: a horizontal flip maps angle th to
            # pi - th, and an unoffset grid 2*pi*c/10 aliases class c onto
            # class (5-c) mod 10 EXACTLY under flip (h_flip=0.5 in every
            # train stack), capping Bayes accuracy at 50%. With the offset
            # the flipped angles fall between class angles, so direction
            # stays identifiable (speed mode is flip-invariant already).
            ang = 2 * np.pi * (self.cls + 0.25) / 10.0
        self._vel = np.array([np.sin(ang), np.cos(ang)]) * speed
        self._start = rng.rand(2) * 0.5 + 0.25

    def get_batch(self, indices, out_wh: Optional[tuple] = None) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indices)
        size = max(self.height, self.width) // 6
        # vectorized: one broadcast of the background, then per-frame square
        out = np.broadcast_to(self._bg, (n, self.height, self.width, 3)).copy()
        # square position at time t (bounces off walls via reflection)
        ts = indices.astype(np.float64)[:, None]
        pos = self._start + self._vel * (ts / self.num_frames)
        pos = np.abs(np.mod(pos, 2.0) - 1.0)      # reflect into [0, 1]
        cy = (pos[:, 0] * (self.height - size)).astype(int)
        cx = (pos[:, 1] * (self.width - size)).astype(int)
        # class-independent color (varies only with frame index)
        colors = np.stack([200 + (indices % 3) * 10,
                           np.full(n, 180),
                           60 + (indices % 5) * 10], axis=1)
        for i in range(n):
            out[i, cy[i]:cy[i] + size, cx[i]:cx[i] + size] = colors[i]
        return _maybe_resize(out, out_wh)


class CvVideoReader(VideoReaderBase):
    """OpenCV-backed decode with sequential grab (avoids unreliable
    frame-accurate seeks). Frames are returned in RGB."""

    def __init__(self, path: str, num_threads: int = 1):
        import cv2
        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"Cannot open video {path}")
        self.path = path
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        if self.num_frames <= 0:
            # count by decoding (rare container without metadata)
            n = 0
            while self.cap.grab():
                n += 1
            self.num_frames = n
            self.cap.release()
            self.cap = cv2.VideoCapture(path)

    def get_batch(self, indices, out_wh: Optional[tuple] = None) -> np.ndarray:
        cv2 = self._cv2
        indices = np.asarray(indices, dtype=np.int64)
        first, last = int(indices.min()), int(indices.max())

        # seek near the window start, then decode forward
        pos = int(self.cap.get(cv2.CAP_PROP_POS_FRAMES))
        if first < pos or first - pos > 300:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, first)
            pos = first

        frames = {}
        need = set(int(i) for i in indices)
        cur = pos
        last_ok = None
        while cur <= last:
            ok = self.cap.grab()
            if not ok:
                break
            if cur in need:
                ok, frame = self.cap.retrieve()
                if not ok:
                    break
                frames[cur] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                last_ok = cur
            cur += 1

        if not frames:
            raise IOError(f"Decode produced no frames for {self.path}")
        # fill any missing frames with the nearest decoded one
        fallback = frames.get(last_ok)
        out = np.stack([frames.get(int(i), fallback) for i in indices])
        return _maybe_resize(out, out_wh)

    def close(self):
        self.cap.release()


@lru_cache(maxsize=4096)
def _synthetic_reader(url: str) -> "SyntheticVideoReader":
    """Synthetic readers are immutable and get_batch is pure, so one shared
    instance per URL is thread-safe and saves rebuilding the background per
    sample per epoch. The cache must exceed the largest cyclically-iterated
    catalog (an LRU smaller than the cycle thrashes to a 0% hit rate)."""
    return SyntheticVideoReader(url)


def open_video(path: str) -> VideoReaderBase:
    if path.startswith("synthetic://"):
        return _synthetic_reader(path)
    from ..native import video_decode
    if video_decode.is_available():
        return video_decode.RspVideoReader(path)
    return CvVideoReader(path)
