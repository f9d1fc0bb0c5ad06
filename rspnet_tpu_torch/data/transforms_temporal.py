"""Temporal index-space transforms (host side, numpy).

Frame selection happens in index space *before* decode, so decode cost scales
with the clip, not the video (reference: datasets/transforms_video/
transforms_temporal.py, functional_temporal.py). Semantics are kept exactly —
including the short-video fallbacks — because they shape what pixels the
model ever sees:

- ``fallback_select``: videos shorter than the clip tile frames cyclically;
  videos shorter than the needed span use rounded linspace.
- ``RandomStrideCrop``: weighted stride choice + uniform random window.
- ``EvenNCrop``: N evenly spaced windows (validation multi-crop).
- ``Cover``: even coverage of the whole video (train: random phase offset;
  val: N phase offsets).
- ``Resample``: fps retargeting via index arithmetic.

All randomness flows through an explicit ``numpy.random.Generator`` so data
order is reproducible per worker (the reference uses the global ``random``
module; we make the stream explicit).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "calc_needed_frames", "fallback_select", "resample_index",
    "RandomStrideCrop", "EvenNCrop", "Cover", "Resample",
]


def calc_needed_frames(size: int, stride: int) -> int:
    return (size - 1) * stride + 1


def fallback_select(size: int, stride: int, num_frames: int) -> Optional[np.ndarray]:
    """Index selection for videos too short for a strided window.

    Returns None when the video is long enough for a real strided crop.
    """
    if num_frames <= 0:
        raise ValueError("No frames in video")
    if num_frames <= size:
        return np.arange(size) % num_frames
    if num_frames < calc_needed_frames(size, stride):
        return np.linspace(0, num_frames - 1, num=size).round().astype(int)
    return None


def resample_index(frame_indices: np.ndarray,
                   original_fps: Optional[float],
                   new_fps: Optional[float]) -> np.ndarray:
    """Retarget fps by subsampling indices (torchvision-style step logic)."""
    if original_fps is None or new_fps is None:
        return frame_indices
    if original_fps <= 0:
        # broken containers report fps=0; resampling is meaningless and
        # [::0] would crash the loader worker with an unattributable error
        return frame_indices
    step = float(original_fps) / float(new_fps)
    if step.is_integer():
        return frame_indices[::int(step)]
    new_num_frames = int(math.floor(len(frame_indices) / step))
    idxs = np.floor(np.arange(new_num_frames) * step).astype(np.int64)
    return frame_indices[idxs]


def _normalize_strides(strides: Sequence[dict]) -> tuple:
    """Return (strides, cumulative weights) without mutating the input."""
    vals = [int(s["stride"]) for s in strides]
    weights = np.array([float(s["weight"]) for s in strides])
    cum = np.cumsum(weights / weights.sum())
    return vals, cum


class RandomStrideCrop:
    """Pick a stride by weight, then a uniform random strided window."""

    def __init__(self, size: int, strides=({"stride": 1, "weight": 1},),
                 rng: Optional[np.random.Generator] = None):
        self.size = size
        self.set_strides(strides)
        self.rng = rng or np.random.default_rng()

    def set_strides(self, strides) -> None:
        self.stride_values, self.cum_weights = _normalize_strides(strides)

    def set_size(self, size: int) -> None:
        self.size = size

    def __call__(self, frame_indices: np.ndarray) -> np.ndarray:
        num_frames = len(frame_indices)
        r = self.rng.random()
        stride = self.stride_values[int(np.searchsorted(self.cum_weights, r))]

        selected = fallback_select(self.size, stride, num_frames)
        if selected is None:
            needed = calc_needed_frames(self.size, stride)
            start = int(self.rng.integers(0, num_frames - needed + 1))
            selected = np.arange(start, start + needed, stride)
        return frame_indices[selected]


class EvenNCrop:
    """N evenly spaced windows; n=1 gives a center crop (validation)."""

    def __init__(self, size: int, stride: int = 1, n: int = 1):
        self.size = size
        self.stride = stride
        self.n = n

    def __call__(self, frame_indices: np.ndarray) -> np.ndarray:
        num_frames = len(frame_indices)
        selected = fallback_select(self.size, self.stride, num_frames)
        if selected is not None:
            selected = np.tile(selected, self.n)
        else:
            needed = calc_needed_frames(self.size, self.stride)
            if self.n == 1:
                start = (num_frames - needed) // 2
                selected = np.arange(start, start + needed, self.stride)
            else:
                starts = np.linspace(0, num_frames - needed,
                                     num=self.n).round().astype(int)
                offset = np.arange(0, needed, self.stride)
                selected = (starts[:, None] + offset).reshape(-1)
        return frame_indices[selected]


class Cover:
    """Spread `size` samples over the whole video.

    n_crop=None: train mode, one random phase offset.
    n_crop=k: validation, k deterministic phase offsets.
    """

    def __init__(self, size: int, n_crop: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.size = size
        self.n_crop = n_crop
        self.rng = rng or np.random.default_rng()

    def __call__(self, frame_indices: np.ndarray) -> np.ndarray:
        num_frames = len(frame_indices)
        selected = fallback_select(self.size, 1, num_frames)
        if selected is not None:
            if self.n_crop is not None:
                selected = np.tile(selected, self.n_crop)
        else:
            stride = num_frames / self.size

            def select(offset: float) -> np.ndarray:
                sel = np.floor(np.arange(self.size) * stride + offset).astype(int)
                return np.minimum(sel, num_frames - 1)

            if self.n_crop is None:
                offsets: List[float] = [float(self.rng.uniform(0, stride))]
            elif self.n_crop == 1:
                offsets = [0.5 * stride]
            else:
                offsets = list(np.linspace(0, stride, num=self.n_crop,
                                           endpoint=False))
            selected = np.concatenate([select(o) for o in offsets])
        return frame_indices[selected]


class Resample:
    def __init__(self, target_fps: Optional[float] = 30.0):
        self.target_fps = target_fps

    def __call__(self, frame_indices: np.ndarray,
                 source_fps: Optional[float]) -> np.ndarray:
        return resample_index(frame_indices, source_fps, self.target_fps)
