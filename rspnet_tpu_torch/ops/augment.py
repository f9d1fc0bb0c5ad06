"""Batched video augmentation: host-side parameter sampling (numpy) and the
device-side geometry + colour pipeline (torch), and the validation
preprocess.

Port of rspnet_tpu/ops/augment.py. Parameter sampling is a numpy copy that
draws the same values from the same ``np.random.Generator`` state. On the
device, crop + bilinear resize (with the horizontal flip folded into the
column matrix) are two batched products, as in the JAX package; the colour
part is kernel K3 (``color_augment.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import color
from .color_augment import color_augment

__all__ = ["AugmentParams", "sample_crop_box", "center_max_box",
           "sample_train_params", "center_crop_params", "crop_resize",
           "augment_batch", "eval_preprocess"]


# ---------------------------------------------------------------------------
# Host-side parameter sampling (copy of rspnet_tpu/ops/augment.py:39-159)
# ---------------------------------------------------------------------------

@dataclass
class AugmentParams:
    """Per-sample augmentation parameters (host numpy, shipped to device).

    boxes:   [B, 4] float32 (i, j, h, w) crop rectangles in source pixels
    flip:    [B] bool
    jitter:  [B, 4] float32 factors (brightness, contrast, saturation, hue);
             neutral = (1, 1, 1, 0)
    order:   [B, 4] int32 permutation of the four jitter ops
    gray:    [B] bool
    blur:    [B] bool
    """
    boxes: np.ndarray
    flip: np.ndarray
    jitter: np.ndarray
    order: np.ndarray
    gray: np.ndarray
    blur: np.ndarray


def sample_crop_box(rng: np.random.Generator, height: int, width: int,
                    scale: Tuple[float, float],
                    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
                    ) -> Tuple[int, int, int, int]:
    """Inception-style area/aspect crop (reference: transforms_spatial.py:53-83)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # Central fallback
    in_ratio = width / height
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def center_max_box(height: int, width: int, ratio: float = 1.0
                   ) -> Tuple[int, int, int, int]:
    """Largest centered crop of the given aspect
    (reference: transforms_spatial.py:86-100)."""
    if width / height > ratio:
        h = height
        w = int(round(h * ratio))
    else:
        w = width
        h = int(round(w / ratio))
    return (height - h) // 2, (width - w) // 2, h, w


def sample_train_params(
    rng: np.random.Generator,
    batch_size: int,
    source_hw: Sequence[Tuple[int, int]],
    *,
    crop_area: Tuple[float, float] = (0.25, 1.0),
    h_flip: float = 0.5,
    gray_p: float = 0.0,
    jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    jitter_p: float = 1.0,
    blur_p: float = 0.0,
) -> AugmentParams:
    """Sample all per-clip augmentation randomness on the host.

    Distributions mirror the reference's transform stack:
    brightness/contrast/saturation ~ U[max(0,1-v), 1+v], hue ~ U[-v, v]
    (transforms_tensor.py:107-124), random op order (:126), gray with prob p,
    flip with prob h_flip, optional blur (aug_plus).
    """
    if len(source_hw) not in (1, batch_size):
        raise ValueError(
            f"source_hw must have 1 or batch_size ({batch_size}) entries, "
            f"got {len(source_hw)}")
    boxes = np.zeros((batch_size, 4), dtype=np.float32)
    if crop_area == (1.0, 1.0):
        # identity fast path: callers with pre-cropped inputs (the engines)
        # skip the per-sample rejection sampling entirely
        for b in range(batch_size):
            h, w = source_hw[b] if len(source_hw) > 1 else source_hw[0]
            boxes[b] = (0, 0, h, w)
    else:
        for b in range(batch_size):
            h, w = source_hw[b] if len(source_hw) > 1 else source_hw[0]
            boxes[b] = sample_crop_box(rng, h, w, crop_area)

    flip = rng.random(batch_size) < h_flip
    gray = rng.random(batch_size) < gray_p
    blur = rng.random(batch_size) < blur_p

    jb, jc, js, jh = jitter
    factors = np.ones((batch_size, 4), dtype=np.float32)
    factors[:, 3] = 0.0
    apply_jitter = rng.random(batch_size) < jitter_p
    for b in range(batch_size):
        if not apply_jitter[b]:
            continue
        if jb > 0:
            factors[b, 0] = rng.uniform(max(0.0, 1.0 - jb), 1.0 + jb)
        if jc > 0:
            factors[b, 1] = rng.uniform(max(0.0, 1.0 - jc), 1.0 + jc)
        if js > 0:
            factors[b, 2] = rng.uniform(max(0.0, 1.0 - js), 1.0 + js)
        if jh > 0:
            factors[b, 3] = rng.uniform(-jh, jh)

    order = np.stack([rng.permutation(4) for _ in range(batch_size)]
                     ).astype(np.int32)
    return AugmentParams(boxes=boxes, flip=flip, jitter=factors, order=order,
                         gray=gray, blur=blur)


def center_crop_params(batch_size: int,
                       source_hw: Sequence[Tuple[int, int]],
                       ratio: float = 1.0) -> AugmentParams:
    """Deterministic eval params: the largest centred crop of aspect
    ``ratio``, no colour ops (rspnet_tpu/ops/augment.py:162)."""
    if len(source_hw) not in (1, batch_size):
        raise ValueError(
            f"source_hw must have 1 or batch_size ({batch_size}) entries, "
            f"got {len(source_hw)}")
    boxes = np.zeros((batch_size, 4), dtype=np.float32)
    for b in range(batch_size):
        h, w = source_hw[b] if len(source_hw) > 1 else source_hw[0]
        boxes[b] = center_max_box(h, w, ratio)
    factors = np.ones((batch_size, 4), dtype=np.float32)
    factors[:, 3] = 0.0
    return AugmentParams(
        boxes=boxes,
        flip=np.zeros(batch_size, dtype=bool),
        jitter=factors,
        order=np.tile(np.arange(4, dtype=np.int32), (batch_size, 1)),
        gray=np.zeros(batch_size, dtype=bool),
        blur=np.zeros(batch_size, dtype=bool),
    )


# ---------------------------------------------------------------------------
# Device-side pipeline
# ---------------------------------------------------------------------------

def _interp_weights(coords: torch.Tensor, n: int) -> torch.Tensor:
    """[..., S] fractional source coords -> [..., S, n] bilinear weights
    max(0, 1 - |coord - k|) over source positions k."""
    grid = torch.arange(n, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - grid), min=0.0)


def crop_resize(clips: torch.Tensor, boxes: torch.Tensor,
                size: Tuple[int, int],
                flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop (i, j, h, w) per clip, then bilinear-resize to ``size``
    (align_corners=False, clamped inside the crop), as two batched products.

    clips: [B, T, H, W, C] float32; boxes: [B, 4] float32; flip: [B] bool,
    folded into the column matrix by reversing its rows. Returns
    [B, T, S_h, S_w, C] (rspnet_tpu/ops/augment.py:201-242).
    """
    B, T, H, W, C = clips.shape
    out_h, out_w = size
    dev = clips.device
    boxes = boxes.to(device=dev, dtype=torch.float32)
    i, j, h, w = (boxes[:, k:k + 1] for k in range(4))
    ys = i + (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * h / out_h - 0.5
    xs = j + (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * w / out_w - 0.5
    ys = torch.minimum(torch.maximum(ys, i), i + h - 1.0)
    xs = torch.minimum(torch.maximum(xs, j), j + w - 1.0)
    my = _interp_weights(ys, H)                    # [B, S_h, H]
    mx = _interp_weights(xs, W)                    # [B, S_w, W]
    if flip is not None:
        flip = flip.to(device=dev, dtype=torch.bool)
        mx = torch.where(flip[:, None, None], torch.flip(mx, dims=(1,)), mx)
    rows = torch.einsum("bsh,bthwc->btswc", my, clips)
    return torch.einsum("brw,btswc->btsrc", mx, rows).contiguous()


def augment_batch(batch: torch.Tensor, params: AugmentParams, *,
                  size: Tuple[int, int],
                  mean: Sequence[float] = (0.485, 0.456, 0.406),
                  std: Sequence[float] = (0.229, 0.224, 0.225),
                  gray_before_jitter: bool = True,
                  use_blur: bool = False,
                  identity_geometry: bool = False) -> torch.Tensor:
    """uint8 [B, T, H, W, C] -> normalized float32 [B, T, S, S, C].

    ``identity_geometry``: the host already cropped and resized to ``size``;
    the uint8 clip goes straight to K3, which flips the input. Otherwise the
    clip is scaled to [0, 1], cropped and resized with the flip folded in,
    and the float result goes to K3 (rspnet_tpu/ops/augment.py:467).

    ``use_blur`` (``aug_plus``): JAX blurs the clips whose ``blur`` is set
    after the jitter and gray and before the normalize
    (rspnet_tpu/ops/augment.py:433-461). The blur's zero padding does not
    commute with the normalize that K3 fuses, so K3 runs with mean 0 and
    std 1 (exact: ``(v - 0) / 1``), the selected clips are blurred, and the
    batch is normalized in place. K3 flips an identity-geometry clip before
    the blur where JAX flips after it: the kernel and its padding are
    symmetric in W, so the two agree up to the order of the sums.
    """
    flip = np.asarray(params.flip, bool)
    if identity_geometry:
        if tuple(batch.shape[2:4]) != tuple(size):
            raise ValueError(f"identity geometry needs {size} clips, got "
                             f"{tuple(batch.shape)}")
        x = batch.contiguous()
        flip_in_kernel = flip
    else:
        x = batch.to(torch.float32) / 255.0
        x = crop_resize(x, torch.from_numpy(np.asarray(params.boxes)), size,
                        flip=torch.from_numpy(flip))
        flip_in_kernel = np.zeros_like(flip)
    if not use_blur:
        return color_augment(x, params.order, params.jitter, params.gray,
                             flip_in_kernel, mean=mean, std=std,
                             gray_before_jitter=gray_before_jitter)
    x = color_augment(x, params.order, params.jitter, params.gray,
                      flip_in_kernel, mean=(0.0, 0.0, 0.0),
                      std=(1.0, 1.0, 1.0),
                      gray_before_jitter=gray_before_jitter)
    blur = np.flatnonzero(np.asarray(params.blur, bool))
    if blur.size:
        rows = torch.from_numpy(blur).to(x.device)
        x.index_copy_(0, rows, color.gaussian_blur(x.index_select(0, rows)))
    mean_t = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std_t = torch.tensor(std, dtype=x.dtype, device=x.device)
    return x.sub_(mean_t).div_(std_t)


def eval_preprocess(batch: torch.Tensor, boxes, *, size: Tuple[int, int],
                    mean: Sequence[float] = (0.485, 0.456, 0.406),
                    std: Sequence[float] = (0.229, 0.224, 0.225)
                    ) -> torch.Tensor:
    """Validation path: uint8 [B, T, H, W, C] -> centre crop ``boxes``,
    bilinear resize to ``size``, normalize; float32 [B, T, S, S, C]. Plain
    torch, as the JAX one is plain XLA (rspnet_tpu/ops/augment.py:494)."""
    x = batch.to(torch.float32) / 255.0
    x = crop_resize(x, torch.from_numpy(np.asarray(boxes, np.float32)), size)
    return color.normalize(x, mean, std)
