"""Plain video augmentation of the RSPNet pretraining recipe, float32.

The draws: per clip an Inception-style crop box (area (0.4, 1) of the
decoded frame, aspect 3/4..4/3, ten tries then a central box), a
horizontal flip (p 0.5), grayscale (p 0.2), brightness, contrast and
saturation factors from U[0.6, 1.4], a hue shift from U[-0.4, 0.4] and a
random order of the four jitter operations. ``draw_params`` takes them
from a numpy ``Generator`` in the order in which the program under test
takes them, so that both sides see the same boxes and factors from one
seed.

The pixels: uint8 -> [0, 1], crop and bilinear resize (half-pixel
centres, the source coordinate clamped inside the box), flip, grayscale
before the jitter, the four jitter operations in the clip's order
(contrast blends with the mean luma of the whole clip at that point), then
the per-channel normalization. Everything on NDHWC float32 tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LUMA = (0.2989, 0.5870, 0.1140)


@dataclass
class Params:
    boxes: np.ndarray      # [B, 4] (top, left, height, width)
    flip: np.ndarray       # [B] bool
    gray: np.ndarray       # [B] bool
    factors: np.ndarray    # [B, 4] brightness, contrast, saturation, hue
    order: np.ndarray      # [B, 4] permutation of the four operations


def _crop_box(rng, height, width, area_range):
    area = height * width
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    for _ in range(10):
        target = rng.uniform(*area_range) * area
        aspect = math.exp(rng.uniform(lo, hi))
        w = int(round(math.sqrt(target * aspect)))
        h = int(round(math.sqrt(target / aspect)))
        if 0 < w <= width and 0 < h <= height:
            return (int(rng.integers(0, height - h + 1)),
                    int(rng.integers(0, width - w + 1)), h, w)
    ratio = width / height
    if ratio < 3 / 4:
        w, h = width, int(round(width / (3 / 4)))
    elif ratio > 4 / 3:
        h, w = height, int(round(height * (4 / 3)))
    else:
        h, w = height, width
    return (height - h) // 2, (width - w) // 2, h, w


def draw_params(rng: np.random.Generator, batch: int, height: int,
                width: int, area=(0.4, 1.0), jitter=0.4, flip_p=0.5,
                gray_p=0.2) -> Params:
    boxes = np.array([_crop_box(rng, height, width, area)
                      for _ in range(batch)], np.float64)
    flip = rng.random(batch) < flip_p
    gray = rng.random(batch) < gray_p
    rng.random(batch)                   # the blur draw (p 0)
    rng.random(batch)                   # whether to jitter (p 1)
    factors = np.empty((batch, 4))
    for b in range(batch):
        factors[b, :3] = [rng.uniform(1 - jitter, 1 + jitter)
                          for _ in range(3)]
        factors[b, 3] = rng.uniform(-jitter, jitter)
    order = np.stack([rng.permutation(4) for _ in range(batch)])
    return Params(boxes, flip, gray, factors.astype(np.float32), order)


def _axis_lerp(start, length, out, size, device):
    """Source indices and weights of a bilinear resize of [start, start +
    length) to ``out`` samples: (lower index, upper index, upper weight)."""
    pos = (start + (torch.arange(out, dtype=torch.float64, device=device)
                    + 0.5) * length / out - 0.5)
    pos = pos.clamp(min=start, max=start + length - 1)
    lo = pos.floor()
    w = (pos - lo).float()
    lo = lo.long()
    hi = (lo + 1).clamp(max=size - 1)
    return lo, hi, w


def crop_resize(clip: torch.Tensor, box, out: int, flip: bool):
    """One clip [T, H, W, 3] float -> [T, out, out, 3]."""
    _, H, W, _ = clip.shape
    top, left, h, w = (float(v) for v in box)
    y0, y1, wy = _axis_lerp(top, h, out, H, clip.device)
    x0, x1, wx = _axis_lerp(left, w, out, W, clip.device)
    rows = (clip[:, y0] * (1 - wy)[None, :, None, None]
            + clip[:, y1] * wy[None, :, None, None])
    cols = (rows[:, :, x0] * (1 - wx)[None, None, :, None]
            + rows[:, :, x1] * wx[None, None, :, None])
    return cols.flip(2) if flip else cols


def _luma(x):
    return LUMA[0] * x[..., 0] + LUMA[1] * x[..., 1] + LUMA[2] * x[..., 2]


def _blend(a, b, f):
    return (f * a + (1 - f) * b).clamp(0.0, 1.0)


def _hue(x, shift):
    r, g, b = x.unbind(-1)
    mx = torch.maximum(r, torch.maximum(g, b))
    mn = torch.minimum(r, torch.minimum(g, b))
    d = mx - mn
    dd = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where((r >= g) & (r >= b), (g - b) / dd,
                    torch.where(g >= b, (b - r) / dd + 2.0,
                                (r - g) / dd + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    v = mx
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)
    table = torch.stack([
        torch.stack([v, q, p, p, t, v], -1),
        torch.stack([t, v, v, q, p, p], -1),
        torch.stack([p, p, t, v, v, q], -1)], -2)   # [..., 3, 6]
    idx = i[..., None, None].expand(*i.shape, 3, 1)
    return torch.gather(table, -1, idx)[..., 0]


def _apply(op, x, f):
    if op == 0:
        return _blend(x, torch.zeros_like(x), f)
    if op == 1:
        return _blend(x, _luma(x).mean(), f)
    if op == 2:
        return _blend(x, _luma(x)[..., None], f)
    return _hue(x, f)


def augment(clips_u8: torch.Tensor, p: Params, out: int, mean, std):
    """uint8 [B, T, H, W, 3] -> normalized float32 [B, T, out, out, 3]."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=clips_u8.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=clips_u8.device)
    res = []
    for b in range(clips_u8.shape[0]):
        x = crop_resize(clips_u8[b].float() / 255.0, p.boxes[b], out,
                        bool(p.flip[b]))
        if p.gray[b]:
            x = _luma(x)[..., None].expand_as(x)
        for op in p.order[b]:
            x = _apply(int(op), x, float(p.factors[b, op]))
        res.append((x - mean_t) / std_t)
    return torch.stack(res)
