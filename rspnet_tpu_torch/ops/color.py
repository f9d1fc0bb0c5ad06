"""Colour math for video augmentation, in plain torch.

Port of rspnet_tpu/ops/color.py (formulas of the reference's
datasets/transforms_video/functional_tensor.py). Clips are channel-last
``[..., H, W, 3]`` float in [0, 1].
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# ITU-R 601-2 luma weights (reference: functional_tensor.py:98)
LUMA = (0.2989, 0.5870, 0.1140)


def luma(img: torch.Tensor) -> torch.Tensor:
    return LUMA[0] * img[..., 0] + LUMA[1] * img[..., 1] + LUMA[2] * img[..., 2]


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3] with r == g == b (luma)."""
    return luma(img)[..., None].expand(img.shape).contiguous()


def _blend(img1: torch.Tensor, img2, ratio: float) -> torch.Tensor:
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    # mean over the whole clip's grayscale (reference: functional_tensor:143)
    return _blend(img, torch.mean(luma(img)), factor)


def adjust_saturation(img: torch.Tensor, factor: float) -> torch.Tensor:
    return _blend(img, rgb_to_grayscale(img), factor)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    v = maxc
    deltac = maxc - minc
    safe_delta = torch.where(deltac == 0, torch.ones_like(deltac), deltac)
    s = torch.where(v == 0, torch.zeros_like(v),
                    deltac / torch.where(v == 0, torch.ones_like(v), v))
    # hue channel by PAIRWISE comparisons, never `g == maxc`: a value that
    # is recomputed with another rounding (FMA contraction) can miss the
    # equality by one ulp and jump the hue by 2/6 (rspnet_tpu color.py:66).
    h_r = (g - b) / safe_delta
    h_g = (b - r) / safe_delta + 2.0
    h_b = (r - g) / safe_delta + 4.0
    r_is_max = (r >= g) & (r >= b)
    h = torch.where(r_is_max, h_r, torch.where(g >= b, h_g, h_b))
    h = torch.where(deltac == 0, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    hi = torch.floor(h * 6.0)
    f = h * 6.0 - hi
    p = v * (1.0 - s)
    t = v * (1.0 - (1.0 - f) * s)
    q = v * (1.0 - f * s)
    hi = torch.remainder(hi.to(torch.int32), 6)

    def pick(cases):
        out = cases[5]
        for k in range(4, -1, -1):
            out = torch.where(hi == k, cases[k], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def adjust_hue(img: torch.Tensor, factor: float) -> torch.Tensor:
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + factor, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def gaussian_kernel1d(kernel_size: int, sigma: float,
                      device=None) -> torch.Tensor:
    x = torch.arange(kernel_size, dtype=torch.float32, device=device)
    g = torch.exp(-((x - kernel_size // 2) ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def gaussian_kernel2d(kernel_size: Tuple[int, int],
                      sigma: Tuple[float, float],
                      device=None) -> torch.Tensor:
    kx = gaussian_kernel1d(kernel_size[0], sigma[0], device)
    ky = gaussian_kernel1d(kernel_size[1], sigma[1], device)
    return kx[:, None] * ky[None, :]


def gaussian_blur(clip: torch.Tensor, kernel_size: Tuple[int, int] = (3, 3),
                  sigma: Tuple[float, float] = (1.5, 1.5)) -> torch.Tensor:
    """Depthwise gaussian blur with zero padding over [..., H, W, C] (the
    leading axes ride the batch), in the clip's dtype
    (rspnet_tpu/ops/color.py:140-156: an XLA convolution outside any
    Pallas kernel; here a grouped ``F.conv2d`` on the channels-last view)."""
    *_, h, w, c = clip.shape
    x = clip.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    kernel = gaussian_kernel2d(kernel_size, sigma, clip.device)
    weight = kernel.to(clip.dtype)[None, None].expand(c, 1, *kernel.shape)
    out = F.conv2d(x, weight, padding=((kernel_size[0] - 1) // 2,
                                       (kernel_size[1] - 1) // 2), groups=c)
    return out.permute(0, 2, 3, 1).reshape(clip.shape)


def normalize(clip: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=clip.dtype, device=clip.device)
    std_t = torch.tensor(std, dtype=clip.dtype, device=clip.device)
    return (clip - mean_t) / std_t


def hflip(clip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., H, W, C]."""
    return torch.flip(clip, dims=(-2,))
