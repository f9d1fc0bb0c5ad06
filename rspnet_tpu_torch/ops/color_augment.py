"""Fused colour augment: CUDA kernel K3 and its plain-torch version.

Replaces rspnet_tpu/ops/pallas_augment.py:_kernel (:51, launched by
``fused_color_augment`` :176). Per clip of an NDHWC batch: uint8 -> [0, 1]
(or float input as it comes from ``augment.crop_resize``), optional
horizontal flip of the input, grayscale before or after the jitter,
brightness / contrast / saturation / hue in the clip's own op order (contrast
against the clip mean of luma at that point of the chain), per-channel
normalize; float32 out. The formulas are those of ``color.py``; the hue
channel is picked by the pairwise ``>=`` chain.

On this card the kernel is bound by device-memory traffic: read the input
once, write f32 once. A clip does not fit in shared memory, and contrast is
the only op that needs a reduction, so the kernel makes two passes: pass 1
recomputes the chain up to contrast and writes one partial luma sum per
block; pass 2 reduces the clip's partials in a fixed order and applies the
whole chain and the normalize. No atomics; f32 throughout (the Pallas
kernel's bf16 was a VMEM workaround). See ``csrc/color_augment.cu``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build, color

launches = {"color_augment": 0}
plain_cuda_calls = {"color_augment": 0}

_OPS = (color.adjust_brightness, color.adjust_contrast,
        color.adjust_saturation, color.adjust_hue)


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(dtype)


def _check_args(x, order, factors, gray, flip, mean, std):
    if x.ndim != 5 or x.shape[-1] != 3:
        raise ValueError(f"color_augment takes [B,T,H,W,3], got {x.shape}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"color_augment: dtype {x.dtype} not in u8/f32")
    b = x.shape[0]
    if (tuple(order.shape) != (b, 4) or tuple(factors.shape) != (b, 4)
            or tuple(gray.shape) != (b,) or tuple(flip.shape) != (b,)):
        raise ValueError("color_augment: order/factors [B,4], gray/flip [B]")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("color_augment: 3-channel mean/std")


def color_augment_plain(x: torch.Tensor, order, factors, gray, flip, *,
                        mean: Sequence[float], std: Sequence[float],
                        gray_before_jitter: bool = True) -> torch.Tensor:
    """Sequential op chain, one clip at a time (the kernel's oracle)."""
    order, factors = _host(order, np.int64), _host(factors, np.float32)
    gray, flip = _host(gray, bool), _host(flip, bool)
    _check_args(x, order, factors, gray, flip, mean, std)
    if x.is_cuda:
        plain_cuda_calls["color_augment"] += 1
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        c = x[b].float() / 255.0 if x.dtype == torch.uint8 else x[b]
        if flip[b]:
            c = color.hflip(c)
        if gray[b] and gray_before_jitter:
            c = color.rgb_to_grayscale(c)
        for op in order[b]:
            c = _OPS[op](c, float(factors[b, op]))
        if gray[b] and not gray_before_jitter:
            c = color.rgb_to_grayscale(c)
        out[b] = color.normalize(c, mean, std)
    return out


def color_augment(x: torch.Tensor, order, factors, gray, flip, *,
                  mean: Sequence[float], std: Sequence[float],
                  gray_before_jitter: bool = True) -> torch.Tensor:
    """K3. x: [B,T,H,W,3] uint8 or float32 NDHWC; order [B,4] permutation
    of (brightness, contrast, saturation, hue); factors [B,4]; gray, flip
    [B] bool. Returns normalized float32 [B,T,H,W,3]."""
    if not x.is_cuda:
        return color_augment_plain(x, order, factors, gray, flip, mean=mean,
                                   std=std,
                                   gray_before_jitter=gray_before_jitter)
    order_h, factors_h = _host(order, np.int32), _host(factors, np.float32)
    gray_h, flip_h = _host(gray, bool), _host(flip, bool)
    _check_args(x, order_h, factors_h, gray_h, flip_h, mean, std)
    if not x.is_contiguous():
        raise ValueError("color_augment: needs a contiguous NDHWC tensor")
    if not all(sorted(row) == [0, 1, 2, 3] for row in order_h.tolist()):
        raise ValueError("color_augment: each order row must permute 0..3")
    B, T, H, W, _ = x.shape
    dev = x.device
    order_d = torch.from_numpy(order_h).to(dev)
    factors_d = torch.from_numpy(factors_h).to(dev)
    flags_d = torch.from_numpy(np.stack([gray_h, flip_h], 1).astype(
        np.int32)).to(dev)
    lib = _build.library("color_augment")
    nblocks = lib.rsp_color_augment_nblocks(T * H * W)
    partials = torch.empty((B, nblocks), dtype=torch.float32, device=dev)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    err = lib.rsp_color_augment(
        x.data_ptr(), int(x.dtype == torch.uint8), out.data_ptr(),
        order_d.data_ptr(), factors_d.data_ptr(), flags_d.data_ptr(),
        partials.data_ptr(), B, T, H, W, int(gray_before_jitter),
        (ctypes.c_float * 3)(*mean), (ctypes.c_float * 3)(*std),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rsp_color_augment")
    launches["color_augment"] += 1
    return out
