"""Fused colour augment: CUDA kernel K3 and its plain-torch version.

Replaces rspnet_tpu/ops/pallas_augment.py:_kernel (:51, launched by
``fused_color_augment`` :209). Per clip of an NDHWC batch: uint8 -> [0, 1]
(or float input as it comes from ``augment.crop_resize``), optional
horizontal flip of the input, grayscale before or after the jitter,
brightness / contrast / saturation / hue in the clip's own op order (contrast
against the clip mean of luma at that point of the chain), per-channel
normalize; float32 out. The formulas are those of ``color.py``; the hue
channel is picked by the pairwise ``>=`` chain.

On this card the kernel is bound by bytes: one read of the input and one
f32 write, 0.736 ms at the main path's f32 [64, 32, 224, 224, 3]. The
Pallas kernel held one clip in VMEM; the resident instance holds one clip
in the shared memory of the whole card, which is how it reads the input
once. One cooperative launch of as many CTAs as can be co-resident walks
the batch; each CTA copies its whole rows of a clip into shared memory
(bulk copies), runs the chain up to contrast there in place and posts one
luma partial as a flagged word; CTA 0 sums the partials in a fixed order
(the same mean in every CTA and every run; no atomics on floats) and posts
the mean; then every CTA runs the rest of the chain from shared memory and
writes the output, while the next clip's rows load into the slots it has
consumed and into the spare slots of its ring. A clip whose slices do not
fit, or an input that is not 16-byte aligned, takes the generic instance:
two launches that read the input twice. ``launch_plan`` says which
instance and grid a call takes; the ``color_augment_generic`` build sends
every call to the generic instance, and ``k3_timeline`` stamps the resident
instance's phases. See ``csrc/color_augment.cu``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises (a refused cooperative launch raises too). Launches count in
``framework/tracing.py``'s ``kernels.`` counters.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..framework import tracing
from . import _build, color

# rsp_color_augment_plan's fields, in order
PLAN_KEYS = ("resident", "ctas", "ctas_per_sm", "rows_per_cta",
             "rows_per_chunk", "chunks", "slots", "slot_bytes",
             "state_offset", "smem_bytes")

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
        tracing.add("kernels.color_augment.plain_on_cuda")
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
                  gray_before_jitter: bool = True,
                  build: str = "color_augment") -> torch.Tensor:
    """K3. x: [B,T,H,W,3] uint8 or float32 NDHWC; order [B,4] permutation
    of (brightness, contrast, saturation, hue); factors [B,4]; gray, flip
    [B] bool. Returns normalized float32 [B,T,H,W,3]. ``build`` names the
    kernel library (``_build.VARIANTS``)."""
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
    # order [B, 4], factors [B, 4] and flags [B, 2] in one copy from pinned
    # memory, which does not wait for the stream as a pageable copy does
    args = torch.from_numpy(np.concatenate([
        order_h.ravel(), factors_h.ravel().view(np.int32),
        np.stack([gray_h, flip_h], 1).astype(np.int32).ravel()])
    ).pin_memory().to(dev, non_blocking=True)
    order_p = args.data_ptr()
    factors_p, flags_p = order_p + 16 * B, order_p + 32 * B
    in_u8 = x.dtype == torch.uint8
    plan = launch_plan(tuple(x.shape), in_u8, x.data_ptr() % 16 == 0,
                       build=build, device=dev.index or 0)
    # 64-bit words, zero at launch: the resident instance's flagged partials
    # [B, ctas] and clip means [B] (the generic one's partials fit in them)
    partials = torch.zeros(B * (plan["ctas"] + 1), dtype=torch.int64,
                           device=dev)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    err = _build.library(build).rsp_color_augment(
        x.data_ptr(), int(in_u8), out.data_ptr(), order_p, factors_p,
        flags_p, partials.data_ptr(), B, T, H, W, int(gray_before_jitter),
        (ctypes.c_float * 3)(*mean), (ctypes.c_float * 3)(*std),
        (ctypes.c_int * len(PLAN_KEYS))(*plan.values()),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rsp_color_augment")
    tracing.add("kernels.color_augment.uint8" if in_u8
                else "kernels.color_augment.float32")
    return out


@functools.lru_cache(maxsize=None)
def _plan(build: str, shape: Tuple[int, ...], in_u8: bool, aligned: bool,
          device: int) -> Tuple[int, ...]:
    B, T, H, W, _ = shape
    plan = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        _build.check(_build.library(build).rsp_color_augment_plan(
            B, T, H, W, int(in_u8), int(aligned), plan),
            "rsp_color_augment_plan")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = dict(zip(PLAN_KEYS, plan))
    # the resident grid must hold a whole clip and be co-resident: as many
    # CTAs as the occupancy query lets run on every SM at once. A plan that
    # is not (a clip near the card's shared memory, such as the packed
    # 48-frame clip at 224², 28.9 MB in f32) takes the generic instance,
    # whose plan the library gives for an unaligned input
    if p["resident"] and not (p["ctas"] == p["ctas_per_sm"] * sms
                              and p["ctas"] * p["rows_per_cta"] >= T * H):
        return _plan(build, shape, in_u8, False, device)
    return tuple(plan)


def launch_plan(shape: Sequence[int], in_u8: bool, aligned: bool = True, *,
                build: str = "color_augment", device: int = 0
                ) -> Dict[str, int]:
    """The instance and grid K3 takes for a [B, T, H, W, 3] input on the
    card (``PLAN_KEYS``): ``resident`` 1 or 0 (the generic instance);
    ``aligned``: the input's address is a multiple of 16."""
    return dict(zip(PLAN_KEYS, _plan(build, tuple(int(d) for d in shape),
                                     bool(in_u8), bool(aligned), device)))
