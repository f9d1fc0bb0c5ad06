"""A CPU model of K2's two-pass algorithm, pinned bit for bit to the plain
max-pool backward.

K2 (rspnet_tpu_torch/csrc/max_pool3d.cu) runs on the card only. Its
algorithm is modelled here with vectorised torch ops, step for step:

- route pass: per output element, the window offset ``dt*9 + dh*3 + dw`` of
  the lexicographically first in-bounds cell, in (dw, dh, dt) order, that
  holds the window max (a strict ``>`` scan in that order), or no cell
  (the byte 0x7F) where the JAX kernel drops the cotangent: a window that
  holds a NaN, and a window whose max is -inf and whose offset-0 cell lies
  in the -inf padding;
- gather pass: per input element, nested accumulators T (outer), H, W
  (inner) over the covering windows in window-offset order, adding g where
  the window's route names this element's own offset; in bf16 the W and H
  sums are rounded to bf16 before they are added one level up; a trivial
  axis (k = s = 1, p = 0) has one window and no rounding level.

Each case asserts ``torch.equal`` with ``max_pool3d_bwd_plain``, which
tests/test_torch_ops.py pins to the JAX first-match oracle.
"""
import numpy as np
import pytest
import torch

from rspnet_tpu_torch.ops import max_pool3d as tmp
from tests.test_pooling import CASES

torch.set_num_threads(1)

NO_ROUTE = 0x7F       # kNoRouteByte of the kernel


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _window_view(v, offs, n, s, p):
    """v[:, to*st - pt + dt, ho*sh - ph + dh, wo*sw - pw + dw] for every
    output (to, ho, wo), with a mask of the in-bounds cells."""
    B, *dims, C = v.shape
    idx, ok = [], []
    for d, off, nn, ss, pp in zip(dims, offs, n, s, p):
        i = torch.arange(nn) * ss - pp + off
        ok.append((i >= 0) & (i < d))
        idx.append(i.clamp(0, d - 1))
    cells = v[:, idx[0][:, None, None], idx[1][None, :, None],
              idx[2][None, None, :]]
    mask = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    return cells, mask[None, :, :, :, None]


def route_model(x, k, s, p):
    """uint8 [B, To, Ho, Wo, C]: the composed first-match offset, or
    NO_ROUTE where the window holds a NaN, or where its max is -inf and
    its offset-0 cell lies in the padding."""
    n = [tmp.out_len(d, kk, ss, pp) for d, kk, ss, pp in
         zip(x.shape[1:4], k, s, p)]
    best = torch.full((x.shape[0], *n, x.shape[4]), float("-inf"),
                      dtype=torch.float32)
    _, start_in = _window_view(x.float(), (0, 0, 0), n, s, p)
    route = torch.where(start_in, torch.tensor(0, dtype=torch.uint8),
                        torch.tensor(NO_ROUTE, dtype=torch.uint8))
    route = route.expand(best.shape).clone()
    has_nan = torch.zeros(best.shape, dtype=torch.bool)
    for dw in range(k[2]):
        for dh in range(k[1]):
            for dt in range(k[0]):
                cells, ok = _window_view(x.float(), (dt, dh, dw), n, s, p)
                upd = ok & (cells > best)
                best = torch.where(upd, cells, best)
                route = torch.where(upd, torch.tensor(dt * 9 + dh * 3 + dw,
                                                      dtype=torch.uint8),
                                    route)
                has_nan |= ok & torch.isnan(cells)
    return torch.where(has_nan, torch.tensor(NO_ROUTE, dtype=torch.uint8),
                       route)


def gather_model(route, g, xshape, dtype, k, s, p):
    """dx from the route and g, with K2's nested accumulators."""
    B, T, H, W, C = xshape
    To, Ho, Wo = route.shape[1:4]
    pad = [max((nn - 1) * ss + kk, pp + d) for nn, ss, kk, pp, d in
           zip((To, Ho, Wo), s, k, p, (T, H, W))]
    gf = g.float()
    zero = torch.zeros((), dtype=torch.float32)
    pooled = [not (kk == 1 and ss == 1 and pp == 0) for kk, ss, pp in
              zip(k, s, p)]

    def level(acc, axis):
        # a pooled stage's cotangent is rounded to x.dtype; a trivial axis
        # has no stage
        return acc.to(dtype).float() if pooled[axis] else acc

    def place(v, offs):
        """v [B, To, Ho, Wo, C] put at padded input (to*st + dt, ...)."""
        buf = torch.zeros((B, *pad, C), dtype=torch.float32)
        buf[:, offs[0]:offs[0] + (To - 1) * s[0] + 1:s[0],
            offs[1]:offs[1] + (Ho - 1) * s[1] + 1:s[1],
            offs[2]:offs[2] + (Wo - 1) * s[2] + 1:s[2]] = v
        return buf

    acc_t = torch.zeros((B, *pad, C), dtype=torch.float32)
    for dt in range(k[0]):
        acc_h = torch.zeros_like(acc_t)
        for dh in range(k[1]):
            acc_w = torch.zeros_like(acc_t)
            for dw in range(k[2]):
                take = route == dt * 9 + dh * 3 + dw
                acc_w = acc_w + place(torch.where(take, gf, zero),
                                      (dt, dh, dw))
            acc_h = acc_h + level(acc_w, 2)
        acc_t = acc_t + level(acc_h, 1)
    dx = acc_t[:, p[0]:p[0] + T, p[1]:p[1] + H, p[2]:p[2] + W]
    return dx.to(dtype).contiguous()


@pytest.mark.parametrize("ties", [False, True], ids=["unique", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ishape,k,s,p", CASES)
def test_route_gather_model_bit_equal_plain(ishape, k, s, p, dtype, ties):
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(7)
    x = rng.randn(1, *ishape)
    if ties:
        # post-ReLU, quantized to halves: windows full of exact ties
        x = np.maximum(np.round(x * 2) / 2, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    oshape = tmp._out_shape(x.shape, k, s, p)
    g = torch.from_numpy(rng.randn(*oshape).astype(np.float32)).to(dtype)
    route = route_model(x, k, s, p)
    # every window has an in-bounds cell, so every route is set
    assert int(route.max()) <= (k[0] - 1) * 9 + (k[1] - 1) * 3 + k[2] - 1
    dx = gather_model(route, g, x.shape, dtype, k, s, p)
    ref = tmp.max_pool3d_bwd_plain(x, g, k, s, p)
    assert dx.dtype == ref.dtype and dx.shape == ref.shape
    assert torch.equal(dx, ref)


def _special(rng, ishape, k, p, kind):
    """Normal values with one NaN (inside the first window), with all -inf
    windows at both corners (and 3% of -inf cells), or with both."""
    x = rng.randn(1, *ishape)
    if kind in ("neginf", "both"):
        x[rng.rand(*x.shape) < 0.03] = -np.inf
        x[:, :k[0], :k[1], :k[2]] = -np.inf
        x[:, -k[0]:, -k[1]:, -k[2]:] = -np.inf
    if kind in ("nan", "both"):
        x[(0, *(rng.randint(kk - pp) for kk, pp in zip(k, p)),
           rng.randint(ishape[3]))] = np.nan
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["nan", "neginf", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ishape,k,s,p", CASES)
def test_route_model_drops_like_plain(ishape, k, s, p, dtype, kind):
    """Windows that hold a NaN, and all -inf windows whose offset-0 cell
    is padding, route nowhere, as in the plain version (and the JAX
    kernel it is pinned to)."""
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(13)
    x = torch.from_numpy(_special(rng, ishape, k, p, kind)).to(dtype)
    oshape = tmp._out_shape(x.shape, k, s, p)
    g = torch.from_numpy(rng.randn(*oshape).astype(np.float32)).to(dtype)
    route = route_model(x, k, s, p)
    if kind != "neginf" or any(p):
        assert bool((route == NO_ROUTE).any())
    dx = gather_model(route, g, x.shape, dtype, k, s, p)
    ref = tmp.max_pool3d_bwd_plain(x, g, k, s, p)
    assert dx.dtype == ref.dtype and dx.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(dx), nan)
    assert torch.equal(dx[~nan], ref[~nan])
