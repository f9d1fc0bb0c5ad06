"""A CPU model of K1's tiled forward, pinned bit for bit to the plain
max-pool forward.

The tiled K1 (``pool_fwd_tile`` in rspnet_tpu_torch/csrc/max_pool3d.cu)
runs on the card only. Its algorithm is modelled here with vectorised torch
ops, step for step:

- a block owns an output tile of TH x 8 pixels (TH is 4 or 8, per
  geometry) and walks its clip frame by frame, from the first window's
  first frame (-pt) to the last window's last frame; a frame outside
  [0, T) is -inf and is not read;
- per frame, the tile's input box ((TH-1)*sh+kh) x (7*sw+kw), from row
  ht*TH*sh - ph and column wt*8*sw - pw, is read once; cells outside the
  tensor (the -inf padding, the floor tail, a ragged last tile) hold -inf;
- the max is taken along W (kw columns of each box row), then H (kh W-maxed
  rows per output row), then T (the last kt frames), with the card's
  NaN-propagating ``max.NaN.f32``;
- output frame to is emitted once frame to*st - pt + kt - 1 is reduced;
  outputs past Ho or Wo in a ragged tile are dropped.

Channels are independent lanes of the max, so the model takes all of them
at once; the kernel's 32-channel chunks change addresses, not values. Each
case asserts that the NaN masks are equal and that the values outside them
are ``torch.equal`` to ``max_pool3d_fwd_plain``, which tests/test_torch_ops.py
pins to the JAX pool. The cases are the pooling suite's (``POOL_CASES``
holds tests/test_pooling.py's ``CASES``), S3D-G's four geometries, and
those geometries at paddings and planes S3D-G does not have; every case
at both tile heights.
"""
import numpy as np
import pytest
import torch

from rspnet_tpu_torch.ops import max_pool3d as tmp
from tests.test_torch_ops import POOL_CASES

torch.set_num_threads(1)

THREADS, TW, CV = 256, 8, 8         # kThreads, kFwdTW, kFwdCV of the kernel
# S3D-G's four pool geometries at its per-clip planes, narrow and short
S3DG_CASES = [
    ((8, 28, 28, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),    # maxPool2
    ((8, 14, 14, 8), (3, 3, 3), (1, 1, 1), (1, 1, 1)),    # 4b-4f branch3
    ((2, 7, 7, 8), (3, 3, 3), (1, 1, 1), (1, 1, 1)),      # 5b/5c branch3
    ((8, 28, 28, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),    # maxPool_4b
    ((4, 14, 14, 8), (2, 2, 2), (2, 2, 2), (0, 0, 0)),    # maxPool_5b
]
# the same geometries off S3D-G's paddings and planes (chip_smoke.py's
# "tile.*" sites): a floor tail, a frame walk from t = -1, no padding,
# ragged tiles on odd planes
EDGE_CASES = [
    ((8, 15, 15, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 5, 5, 4), (2, 2, 2), (2, 2, 2), (1, 1, 1)),
    ((5, 9, 11, 8), (3, 3, 3), (1, 1, 1), (0, 0, 0)),
    ((4, 9, 13, 12), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
]


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def max_nan(a, b):
    """max.NaN.f32: NaN when either operand is NaN, else the larger."""
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), torch.maximum(a, b))


def tile_model(x, k, s, p, th):
    """K1's tiled forward of x [B, T, H, W, C] with tile height th."""
    B, T, H, W, C = x.shape
    To, Ho, Wo = (tmp.out_len(d, kk, ss, pp) for d, kk, ss, pp in
                  zip(x.shape[1:4], k, s, p))
    rh = th * TW * CV // THREADS                # output rows of a thread
    assert rh * THREADS == th * TW * CV
    bh, bw = (th - 1) * s[1] + k[1], (TW - 1) * s[2] + k[2]
    nh, nw = -(-Ho // th), -(-Wo // TW)
    inf = torch.tensor(float("-inf"))
    # every tile's box, all frames: [B, T, nh, bh, nw, bw, C]
    hi = (torch.arange(nh) * th * s[1] - p[1])[:, None] + torch.arange(bh)
    wi = (torch.arange(nw) * TW * s[2] - p[2])[:, None] + torch.arange(bw)
    box = x.float()[:, :, hi.clamp(0, H - 1)][:, :, :, :, wi.clamp(0, W - 1)]
    inside = (((hi >= 0) & (hi < H))[:, :, None, None, None]
              & ((wi >= 0) & (wi < W))[None, None, :, :, None])
    box = torch.where(inside, box, inf)
    # each thread's rows: row0 = group * rh; its box rows row0*sh + rr
    hw = torch.empty(B, T, nh, th, nw, TW, C)
    for group in range(th // rh):
        row0 = group * rh
        rows = []
        for rr in range((rh - 1) * s[1] + k[1]):
            r = box[:, :, :, row0 * s[1] + rr]      # [B, T, nh, nw, bw, C]
            m = r[:, :, :, :, 0:(TW - 1) * s[2] + 1:s[2]]
            for dw in range(1, k[2]):
                m = max_nan(m, r[:, :, :, :, dw:dw + (TW - 1) * s[2] + 1:s[2]])
            rows.append(m)                          # [B, T, nh, nw, TW, C]
        for r in range(rh):
            m = rows[r * s[1]]
            for dh in range(1, k[1]):
                m = max_nan(m, rows[r * s[1] + dh])
            hw[:, :, :, row0 + r] = m
    # the frame walk with a ring of the last kt frames
    out = torch.empty(B, To, nh, th, nw, TW, C)
    ring = [torch.full(hw[:, 0].shape, float("-inf"))] * k[0]
    emitted = []
    for t in range(-p[0], (To - 1) * s[0] - p[0] + k[0]):
        frame = hw[:, t] if 0 <= t < T else torch.full_like(ring[0], -np.inf)
        ring = ring[1:] + [frame]
        j = t + p[0] - (k[0] - 1)
        if j >= 0 and j % s[0] == 0:
            m = ring[0]
            for d in range(1, k[0]):
                m = max_nan(m, ring[d])
            out[:, j // s[0]] = m
            emitted.append(j // s[0])
    assert emitted == list(range(To))
    out = out.reshape(B, To, nh * th, nw * TW, C)[:, :, :Ho, :Wo]
    return out.to(x.dtype).contiguous()


def _values(rng, shape, kind):
    x = rng.randn(*shape)
    if kind == "ties":
        # quantized to halves, negative and positive: windows of exact ties
        x = np.round(x * 2) / 2
    elif kind == "nan":
        hit = rng.rand(*shape)
        x[hit < 0.02] = np.nan
        x[(hit >= 0.02) & (hit < 0.04)] = -np.inf
    return x.astype(np.float32)


def assert_same_pool(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


@pytest.mark.parametrize("th", [4, 8])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ishape,k,s,p",
                         POOL_CASES + S3DG_CASES + EDGE_CASES)
def test_tile_model_bit_equal_plain(ishape, k, s, p, dtype, kind, th):
    k, s, p = _t3(k), _t3(s), _t3(p)
    x = torch.from_numpy(_values(np.random.RandomState(11), (2, *ishape),
                                 kind)).to(dtype)
    assert_same_pool(tile_model(x, k, s, p, th),
                     tmp.max_pool3d_fwd_plain(x, k, s, p))

