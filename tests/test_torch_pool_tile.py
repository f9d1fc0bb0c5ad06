"""A CPU model of K1's tiled forward, pinned bit for bit to the plain
max-pool forward.

The tiled K1 (``max_tile`` on ``walk_tile`` in
rspnet_tpu_torch/csrc/max_pool3d.cu) runs on the card only. Its algorithm
is modelled here with vectorised torch ops, step for step:

- the plan (``fwd_tile_plan`` and ``fwd_dispatch``): the vector width V
  (8 in bf16 where C % 8 == 0 and x and out are 16-byte aligned, 4 where
  C % 4 == 0 and they are aligned for it, else 1), the instance (a tiled
  one for S3D-G's four geometries, (1,2,2)/(1,2,2) and (2,1,1)/(2,1,1) at
  V >= 4 on 32-bit plans, with its rows a thread; else the generic one),
  the C-adaptive thread map (CVr element vectors, the least power of two
  >= C / V and at most 8, x 8 columns x 32 / CVr row groups of RH rows:
  a tile of (32 / CVr) * RH rows) and, where the tile grid holds fewer
  than 198 blocks, the frame walk split into chunks of output frames;
  pinned to the plans the card printed (chip_smoke.py's K1 lines);
- a block walks its clip's frames in order, from its first output
  frame's first window frame (to0*st - pt) to its last output frame's
  last one; a frame outside [0, T) is -inf and is not read;
- per frame, the tile's input box ((th-1)*sh+kh) x (7*sw+kw), from row
  ht*th*sh - ph and column wt*8*sw - pw, is read once; cells outside the
  tensor (the -inf padding, the floor tail, a ragged last tile) hold -inf;
- the max is taken along W (kw columns of each box row), then H (kh W-maxed
  rows per output row, RH rows a thread), then T (a ring of the last kt
  frames), in the tensor's own dtype with NaN propagated (the card's
  ``max.NaN.bf16x2`` / ``max.NaN.f32`` on the lanes: nothing is widened);
- output frame to is emitted once frame to*st - pt + kt - 1 is reduced, by
  the chunk that owns it; outputs past Ho or Wo in a ragged tile are
  dropped.

Channels are independent lanes of the max, so the model takes all of them
at once; the thread map changes which thread owns a lane, not its value,
and a test checks that it owns each output lane once. Each case asserts
that the NaN masks are equal and that the values outside them are
``torch.equal`` to ``max_pool3d_fwd_plain``, which tests/test_torch_ops.py
pins to the JAX pool. The cases are the pooling suite's (``POOL_CASES``
holds tests/test_pooling.py's ``CASES``), S3D-G's four geometries, those
geometries at paddings and planes S3D-G does not have, and the zoo's
narrow-C, (1,2,2) and (2,1,1) sites; walked whole and in chunks.
"""
import ctypes

import numpy as np
import pytest
import torch

from rspnet_tpu_torch.framework import tracing
from rspnet_tpu_torch.ops import _build
from rspnet_tpu_torch.ops import max_pool3d as tmp
from tests.test_torch_ops import POOL_CASES
from tests.test_torch_pool_route_tile import plan_vec, thread_map, tile_owners

torch.set_num_threads(1)

TW = 8                              # kTileCols of the kernel
SPLIT_BLOCKS, MIN_BLOCKS = 198, 264  # kFwdSplitBlocks, kFwdMinBlocks
# (kernel, stride) -> rows a thread of the tiled instance (fwd_tiled)
INSTANCES = {((3, 3, 3), (1, 1, 1)): 2, ((1, 3, 3), (1, 2, 2)): 1,
             ((3, 3, 3), (2, 2, 2)): 1, ((2, 2, 2), (2, 2, 2)): 1,
             ((1, 2, 2), (1, 2, 2)): 1, ((2, 1, 1), (2, 1, 1)): 2}
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
# the zoo's sites for the new instances and the narrow-C map, narrow and
# short: C3D's pool1 and the non-local pools (1,2,2) (a floor tail in W,
# a 7^2 plane), C2D's (2,1,1) (a floor tail in T), the stems at C = 8 and
# 16 (bf16: one and two vectors a pixel, a tile 32 and 16 rows tall) on
# ragged planes, and a 7^2 frame with To = 2 (chip_smoke's tile.split_7x7)
ZOO_CASES = [
    ((4, 14, 15, 16), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ((2, 7, 7, 16), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ((5, 9, 10, 16), (2, 1, 1), (2, 1, 1), (0, 0, 0)),
    ((3, 37, 35, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((4, 29, 30, 16), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((4, 7, 7, 16), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
]


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _outs(shape, k, s, p):
    return [tmp.out_len(d, kk, ss, pp) for d, kk, ss, pp in
            zip(shape[1:4], k, s, p)]


def max_nan(a, b):
    """max.NaN: NaN when either operand is NaN, else the larger."""
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), torch.maximum(a, b))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def fwd_plan(shape, k, s, p, dtype, offsets=(0, 0)):
    """rsp_maxpool3d_fwd_plan's fields for a call on x, out that start
    ``offsets`` bytes into 256-byte aligned storage."""
    B, T, H, W, C = shape
    To, Ho, Wo = _outs(shape, k, s, p)
    vec = plan_vec(C, dtype, offsets)
    wide = max(B * T * H * W * C, B * To * Ho * Wo * C) >= 2 ** 31
    rh = INSTANCES.get((k, s), 0) if vec >= 4 and not wide else 0
    generic = {"vec": min(vec, 4), "rows": 0, "cvl": 0, "chunks": 0,
               "frames_per_chunk": 0, "grid_x": 0, "grid_y": 0, "grid_z": 0}
    if not rh:
        return generic
    cv_n = C // vec
    cvr, _, th = thread_map(cv_n, rh)
    x = -(-cv_n // cvr) * -(-Wo // TW)
    y = -(-Ho // th)
    blocks, per = x * y * B, To
    if blocks < SPLIT_BLOCKS:
        want = -(-MIN_BLOCKS // blocks)
        least = -(-2 * (k[0] - s[0]) // s[0])
        per = min(To, max(-(-To // want), least))
    chunks = -(-To // per)
    if x >= 2 ** 31 or y > 65535 or B * chunks > 65535:
        return generic
    return {"vec": vec, "rows": rh, "cvl": cvr.bit_length() - 1,
            "chunks": chunks, "frames_per_chunk": per, "grid_x": x,
            "grid_y": y, "grid_z": B * chunks}


# (shape, k, s, p, dtype, the plan chip_smoke.py printed on the card:
# V, rows, CVr, chunks of frames, grid; None for the generic instance)
CARD_PLANS = [
    ((64, 8, 112, 112, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1), "bfloat16",
     (8, 1, 8, 1, 8, (7, 14, 64))),
    ((64, 8, 112, 112, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1), "float32",
     (4, 1, 8, 1, 8, (14, 14, 64))),
    ((64, 8, 28, 28, 192), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16",
     (8, 2, 8, 1, 8, (12, 4, 64))),
    ((64, 8, 28, 28, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1), "bfloat16",
     (8, 1, 8, 1, 4, (16, 4, 64))),
    ((64, 4, 14, 14, 528), (3, 3, 3), (1, 1, 1), (1, 1, 1), "float32",
     (4, 2, 8, 1, 4, (34, 2, 64))),
    ((128, 4, 14, 14, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0), "bfloat16",
     (8, 1, 8, 1, 2, (13, 2, 128))),
    ((64, 16, 56, 56, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1), "bfloat16",
     (8, 1, 1, 1, 16, (4, 1, 64))),
    ((64, 16, 56, 56, 16), (1, 3, 3), (1, 2, 2), (0, 1, 1), "bfloat16",
     (8, 1, 2, 1, 16, (4, 2, 64))),
    ((32, 16, 112, 112, 64), (1, 2, 2), (1, 2, 2), (0, 0, 0), "bfloat16",
     (8, 1, 8, 1, 16, (7, 14, 32))),
    ((64, 8, 28, 28, 256), (2, 1, 1), (2, 1, 1), (0, 0, 0), "bfloat16",
     (8, 2, 8, 1, 4, (16, 4, 64))),
    ((64, 16, 56, 56, 64), (3, 3, 3), (2, 2, 2), (1, 1, 1), "bfloat16",
     (8, 1, 8, 1, 8, (4, 7, 64))),
    # the finetune path's batch 4 of 64 frames: split walks
    ((4, 32, 28, 28, 192), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16",
     (8, 2, 8, 2, 16, (12, 4, 8))),
    ((4, 32, 28, 28, 256), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16",
     (8, 2, 8, 1, 32, (16, 4, 4))),
    ((4, 16, 14, 14, 480), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16",
     (8, 2, 8, 3, 6, (16, 2, 12))),
    ((4, 16, 14, 14, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0), "bfloat16",
     (8, 1, 8, 3, 3, (13, 2, 12))),
    ((4, 32, 28, 28, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1), "bfloat16",
     (8, 1, 8, 1, 16, (16, 4, 4))),
    # the visualization's f32 batch 8 at 7^2: 208 blocks, walked whole
    ((8, 2, 7, 7, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1), "float32",
     (4, 2, 8, 1, 2, (26, 1, 8))),
    # chip_smoke's tile.split_7x7 at the batch of its phase 2
    ((4, 4, 7, 7, 832), (3, 3, 3), (2, 2, 2), (1, 1, 1), "bfloat16",
     (8, 1, 8, 2, 1, (13, 1, 8))),
    # the generic instance: C % 4 != 0, a geometry without an instance,
    # a tensor of 2^31 elements or more
    ((4, 8, 15, 15, 5), (3, 3, 3), (2, 2, 2), (1, 1, 1), "float32", None),
    ((4, 5, 9, 9, 8), (3, 3, 3), (3, 3, 3), (0, 0, 0), "bfloat16", None),
    ((33, 16, 1023, 1025, 4), (3, 3, 3), (2, 2, 2), (1, 1, 1), "float32",
     None),
]


@pytest.mark.parametrize("shape,k,s,p,dtype,card", CARD_PLANS)
def test_plan_is_the_cards(shape, k, s, p, dtype, card):
    plan = fwd_plan(shape, k, s, p, getattr(torch, dtype))
    if card is None:
        assert plan["rows"] == 0 and plan["grid_z"] == 0
        return
    vec, rows, cvr, chunks, per, grid = card
    assert (plan["vec"], plan["rows"], 1 << plan["cvl"], plan["chunks"],
            plan["frames_per_chunk"]) == (vec, rows, cvr, chunks, per)
    assert (plan["grid_x"], plan["grid_y"], plan["grid_z"]) == grid


@pytest.mark.parametrize("c,dtype,offsets,vec", [
    (64, torch.bfloat16, (0, 0), 8),
    (12, torch.bfloat16, (0, 0), 4),      # C % 8 != 0
    (6, torch.bfloat16, (0, 0), 1),
    (64, torch.bfloat16, (8, 0), 4),      # x only 8-byte aligned
    (64, torch.bfloat16, (0, 4), 1),      # out only 4-byte aligned
    (64, torch.float32, (0, 0), 4),
    (64, torch.float32, (0, 8), 1),
    (6, torch.float32, (0, 0), 1),
])
def test_plan_vector_width(c, dtype, offsets, vec):
    """V by dtype, C and the alignment of x and out; at V = 1 the generic
    instance takes the call (no tiled instance runs below V = 4)."""
    plan = fwd_plan((2, 4, 14, 14, c), (3, 3, 3), (1, 1, 1), (1, 1, 1),
                    dtype, offsets)
    assert plan["vec"] == vec
    assert bool(plan["rows"]) == (vec >= 4)


@pytest.mark.parametrize("cv_n", [1, 2, 3, 8, 13])
@pytest.mark.parametrize("rh", [1, 2])
def test_thread_map_owns_each_output_once(cv_n, rh):
    """The C-adaptive map over a ragged output plane: each output lane has
    exactly one owner, at narrow C too (no thread owns a lane twice, none
    is left out)."""
    count = tile_owners(cv_n, 37, 19, rh)
    assert torch.equal(count, torch.ones_like(count))


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def tile_model(x, k, s, p, th, rh, per=None):
    """K1's tiled forward of x [B, T, H, W, C]: tiles of th rows, rh rows
    a thread, each clip's output frames walked in chunks of ``per``
    (None: the whole clip)."""
    B, T, H, W, C = x.shape
    To, Ho, Wo = _outs(x.shape, k, s, p)
    per = To if per is None else per
    bh, bw = (th - 1) * s[1] + k[1], (TW - 1) * s[2] + k[2]
    nh, nw = -(-Ho // th), -(-Wo // TW)
    inf = torch.tensor(float("-inf"), dtype=x.dtype)
    # every tile's box, all frames: [B, T, nh, bh, nw, bw, C], in x's dtype
    hi = (torch.arange(nh) * th * s[1] - p[1])[:, None] + torch.arange(bh)
    wi = (torch.arange(nw) * TW * s[2] - p[2])[:, None] + torch.arange(bw)
    box = x[:, :, hi.clamp(0, H - 1)][:, :, :, :, wi.clamp(0, W - 1)]
    inside = (((hi >= 0) & (hi < H))[:, :, None, None, None]
              & ((wi >= 0) & (wi < W))[None, None, :, :, None])
    box = torch.where(inside, box, inf)
    # each thread's rows: row0 = group * rh; its box rows row0*sh + rr
    hw = torch.empty(B, T, nh, th, nw, TW, C, dtype=x.dtype)
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
    # each chunk's frame walk with a ring of the last kt frames
    out = torch.empty(B, To, nh, th, nw, TW, C, dtype=x.dtype)
    emitted = []
    for to0 in range(0, To, per):
        to1 = min(To, to0 + per)
        ring = [torch.full(hw[:, 0].shape, float("-inf"), dtype=x.dtype)]
        ring = ring * k[0]
        for t in range(to0 * s[0] - p[0], (to1 - 1) * s[0] - p[0] + k[0]):
            frame = hw[:, t] if 0 <= t < T else torch.full_like(ring[0],
                                                                -np.inf)
            ring = ring[1:] + [frame]
            j = t + p[0] - (k[0] - 1)
            if j >= to0 * s[0] and j % s[0] == 0:
                m = ring[0]
                for d in range(1, k[0]):
                    m = max_nan(m, ring[d])
                out[:, j // s[0]] = m
                emitted.append(j // s[0])
    assert emitted == list(range(To))
    out = out.reshape(B, To, nh * th, nw * TW, C)[:, :, :Ho, :Wo]
    return out.contiguous()


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
    """The walk at CVr = 8 (C >= 8 V): tiles of 4 (RH = 1) and 8 (RH = 2)
    rows."""
    k, s, p = _t3(k), _t3(s), _t3(p)
    x = torch.from_numpy(_values(np.random.RandomState(11), (2, *ishape),
                                 kind)).to(dtype)
    assert_same_pool(tile_model(x, k, s, p, th, th // 4),
                     tmp.max_pool3d_fwd_plain(x, k, s, p))


@pytest.mark.parametrize("kind", ["normal", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ishape,k,s,p",
                         S3DG_CASES + EDGE_CASES + ZOO_CASES)
def test_planned_walk_bit_equal_plain(ishape, k, s, p, dtype, kind):
    """The walk as the plan launches it at batch 2 (most of these grids
    are small: the walk is split into chunks), and at every chunk length
    from one frame to the whole clip."""
    k, s, p = _t3(k), _t3(s), _t3(p)
    x = torch.from_numpy(_values(np.random.RandomState(12), (2, *ishape),
                                 kind)).to(dtype)
    ref = tmp.max_pool3d_fwd_plain(x, k, s, p)
    plan = fwd_plan(x.shape, k, s, p, dtype)
    assert plan["rows"]                  # every case has a tiled instance
    rh = plan["rows"]
    cvr, _, th = thread_map(x.shape[4] // plan["vec"], rh)
    assert cvr == 1 << plan["cvl"]
    assert_same_pool(tile_model(x, k, s, p, th, rh,
                                plan["frames_per_chunk"]), ref)
    for per in range(1, ref.shape[1] + 1):
        assert_same_pool(tile_model(x, k, s, p, th, rh, per), ref)


def test_fwd_call_on_a_known_geometry_builds_nothing(monkeypatch):
    """A second max_pool3d_fwd call on a known geometry takes its output
    shape and ctypes arguments from the cache (no check, no new ctypes
    array): the kernel library stubbed, a CPU tensor presenting itself as
    a CUDA one."""

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    calls = []

    class Lib:
        @staticmethod
        def rsp_maxpool3d_fwd(xp, outp, dtype, shape_arr, kspec, stream):
            calls.append((shape_arr, kspec))
            return 0

    built = []
    geometry_args = tmp._geometry_args

    def counted(*a):
        built.append(a)
        return geometry_args(*a)

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(tmp, "_stream", lambda t: 0)
    monkeypatch.setattr(tmp, "_geometry_args", counted)
    monkeypatch.setattr(tmp, "check_geometry", lambda *a: built.append(a))
    shape, k = (3, 5, 9, 7, 16), (3, 3, 3)
    tmp._geometries.pop((shape, k, (1, 1, 1), (1, 1, 1)), None)
    x = torch.zeros(shape).as_subclass(OnCard)
    counter = "kernels.max_pool3d_fwd.float32"
    before = tracing.counter(counter)
    out1 = tmp.max_pool3d_fwd(x, k, 1, 1)
    n = len(built)
    out2 = tmp.max_pool3d_fwd(x, k, 1, 1)
    assert n == 2 and len(built) == n        # checked and built once
    assert calls[0][0] is calls[1][0] and calls[0][1] is calls[1][1]
    assert isinstance(calls[0][0], ctypes.Array)
    assert list(calls[0][0]) == list(shape)
    assert list(calls[0][1]) == [3, 3, 3, 1, 1, 1, 1, 1, 1]
    assert out1.shape == out2.shape == (3, 5, 9, 7, 16)
    assert tracing.counter(counter) == before + 2
