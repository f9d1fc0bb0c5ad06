"""3-D max pool over NDHWC tensors: CUDA kernels K1 (forward) and K2
(backward), their plain-torch versions, and the autograd Function.

Replaces rspnet_tpu/ops/pallas_pool.py (``_fwd_kernel`` :152 and
``_bwd_kernel`` :159, reached through ``max_pool3d_pallas``). Semantics:
torch MaxPool3d in floor mode with -inf padding. The gradient routes each
cotangent to the FIRST matching offset of its window, one axis at a time in
the order W, H, T. That is the rule of the Pallas kernel and of
``rspnet_tpu/models/common.py:_make_max_pool3d_fm``, not the argmax of
``F.max_pool3d``: after a ReLU many window values tie at exactly 0, and
the two rules route those gradients to different inputs.

Geometry: per axis 1 <= k <= 3, 1 <= s <= k and 0 <= p <= k // 2 (every
input position lies in some window, every window holds a real value). This
covers all 13 pool sites of S3D-G, the strided stage pools included (the
Pallas kernel took stride 1 only).

On this card the least time of both directions is set by device-memory
traffic: read x (and g), write out (or dx); the source says what holds
each above it. The forward is one launch: at S3D-G's four pool geometries,
(1,2,2)/(1,2,2) and (2,1,1)/(2,1,1), on 16-byte (bf16: 8-channel) vectors,
a block copies each frame's input box for its output tile into shared
memory once and takes the max along W, then H, then T (over the frames it
has walked; a small grid walks each clip in chunks of frames); any other
call computes each output's whole window in one thread. Every max
propagates NaN, as ``torch.maximum`` does. The
backward is two launches. Composed W -> H
-> T, the first-match rule sends each output's cotangent to one input, and
a route pass writes that input's window offset as one byte per output
element. A gather pass then sums, for each input element, the cotangents
whose route names it, in the order of the plain version's stages (and, in
bf16, with its rounding of each stage). At the pool geometries of S3D-G,
ResNet-3D and the non-local blocks, on 16-byte (bf16: 8-channel) vectors,
both passes walk a tile in shared memory and the gather sums level by
level (W, H, T); any other call takes the first design, one thread per
element vector and its whole window. No atomics: it is deterministic and
equal bit for bit to ``max_pool3d_bwd_plain`` in f32 and bf16. See
``csrc/max_pool3d.cu``.

How this backward relates to the JAX S3D-G's pool. The JAX S3D-G pools
with ``_max_pool3d_separable_rw`` (rspnet_tpu/models/common.py:296, the
default at :488), whose VJP is one select-and-scatter per axis; this
module follows the Pallas kernel instead. The two route the same cell on
finite and -inf inputs, ties included (first match per axis both), with
one deviation and one rounding difference:

- NaN (a deviation). A window that holds a NaN routes its cotangent
  nowhere here, as the Pallas kernel does (pallas_pool.py:159: its max is
  NaN, which equals no cell), while the rw-sep VJP routes it to a cell.
  Every other cell agrees in f32 to summation order (1e-5).
- bf16 sums. Per axis a cell collects at most ceil(k / s) cotangents.
  This backward adds them in f32 and rounds the level's sum to bf16 once
  (the W and H stages, then the output); XLA adds them one at a time in
  bf16, rounding after each add. With at most two per level (every strided
  S3D-G geometry) both compute round(a + b): bit-equal. With three
  (k = 3, s = 1) XLA rounds a + b before adding c. Every partial sum on a
  cell's route is bounded by A, the f32 backward of |g| at that cell (the
  cotangent mass that reaches it), so each rounding moves it by at most
  1/2 ulp_bf16(A). Counting the roundings the two sides do not share, the
  port's two stage roundings (W and H, whose rounded results re-enter a
  sum) and XLA's three extra ones (a + b on the W, H and T levels), with
  the final rounding of the output taken as shared, bounds the difference
  per cell by 2.5 ulp_bf16(A), where ``ulp_bf16(v) = 2**(floor(log2(
  max(|v|, 2**-126))) - 7)``. Measured in ulps of the cell's own value
  the difference reaches 256 (a small sum after cancellation), which is
  the wrong yardstick. tests/test_torch_ops.py holds the plain backward to
  the rw-sep VJP by this rule; over unique, tie-heavy and -inf inputs at
  C = 6 and 16 the largest difference was 2.0 ulp_bf16(A).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises. Launches count in ``framework/tracing.py``'s ``kernels.`` counters.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from ..framework import tracing
from . import _build

Triple = Tuple[int, int, int]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _triple(v) -> Triple:
    if isinstance(v, int):
        return (v, v, v)
    if type(v) is tuple:        # the autograd Function passes tuples
        return v
    return tuple(int(a) for a in v)


def out_len(d: int, k: int, s: int, p: int) -> int:
    return (d + 2 * p - k) // s + 1


def check_geometry(shape: Sequence[int], k: Triple, s: Triple,
                   p: Triple) -> None:
    if len(shape) != 5:
        raise ValueError(f"max_pool3d takes NDHWC [B,T,H,W,C], got {shape}")
    for d, kk, ss, pp in zip(shape[1:4], k, s, p):
        if not (1 <= kk <= 3 and 1 <= ss <= kk and 0 <= pp <= kk // 2):
            raise ValueError(f"unsupported pool geometry k={k} s={s} p={p}")
        if out_len(d, kk, ss, pp) < 1:
            raise ValueError(f"pool k={k} s={s} p={p} empties {shape}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _trivial(k: int, s: int, p: int) -> bool:
    return k == 1 and s == 1 and p == 0


def _pad_axis(v: torch.Tensor, axis: int, k: int, s: int, p: int):
    d = v.shape[axis]
    n = out_len(d, k, s, p)
    pad_hi = max(0, (n - 1) * s + k - d - p)
    shape = list(v.shape)
    shape[axis] = d + p + pad_hi
    vpad = torch.full(shape, float("-inf"), dtype=v.dtype, device=v.device)
    vpad.narrow(axis, p, d).copy_(v)
    return vpad, n


def _strided(v: torch.Tensor, axis: int, off: int, n: int, s: int):
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(off, off + (n - 1) * s + 1, s)
    return v[tuple(idx)]


def _pool_axis_fwd_plain(v, axis, k, s, p):
    if _trivial(k, s, p):
        return v
    vpad, n = _pad_axis(v, axis, k, s, p)
    acc = _strided(vpad, axis, 0, n, s)
    for off in range(1, k):
        acc = torch.maximum(acc, _strided(vpad, axis, off, n, s))
    return acc.contiguous()


def _stages_plain(x, k, s, p):
    stages = [x]
    for axis in (1, 2, 3):
        stages.append(_pool_axis_fwd_plain(stages[-1], axis, k[axis - 1],
                                           s[axis - 1], p[axis - 1]))
    return stages


def _pool_axis_bwd_plain(vin, vout, g, axis, k, s, p):
    """First-match adjoint of one axis; sums in window-offset order in (at
    least) f32, like the kernel."""
    if _trivial(k, s, p):
        return g
    d = vin.shape[axis]
    vpad, n = _pad_axis(vin, axis, k, s, p)
    acc_dtype = torch.promote_types(g.dtype, torch.float32)
    gpad = torch.zeros(vpad.shape, dtype=acc_dtype, device=g.device)
    gf = g.to(acc_dtype)
    matched = torch.zeros(vout.shape, dtype=torch.bool, device=g.device)
    for off in range(k):
        eq = _strided(vpad, axis, off, n, s) == vout
        take = eq & ~matched
        matched = matched | eq
        _strided(gpad, axis, off, n, s).add_(
            torch.where(take, gf, torch.zeros((), device=g.device)))
    return gpad.narrow(axis, p, d).to(g.dtype).contiguous()


def max_pool3d_fwd_plain(x: torch.Tensor, k, s, p) -> torch.Tensor:
    """Separable max pool, T then H then W (exact maxes, so equal bit for
    bit to any other evaluation order)."""
    k, s, p = _triple(k), _triple(s), _triple(p)
    if x.is_cuda:
        tracing.add("kernels.max_pool3d_fwd.plain_on_cuda")
    return _stages_plain(x, k, s, p)[-1]


def max_pool3d_bwd_plain(x: torch.Tensor, g: torch.Tensor, k, s,
                         p) -> torch.Tensor:
    """dx of the pool, first-match routing composed W -> H -> T."""
    k, s, p = _triple(k), _triple(s), _triple(p)
    if x.is_cuda:
        tracing.add("kernels.max_pool3d_bwd.plain_on_cuda")
    stages = _stages_plain(x, k, s, p)
    for axis in (3, 2, 1):
        g = _pool_axis_bwd_plain(stages[axis - 1], stages[axis], g, axis,
                                 k[axis - 1], s[axis - 1], p[axis - 1])
    return g


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not in f32/bf16")
    if not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous NDHWC tensor")


def _geometry_args(shape, k, s, p):
    shape_arr = (ctypes.c_int64 * 5)(*shape)
    kspec = (ctypes.c_int * 9)(*k, *s, *p)
    return shape_arr, kspec


def _stream(t: torch.Tensor) -> int:
    """The current stream's handle on t's card, by the raw query (no Stream
    object is built: a small pool's call is host-bound)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _out_shape(shape, k, s, p):
    return (shape[0], *(out_len(d, kk, ss, pp) for d, kk, ss, pp in
                        zip(shape[1:4], k, s, p)), shape[4])


# (shape, k, s, p) -> (output shape, output elements, ctypes shape, ctypes
# kspec, whether no axis pools) of the checked geometries: a backward call
# on a known geometry builds nothing (its host time is what launches a
# small pool's kernels)
_geometries = {}


def _checked_geometry(shape, k, s, p):
    key = (tuple(shape), k, s, p)
    got = _geometries.get(key)
    if got is None:
        check_geometry(shape, k, s, p)
        if len(_geometries) > 4096:
            _geometries.clear()
        oshape = _out_shape(shape, k, s, p)
        got = _geometries[key] = (
            oshape, math.prod(oshape), *_geometry_args(shape, k, s, p),
            all(_trivial(*a) for a in zip(k, s, p)))
    return got


def max_pool3d_fwd(x: torch.Tensor, k, s, p, *,
                   build: str = "max_pool3d") -> torch.Tensor:
    """K1: NDHWC max pool forward. ``build`` names the kernel library
    (``_build.VARIANTS``). A geometry seen before is checked and its
    ctypes arguments built once (``_checked_geometry``): a small pool's
    time is this call's host time."""
    k, s, p = _triple(k), _triple(s), _triple(p)
    oshape, _, shape_arr, kspec, _ = _checked_geometry(x.shape, k, s, p)
    if not x.is_cuda:
        return max_pool3d_fwd_plain(x, k, s, p)
    _check_cuda(x, "max_pool3d_fwd")
    out = x.new_empty(oshape)
    err = _build.library(build).rsp_maxpool3d_fwd(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], shape_arr, kspec,
        _stream(x))
    _build.check(err, "rsp_maxpool3d_fwd")
    tracing.add("kernels.max_pool3d_fwd."
                + str(x.dtype).removeprefix("torch."))
    return out


# rsp_maxpool3d_fwd_plan's fields, in order
FWD_PLAN_KEYS = ("vec", "rows", "cvl", "chunks", "frames_per_chunk",
                 "grid_x", "grid_y", "grid_z")


def fwd_plan(shape, k, s, p, dtype: torch.dtype,
             build: str = "max_pool3d") -> dict:
    """The launch K1 makes for a call on 16-byte aligned [B, T, H, W, C]
    tensors of ``dtype`` (needs the kernel library): the vector width,
    the tiled instance's rows a thread (0: the generic instance takes the
    call), log2 of its channel vectors a block, its frame chunks and
    grid."""
    k, s, p = _triple(k), _triple(s), _triple(p)
    _, _, shape_arr, kspec, _ = _checked_geometry(shape, k, s, p)
    plan = (ctypes.c_int * len(FWD_PLAN_KEYS))()
    _build.check(_build.library(build).rsp_maxpool3d_fwd_plan(
        _DTYPES[dtype], shape_arr, kspec, plan), "rsp_maxpool3d_fwd_plan")
    return dict(zip(FWD_PLAN_KEYS, plan))


def max_pool3d_bwd(x: torch.Tensor, g: torch.Tensor, k, s, p, *,
                   build: str = "max_pool3d") -> torch.Tensor:
    """K2: dx of the NDHWC max pool for cotangent g (first-match routing).
    ``build`` names the kernel library (``_build.VARIANTS``)."""
    k, s, p = _triple(k), _triple(s), _triple(p)
    oshape, route_bytes, shape_arr, kspec, trivial = _checked_geometry(
        x.shape, k, s, p)
    if tuple(g.shape) != oshape:
        raise ValueError(f"cotangent {tuple(g.shape)} != pool out {oshape}")
    if not x.is_cuda:
        return max_pool3d_bwd_plain(x, g, k, s, p)
    _check_cuda(x, "max_pool3d_bwd x")
    _check_cuda(g, "max_pool3d_bwd g")
    if g.dtype != x.dtype or not g.is_cuda:
        raise TypeError("max_pool3d_bwd: g must match x's dtype and device")
    if trivial:
        raise ValueError("max_pool3d_bwd: nothing to pool")
    # dx and the route scratch (one byte an output element) in one
    # allocation, the route after dx (aligned for any vector: dx's bytes
    # are a multiple of C times the element size)
    n, esize = x.numel(), x.element_size()
    buf = torch.empty(n + -(-route_bytes // esize), dtype=x.dtype,
                      device=x.device)
    dx = buf[:n].view(x.shape)
    lib = _build.library(build)
    err = lib.rsp_maxpool3d_bwd(_ptr(x), _ptr(g), _ptr(dx),
                                _ptr(buf) + n * esize, _DTYPES[x.dtype],
                                shape_arr, kspec, _stream(x))
    _build.check(err, "rsp_maxpool3d_bwd")
    tracing.add("kernels.max_pool3d_bwd."
                + str(x.dtype).removeprefix("torch."))
    return dx


class MaxPool3dFunction(torch.autograd.Function):
    """Pool whose gradient is K2 (or its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, x, k, s, p):
        ctx.save_for_backward(x)
        ctx.geom = (k, s, p)
        return max_pool3d_fwd(x, k, s, p)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool3d_bwd(x, g.contiguous(), *ctx.geom), None, None, None


def max_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """Differentiable NDHWC max pool (torch floor mode, -inf padding)."""
    k, s, p = _triple(kernel), _triple(strides), _triple(padding)
    return MaxPool3dFunction.apply(x, k, s, p)
