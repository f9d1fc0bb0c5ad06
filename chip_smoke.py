#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card: name and power limit (nvidia-smi);
  1. build every CUDA kernel of rspnet_tpu_torch/csrc (one nvcc per source,
     all at once), with the build time;
  2. each kernel against its plain-torch version on the card:
     K1/K2 (max pool fwd/bwd) at the 13 S3D-G pool sites (batch cut to 4)
     and at small shapes no site has (the generic instances, the
     one-channel path, the compile-time instances at other paddings and
     planes), f32 and bf16, with and without ties, both
     bit-equal; K1/K2 (both builds) on inputs that hold NaN and -inf, and
     K2 on inputs whose corner windows are all -inf, NaN where the plain
     version has NaN and bit-equal elsewhere; K1/K2 on two tensors of over
     2^31 elements (the 64-bit index plans); K3 (colour augment) over all
     24 op orders x gray on/off x flip on/off x gray before/after, uint8
     and f32 input, at [8, 32, 224, 224, 3], at the main path's batch 64,
     at four ragged shapes, at a clip too large for the resident instance
     (the generic one takes it) and through the color_augment_generic
     build; two K3 calls at the main shapes bit-identical;
  3. timing with CUDA events at the main path's shapes, beside the bound,
     the plain version and the library; K1/K2 are also held bit-equal to
     their plain versions there (K1 at the fused key pass's batch 128
     too), and their compile-time instances are timed against their
     generic instances (the max_pool3d_generic build); K3's resident
     instance against its generic one (the color_augment_generic build),
     u8 and f32, with its grid, and where its time goes clip by clip (the
     color_augment_timeline build, ``ops/k3_timeline.py``);
  4. the main path: ``rspnet_tpu_torch.pretrain.main`` on
     config/pretrain/s3dg.jsonnet with synthetic data and device geometry,
     3 steps (``-d``), counting kernel launches.
Then one JSON line with the kernels, the card line again, and the result
line ``{"ok": true, "device": {...}}`` last. Any failure exits non-zero
before the result line. Imports nothing of JAX or of rspnet_tpu.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores

# (site, per-clip input [T, H, W, C], kernel, stride, padding) of S3D-G at a
# [B, 16, 224, 224, 3] input (rspnet_tpu_torch/models/s3dg.py)
POOL_SITES = [
    ("maxPool1", (8, 112, 112, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("maxPool2", (8, 56, 56, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ("sepInc_3b.branch3", (8, 28, 28, 192), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_3c.branch3", (8, 28, 28, 256), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxPool_sepInc_4b", (8, 28, 28, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("sepInc_4b.branch3", (4, 14, 14, 480), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4c.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4d.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4e.branch3", (4, 14, 14, 512), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_4f.branch3", (4, 14, 14, 528), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("maxPool_sepInc_5b", (4, 14, 14, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ("sepInc_5b.branch3", (2, 7, 7, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("sepInc_5c.branch3", (2, 7, 7, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
]
# (name, [T, H, W, C], kernel, stride, padding) that no S3D-G site has: the
# kernels' one-channel-per-thread path (C % 4 != 0) and their generic
# instances (C % 4 == 0, a geometry without a compile-time instance), over
# the pooling suite's odd geometries and k = 2, p = 1 (an output longer
# than its input); and the compile-time instances (C % 4 == 0, S3D-G's
# geometries) at paddings and planes S3D-G does not have: K1's floor tail,
# a frame walk from t = -1, no padding, ragged tiles and a partial
# channel chunk
EXTRA_POOL_SITES = [
    ("odd.floor_tail", (8, 15, 15, 5), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("odd.window_eq_stride", (5, 9, 9, 2), (3, 3, 3), (3, 3, 3), (0, 0, 0)),
    ("odd.branch3", (8, 14, 14, 6), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ("odd.c3d_pool1", (16, 16, 16, 3), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("odd.k2_p1", (3, 5, 5, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1)),
    ("generic.c3d_pool1", (16, 16, 16, 8), (1, 2, 2), (1, 2, 2), (0, 0, 0)),
    ("generic.window_eq_stride", (5, 9, 9, 8), (3, 3, 3), (3, 3, 3),
     (0, 0, 0)),
    ("generic.k2_p1", (3, 5, 5, 4), (2, 2, 2), (1, 1, 1), (1, 1, 1)),
    ("generic.mixed", (6, 9, 10, 12), (3, 2, 3), (2, 1, 3), (1, 0, 1)),
    ("tile.floor_tail", (8, 15, 15, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("tile.k2_p1", (3, 5, 5, 4), (2, 2, 2), (2, 2, 2), (1, 1, 1)),
    ("tile.branch3_p0", (5, 9, 11, 8), (3, 3, 3), (1, 1, 1), (0, 0, 0)),
    ("tile.stem_odd", (4, 9, 13, 12), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
]
# ([B, T, H, W, C], kernel, stride, padding, dtype) of tensors with 2^31 or
# more elements: the 64-bit index plans of K1 and K2, on the four-channel
# path in f32 (a floor tail on H and W) and the one-channel path in bf16
WIDE_POOL_SITES = [
    ((33, 16, 1023, 1025, 4), (3, 3, 3), (2, 2, 2), (1, 1, 1), "float32"),
    ((43, 16, 1024, 1024, 3), (3, 3, 3), (1, 1, 1), (1, 1, 1), "bfloat16"),
]
# sites whose inputs hold NaN and -inf (phase 2): each K1 instance (the
# four S3D-G geometries, also at their edge cases) and the generic one
# (C % 4 != 0, another geometry)
NAN_POOL_SITES = ("maxPool1", "sepInc_3b.branch3", "maxPool_sepInc_4b",
                  "maxPool_sepInc_5b", "sepInc_5b.branch3", "odd.floor_tail",
                  "generic.mixed", "tile.floor_tail", "tile.k2_p1",
                  "tile.branch3_p0", "tile.stem_odd")
GENERIC = "max_pool3d_generic"   # the build without compile-time instances
K3_TOL = 1e-4
COLOR_CLIP = (32, 224, 224)     # [T, H, W] of a K3 clip on the main path
# (batch, [T, H, W]) of K3 checks off the main path's shape: rows that are
# not multiples of 16 bytes (W % 4 != 0, and u8 rows of 60 bytes), a
# tensor whose byte count is no multiple of 16, a ragged last CTA (371
# rows on 132 or 264 CTAs) and CTAs with no rows
RAGGED_COLOR = [(5, (7, 9, 13)), (3, (3, 100, 101)), (3, (7, 53, 101)),
                (4, (5, 9, 20))]
# a clip whose slices do not fit the co-resident grid: the generic instance
LARGE_COLOR = (2, (64, 480, 640))
MAIN_BATCH = 64                # batch_size of config/pretrain/s3dg.jsonnet


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_pool(dev, batch: int):
    """K1/K2 vs plain at every site; returns the largest f32 abs errors
    (forward, backward)."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_fwd = worst = 0.0
    for name, shape4, k, s, p in POOL_SITES + EXTRA_POOL_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            for ties in (False, True):
                x = torch.randn((batch, *shape4), generator=gen, device=dev)
                if ties:
                    x = torch.relu(x)
                x = x.to(dtype)
                out = mp.max_pool3d_fwd(x, k, s, p)
                ref = mp.max_pool3d_fwd_plain(x, k, s, p)
                require(torch.equal(out, ref),
                        f"K1 {name} {dtype} ties={ties}: forward differs")
                worst_fwd = max(worst_fwd,
                                float((out.float() - ref.float()).abs().max()))
                g = torch.randn(out.shape, generator=gen,
                                device=dev).to(dtype)
                dx = mp.max_pool3d_bwd(x, g, k, s, p)
                dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
                torch.cuda.synchronize()
                err = float((dx.float() - dref.float()).abs().max())
                gsum = float(g.double().sum())
                dsum = float(dx.double().sum())
                scale = float(g.double().abs().sum())
                require(torch.equal(dx, dref),
                        f"K2 {name} {dtype} ties={ties}: not bit-equal "
                        f"(max err {err})")
                # bf16 rounds each stage's cotangent, so its sum drifts
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                require(abs(dsum - gsum) <= tol * scale,
                        f"K2 {name} {dtype}: gradient sum {dsum} != {gsum}")
                worst = max(worst, err)
                print(f"check K1/K2 {name:20s} {str(dtype):15s} ties={ties!s:5}"
                      f" fwd=bit-equal bwd_max_abs_err={err:.3g} "
                      f"bwd_bit_equal={torch.equal(dx, dref)}", flush=True)
    return worst_fwd, worst


def check_pool_nan(dev, batch: int) -> None:
    """K1 and K2 (default and generic builds) on inputs with NaN and -inf
    cells, and K2 on inputs whose corner windows are all -inf: the NaN
    masks equal the plain version's, the other values are bit-equal."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    def same(out, ref):
        nan = torch.isnan(ref)
        return (torch.equal(torch.isnan(out), nan)
                and torch.equal(out[~nan], ref[~nan])), int(nan.sum())

    gen = torch.Generator(device=dev).manual_seed(5)
    sites = {name: rest for name, *rest in POOL_SITES + EXTRA_POOL_SITES}
    for name in NAN_POOL_SITES:
        shape4, k, s, p = sites[name]
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("nan", "edge"):
                x = torch.randn((batch, *shape4), generator=gen, device=dev)
                if case == "nan":       # 1% NaN, 1% -inf
                    u = torch.rand(x.shape, generator=gen, device=dev)
                    x = x.masked_fill(u < 0.01, float("nan"))
                    x = x.masked_fill((u >= 0.01) & (u < 0.02),
                                      float("-inf"))
                else:                   # all -inf windows at both corners
                    x[:, :k[0], :k[1], :k[2]] = float("-inf")
                    x[:, -k[0]:, -k[1]:, -k[2]:] = float("-inf")
                x = x.to(dtype)
                ref = mp.max_pool3d_fwd_plain(x, k, s, p)
                g = torch.randn(ref.shape, generator=gen,
                                device=dev).to(dtype)
                dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
                # the cotangent the plain version drops (NaN and pad routes)
                dropped = float(g.double().sum() - dref.double().sum())
                for build in ("max_pool3d", GENERIC):
                    ok_f, n_f = (same(mp.max_pool3d_fwd(x, k, s, p,
                                                        build=build), ref)
                                 if case == "nan" else (True, 0))
                    ok_b, n_b = same(mp.max_pool3d_bwd(x, g, k, s, p,
                                                       build=build), dref)
                    print(f"check K1/K2 {case:4s} {name:20s} {str(dtype):15s}"
                          f" {build:18s} fwd nan {n_f}/{ref.numel()} same "
                          f"{ok_f} | bwd nan {n_b}, dropped g sum "
                          f"{dropped:.4g}, same NaN mask and values {ok_b}",
                          flush=True)
                    require(ok_f and ok_b,
                            f"K1/K2 {case} {name} {dtype} {build}: differs "
                            f"from the plain version (fwd {ok_f}, bwd "
                            f"{ok_b})")


def check_pool_wide(dev) -> None:
    """K1/K2 on tensors of 2^31 or more elements (the 64-bit index plans),
    held bit-equal to the plain version clip by clip."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(4)
    for shape, k, s, p, dtype_name in WIDE_POOL_SITES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(shape, generator=gen, device=dev).relu_().to(dtype)
        out = mp.max_pool3d_fwd(x, k, s, p)
        g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        dx = mp.max_pool3d_bwd(x, g, k, s, p)
        require(max(x.numel(), out.numel()) >= 2 ** 31,
                f"wide case {shape} is under 2^31 elements")
        fwd_eq = bwd_eq = True
        for lo in range(0, shape[0], 4):
            xs, gs = x[lo:lo + 4], g[lo:lo + 4]
            fwd_eq &= torch.equal(out[lo:lo + 4],
                                  mp.max_pool3d_fwd_plain(xs, k, s, p))
            bwd_eq &= torch.equal(dx[lo:lo + 4],
                                  mp.max_pool3d_bwd_plain(xs, gs, k, s, p))
        what = f"K1/K2 64-bit plan {list(shape)} k={k} s={s} p={p} {dtype_name}"
        print(f"check {what}: {x.numel()} elements, fwd bit-equal {fwd_eq}, "
              f"bwd bit-equal {bwd_eq}", flush=True)
        require(fwd_eq and bwd_eq, f"{what}: differs from the plain version")
        del x, out, g, dx
        torch.cuda.empty_cache()


def _color_args(rng, n):
    import numpy as np
    return np.stack([rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
                     rng.uniform(0.6, 1.4, n), rng.uniform(-0.4, 0.4, n)],
                    1).astype(np.float32)


def _color_input(gen, dev, shape, in_u8: bool):
    import torch
    if in_u8:
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
    return torch.rand(shape, generator=gen, device=dev)


def color_plan_line(shape, in_u8: bool, build: str = "color_augment") -> str:
    from rspnet_tpu_torch.ops import color_augment as ca
    p = ca.launch_plan(shape, in_u8, build=build)
    if not p["resident"]:
        return f"generic instance, {p['ctas']} blocks per clip"
    return (f"resident instance, {p['ctas']} CTAs ({p['ctas_per_sm']} per "
            f"SM), {p['rows_per_cta']} rows per CTA in {p['chunks']} chunks "
            f"of {p['rows_per_chunk']}, a ring of {p['slots']} slots, "
            f"{p['smem_bytes']} B shared memory")


def check_color(dev, batch: int, clip, resident: bool = True,
                build: str = "color_augment") -> float:
    """K3 vs plain over every order x gray x flip x gray-before, u8 and f32
    input, on clips [T, H, W] in batches of ``batch``; the instance the
    plan takes must be the resident one iff ``resident``. Returns the
    largest abs error on the normalized output."""
    import itertools

    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    combos = [(o, gr, fl) for o in itertools.permutations(range(4))
              for gr in (False, True) for fl in (False, True)]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for in_u8 in (True, False):
        shape = (batch, *clip, 3)
        plan = ca.launch_plan(shape, in_u8, build=build)
        line = color_plan_line(shape, in_u8, build)
        require(bool(plan["resident"]) == resident,
                f"K3 {build} {list(shape)} u8={in_u8}: {line}, expected the "
                f"{'resident' if resident else 'generic'} instance")
        for gray_first in (True, False):
            err_case = 0.0
            for lo in range(0, len(combos), batch):
                part = combos[lo:lo + batch]
                n = len(part)
                order = np.asarray([c[0] for c in part], np.int32)
                gray = np.asarray([c[1] for c in part])
                flip = np.asarray([c[2] for c in part])
                x = _color_input(gen, dev, (n, *clip, 3), in_u8)
                kw = dict(mean=(0.485, 0.456, 0.406),
                          std=(0.229, 0.224, 0.225),
                          gray_before_jitter=gray_first)
                factors = _color_args(rng, n)
                out = ca.color_augment(x, order, factors, gray, flip,
                                       build=build, **kw)
                ref = ca.color_augment_plain(x, order, factors, gray, flip,
                                             **kw)
                err_case = max(err_case, float((out - ref).abs().max()))
                del x, out, ref
            print(f"check K3 {build} [{batch},{','.join(map(str, clip))},3] "
                  f"gray_before={gray_first!s:5} input="
                  f"{'u8' if in_u8 else 'f32'} max_abs_err={err_case:.3g} "
                  f"(limit {K3_TOL}); {line}", flush=True)
            require(err_case <= K3_TOL, f"K3 error {err_case} > {K3_TOL}")
            worst = max(worst, err_case)
    torch.cuda.empty_cache()
    return worst


def check_color_repeat(dev, batch: int, clip) -> None:
    """Two K3 calls on the same inputs give the same bits (the clip mean is
    summed in a fixed order, no atomics on floats)."""
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    order = np.stack([rng.permutation(4) for _ in range(batch)]).astype(
        np.int32)
    gray, flip = rng.random(batch) < 0.5, rng.random(batch) < 0.5
    factors = _color_args(rng, batch)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    for in_u8 in (False, True):
        x = _color_input(gen, dev, (batch, *clip, 3), in_u8)
        a = ca.color_augment(x, order, factors, gray, flip, **kw)
        b = ca.color_augment(x, order, factors, gray, flip, **kw)
        same = torch.equal(a, b)
        print(f"check K3 repeat [{batch},{','.join(map(str, clip))},3] "
              f"input={'u8' if in_u8 else 'f32'}: two calls bit-identical "
              f"{same}", flush=True)
        require(same, "K3: two calls on the same inputs differ")
        del x, a, b
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: timing at the main path's shapes
# ---------------------------------------------------------------------------

def check_pool_fwd(dev, batch: int) -> None:
    """K1 (default and generic builds) bit-equal to the plain version at
    every site at a main-path batch that time_pool does not take (the
    fused key pass pools 2B clips)."""
    import torch
    from rspnet_tpu_torch.ops import max_pool3d as mp

    gen = torch.Generator(device=dev).manual_seed(6)
    for name, shape4, k, s, p in POOL_SITES:
        x = torch.relu(torch.randn((batch, *shape4), generator=gen,
                                   device=dev))
        ref = mp.max_pool3d_fwd_plain(x, k, s, p)
        eq = torch.equal(mp.max_pool3d_fwd(x, k, s, p), ref)
        eq_gen = torch.equal(mp.max_pool3d_fwd(x, k, s, p, build=GENERIC),
                             ref)
        print(f"check K1 {name:20s} [{batch},{','.join(map(str, shape4))}] "
              f"bit-equal to plain: K1 {eq} K1 generic {eq_gen}", flush=True)
        require(eq and eq_gen, f"K1 {name} at batch {batch}: differs from "
                               f"the plain version (K1 {eq}, generic {eq_gen})")
        del x, ref
    torch.cuda.empty_cache()


def time_pool(dev, batch: int) -> dict:
    """K1/K2 at every site at the main path's shapes: timed beside the
    bound, the plain version, the library and the generic instances,
    and held bit-equal to the plain version on the same inputs."""
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.ops import max_pool3d as mp

    tot = {k: 0.0 for k in ("fwd", "fwd_again", "fwd_generic", "fwd_plain",
                            "fwd_lib", "fwd_bound", "bwd", "bwd_again",
                            "bwd_generic", "bwd_plain", "bwd_lib",
                            "bwd_bound")}
    by = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    generic = GENERIC
    for name, shape4, k, s, p in POOL_SITES:
        x = torch.relu(torch.randn((batch, *shape4), generator=gen,
                                   device=dev))
        out = mp.max_pool3d_fwd(x, k, s, p)
        g = torch.randn(out.shape, generator=gen, device=dev)
        fref = mp.max_pool3d_fwd_plain(x, k, s, p)
        fwd_eq = torch.equal(out, fref)
        fgen_eq = torch.equal(mp.max_pool3d_fwd(x, k, s, p, build=generic),
                              fref)
        del fref
        dref = mp.max_pool3d_bwd_plain(x, g, k, s, p)
        bwd_eq = torch.equal(mp.max_pool3d_bwd(x, g, k, s, p), dref)
        gen_eq = torch.equal(mp.max_pool3d_bwd(x, g, k, s, p, build=generic),
                             dref)
        del dref
        xn = x.permute(0, 4, 1, 2, 3)          # NCDHW view, channels-last
        _, idx = F.max_pool3d(xn, k, s, p, return_indices=True)
        gn = g.permute(0, 4, 1, 2, 3)
        # the compile-time instance, the generic one, the first again
        f = time_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
        fg = time_ms(lambda: mp.max_pool3d_fwd(x, k, s, p, build=generic))
        f2 = time_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
        fp = time_ms(lambda: mp.max_pool3d_fwd_plain(x, k, s, p), 2, 1)
        fl = time_ms(lambda: F.max_pool3d(xn, k, s, p))
        # the compile-time instance, the generic one, the first again
        b = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p))
        bg = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p, build=generic))
        b2 = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p))
        bp = time_ms(lambda: mp.max_pool3d_bwd_plain(x, g, k, s, p), 2, 1)
        bl = time_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            gn, xn, list(k), list(s), list(p), [1, 1, 1], False, idx))
        window = k[0] * k[1] * k[2]
        fb, fby = bound((x.numel() + out.numel()) * 4, out.numel() * window)
        bb, bby = bound((2 * x.numel() + g.numel()) * 4,
                        x.numel() * 4 * (k[0] + k[1] + k[2]))
        by["fwd"], by["bwd"] = fby, bby
        for key, v in (("fwd", f), ("fwd_again", f2), ("fwd_generic", fg),
                       ("fwd_plain", fp), ("fwd_lib", fl),
                       ("fwd_bound", fb), ("bwd", b), ("bwd_again", b2),
                       ("bwd_generic", bg), ("bwd_plain", bp),
                       ("bwd_lib", bl), ("bwd_bound", bb)):
            tot[key] += v
        print(f"time {name:20s} [{batch},{','.join(map(str, shape4))}] "
              f"K1 {f:.4f} ms (again {f2:.4f}, generic instance {fg:.4f}, "
              f"bound {fb:.4f}, plain {fp:.3f}, F.max_pool3d {fl:.4f}) | "
              f"K2 {b:.4f} ms (again {b2:.4f}, generic instance {bg:.4f}, "
              f"bound {bb:.4f}, plain {bp:.3f}, aten bwd {bl:.4f}) | "
              f"bit-equal to plain: K1 {fwd_eq} K1 generic {fgen_eq} K2 "
              f"{bwd_eq} K2 generic {gen_eq}",
              flush=True)
        require(fwd_eq and fgen_eq and bwd_eq and gen_eq,
                f"{name} at batch {batch}: a kernel differs from its plain "
                f"version (K1 {fwd_eq}, K1 generic {fgen_eq}, K2 {bwd_eq}, "
                f"K2 generic {gen_eq})")
        del x, out, g, idx
    print(f"time K1 over the {len(POOL_SITES)} sites: {tot['fwd']:.4f} ms, "
          f"again {tot['fwd_again']:.4f}, generic instance "
          f"{tot['fwd_generic']:.4f}, F.max_pool3d {tot['fwd_lib']:.4f}, "
          f"bound {tot['fwd_bound']:.4f}", flush=True)
    print(f"time K2 over the {len(POOL_SITES)} sites: {tot['bwd']:.4f} ms, "
          f"again {tot['bwd_again']:.4f}, generic instance "
          f"{tot['bwd_generic']:.4f}, aten bwd {tot['bwd_lib']:.4f}, bound "
          f"{tot['bwd_bound']:.4f}", flush=True)
    tot["by"] = by
    return tot


def ptxas_lines(log: str, entry: str):
    """ptxas's register and spill lines of the entry functions whose
    mangled names hold ``entry``."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and entry in name and ("registers" in line
                                         or "spill" in line):
            out.append(f"{name[-40:]}: {line.strip()}")
    return out


def time_color(dev, batch: int, frames: int, size: int) -> dict:
    """K3's resident instance, its generic instance (the
    color_augment_generic build) and the plain version at the main path's
    shapes, f32 and u8 input, beside the bound."""
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import _build
    from rspnet_tpu_torch.ops import color_augment as ca

    for line in ptxas_lines(_build.build_logs.get("color_augment", ""),
                            "augment_resident"):
        print(f"ptxas K3 resident {line}", flush=True)

    rng = np.random.default_rng(3)
    order = np.stack([rng.permutation(4) for _ in range(batch)]).astype(
        np.int32)
    factors = _color_args(rng, batch)
    gray = rng.random(batch) < 0.2
    flip = np.zeros(batch, bool)
    x = torch.rand((batch, frames, size, size, 3), device=dev)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
              gray_before_jitter=True)
    res = {}
    for name, xin in (("f32", x), ("u8", (x * 255).to(torch.uint8))):
        def run(build):
            return ca.color_augment(xin, order, factors, gray, flip,
                                    build=build, **kw)
        t = time_ms(lambda: run("color_augment"), 20, 3)
        tg = time_ms(lambda: run("color_augment_generic"), 20, 3)
        t2 = time_ms(lambda: run("color_augment"), 20, 3)
        tp = time_ms(lambda: ca.color_augment_plain(xin, order, factors,
                                                    gray, flip, **kw), 1, 1)
        # the function's operations: the chain once per pixel (the hue
        # round trip ~45, the blends ~8 each, luma 5, the normalize 6)
        ops = x.numel() / 3 * (45 + 3 * 8 + 5 + 6)
        b, by = bound(xin.numel() * xin.element_size() + x.numel() * 4, ops)
        print(f"time K3 [{batch},{frames},{size},{size},3] {name} in: "
              f"{t:.4f} ms (again {t2:.4f}, generic instance {tg:.4f}, "
              f"bound {b:.4f} by {by}, plain {tp:.2f}); "
              f"{color_plan_line(tuple(xin.shape), name == 'u8')}",
              flush=True)
        res[name] = {"ms": t, "again_ms": t2, "generic_ms": tg,
                     "plain_ms": tp, "bound_ms": b, "bound_by": by}
        del xin
    del x
    torch.cuda.empty_cache()
    f = res["f32"]
    return {"ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"]}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(batch: int, profile: bool = False) -> dict:
    import torch
    from rspnet_tpu_torch import pretrain
    from rspnet_tpu_torch.ops import color_augment as ca
    from rspnet_tpu_torch.ops import max_pool3d as mp

    counters = (mp.launches, mp.plain_cuda_calls, ca.launches,
                ca.plain_cuda_calls)
    with tempfile.TemporaryDirectory() as exp:
        ext = '{dataset+: {name: "synthetic"}, device_geometry: true}'
        argv = ["-c", "config/pretrain/s3dg.jsonnet", "-e", exp, "-x", ext,
                "-d", "--seed", "0", "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            for key in c:
                c[key] = 0
        t0 = time.perf_counter()
        if profile:
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts,
                                        record_shapes=True) as prof:
                engine = pretrain.main(argv)
                torch.cuda.synchronize()
        else:
            engine = pretrain.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**mp.launches, **ca.launches}
        plain = {**mp.plain_cuda_calls, **ca.plain_cuda_calls}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss = engine.meters["loss"].avg
        ckpt = os.path.exists(os.path.join(exp, "checkpoint.pth.tar"))
    steps = engine.step_times
    print(f"main path: batch {batch}, {len(steps)} steps, step ms "
          f"{[round(t, 1) for t in steps]}, wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GiB, loss {loss:.4f}, launches {counts}, plain calls "
          f"on cuda {plain}, checkpoint {ckpt}", flush=True)
    require(math.isfinite(loss), f"main path loss {loss} is not finite")
    require(len(steps) == 3, f"main path ran {len(steps)} steps, not 3")
    require(all(v > 0 for v in counts.values()),
            f"a kernel of the main path was not launched: {counts}")
    require(not any(plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    require(ckpt, "checkpoint.pth.tar was not written")
    if profile:
        report_profile(prof, wall)
    return {"launches": counts, "steps_ms": steps, "peak_gib": peak}


_KERNEL_GROUPS = [
    # pool_fwd also matches K1's tiled instances, pool_fwd_tile<...>
    ("K1/K2 max pool", ("pool_fwd", "pool_route", "pool_gather")),
    ("K3 colour augment", ("augment_resident", "luma_partials",
                           "apply_chain")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                     "fprop", "nchw", "nhwc")),
    ("gemm", ("gemm", "gemv", "cutlass")),
    ("copy / layout", ("copy", "cat", "transpose", "index", "gather")),
]


def report_profile(prof, wall_s: float) -> None:
    """Device time of the main-path run by kernel group and the top
    kernels (all 3 steps, the first one's warm-up included)."""
    def dev_us(evt):
        # the attribute was renamed from *_cuda_* in recent torch releases
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type) and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        low = e.key.lower()
        name = next((g for g, keys in _KERNEL_GROUPS
                     if any(k in low for k in keys)), "other")
        groups[name] = groups.get(name, 0.0) + dev_us(e) / 1e3
    print(f"profile: device kernel time {total:.1f} ms over a {wall_s:.1f} s"
          f" run (busy share {total / 1e3 / wall_s:.3f})", flush=True)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile group {name:20s} {ms:10.1f} ms  "
              f"{ms / max(total, 1e-9):.3f}", flush=True)
    # K1 is one launch a call (pool_fwd_tile, or pool_fwd off S3D-G's
    # geometries); K2 two: pool_route and pool_gather
    for e in kernels:
        if any(k in e.key for k in _KERNEL_GROUPS[0][1]):
            print(f"profile pool kernel {dev_us(e) / 1e3:9.1f} ms "
                  f"x{e.count:<5d} {e.key[:110]}", flush=True)
    top = sorted(kernels, key=lambda e: -dev_us(e))[:12]
    for e in top:
        print(f"profile kernel {dev_us(e) / 1e3:9.1f} ms x{e.count:<5d} "
              f"{e.key[:110]}", flush=True)
    # which layers the convolution time belongs to: the costliest conv ops
    # by input shapes (device time of the op and the kernels it launched)
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::convolution_backward",
                          "aten::cudnn_convolution")]
    total_us = lambda e: float(getattr(  # noqa: E731
        e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))
    for e in sorted(convs, key=lambda e: -total_us(e))[:8]:
        print(f"profile conv {total_us(e) / 1e3:9.1f} ms x{e.count:<4d} "
              f"{e.key} {str(e.input_shapes)[:150]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler and print "
                         "its device time by kernel group")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from rspnet_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)                            # phase 0

    t0 = time.perf_counter()                                      # phase 1
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                        "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err_fwd, err_bwd = check_pool(dev, batch=4)                   # phase 2
    check_pool_nan(dev, batch=4)
    check_pool_wide(dev)
    err_color = max(
        check_color(dev, 8, COLOR_CLIP),
        check_color(dev, MAIN_BATCH, COLOR_CLIP),
        *(check_color(dev, b, clip) for b, clip in RAGGED_COLOR),
        check_color(dev, *LARGE_COLOR, resident=False),
        check_color(dev, 8, COLOR_CLIP, resident=False,
                    build="color_augment_generic"))
    check_color_repeat(dev, MAIN_BATCH, COLOR_CLIP)

    check_pool_fwd(dev, batch=2 * MAIN_BATCH)                     # phase 3
    pool = time_pool(dev, batch=MAIN_BATCH)
    color = time_color(dev, batch=MAIN_BATCH, frames=32, size=224)
    torch.cuda.empty_cache()
    from rspnet_tpu_torch.ops import k3_timeline
    k3_timeline.main(["--batch", str(MAIN_BATCH)])
    torch.cuda.empty_cache()

    launches = main_path(MAIN_BATCH, args.profile)["launches"]    # phase 4

    kernels = [
        {"name": "max_pool3d_fwd", "route": "cuda",
         "source": "rspnet_tpu_torch/csrc/max_pool3d.cu",
         "replaces": "rspnet_tpu/ops/pallas_pool.py:152",
         "launches": launches["max_pool3d_fwd"], "max_abs_err": err_fwd,
         "ms": pool["fwd"], "plain_ms": pool["fwd_plain"],
         "bound_ms": pool["fwd_bound"], "bound_by": pool["by"]["fwd"],
         "library_ms": pool["fwd_lib"]},
        {"name": "max_pool3d_bwd", "route": "cuda",
         "source": "rspnet_tpu_torch/csrc/max_pool3d.cu",
         "replaces": "rspnet_tpu/ops/pallas_pool.py:159",
         "launches": launches["max_pool3d_bwd"], "max_abs_err": err_bwd,
         "ms": pool["bwd"], "plain_ms": pool["bwd_plain"],
         "bound_ms": pool["bwd_bound"], "bound_by": pool["by"]["bwd"],
         "library_ms": pool["bwd_lib"]},
        {"name": "color_augment", "route": "cuda",
         "source": "rspnet_tpu_torch/csrc/color_augment.cu",
         "replaces": "rspnet_tpu/ops/pallas_augment.py:51",
         "launches": launches["color_augment"], "max_abs_err": err_color,
         "ms": color["ms"], "plain_ms": color["plain_ms"],
         "bound_ms": color["bound_ms"], "bound_by": color["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
