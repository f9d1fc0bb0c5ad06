#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines:
  0. the card: name and power limit (nvidia-smi);
  1. build every CUDA kernel of rspnet_tpu_torch/csrc (one nvcc per source,
     all at once), with the build time;
  2. each kernel against its plain-torch version on the card:
     K1/K2 (max pool fwd/bwd) at the 13 S3D-G pool sites (batch cut to 4),
     f32 and bf16, with and without ties; K3 (colour augment) over all 24
     op orders x gray on/off x flip on/off x gray before/after, uint8 and
     f32 input, at [8, 32, 224, 224, 3];
  3. timing with CUDA events at the main path's shapes, beside the bound,
     the plain version and, for the pool, F.max_pool3d;
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
K3_TOL = 1e-4
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
    for name, shape4, k, s, p in POOL_SITES:
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
                if dtype == torch.float32:
                    require(torch.equal(dx, dref),
                            f"K2 {name} f32 ties={ties}: not bit-equal "
                            f"(max err {err})")
                    require(abs(dsum - gsum) <= 1e-5 * scale,
                            f"K2 {name} f32: gradient sum {dsum} != {gsum}")
                    worst = max(worst, err)
                else:
                    require(err <= 1e-2 * float(g.float().abs().max()),
                            f"K2 {name} bf16 ties={ties}: max err {err}")
                    require(abs(dsum - gsum) <= 1e-2 * scale,
                            f"K2 {name} bf16: gradient sum {dsum} != {gsum}")
                print(f"check K1/K2 {name:20s} {str(dtype):15s} ties={ties!s:5}"
                      f" fwd=bit-equal bwd_max_abs_err={err:.3g} "
                      f"bwd_bit_equal={torch.equal(dx, dref)}", flush=True)
    return worst_fwd, worst


def check_color(dev, batch: int, frames: int, size: int) -> float:
    """K3 vs plain over every order x gray x flip x gray-before, u8 and f32
    input; returns the largest abs error on the normalized output."""
    import itertools

    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    combos = [(o, gr, fl) for o in itertools.permutations(range(4))
              for gr in (False, True) for fl in (False, True)]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for gray_first in (True, False):
        for in_u8 in (True, False):
            err_case = 0.0
            for lo in range(0, len(combos), batch):
                part = combos[lo:lo + batch]
                n = len(part)
                order = np.asarray([c[0] for c in part], np.int32)
                gray = np.asarray([c[1] for c in part])
                flip = np.asarray([c[2] for c in part])
                factors = np.stack([rng.uniform(0.6, 1.4, n),
                                    rng.uniform(0.6, 1.4, n),
                                    rng.uniform(0.6, 1.4, n),
                                    rng.uniform(-0.4, 0.4, n)],
                                   1).astype(np.float32)
                shape = (n, frames, size, size, 3)
                if in_u8:
                    x = torch.randint(0, 256, shape, generator=gen,
                                      device=dev, dtype=torch.uint8)
                else:
                    x = torch.rand(shape, generator=gen, device=dev)
                kw = dict(mean=(0.485, 0.456, 0.406),
                          std=(0.229, 0.224, 0.225),
                          gray_before_jitter=gray_first)
                out = ca.color_augment(x, order, factors, gray, flip, **kw)
                ref = ca.color_augment_plain(x, order, factors, gray, flip,
                                             **kw)
                err_case = max(err_case, float((out - ref).abs().max()))
            print(f"check K3 gray_before={gray_first!s:5} "
                  f"input={'u8' if in_u8 else 'f32'} max_abs_err="
                  f"{err_case:.3g} (limit {K3_TOL})", flush=True)
            require(err_case <= K3_TOL, f"K3 error {err_case} > {K3_TOL}")
            worst = max(worst, err_case)
    return worst


# ---------------------------------------------------------------------------
# phase 3: timing at the main path's shapes
# ---------------------------------------------------------------------------

def time_pool(dev, batch: int) -> dict:
    import torch
    import torch.nn.functional as F
    from rspnet_tpu_torch.ops import max_pool3d as mp

    tot = {k: 0.0 for k in ("fwd", "fwd_plain", "fwd_lib", "fwd_bound",
                            "bwd", "bwd_plain", "bwd_lib", "bwd_bound")}
    by = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, shape4, k, s, p in POOL_SITES:
        x = torch.relu(torch.randn((batch, *shape4), generator=gen,
                                   device=dev))
        out = mp.max_pool3d_fwd(x, k, s, p)
        g = torch.randn(out.shape, generator=gen, device=dev)
        xn = x.permute(0, 4, 1, 2, 3)          # NCDHW view, channels-last
        _, idx = F.max_pool3d(xn, k, s, p, return_indices=True)
        gn = g.permute(0, 4, 1, 2, 3)
        f = time_ms(lambda: mp.max_pool3d_fwd(x, k, s, p))
        fp = time_ms(lambda: mp.max_pool3d_fwd_plain(x, k, s, p), 2, 1)
        fl = time_ms(lambda: F.max_pool3d(xn, k, s, p))
        b = time_ms(lambda: mp.max_pool3d_bwd(x, g, k, s, p))
        bp = time_ms(lambda: mp.max_pool3d_bwd_plain(x, g, k, s, p), 2, 1)
        bl = time_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            gn, xn, list(k), list(s), list(p), [1, 1, 1], False, idx))
        window = k[0] * k[1] * k[2]
        fb, fby = bound((x.numel() + out.numel()) * 4, out.numel() * window)
        bb, bby = bound((2 * x.numel() + g.numel()) * 4,
                        x.numel() * 4 * (k[0] + k[1] + k[2]))
        by["fwd"], by["bwd"] = fby, bby
        for key, v in (("fwd", f), ("fwd_plain", fp), ("fwd_lib", fl),
                       ("fwd_bound", fb), ("bwd", b), ("bwd_plain", bp),
                       ("bwd_lib", bl), ("bwd_bound", bb)):
            tot[key] += v
        print(f"time {name:20s} [{batch},{','.join(map(str, shape4))}] "
              f"K1 {f:.4f} ms (bound {fb:.4f}, plain {fp:.3f}, "
              f"F.max_pool3d {fl:.4f}) | K2 {b:.4f} ms (bound {bb:.4f}, "
              f"plain {bp:.3f}, aten bwd {bl:.4f})", flush=True)
        del x, out, g, idx
    tot["by"] = by
    return tot


def time_color(dev, batch: int, frames: int, size: int) -> dict:
    import numpy as np
    import torch
    from rspnet_tpu_torch.ops import color_augment as ca

    rng = np.random.default_rng(3)
    order = np.stack([rng.permutation(4) for _ in range(batch)]).astype(
        np.int32)
    factors = np.stack([rng.uniform(0.6, 1.4, batch),
                        rng.uniform(0.6, 1.4, batch),
                        rng.uniform(0.6, 1.4, batch),
                        rng.uniform(-0.4, 0.4, batch)], 1).astype(np.float32)
    gray = rng.random(batch) < 0.2
    flip = np.zeros(batch, bool)
    x = torch.rand((batch, frames, size, size, 3), device=dev)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
              gray_before_jitter=True)
    t = time_ms(lambda: ca.color_augment(x, order, factors, gray, flip, **kw))
    tp = time_ms(lambda: ca.color_augment_plain(x, order, factors, gray, flip,
                                                **kw), 1, 1)
    npix = batch * frames * size * size
    # f32 operations per pixel: the chain once up to contrast (pass 1, on
    # average half of it) and once whole (pass 2), with the hue round trip
    # ~45, the blends ~8 each, luma 5 and the normalize 6
    ops = npix * 1.5 * (45 + 3 * 8 + 5 + 6)
    b, by = bound(x.numel() * 4 * 2, ops)
    print(f"time K3 [{batch},{frames},{size},{size},3] f32 in: {t:.4f} ms "
          f"(bound {b:.4f} by {by}, plain {tp:.2f})", flush=True)
    xu = (x * 255).to(torch.uint8)
    tu = time_ms(lambda: ca.color_augment(xu, order, factors, gray, flip,
                                          **kw))
    print(f"time K3 [{batch},{frames},{size},{size},3] u8 in: {tu:.4f} ms",
          flush=True)
    return {"ms": t, "plain_ms": tp, "bound_ms": b, "bound_by": by}


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
    ("K1/K2 max pool", ("pool_fwd", "pool_axis_bwd")),
    ("K3 colour augment", ("luma_partials", "apply_chain")),
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
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err_fwd, err_bwd = check_pool(dev, batch=4)                   # phase 2
    err_color = check_color(dev, batch=8, frames=32, size=224)

    pool = time_pool(dev, batch=MAIN_BATCH)                       # phase 3
    color = time_color(dev, batch=MAIN_BATCH, frames=32, size=224)
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
