"""Where the time of K3's resident instance goes, per clip, on the card.

    python -m rspnet_tpu_torch.ops.k3_timeline [--batch 64] [--frames 32]
        [--size 224] [--u8] [--seed 3]

Uses the ``color_augment_timeline`` build (``color_augment.cu`` with
``-DRSP_K3_TIMELINE``: thread 0 of every CTA stamps the global timer at
each phase of each clip, and its SM; chip_smoke.py phase 3 runs this),
times that build beside the default one on the same inputs (the stamps
cost little), and prints per-clip statistics over the CTAs that hold rows:

- period: from the first CTA's release from the grid barrier of clip b to
  that of clip b + 1 (the call takes about B periods);
- loop: pass 2 of clip b with pass 1 of clip b + 1 between its rounds;
- tail: the rest of pass 1 of clip b + 1 and the CTA's arrival;
- pre-wait: pass 1 of clip b + 1 on the chunks already in, before the
  wait for clip b;
- latency: from the last arrival at a barrier to the first release;
- release spread: from the first CTA's release to the last one's.
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np

from . import _build

BUILD = "color_augment_timeline"
CLIPS, CTAS = 64, 272            # kTlClips, kTlCtas of the source


def _stats(v: np.ndarray) -> str:
    return (f"min {v.min():.2f} median {np.median(v):.2f} "
            f"max {v.max():.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--u8", action="store_true", help="uint8 input")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from . import color_augment as ca

    lib = _build.library(BUILD)
    lib.rsp_color_augment_timeline.argtypes = [ctypes.c_void_p]
    lib.rsp_color_augment_timeline.restype = ctypes.c_int

    B, T, S = args.batch, args.frames, args.size
    rng = np.random.default_rng(args.seed)
    order = np.stack([rng.permutation(4) for _ in range(B)]).astype(np.int32)
    factors = np.stack([rng.uniform(0.6, 1.4, B), rng.uniform(0.6, 1.4, B),
                        rng.uniform(0.6, 1.4, B), rng.uniform(-0.4, 0.4, B)],
                       1).astype(np.float32)
    gray, flip = rng.random(B) < 0.2, rng.random(B) < 0.5
    x = torch.rand((B, T, S, S, 3), device="cuda")
    if args.u8:
        x = (x * 255).to(torch.uint8)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))

    def run(build):
        return ca.color_augment(x, order, factors, gray, flip, build=build,
                                **kw)

    plan = ca.launch_plan(tuple(x.shape), args.u8, build=BUILD)
    if not plan["resident"]:
        raise SystemExit(f"{list(x.shape)} takes the generic instance")
    times = {}
    for build in ("color_augment", BUILD, "color_augment", BUILD):
        for _ in range(3):
            run(build)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            run(build)
        end.record()
        torch.cuda.synchronize()
        times.setdefault(build, []).append(start.elapsed_time(end) / 20)
    run(BUILD)
    torch.cuda.synchronize()
    buf = np.zeros(CLIPS * 6 * CTAS, np.uint64)
    _build.check(lib.rsp_color_augment_timeline(buf.ctypes.data),
                 "rsp_color_augment_timeline")
    ncta = plan["ctas"]
    busy = np.arange(ncta) * plan["rows_per_cta"] < T * S
    tl = buf.reshape(CLIPS, 6, CTAS)[:, :, :ncta][:, :, busy].astype(
        np.float64)
    n = min(B, CLIPS) - 1            # clips with a next barrier stamped
    us = lambda a: a / 1e3           # noqa: E731  (stamps are in ns)
    start, before, after, pass2, arrived = (tl[:n, e] for e in range(5))
    release = after.min(1)
    period = us(np.diff(tl[:n + 1, 2].min(1)))
    print(f"K3 resident [{B},{T},{S},{S},3] {'u8' if args.u8 else 'f32'}: "
          f"default build {min(times['color_augment']):.4f} ms, timeline "
          f"build {min(times[BUILD]):.4f} ms; {ncta} CTAs, {busy.sum()} "
          f"with rows, on {len(set(tl[0, 5].astype(int)))} SMs")
    rows = (("period", period),
            ("loop (median CTA)", us(np.median(pass2 - after, 1))),
            ("loop (slowest CTA)", us((pass2 - after).max(1))),
            ("tail (median CTA)", us(np.median(arrived - pass2, 1))),
            ("pre-wait (median CTA)", us(np.median(before - start, 1))),
            ("latency", us(tl[1:n + 1, 2].min(1) - arrived.max(1))),
            ("release spread", us(after.max(1) - release)))
    for name, v in rows:
        print(f"  {name:22s} us per clip over clips 0..{n - 1}: "
              f"mean {v.mean():.2f}, {_stats(v)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
