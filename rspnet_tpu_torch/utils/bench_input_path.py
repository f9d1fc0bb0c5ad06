"""Host input-path micro-bench: decode-time scaling against the per-frame
OpenCV loop (port of rspnet_tpu/utils/bench_input_path.py).

Builds a small set of MJPG videos of mixed sizes (the geometry of the
reference's transcode recipe: height 256, variable widths,
utils/transcode_dataset.py scale=w=-2:h=256) and times ``_load_one`` per
sample for:
  1. host geometry: crop and a per-frame ``cv2.resize`` on the host;
  2. ``device_geometry`` with ``decode_size``: the native decoder's
     ``sws_scale`` resizes during decode, and the geometry runs on the
     card.

Both variants decode with whatever ``open_video`` picks (the native
decoder when it builds, else OpenCV). Writing the videos and the host
geometry need OpenCV. Run it alone (a concurrent test run skews the
numbers):

    python -m rspnet_tpu_torch.utils.bench_input_path [--iters N]

Prints one JSON line: ms per sample of each variant (the least of 3
interleaved repetitions, the least contended estimate), the bytes each
ships to the card per sample, and the decoder that ran.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


class _Sample:
    def __init__(self, p):
        self.video_path = p
        self.class_index = 0


def make_videos(d, sizes, frames=80):
    """MJPG videos of a moving gradient, one per (w, h) of ``sizes``."""
    import cv2
    paths = []
    for k, (w, h) in enumerate(sizes):
        p = os.path.join(d, f"v{k}.avi")
        wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([yy * 255 / h, xx * 255 / w,
                         (xx + yy) * 127 / (h + w)], -1).astype(np.uint8)
        for t in range(frames):
            wr.write(np.roll(base, t * 3, axis=1))
        wr.release()
        paths.append(p)
    return paths


def main(argv=None) -> dict:
    from ..data.pipeline import PipelineConfig, _load_one
    from ..moco.step import packed_frame_subset
    from ..native import video_decode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=32,
                    help="samples timed per repetition and variant")
    args = ap.parse_args(argv)

    d = tempfile.mkdtemp(prefix="rspnet_inpbench_")
    try:
        sizes = [(342, 256), (454, 256), (320, 256), (342, 256)]
        catalog = [_Sample(p) for p in make_videos(d, sizes)]
        common = dict(clip_len=32, frame_subset=packed_frame_subset(32, (2,)),
                      num_clips=2, out_size=112, batch_size=1, train=True,
                      num_workers=0, seed=0)
        variants = {
            "host_geometry_ms_per_sample": PipelineConfig(**common),
            "devgeom_decode_size_ms_per_sample": PipelineConfig(
                **common, device_geometry=True, decode_size=(128, 171)),
        }
        reps = {name: [] for name in variants}
        for cfg in variants.values():
            _load_one(catalog, cfg, 0, np.random.default_rng(0))  # warm
        for _ in range(3):
            for name, cfg in variants.items():
                rng = np.random.default_rng(0)
                t0 = time.perf_counter()
                for i in range(args.iters):
                    _load_one(catalog, cfg, i % len(catalog), rng)
                reps[name].append(
                    (time.perf_counter() - t0) / args.iters * 1e3)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    frames = len(common["frame_subset"])
    result = {name: min(ts) for name, ts in reps.items()}
    # bytes shipped to the card per sample (both clips)
    result["host_geometry_bytes_per_sample"] = 2 * frames * 112 * 112 * 3
    result["devgeom_decode_size_bytes_per_sample"] = (
        2 * frames * 128 * 171 * 3)
    result["decoder"] = ("native" if video_decode.is_available()
                         else "opencv")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
