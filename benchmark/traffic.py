"""The one generator that turns a traffic mix (``traffic/<name>.json``) into
the data a cell trains on and the configuration keys that point the
program's loader at it.

A mix file holds:

- ``config``: keys merged over the configuration (the loader's mode, the
  catalog, the decode size, the device cache, the workers);
- optionally ``videos``: a set of video files to write once a checkout and
  list in a UCF101-layout catalog (``classInd.txt``, ``trainlist01.txt``):
  ``count`` files of ``frames`` frames at ``height`` x ``width`` and
  ``fps``, in the ``fourcc`` codec at JPEG ``quality``, the catalog
  repeated to ``list_lines`` lines. Video i is class i, so a served clip's
  label names its file.

The files go to ``benchmark/data/<mix>/`` inside the checkout (ignored by
git) and are reused by later runs; a marker file written last says they
are complete. Their content is fixed (it does not depend on a run's
seed): the seed draws the windows, the order, the augment and the
weights.
"""
from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

DATA_DIR = Path(__file__).resolve().parent / "data"
CONTENT_SEED = 20240531


def merge(base: dict, over: dict) -> dict:
    """Deep merge of plain dicts: ``over``'s keys win, nested dicts merge."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def video_frames(index: int, frames: int, height: int, width: int,
                 device="cpu") -> "torch.Tensor":
    """Video ``index`` as uint8 RGB [frames, height, width, 3] on
    ``device``: a slowly drifting colour gradient and three soft discs
    moving on straight paths, bouncing off the borders. Smooth, so that a
    JPEG frame stays small, and moving, so that consecutive frames
    differ. The writer and the check make it on the same device."""
    import torch
    rng = np.random.default_rng((CONTENT_SEED, index))
    base = rng.uniform(40, 200, 3)
    tilt = rng.uniform(-60, 60, (2, 3))
    drift = rng.uniform(-0.5, 0.5, 3)
    pos = rng.uniform(0.2, 0.8, (3, 2)) * (height, width)
    vel = rng.uniform(-8.0, 8.0, (3, 2))
    radius = rng.uniform(12, 40, 3)
    colour = rng.uniform(0, 255, (3, 3))

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    yy = torch.arange(height, device=device, dtype=torch.float32)
    xx = torch.arange(width, device=device, dtype=torch.float32)
    ts = torch.arange(frames, device=device, dtype=torch.float32)
    img = (t32(base) + ts[:, None, None, None] * t32(drift)
           + (yy / height)[None, :, None, None] * t32(tilt[0])
           + (xx / width)[None, None, :, None] * t32(tilt[1]))
    span = t32([height, width])
    for d in range(3):
        p = t32(pos[d]) + ts[:, None] * t32(vel[d])
        p = torch.abs(torch.remainder(p, 2 * span) - span)       # bounce
        r2 = ((yy[None, :, None] - p[:, 0, None, None]) ** 2
              + (xx[None, None, :] - p[:, 1, None, None]) ** 2)
        a = torch.exp(-r2 / float(2 * radius[d] ** 2))[..., None]
        img = img * (1 - a) + t32(colour[d]) * a
    return img.clamp(0, 255).to(torch.uint8)


def _write_videos(root: Path, spec: dict, device) -> None:
    import cv2
    videos = root / "videos"
    videos.mkdir(parents=True, exist_ok=True)
    n = int(spec["count"])
    names = [f"C{i:03d}" for i in range(n)]
    for i, name in enumerate(names):
        (videos / name).mkdir(exist_ok=True)
        path = videos / name / f"v_{name}_g01_c01.avi"
        tmp = path.with_name(path.name + ".part.avi")
        writer = cv2.VideoWriter(
            str(tmp), cv2.VideoWriter_fourcc(*spec["fourcc"]),
            float(spec["fps"]), (int(spec["width"]), int(spec["height"])))
        if not writer.isOpened():
            raise RuntimeError(f"OpenCV cannot write {spec['fourcc']} video")
        writer.set(cv2.VIDEOWRITER_PROP_QUALITY, float(spec["quality"]))
        clip = video_frames(i, int(spec["frames"]), int(spec["height"]),
                            int(spec["width"]), device).cpu().numpy()
        for frame in clip:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))   # BGR
        writer.release()
        os.replace(tmp, path)
    ann = root / "annotations"
    ann.mkdir(exist_ok=True)
    (ann / "classInd.txt").write_text(
        "".join(f"{i + 1} {name}\n" for i, name in enumerate(names)))
    lines = int(spec["list_lines"])
    (ann / "trainlist01.txt").write_text("".join(
        f"{names[j % n]}/v_{names[j % n]}_g01_c01.avi {j % n + 1}\n"
        for j in range(lines)))


def prepare(name: str, mix: dict, device="cpu") -> Dict:
    """-> the configuration keys of mix ``name``, its data written first
    (frames made on ``device``) where it has any."""
    over = copy.deepcopy(mix.get("config", {}))
    spec = mix.get("videos")
    if spec is not None:
        root = DATA_DIR / name
        marker = root / "complete.json"
        want = json.dumps(spec, sort_keys=True)
        if not marker.exists() or marker.read_text() != want:
            _write_videos(root, spec, device)
            marker.write_text(want)
        over = merge(over, {"dataset": {
            "name": "ucf101", "root": str(root / "videos"),
            "annotation_path": str(root / "annotations"), "fold": 1}})
    return over
