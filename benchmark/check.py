"""What decides ``correct``: the three steps the program ran before its
window, recomputed by the plain float32 reference from the same seed and
the same batches, and compared number by number against the cell's
limits (``limits/<workload>.json``); a number the limits file does not
name is printed and not compared.

The numbers (each a gap that the program should keep small):

- ``loss``, ``loss1``: the largest relative gap of a step's loss over the
  3 steps, and the first step's;
- ``grad1``, ``grad1_med``: the first step's gradient, leaf by leaf: the
  gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the worst leaf's and the median leaf's. The program's gradient
  is worked out from its optimizer state after one step (SGD's momentum
  buffer, less the weight decay term);
- ``update``, ``update_med``: the same measure of each query-encoder
  leaf's change over the three steps;
- ``ema``, ``ema_med``: the same of each key-encoder leaf's change (the
  EMA);
- ``keys``, ``keys_med``, ``keys1_med``: the distance between a key the
  program enqueued and the reference's (both unit vectors): the largest
  over the 3 x B keys, their median, the first step's median;
- ``frames``, ``frames_med`` (a mix that writes videos): the decoded
  clips against the frames written (``frame_gaps``).

The changes leave out the leaves whose reference gradient is under a
thousandth of the median leaf's: such a leaf moves by weight decay and
rounding alone.
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from .reference import moco

NAMES = ("loss", "loss1", "grad1", "grad1_med", "update", "update_med",
         "ema", "ema_med", "keys", "keys_med", "keys1_med")


def step_config(cfg: dict) -> moco.StepConfig:
    opt = cfg["optimizer"]
    batch = int(cfg["batch_size"])
    return moco.StepConfig(
        arch=cfg["model"]["arch"], size=int(cfg["spatial_transforms"]["size"]),
        dim=int(cfg["moco"]["dim"]), m=float(cfg["moco"]["m"]),
        t=float(cfg["moco"]["t"]), margin=2.0,
        # the linear scaling of the learning rate with the batch (base 64)
        lr=float(opt["lr"]) * batch / 64.0,
        momentum=float(opt["momentum"]),
        weight_decay=float(opt["weight_decay"]),
        mean=cfg["dataset"]["mean"], std=cfg["dataset"]["std"],
        speed=int(max(cfg["moco"]["diff_speed"])))


def leaf_norms(tree: Dict[str, torch.Tensor], keep) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(tree[n].double()))
            for n in keep}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    med = float(np.median(list(ref.values())))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref).values())


def reference_steps(cfg, seed, device, batches, p0, quant=None,
                    tf32=False) -> moco.Result:
    from .run import derive, make_queue
    c = step_config(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "perm"))
    rng = np.random.default_rng(derive(seed, "augment"))
    queue = make_queue(c.dim, int(cfg["moco"]["k"]), seed, device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return moco.run_steps(c, p0, queue,
                              [(b[0], b[1]) for b in batches], rng, gen,
                              device, quant=quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def gaps(prog, ref: moco.Result, p0, worst=None) -> Dict[str, float]:
    """The compared numbers of the program's (or a control's) three steps
    ``prog`` against the reference's ``ref``; ``worst``, a dict, receives
    the three worst leaves of each leaf-wise number."""
    names = list(ref.grad1)
    g_ref = leaf_norms(ref.grad1, names)
    med = float(np.median(list(g_ref.values())))
    moved = [n for n in names if g_ref[n] >= 1e-3 * med]
    p0c = {n: p0[n].detach().to("cpu", torch.float64) for n in names}

    def change(tree):
        return {n: tree[n].to("cpu", torch.float64) - p0c[n] for n in moved}

    pairs = {
        "grad1": (leaf_norms(prog.grad1, names), g_ref),
        "update": (leaf_norms(change(prog.q), moved),
                   leaf_norms(change(ref.q), moved)),
        "ema": (leaf_norms(change(prog.k), moved),
                leaf_norms(change(ref.k), moved)),
    }
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog.losses,
                                                        ref.losses)]
    out = {"loss": max(loss_gaps), "loss1": loss_gaps[0]}
    for key, (a, b) in pairs.items():
        g = leaf_gaps(a, b)
        out[key] = max(g.values())
        out[key + "_med"] = float(np.median(list(g.values())))
        if worst is not None:
            worst[key] = [(n, g[n], a[n], b[n]) for n in
                          sorted(g, key=g.get, reverse=True)[:3]]
    dist = torch.linalg.vector_norm(
        prog.keys.double().cpu() - ref.keys.double().cpu(), dim=1)
    b = len(dist) // len(ref.losses)
    out["keys"] = float(dist.max())
    out["keys_med"] = float(dist.median())
    out["keys1_med"] = float(dist[:b].median())
    if worst is not None:
        worst["losses"] = (list(prog.losses), list(ref.losses))
        worst["leaves_left_out"] = sorted(set(names) - set(moved))
    return out


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the tensor: its largest
    magnitude at the format's largest finite value ``top``."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Float8 training as it is done: values in e4m3, gradients in e5m2,
    each tensor with a scale of its own."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def control_steps(cfg, seed, device, batches, p0, variant="fp8"
                  ) -> moco.Result:
    """The control: the reference in the program's place, computed in
    float8 (``fp8``: every convolution and linear layer on float8 inputs
    and weights, every kept activation and its gradient rounded to
    float8), the precision below the configuration's bf16. ``tf32``: the
    float32 reference with TF32 convolutions and matmuls, a witness of how
    far a number moves under rounding alone."""
    if variant == "tf32":
        return reference_steps(cfg, seed, device, batches, p0, tf32=True)
    return reference_steps(cfg, seed, device, batches, p0, quant=fp8)


def frame_gaps(batches, videos: dict, decode_hw, device) -> Dict[str, float]:
    """The decoded clips the loader served against the frames the
    benchmark wrote, made again and resized to the decode size (bilinear,
    half-pixel centres): for each clip, the mean absolute gap in levels
    (0-255) at the window of the source video that fits it best (the clip
    must be consecutive frames of its labelled video; the window is found
    on 4x4-pooled frames, then measured at full size); ``frames`` is the
    worst clip's, ``frames_med`` the median clip's."""
    import torch.nn.functional as F
    from .traffic import video_frames

    def small(x):                       # [T, H, W, 3] -> [T, 3, H/4, W/4]
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 4)

    made = {}
    gaps_ = []
    for batch in batches:
        labels = batch[2]
        for clips in batch[:2]:
            for r in range(clips.shape[0]):
                i = int(labels[r])
                if i not in made:
                    v = video_frames(i, int(videos["frames"]),
                                     int(videos["height"]),
                                     int(videos["width"]), device)
                    v = F.interpolate(v.permute(0, 3, 1, 2).float(),
                                      size=tuple(decode_hw), mode="bilinear",
                                      align_corners=False)
                    v = v.permute(0, 2, 3, 1).contiguous()
                    made[i] = (v, small(v))
                v, vs = made[i]
                x = clips[r].to(device).float()
                t = x.shape[0]
                xs = small(x).permute(1, 2, 3, 0)          # [3, h, w, t]
                cost = (vs.unfold(0, t, 1) - xs).abs().mean(dim=(1, 2, 3, 4))
                best = cost.topk(min(3, len(cost)), largest=False).indices
                gaps_.append(min(float((v[s:s + t] - x).abs().mean())
                                 for s in best.tolist()))
    return {"frames": max(gaps_), "frames_med": float(np.median(gaps_))}


def compare(spec, cfg, seed, device, batches, prog, p0) -> Dict[str, dict]:
    """-> {name: {"value", "limit"}} for every number the cell's limits
    file names; with no limits file, every number with no limit (None),
    which fails."""
    ref = reference_steps(cfg, seed, device, batches, p0)
    worst = {}
    got = gaps(prog, ref, p0, worst)
    if "videos" in spec.traffic:
        got.update(frame_gaps(batches, spec.traffic["videos"],
                              cfg["decode_size"], device))
    for key, rows in worst.items():
        print(f"detail {key}: {rows}", file=sys.stderr)
    if not spec.limits:
        return {n: {"value": v, "limit": None} for n, v in got.items()}
    return {n: {"value": got[n], "limit": float(spec.limits[n])}
            for n in got if n in spec.limits}
