"""The benchmark of ``rspnet_tpu_torch``: MoCo + RSP pretraining on one card.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``);
its correctness limits are ``limits/<workload>.json`` and each per-layer
metric is read by ``metrics/<metric>.py``. The run:

1. builds the engine through the program's public entry (``bootstrap`` and
   ``PretrainEngine``, as ``rspnet_tpu_torch/pretrain.py`` does) from the
   configuration with the mix's keys, and hands it weights, a queue and
   draw streams made from ``--seed``;
2. drives three steps through ``PretrainEngine.train_epoch`` over the
   engine's own loader, keeping their input batches and the state after
   the first and the third step: they are also the warm-up;
3. times a window of ``--seconds`` seconds of ``train_epoch`` calls, epoch
   after epoch, over the same loader cut at the deadline (``Feed``); with
   ``--trace 1`` under ``torch.profiler``;
4. frees the program, recomputes the three steps with the plain float32
   reference (``reference/``) from the same seed and batches, and compares
   (``check.py``);
5. prints the comparison's lines last on standard error and one JSON line
   last on standard output.

It exits non-zero with no result when no card is found, when a module of
JAX or of the JAX package is loaded, or when the program cannot be
imported.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "rspnet_tpu"}
# the prefix of the benchmark's own spans in the trace
SPAN = "rspbench."


def derive(seed: int, tag: str) -> int:
    """A 63-bit stream seed of its own for each use of ``seed``."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its
    configuration, mix, limits and metric readers, each found by name
    under ``root``/benchmark."""
    bench = _read(root / "BENCHMARK.json")
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[cell["config"]]["file"])
    traffic = _read(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = _read(limits_path) if limits_path.exists() else {}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return SimpleNamespace(name=workload, cell=cell, config=config,
                           metrics_dir=bench_dir / "metrics",
                           traffic=traffic, limits=limits,
                           per_layer=per_layer, end_to_end=end_to_end)


class Feed:
    """The engine's loader, handed out in pieces: ``take(n)`` makes the
    next iteration yield n batches, ``until(deadline)`` yields until the
    host clock passes the deadline (at least one batch an iteration, so
    that ``train_epoch`` never sees an empty epoch). One iterator of the
    wrapped loader serves an epoch across ``train_epoch`` calls, so the
    batches never repeat within it. ``capture`` keeps a host copy of each
    batch's two clips and labels while it is set."""

    def __init__(self, inner):
        self.inner = inner
        self.cfg = inner.cfg
        self.epoch = None
        self._it = None
        self._limit = None
        self._deadline = None
        self.capture: Optional[list] = None
        # batches of the current epoch not handed out yet
        self.remaining = len(inner)

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        if epoch != self.epoch:
            self.close()
            self.epoch = epoch
            self.remaining = len(self.inner)

    def take(self, n: int) -> None:
        self._limit, self._deadline = n, None

    def until(self, deadline: float) -> None:
        self._limit, self._deadline = None, deadline

    def close(self) -> None:
        if self._it is not None:
            close = getattr(self._it, "close", None)
            if close is not None:
                close()
            self._it = None

    def __iter__(self):
        import torch
        given = 0
        while True:
            if self.remaining == 0 or (self._limit is not None
                                       and given >= self._limit):
                return
            if (self._deadline is not None and given
                    and time.perf_counter() >= self._deadline):
                return
            if self._it is None:
                self.inner.set_epoch(self.epoch)
                self._it = iter(self.inner)
            with torch.profiler.record_function(SPAN + "loader_next"):
                batch = next(self._it)
            self.remaining -= 1
            if self.capture is not None:
                self.capture.append(tuple(
                    c.to("cpu", copy=True) if torch.is_tensor(c)
                    else torch.from_numpy(c.copy()) for c in batch["clips"])
                    + (batch["labels"].copy(),))
            given += 1
            yield batch


# --------------------------------------------------------------------------
# weights, queue and draw streams from the seed
# --------------------------------------------------------------------------

def make_weights(arch: str, dim: int, seed: int, device) -> Dict:
    """Every leaf of the MoCo encoder, made on ``device`` from the seed:
    convolution weights normal with the He fan-out scale, linear weights
    normal with std 1/sqrt(fan in), biases 0, BN scale 1 and shift 0,
    running statistics 0 and 1. One draw of all the weights at once."""
    import torch
    from .reference import models
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  models.build(arch, dim).state_dict().items()}
    weights = [k for k, s in shapes.items()
               if k.endswith(".weight") and len(s) >= 2]
    total = sum(shapes[k].numel() for k in weights)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, ofs = {}, 0
    for k, s in shapes.items():
        if k in weights:
            n = s.numel()
            fan = s[0] * s[2:].numel() if len(s) == 5 else s[1]
            out[k] = flat[ofs:ofs + n].view(s) * (
                (2.0 / fan) ** 0.5 if len(s) == 5 else fan ** -0.5)
            ofs += n
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith("running_var") or k.endswith(".weight"):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def make_queue(dim: int, k: int, seed: int, device):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "queue"))
    q = torch.randn((dim, k), generator=gen, device=device)
    return q / torch.linalg.vector_norm(q, dim=0, keepdim=True)


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

def _events(prof):
    """(device events, host events) as (name, start_ns, end_ns)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not (e.is_user_annotation() or item[0].startswith(SPAN)):
            # spans (the benchmark's, the optimizer's) are mirrored on the
            # device's timeline; they are not device work
            dev.append(item)
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def read_trace(prof, window_s: float):
    dev, host = _events(prof)
    merged = _union(dev)
    busy_s = sum(e - s for s, e in merged) / 1e9
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        inside = [(he - hs, name) for name, hs, he in host
                  if hs <= mid <= he]
        name = min(inside)[1] if inside else ""
        if not inside or name == SPAN + "epoch":
            name = "host: the engine's Python, no traced operation"
        idle.append([_short(name), length / 1e9])
    return SimpleNamespace(
        kernels=dev, busy_s=busy_s, window_s=window_s,
        breakdown={"device_ops": [[_short(n), t] for n, t in top],
                   "idle_gaps": idle})


def load_metric(metrics_dir: Path, name: str):
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------

def build_engine(spec, seed: int, device: str, exp_dir: Path):
    """The program's engine for the cell, built as its pretrain CLI builds
    it: the configuration with the mix's keys written to one JSON file,
    ``bootstrap`` and ``PretrainEngine``."""
    from . import traffic
    cfg = traffic.merge(spec.config["config"],
                        traffic.prepare(spec.cell["traffic"], spec.traffic,
                                        device))
    exp_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = exp_dir / f"{spec.name}.json"
    cfg_path.write_text(json.dumps(cfg, indent=1))
    from rspnet_tpu_torch.engines.pretrain import PretrainEngine
    from rspnet_tpu_torch.framework import bootstrap
    args, tree = bootstrap(["-c", str(cfg_path), "-e", str(exp_dir),
                            "--seed", str(seed), "--device", device])
    return PretrainEngine(args, tree), cfg


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", spec=None,
        control: Optional[str] = None) -> dict:
    """One run of a cell; returns the result line as a dict. ``control``
    (tests and the limits' calibration: ``fp8`` or ``tf32``, see
    ``check.control_steps``) puts that computation in the program's place
    for the compared steps."""
    import numpy as np
    import torch
    from . import check

    spec = spec or load_cell(workload)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    exp_dir = Path(os.environ.get("RSPBENCH_EXP_DIR",
                                  BENCH_DIR / "runs" / workload))
    engine, cfg = build_engine(spec, seed, device, exp_dir)
    dev = engine.device
    s = engine.state
    arch = cfg["model"]["arch"]
    dim, batch = s.queue.shape[0], engine.batch_size
    if s.queue.shape[1] < 3 * batch:
        raise ValueError("the check reads the 3 steps' keys from the queue: "
                         "moco.k must hold 3 batches")

    # weights, queue and draw streams from the seed, the same for the
    # reference
    p0 = make_weights(arch, dim, seed, dev)
    s.model_q.load_state_dict(p0)
    s.model_k.load_state_dict(p0)
    s.queue.copy_(make_queue(dim, s.queue.shape[1], seed, dev))
    s.queue_ptr = 0
    engine.generator.manual_seed(derive(seed, "perm"))
    engine.rng = np.random.default_rng(derive(seed, "augment"))

    feed = Feed(engine.train_loader)
    engine.train_loader = feed
    opt = s.optimizer
    wd = opt.param_groups[0]["weight_decay"]
    params = dict(s.model_q.named_parameters())

    # three steps through train_epoch: the compared steps and the warm-up
    feed.capture = []
    losses = []
    grad1 = None
    epoch = 1
    for step in range(3):
        feed.take(1)
        engine.train_epoch(epoch)
        if feed.remaining == 0:
            epoch += 1
        losses.append(float(engine.meters["loss"].val))
        if step == 0:
            grad1 = {n: (opt.state[p]["momentum_buffer"] - wd * p0[n]
                         if p in opt.state else torch.zeros_like(p)
                         ).detach().to("cpu", copy=True)
                         for n, p in params.items()}
    batches = feed.capture
    feed.capture = None
    prog = SimpleNamespace(
        losses=losses, grad1=grad1,
        q={n: p.detach().to("cpu", copy=True) for n, p in params.items()},
        k={n: p.detach().to("cpu", copy=True)
           for n, p in s.model_k.named_parameters()},
        keys=s.queue[:, :3 * batch].T.to("cpu", copy=True))
    steps_before = len(engine.step_times)

    # the window
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - _T0
    t0 = time.perf_counter()
    feed.until(t0 + seconds)
    while True:
        with torch.profiler.record_function(SPAN + "epoch"):
            engine.train_epoch(epoch)
        if feed.remaining == 0:
            epoch += 1
        if time.perf_counter() >= t0 + seconds:
            break
    t1 = time.perf_counter()
    window_s = t1 - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    step_ms = engine.step_times[steps_before:]
    steps = len(step_ms)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    feed.close()
    engine.close()

    metrics = {}
    values = {"clips_per_s": steps * batch / window_s,
              "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    traced = None
    if trace:
        traced = read_trace(prof, window_s)
        prof = None
        from . import yardstick
        tt = cfg["temporal_transforms"]
        speed = max(cfg["moco"]["diff_speed"])
        work = yardstick.step_work(arch, batch, tt["size"] // speed,
                                   tt["size"],
                                   cfg["spatial_transforms"]["size"])
        ctx = SimpleNamespace(step_ms=step_ms, steps=steps, batch=batch,
                              window_s=window_s, trace=traced, work=work,
                              yardstick=yardstick)
        for m in spec.per_layer:
            v = load_metric(spec.metrics_dir, m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
        wanted = spec.per_layer
    else:
        wanted = spec.end_to_end
    for m in wanted:
        if m["name"] in values:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # free the program before the reference runs
    del engine, s, opt, params, feed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if control:
        prog = check.control_steps(cfg, seed, dev, batches, p0, control)
    checks = check.compare(spec, cfg, seed, dev, batches, prog, p0)
    ok = {n: c["limit"] is not None and c["value"] <= c["limit"]
          for n, c in checks.items()}
    correct = bool(checks) and all(ok.values())

    result = {"correct": correct, "attempted": steps * batch, "failed": 0,
              "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak,
            "power_limit_w": power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=window_s)
        result["breakdown"] = traced.breakdown
    for name, c in checks.items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']} "
              f"{'ok' if ok[name] else 'FAIL'}",
              file=sys.stderr, flush=True)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    # kernel and compiler caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    spec = load_cell(a.workload)
    import torch
    need = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no CUDA card, or fewer than {need}: this benchmark runs on "
              f"the card only", file=sys.stderr)
        return 2
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), spec=spec)
    found = banned_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
