"""The benchmark's arithmetic: the card's peaks, the bytes each hand-written
kernel must move at a cell's shapes, and the model FLOPs of a step.

Everything here is counted from shapes on the benchmark's own plain model
(``reference/models.py``, the backbone from ``reference/backbones/``) on
the ``meta`` device: no number comes from the program under test. Bytes
follow the roofline rule: each input byte is read once and each output
byte written once, whatever a kernel reads again (the pool backward's
route buffer is not counted).

- K1, the max-pool forward: input + output.
- K2, the max-pool backward (route and gather passes together): the
  forward input (read to find each window's maximum), the output gradient
  and the input gradient.
- K3, the colour augment: its input (float32 after the crop and resize)
  and its float32 output.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .reference import models

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth,
# float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


@dataclass(frozen=True)
class PoolCall:
    """One max-pool call: input [N, C, T, H, W] and output shapes."""
    shape_in: Tuple[int, ...]
    shape_out: Tuple[int, ...]
    kernel: Tuple[int, ...]

    @property
    def n_in(self) -> int:
        return _numel(self.shape_in)

    @property
    def n_out(self) -> int:
        return _numel(self.shape_out)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class _PoolRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls: List[PoolCall] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.max_pool3d_with_indices.default:
            self.calls.append(PoolCall(tuple(args[0].shape),
                                       tuple(out[0].shape), tuple(args[1])))
        return out


def pool_calls(arch: str, batch: int, frames: int, size: int,
               dim: int = 128) -> List[PoolCall]:
    """The max-pool calls of one forward of ``batch`` clips [frames, size,
    size, 3] through the plain model."""
    with torch.device("meta"):
        model = models.build(arch, dim)
        x = torch.empty(batch, frames, size, size, 3)
    rec = _PoolRecorder()
    with torch.no_grad(), rec:
        model(x)
    return rec.calls


def k1_bytes(calls: List[PoolCall], esize: int) -> int:
    return sum((c.n_in + c.n_out) * esize for c in calls)


def k2_bytes(calls: List[PoolCall], esize: int) -> int:
    return sum((2 * c.n_in + c.n_out) * esize for c in calls)


def k3_bytes(batch: int, frames: int, size: int, in_esize: int = 4) -> int:
    n = batch * frames * size * size * 3
    return n * in_esize + n * 4


def forward_flops(arch: str, batch: int, frames: int, size: int,
                  dim: int = 128) -> int:
    """Convolution and matmul FLOPs (2 per multiply-add) of one forward."""
    with torch.device("meta"):
        model = models.build(arch, dim)
        x = torch.empty(batch, frames, size, size, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    return int(fc.get_total_flops())


def train_flops(arch: str, batch: int, frames: int, size: int,
                dim: int = 128) -> int:
    """Forward and backward FLOPs of ``batch`` clips (the input takes no
    gradient)."""
    with torch.device("meta"):
        model = models.build(arch, dim)
        x = torch.empty(batch, frames, size, size, 3)
    with FlopCounterMode(display=False) as fc:
        a, m = model(x)
        (a.sum() + m.sum()).backward()
    return int(fc.get_total_flops())


def step_flops(arch: str, batch: int, frames: int, size: int,
               dim: int = 128) -> int:
    """Model FLOPs of one MoCo step: the key pass forward on 2B clips, the
    query forward and backward on B. Recomputation is not counted."""
    return (forward_flops(arch, 2 * batch, frames, size, dim)
            + train_flops(arch, batch, frames, size, dim))


@dataclass(frozen=True)
class StepWork:
    """What one step of a cell must move and compute."""
    flops: int
    k1_bytes: int
    k2_bytes: int
    k3_bytes: int


def step_work(arch: str, batch: int, frames: int, window: int, size: int,
              pool_esize: int = 2, dim: int = 128) -> StepWork:
    """One step on clips of ``frames`` frames after the speed gather: K1
    on the key pass (2B) and the query pass (B), K2 on the query's
    backward, K3 once on the query's and once on the key's loaded window
    of ``window`` frames."""
    q = pool_calls(arch, batch, frames, size, dim)
    k = pool_calls(arch, 2 * batch, frames, size, dim)
    return StepWork(
        flops=step_flops(arch, batch, frames, size, dim),
        k1_bytes=k1_bytes(q, pool_esize) + k1_bytes(k, pool_esize),
        k2_bytes=k2_bytes(q, pool_esize),
        k3_bytes=2 * k3_bytes(batch, window, size))


def device_seconds(trace, pattern: str) -> float:
    """Device seconds of the trace's operations whose names match."""
    rx = re.compile(pattern)
    return sum(e - s for name, s, e in trace.kernels if rx.search(name)) / 1e9


def roofline(ctx, pattern: str, nbytes_per_step: int):
    """The kernels' share (%) of their bandwidth roofline over the traced
    window: the bytes the window's steps must move at HBM_BYTES_PER_S,
    over the matching kernels' device time. None where the trace holds
    none of them."""
    if ctx.trace is None or not ctx.steps:
        return None
    t = device_seconds(ctx.trace, pattern)
    if t <= 0:
        return None
    return 100.0 * nbytes_per_step * ctx.steps / HBM_BYTES_PER_S / t
