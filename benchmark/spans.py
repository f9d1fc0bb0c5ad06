"""The program's own spans in a traced window, step by step, for the
per-layer metrics that read them (``metrics/engine.enqueue_ms.py``,
``augment.device_ms``, ``step.fwd_ms``, ``step.bwd_ms``,
``step.update_ms``).

The spans are kept by the program's tracer
(``rspnet_tpu_torch/framework/tracing.py``) while the window's profiler
runs: ``rsp.engine.step`` is the interval of one entry of the engine's
``step_times``, and its children are the two ``rsp.augment`` phases, the
MoCo step's seven phases and ``rsp.engine.sync``. A phase's device time
is the time between the CUDA events at its ends, and the phases of a
step share their boundary events. Each reader returns None where the
program has no tracer (a commit before it) or the window no step span.
"""
from __future__ import annotations

import statistics
from typing import Callable, Iterable, List, Optional, Tuple

STEP = "rsp.engine.step"


def steps(ctx) -> Optional[List[Tuple[object, list]]]:
    """[(step span, its child spans)] of the traced window, or None."""
    if ctx.trace is None:
        return None
    try:
        from rspnet_tpu_torch.framework import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    children = {}
    for s in spans:
        if s.parent is not None and s.parent.name == STEP:
            children.setdefault(id(s.parent), []).append(s)
    out = [(s, children.get(id(s), [])) for s in spans if s.name == STEP]
    return out or None


def median_ms(ctx, per_step: Callable[[object, list], Optional[float]]
              ) -> Optional[float]:
    """The median over the window's steps of ``per_step(step, children)``
    (ms), the steps where it is None left out."""
    got = steps(ctx)
    if not got:
        return None
    vals = [v for v in (per_step(s, c) for s, c in got) if v is not None]
    return statistics.median(vals) if vals else None


def phases_device_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The median over steps of the summed device ms of the step's phases
    named ``names``."""
    names = set(names)

    def one(step, children):
        mine = [c for c in children if c.name in names]
        return sum(c.device_ms() for c in mine) if mine else None
    return median_ms(ctx, one)
