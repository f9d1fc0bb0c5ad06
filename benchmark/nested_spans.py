"""The program's device spans that nest inside a step's phases
(``tracing.device_span``: ``rsp.backbone.spatial`` and
``rsp.backbone.temporal``, the halves of R(2+1)D's factored
convolutions), for the per-layer metrics that read them
(``metrics/backbone.spatial_fwd_ms.py``, ``backbone.temporal_fwd_ms``).

Such a span is no direct child of ``rsp.engine.step``, so it is grouped
by the step id it carries. The reader returns None where the program
records no such span (a commit before it) or the window no step span.
"""
from __future__ import annotations

import statistics
from typing import Optional

from benchmark import spans


def median_step_ms(ctx, name: str) -> Optional[float]:
    """The median over the window's steps of the summed device ms of the
    step's spans named ``name``."""
    got = spans.steps(ctx)
    if not got:
        return None
    from rspnet_tpu_torch.framework import tracing
    ids = {s.step for s, _ in got}
    per_step = {}
    for s in tracing.spans():
        if s.name == name and s.step in ids:
            per_step[s.step] = per_step.get(s.step, 0.0) + s.device_ms()
    return statistics.median(per_step.values()) if per_step else None
