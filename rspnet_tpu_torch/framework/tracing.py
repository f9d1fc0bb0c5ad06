"""Spans and counters inside the port's hot loops, on the clock of
``torch.profiler``'s events.

- ``span(name)``: a host span. While the tracer is on it keeps a ``Span``
  (``name``, ``start_ns``, ``end_ns``, ``parent``, ``step``, ``thread``) in
  memory and opens ``torch.profiler.record_function(name)``, so that the
  span sits in the profiler's timeline beside the kernels launched inside
  it. Times are nanoseconds on the profiler's clock (the Unix epoch, as
  ``time.time_ns``): ``perf_counter_ns`` plus an offset taken when the
  session starts. The parent is the span open on the same thread; the
  step is the one ``begin_step`` set last.
- ``phase(name)``: a span with a device time. When the step runs on a card
  (``begin_step``'s device) a phase records a CUDA event on the current
  stream at each end, and the phases of one step form a chain: each starts
  at the event that ended the one before, so that their device times add
  up to the step's. ``Phase.device_ms`` resolves the pair after the
  window; on the CPU a phase's device time is its host time. Phases run
  on the thread that calls ``begin_step`` and do not nest.
- ``device_span(name)``: a span with a device time of its own, which may
  nest inside a phase. On a card it records a pair of CUDA events of its
  own on the step's stream, and leaves the phase chain as it is: the
  phases' device times still tile the step. ``rsp.backbone.spatial`` and
  ``rsp.backbone.temporal`` (``models/r2plus1d.py``: the two halves of a
  factored convolution, 12 of each a forward of R(2+1)D-10) are such
  spans.
- ``Stopwatch(name)``: a span that always times its body (``ms``), on or
  off, so that a caller's own timing and its span come from the same two
  clock reads (the engine's ``step_times`` and ``rsp.engine.step``).
- Counters: ``add(name, n)``, integer sums kept always, on or off:
  ``loader.h2d_calls`` and ``loader.h2d_bytes`` (``data/device_cache.py``:
  the engines' host-to-card clip copies), ``backbone.stem_pad_calls``
  (``models/common.py``: forwards of ``SpaceToDepthConv3d``, the packed
  and channel-padded RGB stem; 2 a pretrain step in bf16 on a card),
  ``backbone.factored_conv_calls`` (``models/r2plus1d.py``: forwards of
  ``SpatioTemporalConv``, 12 a forward of R(2+1)D-10 and so 24 a
  pretrain step).

The tracer is on exactly while a ``torch.profiler`` session is active in
the process (torch's process-wide flag; ``_profiler_enabled()`` is the
calling thread's, and the loader's producer thread reads False there).
Off, ``span``, ``phase`` and ``device_span`` cost one check and return the
shared no-op context ``OFF``: no ``record_function``, no CUDA event, no allocation. The
first span (or ``spans()`` call) that finds the profiler on after the
tracer last found it off starts a fresh buffer, so that a reader after a
window sees that window's spans only. The buffer keeps the newest
``max_spans`` spans and counts the ones it drops (``dropped``). The
profiler records a ``record_function`` on the thread that started it
only: another thread's spans are kept here alone.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 16


def _profiler_on() -> bool:
    """Whether a profiler session is active anywhere in the process."""
    flag = getattr(_profiler, "_is_profiler_enabled", None)
    if flag is None:            # a torch without the process-wide flag
        return torch._C._autograd._profiler_enabled()
    return flag


class _Off:
    """What ``span``, ``phase`` and ``device_span`` return while the tracer
    is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One host span; a context manager that records itself on exit."""
    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "thread",
                 "_tracer", "_rf")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self.start_ns = self.end_ns = None

    def __enter__(self):
        t = self._tracer
        t._open(self)
        self.start_ns = time.perf_counter_ns() + t._offset_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + self._tracer._offset_ns
        self._tracer._close(self, exc)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Phase(Span):
    """A span with a device time (see the module's docstring)."""
    __slots__ = ("_start_event", "_end_event")

    def __enter__(self):
        super().__enter__()
        t = self._tracer
        self._start_event = self._end_event = None
        if t._stream is not None:
            start = t._boundary
            if start is None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(t._stream)
            self._start_event = start
        return self

    def __exit__(self, *exc):
        if self._start_event is not None:
            t = self._tracer
            end = torch.cuda.Event(enable_timing=True)
            end.record(t._stream)
            self._end_event = t._boundary = end
        return super().__exit__(*exc)

    def device_ms(self) -> float:
        """Milliseconds between the phase's events (waits for the end
        one); the host time where the phase recorded none."""
        if self._start_event is None:
            return self.host_ms
        self._end_event.synchronize()
        return self._start_event.elapsed_time(self._end_event)


class DeviceSpan(Span):
    """A span with a pair of CUDA events of its own (see the module's
    docstring): it may nest inside a phase and does not touch the chain."""
    __slots__ = ("_start_event", "_end_event")

    def __enter__(self):
        super().__enter__()
        self._start_event = self._end_event = None
        stream = self._tracer._stream
        if stream is not None:
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record(stream)
        return self

    def __exit__(self, *exc):
        if self._start_event is not None:
            self._end_event = torch.cuda.Event(enable_timing=True)
            self._end_event.record(self._tracer._stream)
        return super().__exit__(*exc)

    device_ms = Phase.device_ms


class Tracer:
    """Spans in a bounded buffer, a span stack per thread, counters."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self.dropped = 0
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._on = False
        self._offset_ns = 0
        self._step: Optional[int] = None
        self._stream = None         # the current stream of a step on a card
        self._boundary = None

    # -- on and off ---------------------------------------------------------
    def active(self) -> bool:
        """Whether a profiler session is active; a new session starts a
        fresh buffer."""
        on = _profiler_on()
        if on != self._on:
            with self._lock:
                if on and not self._on:
                    self._spans = collections.deque(maxlen=self.max_spans)
                    self.dropped = 0
                    self._boundary = None
                    self._offset_ns = time.time_ns() - time.perf_counter_ns()
                self._on = on
        return on

    def span(self, name: str):
        return Span(self, name) if self.active() else OFF

    def phase(self, name: str):
        return Phase(self, name) if self.active() else OFF

    def device_span(self, name: str):
        return DeviceSpan(self, name) if self.active() else OFF

    def begin_step(self, step: int, device: Optional[torch.device] = None
                   ) -> None:
        """The step id of the spans that follow, and the device of the
        step's phases: on ``cuda`` they record events on its current
        stream. A step starts a new chain of phases."""
        self._step = step
        self._stream = None
        if getattr(device, "type", None) == "cuda" and self.active():
            self._stream = torch.cuda.current_stream(device)
        self._boundary = None

    # -- spans --------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # the clock is read inside the record_function, so that a span lies
    # within its profiler event
    def _open(self, span: Span) -> None:
        stack = self._stack()
        span.parent = stack[-1] if stack else None
        span.step = self._step
        span.thread = threading.get_native_id()
        stack.append(span)
        span._rf = torch.profiler.record_function(span.name)
        span._rf.__enter__()

    def _close(self, span: Span, exc) -> None:
        span._rf.__exit__(*exc)
        span._rf = None
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        spans = self._spans
        if len(spans) == spans.maxlen:
            with self._lock:
                self.dropped += 1
        spans.append(span)

    def spans(self) -> List[Span]:
        """The spans of the active or the last session, oldest first."""
        self.active()
        return list(self._spans)

    # -- counters -----------------------------------------------------------
    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


class Stopwatch:
    """``with watch:`` times its body on the host clock, on or off
    (``ms``); while the tracer is on the body is also the span ``name``,
    from the same two clock reads. Reusable; not reentrant."""
    __slots__ = ("name", "ms", "_tracer", "_span", "_t0")

    def __init__(self, name: str, tracer: Optional[Tracer] = None):
        self.name = name
        self.ms: Optional[float] = None
        self._tracer = tracer or TRACER
        self._span = None

    def __enter__(self):
        t = self._tracer
        self._span = Span(t, self.name) if t.active() else None
        if self._span is not None:
            t._open(self._span)
        self._t0 = time.perf_counter_ns()
        if self._span is not None:
            self._span.start_ns = self._t0 + t._offset_ns
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ms = (t1 - self._t0) / 1e6
        if self._span is not None:
            self._span.end_ns = t1 + self._tracer._offset_ns
            self._tracer._close(self._span, exc)
            self._span = None
        return False


def summarize(spans: List[Span]) -> List[Tuple[str, int, float,
                                               Optional[float]]]:
    """Per span name, in the order first seen: (name, count, host ms summed,
    device ms summed for phases and device spans, else None)."""
    rows: Dict[str, list] = {}
    for s in spans:
        row = rows.setdefault(s.name, [s.name, 0, 0.0, None])
        row[1] += 1
        row[2] += s.host_ms
        if isinstance(s, (Phase, DeviceSpan)):
            row[3] = (row[3] or 0.0) + s.device_ms()
    return [tuple(r) for r in rows.values()]


# the process's tracer: a profiler session is the process's too
TRACER = Tracer()
span = TRACER.span
phase = TRACER.phase
device_span = TRACER.device_span
begin_step = TRACER.begin_step
spans = TRACER.spans
add = TRACER.add
counter = TRACER.counter
counters = TRACER.counters
