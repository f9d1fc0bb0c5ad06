"""The port's tracer (rspnet_tpu_torch/framework/tracing.py) and the spans
of the pretrain hot loop, on the CPU at a tiny S3D-G:

- off (no profiler), ``train_epoch`` records no span and opens no
  ``record_function``, and ``step_times`` still fills;
- under ``torch.profiler`` one epoch of 2 steps records each engine span
  and each phase of the MoCo step once a step, two ``rsp.augment`` phases,
  with their parents and step ids, each child inside its parent, and
  ``step_times`` from the ``rsp.engine.step`` span's own clock reads;
- the spans lie on the profiler's clock: each overlaps its profiler event
  and starts within 1 ms of it;
- two profiler sessions keep their spans apart; the bounded buffer drops
  the oldest spans and counts them;
- the loader's producer thread keeps its own spans, parents and thread;
- ``loader.h2d_bytes`` counts a host clip's bytes, a cached clip none;
- a CUDA phase chain shares its boundary events (events stubbed);
- ``--profile-steps`` writes a Chrome trace holding the step's phases;
- a K1 launch (its library stubbed) moves its ``kernels.`` counter, and
  ``--profile-steps`` logs the launches of its steps.
"""
import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rspnet_tpu_torch.data.device_cache import clip_to_device
from rspnet_tpu_torch.data.pipeline import prefetch_iterator
from rspnet_tpu_torch.framework import tracing
from tests.conftest import REPO_ROOT

torch.set_num_threads(1)

ENGINE = ["rsp.engine.iter", "rsp.loader.next", "rsp.engine.step",
          "rsp.engine.sync"]
STEP = ["rsp.step.ema", "rsp.step.gather", "rsp.step.key_pass",
        "rsp.step.q_forward", "rsp.step.backward", "rsp.step.optimizer",
        "rsp.step.enqueue"]
PARENT = {"rsp.engine.iter": "rsp.engine.epoch",
          "rsp.loader.next": "rsp.engine.iter",
          "rsp.engine.step": "rsp.engine.iter",
          "rsp.engine.sync": "rsp.engine.step",
          "rsp.augment": "rsp.engine.step",
          "rsp.loader.h2d": "rsp.augment",
          "rsp.engine.drain": "rsp.engine.epoch",
          **{n: "rsp.engine.step" for n in STEP}}


def _argv(exp, *extra):
    return ["-c", "config/pretrain/s3dg.jsonnet", "-e", str(exp), "-x",
            '{dataset+: {name: "synthetic", num_samples: 4, height: 40, '
            'width: 48}, batch_size: 2, num_workers: 1, spatial_transforms+: '
            '{size: 32}, temporal_transforms+: {_size:: 8}, moco+: {k: 8}, '
            'device_geometry: true}', "--seed", "0", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from rspnet_tpu_torch.engines.pretrain import PretrainEngine
    from rspnet_tpu_torch.framework import bootstrap
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)
    try:
        eng = PretrainEngine(*bootstrap(_argv(
            tmp_path_factory.mktemp("tracing"))))
    finally:
        os.chdir(cwd)
    assert len(eng.train_loader) == 2
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def profiled(engine):
    """One epoch of 2 steps under the profiler: (its spans, the
    profiler's host events, the main thread's native id, the step
    times)."""
    n = len(engine.step_times)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.train_epoch(1)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return (tracing.spans(), events, threading.get_native_id(),
            engine.step_times[n:])


def test_off_records_nothing(engine, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = tracing.spans()
    n = len(engine.step_times)
    engine.train_epoch(1)
    assert tracing.spans() == before
    assert len(engine.step_times) == n + 2
    assert all(t > 0 for t in engine.step_times[n:])
    assert tracing.span("x") is tracing.OFF
    assert tracing.phase("x") is tracing.OFF


def test_epoch_spans_once_a_step(profiled):
    spans, _, main, step_ms = profiled
    mine = [s for s in spans if s.thread == main]
    steps = sorted({s.step for s in mine if s.name == "rsp.engine.step"})
    assert len(steps) == 2 and steps[1] == steps[0] + 1
    for step in steps:
        names = [s.name for s in mine if s.step == step]
        for name in ENGINE + STEP:
            assert names.count(name) == 1, (step, name, names)
        assert names.count("rsp.augment") == 2
        assert names.count("rsp.loader.h2d") == 2
    names = [s.name for s in mine]
    assert names.count("rsp.engine.epoch") == 1
    assert names.count("rsp.engine.drain") == 1
    # the turn that finds the loader empty: a wait, no step
    assert names.count("rsp.engine.iter") == 3
    assert [s.host_ms for s in mine if s.name == "rsp.engine.step"] == \
        step_ms


def test_parents_hold_their_children(profiled):
    spans, _, main, _ = profiled
    for s in spans:
        if s.thread != main:
            continue
        want = PARENT.get(s.name)
        got = s.parent.name if s.parent is not None else None
        assert got == want, (s.name, got)
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns, s.name
            assert s.parent.thread == s.thread


def _rsp_events(events, prefix):
    by_name = {}
    for name, start, end in sorted(events, key=lambda e: e[1]):
        if name.startswith(prefix):
            by_name.setdefault(name, []).append((start, end))
    return by_name


def test_spans_lie_on_the_profilers_clock(profiled):
    # each span of the epoch's thread overlaps its profiler event (the
    # n-th span of a name, the n-th event)
    spans, events, main, _ = profiled
    by_name = _rsp_events(events, "rsp.")
    seen = {}
    for s in sorted((s for s in spans if s.thread == main),
                    key=lambda s: s.start_ns):
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        start, end = by_name[s.name][k]
        assert max(start, s.start_ns) < min(end, s.end_ns), s.name
    assert set(seen) == set(by_name)
    # and, with no other thread to wait for, starts within 1 ms of it
    # after a warm call
    t = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with tracing.Stopwatch("clock.watch", tracer=t):
                with t.span("clock.span"):
                    with t.phase("clock.phase"):
                        torch.ones(64).sum()
    by_name = _rsp_events(
        [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()], "clock.")
    warm = t.spans()[3:]
    assert [s.name for s in warm] == ["clock.phase", "clock.span",
                                      "clock.watch"]
    for s in warm:
        start, end = by_name[s.name][1]
        assert max(start, s.start_ns) < min(end, s.end_ns), s.name
        assert abs(start - s.start_ns) < 1_000_000, (s.name,
                                                     start - s.start_ns)


def test_producer_thread_keeps_its_own_spans(profiled):
    spans, _, main, _ = profiled
    produce = [s for s in spans if s.name == "rsp.loader.produce"]
    assert produce
    assert all(s.thread != main and s.parent is None for s in produce)

    def batches():
        for i in range(3):
            with tracing.span("inner"):
                pass
            yield i
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            assert list(prefetch_iterator(batches())) == [0, 1, 2]
    got = tracing.spans()
    outer, = [s for s in got if s.name == "outer"]
    inner = [s for s in got if s.name == "inner"]
    assert len(inner) == 3
    for s in inner:
        assert s.thread != outer.thread
        assert s.parent.name == "rsp.loader.produce"
        assert s.parent.thread == s.thread


def test_sessions_do_not_mix():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("first"):
            pass
    assert [s.name for s in tracing.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            with tracing.phase("second.phase"):
                pass
    got = tracing.spans()
    assert [s.name for s in got] == ["second.phase", "second"]
    assert got[0].parent is got[1]


def test_buffer_drops_the_oldest():
    t = tracing.Tracer(max_spans=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with t.span(f"s{i}"):
                pass
    assert [s.name for s in t.spans()] == ["s2", "s3", "s4"]
    assert t.dropped == 2


def test_stopwatch_reads_once_on_and_off():
    t = tracing.Tracer()
    watch = tracing.Stopwatch("w", tracer=t)
    with watch:
        torch.ones(8).sum()
    assert watch.ms > 0 and t.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        t.begin_step(7)
        with watch:
            with t.phase("p"):
                torch.ones(8).sum()
    w, = [s for s in t.spans() if s.name == "w"]
    p, = [s for s in t.spans() if s.name == "p"]
    assert w.host_ms == watch.ms
    assert (w.step, p.step, p.parent) == (7, 7, w)
    # on the CPU a phase's device time is its host time
    assert p.device_ms() == p.host_ms
    rows = {r[0]: r for r in tracing.summarize(t.spans())}
    assert rows["w"][1:] == (1, w.host_ms, None)
    assert rows["p"][1:] == (1, p.host_ms, p.host_ms)


def test_h2d_counts_host_clips_only():
    def copies():
        return (tracing.counter("loader.h2d_calls"),
                tracing.counter("loader.h2d_bytes"))
    calls, nbytes = copies()
    clip = np.zeros((2, 4, 8, 8, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]):
        out = clip_to_device(clip, torch.device("cpu"))
        assert clip_to_device(out, torch.device("cpu")) is out
    assert copies() == (calls + 1, nbytes + clip.nbytes)
    assert [s.name for s in tracing.spans()] == ["rsp.loader.h2d"]


class _Event:
    """A stand-in for torch.cuda.Event: the order of its records."""
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        assert stream == "the stream"
        _Event.clock += 1
        self.at = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_cuda_phases_share_boundary_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "the stream")
    t = tracing.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        for step in (0, 1):
            t.begin_step(step, torch.device("cuda", 0))
            for name in ("a", "b", "c"):
                with t.phase(name):
                    pass
    got = t.spans()
    assert [s.name for s in got] == ["a", "b", "c"] * 2
    for first in (0, 3):
        a, b, c = got[first:first + 3]
        assert a._end_event is b._start_event
        assert b._end_event is c._start_event
        assert [s.device_ms() for s in (a, b, c)] == [1.0, 1.0, 1.0]
    # a new step starts a new chain
    assert got[3]._start_event is not got[2]._end_event


def test_profile_steps_writes_the_trace(tmp_path, monkeypatch):
    from rspnet_tpu_torch import pretrain
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path, "--profile-steps", "2"))
    path = engine.args.run_dir / "profile" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("rsp.step.backward") == 2
    assert names.count("rsp.engine.step") == 2
    assert not (tmp_path / "checkpoint.pth.tar").exists()
    log = (engine.args.run_dir / "experiment.log").read_text()
    assert "rsp.step.backward: 2 spans" in log
    # other tests of the process may have moved other counters, which
    # sort before it on the line
    assert re.search(r"counters: (\S+=\d+ )*loader\.h2d_bytes=\d+", log)


def test_profile_steps_logs_kernel_launches(tmp_path, monkeypatch):
    """K1's wrapper with the kernel library stubbed and a CPU tensor
    presenting itself as a CUDA one: each launch moves
    ``kernels.max_pool3d_fwd.float32``; one a step shows on the counter
    line of ``--profile-steps 2``."""
    from rspnet_tpu_torch import pretrain
    from rspnet_tpu_torch.engines import pretrain as engines_pretrain
    from rspnet_tpu_torch.ops import _build
    from rspnet_tpu_torch.ops import max_pool3d as tmp

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    class Lib:
        @staticmethod
        def rsp_maxpool3d_fwd(*args):
            return 0

    monkeypatch.setattr(_build, "library", lambda name: Lib)
    monkeypatch.setattr(tmp, "_stream", lambda t: 0)
    x = torch.zeros(1, 2, 4, 4, 8).as_subclass(OnCard)
    name = "kernels.max_pool3d_fwd.float32"
    before = tracing.counter(name)
    tmp.max_pool3d_fwd(x, 2, 2, 0)
    assert tracing.counter(name) == before + 1

    step = engines_pretrain.train_step

    def step_and_launch(*args, **kwargs):
        tmp.max_pool3d_fwd(x, 2, 2, 0)
        return step(*args, **kwargs)

    monkeypatch.setattr(engines_pretrain, "train_step", step_and_launch)
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path, "--profile-steps", "2"))
    log = (engine.args.run_dir / "experiment.log").read_text()
    assert re.search(r"counters: (\S+=\d+ )*kernels\.max_pool3d_fwd\.float32=2"
                     r"( |$)", log, re.M)
