"""What the tracer records of R(2+1)D's factored convolutions
(``models/r2plus1d.py:SpatioTemporalConv``), on the CPU at a tiny size:

- ``backbone.factored_conv_calls`` grows by 12 a forward of R(2+1)D-10,
  with or without a gradient, and by 24 a MoCo step;
- under ``torch.profiler`` a MoCo step records 12 ``rsp.backbone.spatial``
  and 12 ``rsp.backbone.temporal`` device spans in each of its two passes,
  each inside its phase and carrying the step; on a card (CUDA events
  stubbed) each span has a pair of events of its own, and the phase
  chain's device times still tile the step;
- with the profiler off no span is kept and no CUDA event is made.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework import tracing
from rspnet_tpu_torch.models.r2plus1d import r2plus1d_vcop
from rspnet_tpu_torch.moco import build_moco_model, init_moco_state
from rspnet_tpu_torch.moco import train_step

torch.set_num_threads(1)

COUNTER = "backbone.factored_conv_calls"
SPANS = ("rsp.backbone.spatial", "rsp.backbone.temporal")
PHASES = ["rsp.step.ema", "rsp.step.gather", "rsp.step.key_pass",
          "rsp.step.q_forward", "rsp.step.backward", "rsp.step.optimizer",
          "rsp.step.enqueue"]


class _Event:
    """A stand-in for torch.cuda.Event: the order of its records."""
    clock = 0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.at = None

    def record(self, stream=None):
        assert stream == "the stream"
        _Event.clock += 1
        self.at = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture(scope="module")
def state():
    cfg = ConfigTree.from_dict({
        "model": {"arch": "r2plus1d-vcop"},
        "moco": {"dim": 16, "k": 8, "m": 0.999, "t": 0.07,
                 "diff_speed": [2], "fc_type": "linear"},
        "temporal_transforms": {"size": 8}})
    model, mcfg = build_moco_model(cfg)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    return init_moco_state(model, mcfg, opt, torch.Generator()), mcfg


def _step(state):
    s, mcfg = state
    gen = torch.Generator().manual_seed(0)
    views = [torch.randn(2, 8, 32, 32, 3, generator=gen) for _ in range(2)]
    train_step(s, views[0], views[1], mcfg, perm=torch.tensor([1, 0]),
               speed_index=0)


def test_counter_grows_by_12_a_forward():
    net = r2plus1d_vcop().eval()
    x = torch.randn(1, 3, 4, 16, 16)
    before = tracing.counter(COUNTER)
    net.features(x).sum().backward()
    assert tracing.counter(COUNTER) == before + 12
    with torch.no_grad():
        net.features(x)
    assert tracing.counter(COUNTER) == before + 24


def test_step_spans_inside_their_phases(state, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "the stream")
    before = tracing.counter(COUNTER)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.begin_step(5, torch.device("cuda", 0))
        _step(state)
    assert tracing.counter(COUNTER) == before + 24
    got = tracing.spans()
    phases = [s for s in got if isinstance(s, tracing.Phase)]
    assert [s.name for s in phases] == PHASES
    for name in SPANS:
        mine = [s for s in got if s.name == name]
        assert [s.parent.name for s in mine] == \
            ["rsp.step.key_pass"] * 12 + ["rsp.step.q_forward"] * 12
        for s in mine:
            assert s.step == 5
            assert isinstance(s, tracing.DeviceSpan)
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
            assert s._start_event.at < s._end_event.at
            assert s.parent._start_event.at < s._start_event.at
            assert s._end_event.at < s.parent._end_event.at
            assert s.device_ms() == s._end_event.at - s._start_event.at
    # the chain: each phase starts at the event that ended the one before,
    # so that the phases' device times add up to the step's
    for a, b in zip(phases, phases[1:]):
        assert a._end_event is b._start_event
    span_events = {id(e) for s in got if isinstance(s, tracing.DeviceSpan)
                   for e in (s._start_event, s._end_event)}
    assert not span_events & {id(e) for p in phases
                              for e in (p._start_event, p._end_event)}
    assert sum(p.device_ms() for p in phases) == \
        phases[-1]._end_event.at - phases[0]._start_event.at


def test_off_keeps_no_span_and_makes_no_event(state, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event while the tracer is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = tracing.spans()
    tracing.begin_step(6, torch.device("cuda", 0))
    _step(state)
    assert tracing.spans() == before
    assert tracing.device_span("x") is tracing.OFF
