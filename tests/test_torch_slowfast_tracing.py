"""What the tracer records of SlowFast's fast pathway and non-local blocks
(``models/slowfast.py``), on the CPU at the published spec
(``SLOWFAST_NLN_4x16_R50``, every width and block) and a tiny input:

- ``backbone.nonlocal_calls`` grows by 5 a forward, with or without a
  gradient, and by 10 a MoCo step;
- under ``torch.profiler`` a MoCo step records one ``rsp.backbone.fast``
  and five ``rsp.backbone.nonlocal`` device spans in each of its two
  passes, each inside its phase and carrying the step; on a card (CUDA
  events stubbed) each span has a pair of events of its own, and the
  phase chain's device times still tile the step;
- with the profiler off no span is kept and no CUDA event is made.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework import tracing
from rspnet_tpu_torch.moco import build_moco_model, init_moco_state
from rspnet_tpu_torch.moco import train_step
from tests.test_torch_r2plus1d_tracing import PHASES, _Event

torch.set_num_threads(1)

ARCH = "SLOWFAST_NLN_4x16_R50"
COUNTER = "backbone.nonlocal_calls"
SPANS = {"rsp.backbone.fast": 1, "rsp.backbone.nonlocal": 5}


@pytest.fixture(scope="module")
def state():
    cfg = ConfigTree.from_dict({
        "model": {"arch": ARCH},
        "moco": {"dim": 16, "k": 8, "m": 0.999, "t": 0.07,
                 "diff_speed": [2], "fc_type": "linear"},
        "temporal_transforms": {"size": 16}})
    model, mcfg = build_moco_model(cfg)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    return init_moco_state(model, mcfg, opt, torch.Generator()), mcfg


def _step(state):
    s, mcfg = state
    gen = torch.Generator().manual_seed(0)
    views = [torch.randn(2, 16, 32, 32, 3, generator=gen) for _ in range(2)]
    train_step(s, views[0], views[1], mcfg, perm=torch.tensor([1, 0]),
               speed_index=0)


def test_counter_grows_by_5_a_forward(state):
    net = state[0].model_q.encoder
    x = torch.randn(2, 3, 8, 32, 32)
    before = tracing.counter(COUNTER)
    net.features(x).sum().backward()
    assert tracing.counter(COUNTER) == before + 5
    with torch.no_grad():
        net.features(x)
    assert tracing.counter(COUNTER) == before + 10
    state[0].model_q.zero_grad(set_to_none=True)


def test_step_spans_inside_their_phases(state, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "the stream")
    before = tracing.counter(COUNTER)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.begin_step(5, torch.device("cuda", 0))
        _step(state)
    assert tracing.counter(COUNTER) == before + 10
    got = tracing.spans()
    phases = [s for s in got if isinstance(s, tracing.Phase)]
    assert [s.name for s in phases] == PHASES
    for name, n in SPANS.items():
        mine = [s for s in got if s.name == name]
        assert [s.parent.name for s in mine] == \
            ["rsp.step.key_pass"] * n + ["rsp.step.q_forward"] * n
        for s in mine:
            assert s.step == 5
            assert isinstance(s, tracing.DeviceSpan)
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
            assert s._start_event.at < s._end_event.at
            assert s.parent._start_event.at < s._start_event.at
            assert s._end_event.at < s.parent._end_event.at
            assert s.device_ms() == s._end_event.at - s._start_event.at
    # the fast pathway and the non-local blocks (slow pathway) do not nest
    fast = [s for s in got if s.name == "rsp.backbone.fast"]
    for s in got:
        if s.name == "rsp.backbone.nonlocal":
            assert not any(f.start_ns <= s.start_ns <= f.end_ns
                           for f in fast)
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
    count = tracing.counter(COUNTER)
    tracing.begin_step(6, torch.device("cuda", 0))
    _step(state)
    assert tracing.spans() == before
    assert tracing.counter(COUNTER) == count + 10
