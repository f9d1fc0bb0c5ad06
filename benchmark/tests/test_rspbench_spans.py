"""The five readers of the program's spans (``benchmark/spans.py``) in a
CPU run of the tiny cell of ``test_rspbench_counts.py``: with ``--trace
1`` each returns a number, and the step's parts lie within its time; with
``--trace 0`` none is read."""
from __future__ import annotations

import json
import statistics
from types import SimpleNamespace

from benchmark import run
from benchmark.tests.test_rspbench_counts import ROOT, tiny_spec
from rspnet_tpu_torch.framework import tracing

SPAN_METRICS = ["engine.enqueue_ms", "augment.device_ms", "step.fwd_ms",
                "step.bwd_ms", "step.update_ms"]


def _spec(tmp_path, monkeypatch):
    limits = json.loads(
        (ROOT / "benchmark/limits/r3d18_pretrain.cached.json").read_text())
    spec = tiny_spec(tmp_path, monkeypatch, limits)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec.per_layer = spec.per_layer + [
        dict(m, workloads=["tiny.tiny"]) for m in bench["per_layer"]
        if m["name"] in SPAN_METRICS]
    return spec


def test_traced_run_reads_every_span_metric(tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch)
    res = run.run("tiny.tiny", 2 ** 31 + 7, 1.0, True, device="cpu",
                  spec=spec)
    got = {n: res["metrics"][n]["value"] for n in SPAN_METRICS}
    assert all(v > 0 for v in got.values()), got
    assert all(res["metrics"][n]["unit"] == "ms" for n in SPAN_METRICS)
    # the step's parts are its children, inside the step's time (medians
    # of each part: a little room)
    step_ms = statistics.median(s.host_ms for s in tracing.spans()
                                if s.name == "rsp.engine.step")
    parts = sum(got[n] for n in SPAN_METRICS[1:])
    assert got["engine.enqueue_ms"] <= step_ms
    assert 0.5 * step_ms < parts <= 1.25 * step_ms, (parts, step_ms)
    # the idle gaps are named by spans of the program, or by its ops
    assert not any(name.startswith("rsp.") for name, _ in
                   res["breakdown"]["device_ops"])


def test_untraced_run_reads_none(tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch)
    res = run.run("tiny.tiny", 2 ** 31 + 7, 1.0, False, device="cpu",
                  spec=spec)
    assert not set(SPAN_METRICS) & set(res["metrics"])
    ctx = SimpleNamespace(trace=None, step_ms=[1.0], steps=1)
    for name in SPAN_METRICS:
        assert run.load_metric(spec.metrics_dir, name).read(ctx) is None
