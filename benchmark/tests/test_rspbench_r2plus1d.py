"""The yardstick's counts for R(2+1)D-10 (``r2plus1d-vcop``), and the two
readers of its factored convolutions' spans in a CPU run of a tiny
R(2+1)D cell."""
from __future__ import annotations

import json
from types import SimpleNamespace

from benchmark import run, yardstick as y
from benchmark.tests.test_rspbench_counts import ROOT, tiny_spec

ARCH = "r2plus1d-vcop"
READERS = ["backbone.spatial_fwd_ms", "backbone.temporal_fwd_ms"]


def test_flops_per_clip_are_pinned():
    """Convolution and matmul FLOPs of one 16-frame clip at 112 x 112, 2
    per multiply-add: 42,724,362,240 in the backbone (the program's model
    counts the same) and 2 x 512 x 128 multiply-adds in each of the two
    linear heads."""
    heads = 2 * 2 * 512 * 128
    assert y.forward_flops(ARCH, 1, 16, 112) == 42_724_362_240 + heads
    assert y.train_flops(ARCH, 1, 16, 112) == 126_949_478_400


def test_has_no_pool_sites():
    assert y.pool_calls(ARCH, 32, 16, 112) == []
    work = y.step_work(ARCH, 32, 16, 32, 112)
    assert work.k1_bytes == work.k2_bytes == 0
    assert work.k3_bytes == y.k3_bytes(32, 32, 112) * 2


def _spec(tmp_path, monkeypatch, arch):
    limits = json.loads(
        (ROOT / "benchmark/limits/r3d18_pretrain.cached.json").read_text())
    spec = tiny_spec(tmp_path, monkeypatch, limits)
    cfg = spec.config["config"]
    cfg["arch"] = cfg["model"]["arch"] = arch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec.per_layer = spec.per_layer + [
        dict(m, workloads=["tiny.tiny"]) for m in bench["per_layer"]
        if m["name"] in READERS + ["step.fwd_ms"]]
    return spec


def test_traced_run_reads_the_factored_convolutions(tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch, ARCH)
    res = run.run("tiny.tiny", 2 ** 31 + 13, 1.0, True, device="cpu",
                  spec=spec)
    got = {n: res["metrics"][n]["value"] for n in READERS}
    assert all(v > 0 for v in got.values()), got
    # the spans lie inside the key pass and the query pass (medians of
    # each: a little room)
    assert sum(got.values()) <= 1.25 * res["metrics"]["step.fwd_ms"]["value"]
    t0 = run.run("tiny.tiny", 2 ** 31 + 13, 1.0, False, device="cpu",
                 spec=spec)
    assert not set(READERS) & set(t0["metrics"])


def test_a_program_without_the_spans_reads_none(tmp_path, monkeypatch):
    """A traced window with steps but no such span (another backbone, or
    a commit before the spans) leaves both metrics out of the line."""
    spec = _spec(tmp_path, monkeypatch, "resnet18")
    res = run.run("tiny.tiny", 2 ** 31 + 13, 1.0, True, device="cpu",
                  spec=spec)
    assert "step.fwd_ms" in res["metrics"]
    assert not set(READERS) & set(res["metrics"])
    for name in READERS:
        reader = run.load_metric(spec.metrics_dir, name)
        assert reader.read(SimpleNamespace(trace=None, steps=1)) is None
