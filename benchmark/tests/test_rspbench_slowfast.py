"""The yardstick's counts for SlowFast-NLN R50 4x16
(``SLOWFAST_NLN_4x16_R50``) at its published 32 x 224^2 input, and the
two readers of its fast pathway's and non-local blocks' spans in a CPU run
of a tiny SlowFast cell."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark import run, yardstick as y
from benchmark.tests.test_rspbench_r2plus1d import _spec

ARCH = "SLOWFAST_NLN_4x16_R50"
READERS = ["backbone.fast_fwd_ms", "backbone.nonlocal_fwd_ms"]


def test_flops_per_clip_are_pinned():
    """Convolution and matmul FLOPs of one 32-frame clip at 224 x 224, 2
    per multiply-add: 71,530,905,600 in the backbone (the program's model
    counts the same; the non-local blocks' two batched products a block
    included) and 2 x 2304 x 128 multiply-adds in each of the two linear
    heads."""
    heads = 2 * 2 * 2304 * 128
    assert y.forward_flops(ARCH, 1, 32, 224) == 71_530_905_600 + heads
    assert y.train_flops(ARCH, 1, 32, 224) == 208_931_586_048


def test_pool_sites_are_pinned():
    """Seven max pools a forward: the slow stem's and the fast stem's
    (1,3,3) / (1,2,2), then the five non-local blocks' (1,2,2) pools at
    28^2 and 14^2; so K1 runs 14 times a step (7 in the query pass, 7 in
    the fused key pass) and K2 7 times."""
    calls = y.pool_calls(ARCH, 64, 32, 224)
    assert [(c.shape_in, c.shape_out, c.kernel) for c in calls] == [
        ((64, 64, 4, 112, 112), (64, 64, 4, 56, 56), (1, 3, 3)),
        ((64, 8, 32, 112, 112), (64, 8, 32, 56, 56), (1, 3, 3)),
    ] + [((64, 512, 4, 28, 28), (64, 512, 4, 14, 14), (1, 2, 2))] * 2 + [
        ((64, 1024, 4, 14, 14), (64, 1024, 4, 7, 7), (1, 2, 2))] * 3
    work = y.step_work(ARCH, 64, 32, 64, 224)
    assert work.k1_bytes == y.k1_bytes(calls, 2) + y.k1_bytes(
        y.pool_calls(ARCH, 128, 32, 224), 2)
    assert work.k2_bytes == y.k2_bytes(calls, 2) == 3_468_165_120
    assert work.k3_bytes == y.k3_bytes(64, 64, 224) * 2


def test_traced_run_reads_the_fast_pathway_and_nonlocal_blocks(
        tmp_path, monkeypatch):
    spec = _spec(tmp_path, monkeypatch, ARCH)
    spec.per_layer = [m for m in spec.per_layer
                      if m["name"] not in ("backbone.spatial_fwd_ms",
                                           "backbone.temporal_fwd_ms")]
    spec.per_layer += [dict(name=n, unit="ms", workloads=["tiny.tiny"])
                       for n in READERS]
    res = run.run("tiny.tiny", 2 ** 31 + 17, 1.0, True, device="cpu",
                  spec=spec)
    got = {n: res["metrics"][n]["value"] for n in READERS}
    assert all(v > 0 for v in got.values()), got
    # both lie inside the key pass and the query pass, and do not nest
    # (medians of each: a little room)
    assert sum(got.values()) <= 1.25 * res["metrics"]["step.fwd_ms"]["value"]


def test_a_program_without_the_spans_reads_none(tmp_path, monkeypatch):
    """A traced window with steps but no such span (another backbone, or
    a commit before the spans) leaves both metrics out of the line."""
    spec = _spec(tmp_path, monkeypatch, "resnet18")
    spec.per_layer += [dict(name=n, unit="ms", workloads=["tiny.tiny"])
                       for n in READERS]
    res = run.run("tiny.tiny", 2 ** 31 + 17, 1.0, True, device="cpu",
                  spec=spec)
    assert "step.fwd_ms" in res["metrics"]
    assert not set(READERS) & set(res["metrics"])
    for name in READERS:
        reader = run.load_metric(spec.metrics_dir, name)
        assert reader.read(SimpleNamespace(trace=None, steps=1)) is None
