"""``correct`` must come out false when the timed path is broken.

On the CPU, at a size a test run holds: a run of the harness whose look
for a card is skipped (``device="cpu"``) with a fault planted underneath
the engine, for each fault a one-card training cell can have, and with
the control (the float8 reference) in the program's place; every case is
held to the ResNet-18 cell's limits. On the card (marker ``card``): the
control at each cell's own size.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import faults, run
from benchmark.tests.test_rspbench_counts import ROOT, tiny_spec

LIMITS = json.loads(
    (ROOT / "benchmark/limits/r3d18_pretrain.cached.json").read_text())
SEED = 2 ** 31 + 5


@pytest.mark.parametrize("fault", sorted(faults.STEP_FAULTS))
def test_a_broken_step_is_not_correct(fault, tmp_path, monkeypatch):
    spec = tiny_spec(tmp_path, monkeypatch, LIMITS)
    undo = faults.plant(fault)
    try:
        res = run.run("tiny.tiny", SEED, 1.0, False, device="cpu", spec=spec)
    finally:
        undo()
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_control_is_not_correct(tmp_path, monkeypatch):
    spec = tiny_spec(tmp_path, monkeypatch, LIMITS)
    res = run.run("tiny.tiny", SEED, 1.0, False, device="cpu", spec=spec,
                  control="fp8")
    assert res["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_the_control_fails_at_the_cells_size(card, workload, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("RSPBENCH_EXP_DIR", str(tmp_path))
    res = run.run(workload, SEED, 1.0, False, control="fp8")
    assert res["correct"] is False
