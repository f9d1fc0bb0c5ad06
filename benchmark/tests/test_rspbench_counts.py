"""The yardstick's arithmetic on the CPU, and the harness finding a cell,
a mix and a metric by their names in files added beside the others."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import run, yardstick as y

ROOT = Path(__file__).resolve().parents[2]


def test_pool_and_augment_bytes_reproduce_the_kernel_bounds():
    """S3D-G's 13 pool sites at the query pass's batch 64 in bf16, and K3
    on f32 [64, 32, 224, 224, 3]: the bounds the kernel table states
    (1.074, 1.833 and 0.736 ms at 3.35 TB/s)."""
    calls = y.pool_calls("s3dg", 64, 16, 224)
    assert len(calls) == 13
    ms = 1e3 / y.HBM_BYTES_PER_S
    assert round(y.k1_bytes(calls, 2) * ms, 3) == 1.074
    assert round(y.k2_bytes(calls, 2) * ms, 3) == 1.833
    assert round(y.k3_bytes(64, 32, 224) * ms, 3) == 0.736
    assert y.k1_bytes(calls, 2) == 3_597_418_496
    assert y.k2_bytes(calls, 2) == 6_140_739_584


def test_resnet18_has_one_pool_site():
    (call,) = y.pool_calls("resnet18", 64, 16, 112)
    assert call.shape_in == (64, 64, 16, 56, 56)
    assert call.shape_out == (64, 64, 8, 28, 28)


@pytest.mark.parametrize("arch, size, fwd, train", [
    # convolution and matmul FLOPs of one 16-frame clip, 2 per
    # multiply-add: S3D-G at 224 x 224 (Xie et al. give 71 G multiply-adds
    # for 64 frames), ResNet-18 at 112 x 112
    ("s3dg", 224, 34_070_549_504, 100_323_425_280),
    ("resnet18", 112, 16_615_866_368, 43_238_817_792),
])
def test_flops_per_clip_are_pinned(arch, size, fwd, train):
    assert y.forward_flops(arch, 1, 16, size) == fwd
    assert y.train_flops(arch, 1, 16, size) == train


def _tiny_root(tmp_path: Path, limits: dict) -> Path:
    """A copy of BENCHMARK.json with one more configuration, mix, cell and
    per-layer metric, each a new file; no existing file edited."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "benchmark" / "metrics", d / "metrics")
    cfg = json.loads(
        (ROOT / "benchmark/configs/r3d18_pretrain.json").read_text())
    c = cfg["config"]
    c.update(batch_size=4, num_workers=1)
    c["spatial_transforms"]["size"] = 48
    c["temporal_transforms"]["size"] = 16
    c["moco"]["k"] = 16
    (d / "configs/tiny.json").write_text(json.dumps(cfg))
    (d / "traffic/tiny.json").write_text(json.dumps({"config": {
        "dataset": {"name": "synthetic", "num_samples": 8,
                    "num_frames": 32, "height": 40, "width": 48},
        "cache_device": "train", "device_geometry": True}}))
    (d / "limits/tiny.tiny.json").write_text(json.dumps(limits))
    (d / "metrics/tiny.steps.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    bench["per_layer"].append({
        "name": "tiny.steps", "unit": "steps", "better": "higher",
        "source": "program_span", "layer": "engine",
        "moves": "clips_per_s", "workloads": ["tiny.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def tiny_spec(tmp_path, monkeypatch, limits):
    root = _tiny_root(tmp_path, limits)
    monkeypatch.setenv("RSPBENCH_EXP_DIR", str(tmp_path / "exp"))
    return run.load_cell("tiny.tiny", root=root)


def test_added_files_are_found_by_name(tmp_path, monkeypatch):
    limits = json.loads(
        (ROOT / "benchmark/limits/r3d18_pretrain.cached.json").read_text())
    spec = tiny_spec(tmp_path, monkeypatch, limits)
    assert [m["name"] for m in spec.per_layer] == ["tiny.steps"]
    res = run.run("tiny.tiny", 2 ** 31 + 11, 1.0, True, device="cpu",
                  spec=spec)
    assert res["metrics"]["tiny.steps"]["value"] >= 1
    assert res["metrics"]["tiny.steps"]["unit"] == "steps"
    assert set(res["checks"]) == set(limits) - {"from"}
    assert list(res)[-1] == "checks"
    t0 = run.run("tiny.tiny", 2 ** 31 + 11, 1.0, False, device="cpu",
                 spec=spec)
    assert set(t0["metrics"]) == {"clips_per_s", "peak_gib", "setup_s"}
