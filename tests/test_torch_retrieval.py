"""The port's retrieval workload (rspnet_tpu_torch/engines/retrieval.py)
against the JAX package's, on the CPU in f32.

- ``topk_retrieval`` equals the JAX engine's on random features with tied
  similarities (duplicate train clips): the same ``argsort`` on the same
  f32 arrays.
- ``crop_features`` (n-crop fold, eval-mode features, global average pool,
  crop mean) against the JAX engine's own feature function on C3D: 1e-5
  relative.
- The whole engine through both CLIs, one seed, synthetic data with device
  geometry (8 frames at 32², 2 crops, batch 1, ``-d``: 3 batches a split),
  ``--mc`` from a JAX-written pretrain checkpoint (C3D) and from a
  port-written one (ResNet-18): features within 1e-4 relative (of the
  largest), labels and R@k equal, the same crop boxes in the same order
  (train: Inception crops from the seed's generator; test: centre max
  crops), the reference's and the JAX package's artifact names.
- ``--load-model`` of a finetune checkpoint holding the same backbone gives
  the ``--mc`` run's features; the CLI runs as a module.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import retrieval as jax_retrieval_cli
from rspnet_tpu.engines import retrieval as jax_retrieval
from rspnet_tpu.engines.classifier import TrainState
from rspnet_tpu.framework.checkpoint import save_state as jax_save_state
from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu_torch import retrieval
from rspnet_tpu_torch.engines import retrieval as port_retrieval
from rspnet_tpu_torch.framework import save_state
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.conftest import REPO_ROOT
from tests.test_torch_zoo import (  # noqa: F401 (a fixture)
    _random_variables, release_jax_memory)
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
DIM, NC = 8, 4
SYNTH = ('{dataset: {name: "synthetic", num_samples: 16, num_classes: 4, '
         'num_frames: 48, height: 48, width: 64}, batch_size: 1, '
         'num_workers: 2, spatial_transforms+: {size: 32}, '
         'temporal_transforms+: {size: 8, validate+: {final_n_crop: 2}}, '
         'validate: {batch_size: 1}, final_validate: {batch_size: 1}, '
         'device_geometry: true}')
ARTIFACTS = {f"{split}_{name}.npy" for split in ("train", "test")
             for name in ("fold1_feats", "fold1_labels", "feature", "class")
             } | {"topk_correct.json"}


def argv(arch, exp, *more):
    return ["-c", f"config/retrieval/ucf101_{arch}.jsonnet", "-e", str(exp),
            "-x", SYNTH, "-d", "--seed", "1", *more]


def test_topk_retrieval_matches_jax():
    rng = np.random.RandomState(0)
    train = rng.randn(40, 16).astype(np.float32)
    train[20:] = train[:20]                     # every similarity tied
    train_l = rng.randint(0, 5, 40)
    test = rng.randn(12, 16).astype(np.float32)
    test[:4] = train[:4] * 3.0                  # exact ties with the top
    test_l = rng.randint(0, 5, 12)
    got = port_retrieval.topk_retrieval(train, train_l, test, test_l)
    want = jax_retrieval.RetrievalEngine.topk_retrieval(train, train_l, test,
                                                        test_l)
    assert got == want


def test_crop_features_match_jax():
    jm = JaxWrapper(encoder_factory=jax_model_class("c3d"), num_classes=NC,
                    finetune=True, axis_name="data")
    v = _random_variables(jm, np.random.default_rng(2), np.float32)
    stub = type("Stub", (), {})()
    stub.n_crop, stub.model = 2, jm
    stub.mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    feature_fn = jax_retrieval.RetrievalEngine._build_feature_fn(stub)
    clips = np.random.RandomState(3).randn(2, 16, 32, 32, 3).astype(
        np.float32)
    want = np.asarray(feature_fn(
        TrainState(v["params"], v["batch_stats"], None, jnp.zeros(())),
        jnp.asarray(clips)))
    model = MultiTaskWrapper(get_model_class("c3d")(), NC, finetune=True)
    convert.load_converted(model, convert.variables_to_state_dict(v, "c3d"))
    model = model.to(memory_format=torch.channels_last_3d).eval()
    got = port_retrieval.crop_features(model, torch.from_numpy(clips),
                                       2).numpy()
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _pretrain_state(arch, params, stats):
    return {"epoch": 1, "arch": arch, "model": {
        "params_q": params, "params_k": params, "batch_stats_q": stats,
        "batch_stats_k": stats, "queue": np.zeros((DIM, 8), np.float32),
        "queue_ptr": np.zeros((), np.int32)}}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX-written C3D pretrain checkpoint, a port-written ResNet-18 one
    and a finetune checkpoint with the C3D one's backbone."""
    d = tmp_path_factory.mktemp("ckpt")
    jm = JaxWrapper(encoder_factory=jax_model_class("c3d"), num_classes=DIM,
                    axis_name=None)
    v = _random_variables(jm, np.random.default_rng(4), np.float32)
    jax_save_state(_pretrain_state("c3d", v["params"], v["batch_stats"]),
                   d / "c3d_jax.pth.tar")
    torch.manual_seed(5)
    net = MultiTaskWrapper(get_model_class("resnet18")(), DIM)
    for name, buf in net.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(0.5 + torch.rand_like(buf))
    pv = convert.state_dict_to_variables(net.state_dict(), "resnet18")
    save_state(_pretrain_state("resnet18", pv["params"], pv["batch_stats"]),
               d / "resnet18_port.pth.tar")
    fine = MultiTaskWrapper(get_model_class("c3d")(), NC, finetune=True)
    fv = convert.state_dict_to_variables(fine.state_dict(), "c3d")
    fv["params"]["encoder"] = v["params"]["encoder"]
    fv["batch_stats"]["encoder"] = v["batch_stats"]["encoder"]
    save_state({"epoch": 1, "arch": "c3d", "model": fv, "best_acc1": 0.0},
               d / "c3d_finetune.pth.tar")
    return {"c3d": d / "c3d_jax.pth.tar",
            "resnet18": d / "resnet18_port.pth.tar",
            "c3d_finetune": d / "c3d_finetune.pth.tar"}


def _record_boxes(monkeypatch, module):
    boxes = []
    inner = module.eval_preprocess

    def recording(batch, b, **kw):
        boxes.append(np.asarray(b, np.float32).copy())
        return inner(batch, b, **kw)
    monkeypatch.setattr(module, "eval_preprocess", recording)
    return boxes


def _outputs(exp: Path):
    run_dir = next(exp.glob("run_0_*"))
    names = {p.name for p in run_dir.iterdir()
             if p.suffix in (".npy", ".json") and p.name != "config.json"}
    arrays = {n: np.load(run_dir / n) for n in names if n.endswith(".npy")}
    return names, arrays, json.loads(
        (run_dir / "topk_correct.json").read_text())


@pytest.mark.parametrize("arch", ["c3d", "resnet18"])
def test_engine_matches_jax(arch, checkpoints, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    ckpt = str(checkpoints[arch])
    jax_boxes = _record_boxes(monkeypatch, jax_retrieval)
    port_boxes = _record_boxes(monkeypatch, port_retrieval)
    want_r = jax_retrieval_cli.main(argv(arch, tmp_path / "jax", "--mc",
                                         ckpt, "--ws", "1"))
    engine, got_r = retrieval.main(argv(arch, tmp_path / "port", "--mc",
                                        ckpt, "--device", "cpu"))
    assert engine.dtype is None and engine.device.type == "cpu"
    assert got_r == want_r
    vals = [got_r[f"R@{k}"] for k in (1, 5, 10, 20, 50)]
    assert vals == sorted(vals)
    # 3 train batches (random crops) then 3 test batches (centre crops)
    assert len(port_boxes) == len(jax_boxes) == 6
    for a, b in zip(port_boxes, jax_boxes):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(port_boxes[0], port_boxes[1])
    names_p, got, json_p = _outputs(tmp_path / "port")
    names_j, want, json_j = _outputs(tmp_path / "jax")
    assert names_p == names_j == ARTIFACTS
    assert json_p == json_j == want_r
    for name, ref in want.items():
        if "label" in name or "class" in name:
            np.testing.assert_array_equal(got[name], ref, err_msg=name)
            continue
        assert got[name].dtype == np.float32
        assert got[name].shape == (3, 512) and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_load_model_gives_the_mc_features(checkpoints, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    retrieval.main(argv("c3d", tmp_path / "mc", "--device", "cpu", "--mc",
                        str(checkpoints["c3d"])))
    retrieval.main(argv("c3d", tmp_path / "lm", "--device", "cpu",
                        "--load-model", str(checkpoints["c3d_finetune"])))
    _, mc, r_mc = _outputs(tmp_path / "mc")
    _, lm, r_lm = _outputs(tmp_path / "lm")
    assert r_mc == r_lm
    for name, ref in mc.items():
        np.testing.assert_array_equal(lm[name], ref, err_msg=name)


def test_cli_module_runs_on_cpu(checkpoints, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rspnet_tpu_torch.retrieval",
         *argv("resnet18", tmp_path, "--device", "cpu", "--mc",
               str(checkpoints["resnet18"]))],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "'R@50'" in proc.stdout
    names, _, _ = _outputs(tmp_path)
    assert names == ARTIFACTS
