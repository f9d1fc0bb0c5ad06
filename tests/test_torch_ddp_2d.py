"""The port's 2-D ``data x model`` layout (the K-sharded queue) on two
gloo ranks, ``parallel: {data: 1, model: 2}``, f64.

- Against the JAX ``make_sharded_train_step_2d`` on a (1, 2) mesh of the
  conftest's CPU devices: two steps of the plain single-speed fused step
  (``diff_speed: [2]``) on TSM-r18, K = 8 over a global batch of 4, so
  the first step enqueues into shard 0 and the second into shard 1. After
  both, params_q, params_k, both BN statistics, the dense queue (gathered
  from the shards), the pointer and each step's metrics agree at atol
  1e-8 / rtol 1e-7, and the ranks hold bit-equal parameters and queue.
- Against the port's own 1-D layout on the same two ranks, from the same
  state and draws (the pattern of tests/test_sharded_queue.py:120): the
  same quantities, and then one eval step (``--validate``) of each
  layout, at the same tolerances.
- ``queue_update_sharded`` refuses a global batch that K/M does not
  divide (an enqueue would straddle two shards), lands each enqueue on
  the shard that holds the pointer and advances the pointer modulo K;
  ``trim_moco_k`` trims K to a multiple of the global batch x M.
- The CLIs with ``--device cpu --ws 2``: pretrain (1-D), ``--validate``
  from its checkpoint in the 2-D layout, finetune ``--mc``; rank 0 alone
  writes each run dir and checkpoint, which the JAX package reads.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.moco import make_sharded_train_step_2d
from rspnet_tpu.parallel import create_mesh_2d
from rspnet_tpu.utils.moco import trim_moco_k as jax_trim
from rspnet_tpu_torch.moco.sharded_queue import queue_update_sharded
from rspnet_tpu_torch.utils.moco import trim_moco_k
from tests.conftest import REPO_ROOT
from tests.test_step_parity import enable_x64
from tests.test_torch_ddp import (ATOL, B, RTOL, S, T, assert_ranks_equal,
                                  assert_state, jax_setup, replica_perms)
from tests.torch_ddp_ranks import run_ranks
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
K2 = 8      # K/M = 4 = the global batch: each step fills one shard


def test_two_ranks_2d_match_jax_and_1d():
    with enable_x64():
        _two_d()


def _assert_close_runs(a, b, what):
    for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        assert set(ma) == set(mb)
        for name in ma:
            np.testing.assert_allclose(ma[name], mb[name], atol=ATOL,
                                       rtol=RTOL,
                                       err_msg=f"{what} step {i}: {name}")
    for which in ("q", "k"):
        for name, t in a[which].items():
            np.testing.assert_allclose(t.numpy(), b[which][name].numpy(),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what} {which}: {name}")
    np.testing.assert_allclose(a["queue"].numpy(), b["queue"].numpy(),
                               atol=ATOL, rtol=RTOL, err_msg=what)
    assert a["ptr"] == b["ptr"]


def _two_d():
    mesh = create_mesh_2d(1, 2)
    jmodel, optimizer, cfg, state, port, rng = jax_setup(
        ("data", "model"), (2,), mesh, k=K2)
    step = make_sharded_train_step_2d(jmodel, optimizer, cfg, mesh)
    port_steps, jmetrics = [], []
    for i in range(2):
        x_q = rng.randn(2 * B, T, S, S, 3)
        x_k = rng.randn(2 * B, T, S, S, 3)
        key = jax.random.PRNGKey(11 + i)
        port_steps.append({"speed": None, "x_q": torch.from_numpy(x_q),
                           "x_k": torch.from_numpy(x_k),
                           # the flat replica index d * M + m is the rank
                           "perms": replica_perms(key)})
        state, m = step(state, jnp.asarray(x_q), jnp.asarray(x_k), key)
        jmetrics.append({k: float(v) for k, v in m.items()})
    ev_key = jax.random.PRNGKey(21)
    evaluation = {"x_q": torch.from_numpy(rng.randn(2 * B, T, S, S, 3)),
                  "x_k": torch.from_numpy(rng.randn(2 * B, T, S, S, 3)),
                  "perms": replica_perms(ev_key)}
    outs = run_ranks("moco", {**port, "layouts": ["2d", "1d"],
                              "mesh_2d": (1, 2), "steps": port_steps,
                              "eval": evaluation})
    for layout in ("2d", "1d"):
        assert_ranks_equal(outs, layout)
    got = outs[0]["2d"]
    _assert_close_runs(got, {**outs[0]["1d"]}, "2-D against 1-D")
    for name, ref in outs[0]["1d"]["eval"].items():
        np.testing.assert_allclose(got["eval"][name], ref, atol=ATOL,
                                   rtol=RTOL, err_msg=f"eval {name}")
    for i, (mine, ref) in enumerate(zip(got["metrics"], jmetrics)):
        assert set(mine) == set(ref)
        for name in ref:
            np.testing.assert_allclose(mine[name], ref[name], atol=ATOL,
                                       rtol=RTOL,
                                       err_msg=f"step {i}: {name}")
    assert_state(got["q"], state.params_q, state.batch_stats_q, "encoder q")
    assert_state(got["k"], state.params_k, state.batch_stats_k, "encoder k")
    np.testing.assert_allclose(got["queue"].numpy(), np.asarray(state.queue),
                               atol=ATOL, rtol=RTOL)
    assert got["ptr"] == int(state.queue_ptr) == 0       # 2 x 4 = K


def test_queue_update_sharded():
    keys = torch.arange(8.0).reshape(4, 2)        # [global B 4, dim 2]
    with pytest.raises(ValueError, match="divisible"):
        queue_update_sharded(torch.zeros(2, 6), 0, keys, 0, 2)
    shards = [torch.zeros(2, 4), torch.zeros(2, 4)]
    ptrs = [queue_update_sharded(s, 4, keys, m, 2)
            for m, s in enumerate(shards)]
    assert ptrs == [0, 0]                          # 4 + 4 = K = 8
    assert not shards[0].any()
    assert torch.equal(shards[1], keys.T)


@pytest.mark.parametrize("k,batch,model", [(16384, 64, 2), (16384, 96, 1),
                                           (100, 8, 4), (16, 4, 2)])
def test_trim_moco_k_matches_jax(k, batch, model):
    assert trim_moco_k(k, batch, model) == jax_trim(k, batch, model)


def _cli_ranks(module, argv, name):
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv, "--ws", "2"], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, f"{name}: {proc.stderr[-3000:]}"
    return proc.stdout + proc.stderr


def test_cli_two_ranks_pretrain_validate_finetune(tmp_path):
    """``--device cpu --ws 2``: pretrain (1-D), ``--validate`` from its
    checkpoint under ``parallel: {data: 1, model: 2}`` (the dense queue
    sharded over K), finetune ``--mc``. Rank 0 alone writes one run dir
    and one checkpoint, which the JAX package reads."""
    from rspnet_tpu.engines.transfer import \
        load_pretrained_encoder as jax_load_encoder
    from rspnet_tpu.framework.checkpoint import load_state as jax_load_state
    from tests.test_torch_finetune import PRETRAIN_X, finetune_argv

    pre = tmp_path / "pretrain"
    base = ["-c", "config/pretrain/s3dg.jsonnet", "-x", PRETRAIN_X, "-d",
            "--seed", "0", "--device", "cpu"]
    log = _cli_ranks("rspnet_tpu_torch.pretrain", ["-e", str(pre), *base],
                     "pretrain")
    assert "Mesh: rank 0 of {'data': 2, 'model': 1}" in log
    assert "Epoch 1 done" in log
    assert len(list(pre.glob("run_*"))) == 1
    assert sorted(p.name for p in pre.glob("*.pth.tar")) == [
        "checkpoint.pth.tar", "model_best.pth.tar"]
    ckpt = pre / "checkpoint.pth.tar"
    m = jax_load_state(ckpt)["model"]
    # 8 clips, 2 steps of a global batch of 4
    assert np.asarray(m["queue"]).shape == (128, 8)
    assert int(np.asarray(m["queue_ptr"])) == 0
    jax_load_encoder(ckpt, "s3dg")

    val = tmp_path / "validate"
    log = _cli_ranks("rspnet_tpu_torch.pretrain",
                     ["-e", str(val), *base[:3],
                      PRETRAIN_X[:-1] + ", parallel: {data: 1, model: 2}}",
                      *base[4:], "--validate", "--load-checkpoint",
                      str(ckpt)], "validate")
    assert "Mesh: rank 0 of {'data': 1, 'model': 2}" in log
    assert "Validate statistics: loss" in log
    assert not list(val.rglob("*.pth.tar"))

    ft = tmp_path / "finetune"
    log = _cli_ranks("rspnet_tpu_torch.finetune",
                     finetune_argv(ft, "", "--mc", str(ckpt)), "finetune")
    assert log.count("Final validate: acc1=") == 1     # rank 0 logs it
    assert len(list(ft.glob("run_*"))) == 1
    assert (ft / "checkpoint.pth.tar").exists()
    assert set(jax_load_state(ft / "checkpoint.pth.tar")["model"]) == {
        "params", "batch_stats"}
