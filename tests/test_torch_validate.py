"""``--validate`` in the port: ``moco.step.eval_step`` against the JAX
``make_eval_step(..., axis_name=None)`` in f64, and the engine's
``validate_epoch`` through the CLI entry point on the CPU.

The eval step runs both encoders in eval mode (BN from the running
statistics) on the same state, inputs and draws (the permutation and speed
row the JAX step takes from its key), and returns the train step's metrics:
they agree at atol 1e-8 / rtol 1e-7, and nothing of the state changes (no
EMA, no BN statistics, no enqueue, no optimizer step; the encoders' modes
come back). The validate run loads a checkpoint, leaves the loaded state as
it was and writes no checkpoint.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MoCoConfig as JaxMoCoConfig
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.moco.builder import MoCoState as JaxState
from rspnet_tpu.moco.builder import make_eval_step
from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.moco import MoCoConfig, MoCoState
from rspnet_tpu_torch.moco.step import eval_step
from tests.conftest import REPO_ROOT
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64
from tests.test_torch_pretrain import _argv
from tests.test_torch_step import _port_model
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
B, T, S, DIM, K = 4, 16, 32, 8, 16


def _snapshot(state: MoCoState) -> dict:
    snap = {f"q.{k}": v.clone() for k, v in state.model_q.state_dict().items()}
    snap.update({f"k.{k}": v.clone()
                 for k, v in state.model_k.state_dict().items()})
    snap["queue"] = state.queue.clone()
    return snap


def test_eval_step_matches_jax_and_changes_nothing():
    with enable_x64():
        _run()


def _run():
    jmodel = JaxWrapper(encoder_factory=get_model_class("s3dg"),
                        num_classes=DIM, fc_type="linear", axis_name=None)
    rng = np.random.RandomState(0)
    variables = init(jmodel, (1, T // 2, S, S, 3))
    params_q = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape),
        np_tree(variables["params"]))
    params_k = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), params_q)
    # running statistics away from their init, so eval-mode BN normalizes
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)),
        np_tree(variables["batch_stats"]))
    queue = rng.randn(DIM, K)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    cfg = JaxMoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=(2,),
                        fc_type="linear", margin=2.0)
    state = JaxState(params_q=params_q, params_k=params_k,
                     batch_stats_q=stats, batch_stats_k=stats,
                     queue=jnp.asarray(queue),
                     queue_ptr=jnp.zeros((), jnp.int32), opt_state=None,
                     step=jnp.zeros((), jnp.int32))
    x_q = rng.randn(B, T, S, S, 3)
    x_k = rng.randn(B, T, S, S, 3)
    key = jax.random.PRNGKey(3)
    # make_eval_body's draws: the key itself goes to diff_speed_gather
    # (step_core.py:396-398, :181-205)
    key_perm, key_speed = jax.random.split(key)
    perm = np.array(jax.random.permutation(key_perm, B))
    speed_index = int(jax.random.randint(key_speed, (), 0, 1))
    jmetrics = jax.jit(make_eval_step(jmodel, cfg, axis_name=None))(
        state, jnp.asarray(x_q), jnp.asarray(x_k), key)

    model_q = _port_model(params_q, stats)
    model_k = _port_model(params_k, stats)
    model_k.eval()                      # the modes come back as they were
    pstate = MoCoState(model_q, model_k, torch.from_numpy(queue.copy()), 0,
                       None)
    before = _snapshot(pstate)
    metrics = eval_step(pstate, torch.from_numpy(x_q), torch.from_numpy(x_k),
                        MoCoConfig(dim=DIM, k=K, m=0.999, t=0.07),
                        perm=torch.from_numpy(perm), speed_index=speed_index)

    assert set(metrics) == set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # a non-trivial objective: the heads tell the clips apart
    assert 0.0 < float(metrics["loss_M"]) < 2 * cfg.margin
    after = _snapshot(pstate)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert pstate.queue_ptr == 0 and pstate.step == 0
    assert model_q.training and not model_k.training


def test_validate_loads_checkpoint_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    trained = pretrain.main(_argv(tmp_path / "train",
                                  ", device_geometry: true"))
    ckpt = tmp_path / "train" / "checkpoint.pth.tar"
    run = tmp_path / "validate"
    engine = pretrain.main(_argv(run, ", device_geometry: true",
                                 "--validate", "--load-checkpoint",
                                 str(ckpt)))
    assert sorted(engine.validation) == sorted(trained.meters.meters)
    assert all(math.isfinite(v) for v in engine.validation.values())
    assert engine.step_times == []
    assert not list(run.rglob("*.pth.tar"))
    s, t = engine.state, trained.state
    assert s.queue_ptr == t.queue_ptr and s.step == t.step
    assert torch.equal(s.queue, t.queue)
    for a, b in ((s.model_q, t.model_q), (s.model_k, t.model_k)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sb)
