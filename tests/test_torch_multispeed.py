"""Exact multi-speed training and packed frames in the port against the
JAX package, on the CPU.

- ``packed_frame_subset`` (exact and pinned unions) and
  ``speed_index_sets`` equal rspnet_tpu/moco/step_core.py's over several
  ``(T, speeds)``.
- ``diff_speed_gather`` on packed input for each single-speed branch of
  ``speed_branch_config`` (``pack_speeds``: the exact union), and on the
  pinned union of one speed, bit-equal to JAX's when fed JAX's
  permutation and speed.
- Two f64 train steps on one state, speed 4 and then speed 2 (T_real = 4,
  then 8, from an 11-frame packed input of a 16-frame window), against
  the JAX ``make_variable_speed_train_steps`` on a one-device mesh, with
  the JAX steps' permutations injected: params, BN statistics, queue,
  pointer and metrics after each step at atol 1e-8 / rtol 1e-7
  (tests/test_torch_step.py's tolerances). The encoder is TSM on
  resnet18 (tests/test_torch_tsm_step.py), whose T rides the input, so
  both clip lengths run at a fraction of S3D-G's f64 cost; the branches
  are arch-independent.
- The engine's speed sequence against the JAX engine's ``_draw_speed``
  (seed + 0x5BEE: 4, 2, 2 with seed 0), and the pretrain CLI with
  ``diff_speed: [4, 2]`` and ``packed_frames``: training, and
  ``--validate`` from its checkpoint, both speeds drawn in each; and
  ``packed_frames`` alone.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rspnet_tpu.engines.pretrain import PretrainEngine as JaxEngine
from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MoCoConfig as JaxMoCoConfig
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.moco import step_core
from rspnet_tpu.moco.builder import MoCoState as JaxState
from rspnet_tpu.moco.builder import make_variable_speed_train_steps
from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.engines.pretrain import PretrainEngine
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
from rspnet_tpu_torch.moco import MoCoConfig, MoCoState
from rspnet_tpu_torch.moco import step as tstep
from tests.conftest import REPO_ROOT
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64
from tests.test_torch_step import ATOL, RTOL, _assert_model, _port_model
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)

SPEEDS = (4, 2)


@pytest.mark.parametrize("T,speeds", [(16, (4, 2)), (64, (4, 2)),
                                      (32, (2,)), (32, (2, 4)),
                                      (30, (3, 2)), (48, (8, 4, 2))])
@pytest.mark.parametrize("exact", [True, False])
def test_packed_frame_subset_matches_jax(T, speeds, exact):
    np.testing.assert_array_equal(
        tstep.packed_frame_subset(T, speeds, exact),
        step_core.packed_frame_subset(T, speeds, exact))
    np.testing.assert_array_equal(
        tstep.speed_index_sets(T, speeds),
        np.asarray(step_core.speed_index_sets(T, speeds)))


def test_packed_union_of_the_leg():
    """The slice's leg: 64 loaded frames, diff_speed [4, 2]: 48 packed."""
    assert len(tstep.packed_frame_subset(64, SPEEDS, exact=True)) == 48


def _jax_draws(key, B):
    """The permutation and speed index a JAX step draws from ``key``
    (step_core.py:314-315, :181-205)."""
    key_perm, key_speed = jax.random.split(key)
    perm = np.array(jax.random.permutation(key_perm, B))
    return perm, key_speed


@pytest.mark.parametrize("speeds,branch", [(SPEEDS, 4), (SPEEDS, 2),
                                           ((2,), None)])
def test_diff_speed_gather_packed_matches_jax(speeds, branch):
    T, B = 16, 4
    jcfg = JaxMoCoConfig(diff_speed=speeds, packed_frames=True, t_load=T)
    pcfg = MoCoConfig(diff_speed=speeds, packed_frames=True, t_load=T)
    if branch is not None:
        jcfg = step_core.speed_branch_config(jcfg, branch)
        pcfg = tstep.speed_branch_config(pcfg, branch)
        assert pcfg.diff_speed == jcfg.diff_speed == (branch,)
        assert pcfg.pack_speeds == jcfg.pack_speeds == speeds
    P = len(step_core.packed_frame_subset(T, speeds, exact=len(speeds) > 1))
    rng = np.random.default_rng(0)
    q = rng.random((B, P, 2, 2, 3), np.float32)
    k = rng.random((B, P, 2, 2, 3), np.float32)
    key = jax.random.PRNGKey(3)
    ref = step_core.diff_speed_gather(jnp.asarray(q), jnp.asarray(k), key,
                                      jcfg)
    perm, key_speed = _jax_draws(key, B)
    s_idx = int(jax.random.randint(key_speed, (), 0, len(jcfg.diff_speed)))
    out = tstep.diff_speed_gather(torch.from_numpy(q), torch.from_numpy(k),
                                  pcfg, perm=torch.from_numpy(perm),
                                  speed_index=s_idx)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[0].shape[1] == 16 // max(pcfg.diff_speed)


def test_two_speed_train_steps_match_jax():
    with enable_x64():
        _two_speed_steps()


def _two_speed_steps():
    B, T, S, DIM, K = 4, 16, 32, 8, 16
    model_cfg = {"base_model": "resnet18"}
    jmodel = JaxWrapper(encoder_factory=get_model_class("tsm", **model_cfg),
                        num_classes=DIM, axis_name=None)
    rng = np.random.RandomState(0)
    variables = init(jmodel, (1, 4, S, S, 3))
    params_q = np_tree(variables["params"])
    params_k = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), params_q)
    stats = np_tree(variables["batch_stats"])
    queue = rng.randn(DIM, K)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)

    cfg = JaxMoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=SPEEDS,
                        packed_frames=True, t_load=T)
    optimizer = optax.chain(optax.add_decayed_weights(1e-4),
                            optax.sgd(0.05, momentum=0.9))
    # the sharded step donates its state: no buffer twice
    state = JaxState(params_q=params_q, params_k=params_k,
                     batch_stats_q=stats,
                     batch_stats_k=jax.tree_util.tree_map(np.copy, stats),
                     queue=jnp.asarray(queue),
                     queue_ptr=jnp.zeros((), jnp.int32),
                     opt_state=jax.jit(optimizer.init)(params_q),
                     step=jnp.zeros((), jnp.int32))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    steps = make_variable_speed_train_steps(jmodel, optimizer, cfg, mesh)

    model_q = _port_model(params_q, stats, "tsm", model_cfg)
    model_k = _port_model(params_k, stats, "tsm", model_cfg)
    for p in model_k.parameters():
        p.requires_grad_(False)
    opt = build_optimizer(ConfigTree.from_dict(
        {"lr": 0.05, "momentum": 0.9, "dampening": 0, "nesterov": False,
         "weight_decay": 1e-4}), model_q.parameters(), 0.05)
    pstate = MoCoState(model_q, model_k, torch.from_numpy(queue.copy()), 0,
                       opt)
    pcfg = MoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=SPEEDS,
                      packed_frames=True, t_load=T)
    P = len(tstep.packed_frame_subset(T, SPEEDS, exact=True))
    for i, speed in enumerate((4, 2)):
        x_q = rng.randn(B, P, S, S, 3)
        x_k = rng.randn(B, P, S, S, 3)
        key = jax.random.PRNGKey(7 + i)
        # the 1-D layout folds in the replica index (builder.py:121)
        rng_speed, _ = jax.random.split(jax.random.fold_in(key, 0))
        perm, _ = _jax_draws(rng_speed, B)
        metrics = tstep.train_step(
            pstate, torch.from_numpy(x_q), torch.from_numpy(x_k),
            tstep.speed_branch_config(pcfg, speed),
            perm=torch.from_numpy(perm), speed_index=0)
        state, jmetrics = steps[speed](state, jnp.asarray(x_q),
                                       jnp.asarray(x_k), key)
        for name, ref in jmetrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(ref),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"speed {speed}: {name}")
        _assert_model(pstate.model_q, state.params_q, state.batch_stats_q,
                      f"encoder q, speed {speed}", "tsm")
        _assert_model(pstate.model_k, state.params_k, state.batch_stats_k,
                      f"encoder k, speed {speed}", "tsm")
        np.testing.assert_allclose(pstate.queue.numpy(),
                                   np.asarray(state.queue), atol=ATOL,
                                   rtol=RTOL)
        assert pstate.queue_ptr == int(state.queue_ptr) == (i + 1) * B % K


def test_speed_draws_match_jax_engine():
    seed = 0
    jax_self = types.SimpleNamespace(
        moco_cfg=JaxMoCoConfig(diff_speed=SPEEDS),
        _speed_rng=np.random.default_rng(seed + 0x5BEE))
    want = [JaxEngine._draw_speed(jax_self) for _ in range(20)]
    port_self = types.SimpleNamespace(
        moco_cfg=MoCoConfig(diff_speed=SPEEDS),
        speed_rng=np.random.default_rng(seed + 0x5BEE), speeds=[])
    cfgs = [PretrainEngine._step_config(port_self) for _ in range(20)]
    assert port_self.speeds == want and want[:3] == [4, 2, 2]
    assert [c.diff_speed for c in cfgs] == [(s,) for s in want]


MULTI = (", device_geometry: true, moco+: {k: 8, diff_speed: [4, 2], "
         "packed_frames: true}")


def test_cli_multi_speed_packed_then_validate(tmp_path, monkeypatch):
    from tests.test_torch_pretrain import _argv
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path / "train", MULTI))
    # _size 8 at the fastest speed 4: a 32-frame window, 24 frames packed
    assert engine.cfg.get_int("temporal_transforms.size") == 32
    np.testing.assert_array_equal(
        engine.train_loader.cfg.frame_subset,
        step_core.packed_frame_subset(32, SPEEDS, exact=True))
    assert engine.speeds == [4, 2, 2] and len(engine.step_times) == 3
    assert np.isfinite(engine.meters["loss"].avg)
    ckpt = tmp_path / "train" / "checkpoint.pth.tar"
    val = pretrain.main(_argv(tmp_path / "val", MULTI, "--validate",
                              "--load-checkpoint", str(ckpt)))
    assert val.speeds == [4, 2, 2]
    assert all(np.isfinite(v) for v in val.validation.values())


def test_cli_packed_frames_one_speed(tmp_path, monkeypatch):
    """``packed_frames`` with the default ``diff_speed: [2]``: a 16-frame
    window, the pinned union of 12 frames shipped, no speed drawn."""
    from tests.test_torch_pretrain import _argv
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path, ", device_geometry: true, "
                                 "moco+: {k: 8, packed_frames: true}"))
    np.testing.assert_array_equal(engine.train_loader.cfg.frame_subset,
                                  step_core.packed_frame_subset(16, (2,)))
    assert engine.speeds == [] and len(engine.step_times) == 3
    assert np.isfinite(engine.meters["loss"].avg)
