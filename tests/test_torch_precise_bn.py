"""Precise-BN in the port (``engines/precise_bn.py``) against the JAX
package's ``recalibrate_batch_stats`` on a one-device CPU mesh, f64, and
the guards of the three F6 faults (ROADMAP.md §3), each a stated
deviation from the JAX package with its own test.

- Parity: three calibration batches through the multitask S3D-G; every
  BN's running mean and variance (the mean of the batch means and of the
  unbiased batch variances) at atol 1e-8 / rtol 1e-7; the parameters, the
  momenta, the batch counters and the model's mode as they were.
- F6, precise_bn.py:79: a BN that no calibration forward runs keeps its
  statistics (JAX's recovery turns such a leaf into mean 0 and var 0).
- F6, precise_bn.py:55: ``SubBatchNorm`` raises ``NotImplementedError``;
  a multi-process group runs (its BNs reduce over the group).
- F6, finetune.py:240: when recalibration raises, the engine's loader
  generator is closed and every BN keeps its statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rspnet_tpu.engines.precise_bn import recalibrate_batch_stats
from rspnet_tpu_torch.engines import finetune as ft_engine
from rspnet_tpu_torch.engines.precise_bn import recalibrate_bn_stats
from rspnet_tpu_torch.framework import bootstrap
from rspnet_tpu_torch.models import convert
from tests.conftest import REPO_ROOT
from tests.test_step_parity import enable_x64
from tests.test_torch_finetune import (S, T, finetune_argv, jax_variables,
                                       port_classifier)

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7


class Closing:
    """An iterable of batches that records whether it was closed."""

    def __init__(self, batches):
        self.batches = batches
        self.closed = False

    def __iter__(self):
        return iter(self.batches)

    def close(self):
        self.closed = True


def _bn_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_precise_bn_matches_jax():
    rng = np.random.RandomState(0)
    batches = [rng.randn(2, T, S, S, 3) for _ in range(3)]
    with enable_x64():
        jm, params, stats = jax_variables(rng)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        new_stats = recalibrate_batch_stats(
            jm, mesh, params, stats, (jnp.asarray(b) for b in batches),
            jax.random.PRNGKey(1))
        net = port_classifier(params, stats)
    net.eval()
    before = _bn_state(net)
    momenta = [m.momentum for m in net.modules()
               if isinstance(m, nn.BatchNorm3d)]
    src = Closing([torch.from_numpy(b) for b in batches])
    assert recalibrate_bn_stats(net, src) == 3
    assert src.closed and not net.training

    want = convert.variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, new_stats)})
    after = net.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
    assert len(stat_keys) > 100
    for k in stat_keys:
        np.testing.assert_allclose(after[k].numpy(), want[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
        assert not torch.equal(after[k], before[k]), k
    for k, v in before.items():
        if k not in stat_keys:
            assert torch.equal(after[k], v), k
    assert momenta == [m.momentum for m in net.modules()
                       if isinstance(m, nn.BatchNorm3d)]


class TwoBN(nn.Module):
    """One BN that the forward runs and one that it never runs."""

    def __init__(self):
        super().__init__()
        self.used = nn.BatchNorm3d(3)
        self.unused = nn.BatchNorm3d(3)
        for bn in (self.used, self.unused):
            bn.running_mean.fill_(0.5)
            bn.running_var.fill_(2.0)

    def forward(self, x):
        return self.used(x)


def test_unused_bn_keeps_its_statistics():
    """F6, rspnet_tpu/engines/precise_bn.py:79."""
    model = TwoBN()
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 3, 2, 5, 5, generator=gen) * 3 + 1
          for _ in range(2)]
    assert recalibrate_bn_stats(model, xs) == 2
    np.testing.assert_array_equal(model.unused.running_mean.numpy(),
                                  np.full(3, 0.5, np.float32))
    np.testing.assert_array_equal(model.unused.running_var.numpy(),
                                  np.full(3, 2.0, np.float32))
    means = torch.stack([x.mean(dim=(0, 2, 3, 4)) for x in xs]).mean(0)
    vars_ = torch.stack([x.transpose(0, 1).reshape(3, -1).var(dim=1)
                         for x in xs]).mean(0)
    torch.testing.assert_close(model.used.running_mean, means)
    torch.testing.assert_close(model.used.running_var, vars_)


class SubBatchNorm(nn.Module):
    """Stands in for SlowFast's per-replica BN (rspnet_tpu/models/common.py
    SubBatchNorm)."""

    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm3d(3)

    def forward(self, x):
        return self.bn(x)


def test_sub_batch_norm_and_process_groups_raise(monkeypatch):
    """F6, rspnet_tpu/engines/precise_bn.py:55: ``SubBatchNorm`` raises. A
    multi-process group no longer does: each BN takes its moments over
    its group (pinned against the JAX package by
    tests/test_torch_ddp_finetune.py)."""
    src = Closing([torch.zeros(2, 3, 1, 2, 2)])
    with pytest.raises(NotImplementedError, match="SubBatchNorm"):
        recalibrate_bn_stats(nn.Sequential(SubBatchNorm()), src)
    assert src.closed
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert recalibrate_bn_stats(TwoBN(), [torch.zeros(2, 3, 1, 2, 2)]) == 1


class FakeLoader:
    """A train loader whose iterators record being closed."""

    def __init__(self, cfg, batch):
        self.cfg = cfg
        self.batch = batch
        self.open = 0
        self.closed = 0

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 4

    def __iter__(self):
        self.open += 1
        try:
            for _ in range(4):
                yield self.batch
        finally:
            self.closed += 1


def test_engine_closes_loader_when_recalibration_raises(tmp_path,
                                                        monkeypatch):
    """F6, rspnet_tpu/engines/finetune.py:240."""
    monkeypatch.chdir(REPO_ROOT)
    engine = ft_engine.FinetuneEngine(*bootstrap(finetune_argv(
        tmp_path, ", bn_recalibrate: 3")))
    batch = next(iter(engine.train_loader))
    engine.train_loader = FakeLoader(engine.train_loader.cfg, batch)
    before = _bn_state(engine.model)
    rng_state = engine.rng.bit_generator.state
    calls = []
    forward = engine.model.forward

    def failing(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return forward(x)

    monkeypatch.setattr(engine.model, "forward", failing)
    with pytest.raises(RuntimeError, match="device fault"):
        engine.recalibrate_bn()
    loader = engine.train_loader
    assert loader.open == 1 and loader.closed == 1
    after = engine.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert engine.rng.bit_generator.state == rng_state
    # and without the fault, the calibration runs over 3 batches
    monkeypatch.setattr(engine.model, "forward", forward)
    engine.recalibrate_bn()
    assert loader.closed == loader.open == 2
