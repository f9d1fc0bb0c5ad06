"""The pretrain engine's small options in the port against the JAX
package, on the CPU.

- ``framework/lr_schedule.py:build_optimizer`` with ``type: adam``: three
  f64 steps against ``optax.adam(lr, eps)`` as the JAX package builds it,
  a ``weight_decay`` in the config ignored by both, and ``set_opt_lr``
  between steps (atol 1e-14 / rtol 1e-12: the same formula in another
  order).
- An Adam run of the pretrain CLI saves its optimizer state and resumes
  it; an optax Adam state that the JAX package wrote still raises; an
  Adam finetune runs.
- The TensorBoard scalars of one pretrain epoch, through a fake
  tensorboardX, carry the JAX engine's names in its order, and the writer
  is closed.
- ``framework/code_pack.py:pack_code`` in a temporary git repository
  (the same ``code.tar.gz`` and ``dirty.patch`` bytes as the JAX
  package's) and outside one (a warning only).
"""
import logging
import subprocess
import sys
import tarfile
import types

import jax.numpy as jnp
import numpy as np
import optax
import torch

from rspnet_tpu.config import ConfigTree as JaxConfigTree
from rspnet_tpu.engines.pretrain import PretrainEngine as JaxEngine
from rspnet_tpu.engines.pretrain import _METER_KEYS as _JAX_METER_KEYS
from rspnet_tpu.framework import MeterGroup as JaxMeterGroup
from rspnet_tpu.framework import save_state as jax_save_state
from rspnet_tpu.framework.code_pack import pack_code as jax_pack_code
from rspnet_tpu.framework.lr_schedule import build_optimizer as jax_optimizer
from rspnet_tpu.framework.lr_schedule import set_opt_lr as jax_set_opt_lr
from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework import load_state
from rspnet_tpu_torch.framework.checkpoint import load_optimizer_state
from rspnet_tpu_torch.framework.code_pack import pack_code
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer, set_opt_lr
from tests.conftest import REPO_ROOT
from tests.test_step_parity import enable_x64
from tests.test_torch_pretrain import _argv
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)

ADAM = {"type": "adam", "lr": 1e-3, "eps": 1e-8, "schedule": "none",
        "weight_decay": 1e-4}
ADAM_X = (', optimizer: {type: "adam", lr: 1e-3, eps: 1e-8, '
          'schedule: "none", weight_decay: 1e-4}')


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    init = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) for s in shapes] for _ in range(3)]
    lrs = (1e-3, 1e-3, 5e-4)           # set_opt_lr before the third step
    with enable_x64():
        tx = jax_optimizer(JaxConfigTree.from_dict(ADAM), ADAM["lr"])
        params = [jnp.asarray(a) for a in init]
        state = tx.init(params)
        want = []
        for lr, g in zip(lrs, grads):
            state = jax_set_opt_lr(state, lr)
            updates, state = tx.update([jnp.asarray(a) for a in g], state,
                                       params)
            params = optax.apply_updates(params, updates)
            want.append([np.asarray(p) for p in params])
    ps = [torch.tensor(a, requires_grad=True) for a in init]
    opt = build_optimizer(ConfigTree.from_dict(ADAM), ps, ADAM["lr"])
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.0
    for step, (lr, g) in enumerate(zip(lrs, grads)):
        set_opt_lr(opt, lr)
        for p, a in zip(ps, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, w in zip(ps, want[step]):
            np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-14,
                                       rtol=1e-12, err_msg=f"step {step}")


def test_adam_run_saves_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    extra = ", device_geometry: true" + ADAM_X
    engine = pretrain.main(_argv(tmp_path / "a", extra))
    assert isinstance(engine.state.optimizer, torch.optim.Adam)
    ckpt = tmp_path / "a" / "checkpoint.pth.tar"
    saved = load_state(ckpt)["optimizer"]
    assert saved["param_groups"][0]["eps"] == 1e-8
    assert all(s["step"] == 3 for s in saved["state"].values())
    resumed = pretrain.main(_argv(tmp_path / "b", extra,
                                  "--load-checkpoint", str(ckpt)))
    got = resumed.state.optimizer.state_dict()
    assert got["param_groups"] == saved["param_groups"]
    assert got["state"].keys() == saved["state"].keys()
    for k, s in saved["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][k][name], s[name]), (k, name)

    # an optax Adam state written by the JAX package does not resume here
    path = tmp_path / "jax_adam.pth.tar"
    jax_save_state({"optimizer": optax.adam(1e-3).init(
        {"w": np.zeros(3, np.float32)})}, path)
    try:
        load_optimizer_state(resumed.state.optimizer,
                             load_state(path)["optimizer"], path)
    except ValueError as e:
        assert "optimizer state" in str(e)
    else:
        raise AssertionError("a JAX optax state was loaded")


def test_adam_reaches_finetune(tmp_path, monkeypatch):
    """The finetune engine builds its optimizer with the same
    ``build_optimizer``: an Adam finetune trains, validates and saves."""
    from rspnet_tpu_torch import finetune
    from tests.test_torch_finetune import finetune_argv
    monkeypatch.chdir(REPO_ROOT)
    engine, _ = finetune.main(finetune_argv(tmp_path, ADAM_X))
    assert isinstance(engine.optimizer, torch.optim.Adam)
    assert len(engine.step_times) == 2
    saved = load_state(tmp_path / "checkpoint.pth.tar")["optimizer"]
    assert all(s["step"] == 2 for s in saved["state"].values())


class _FakeWriter:
    """tensorboardX.SummaryWriter's calls, recorded."""

    def __init__(self, logdir=None):
        self.calls, self.closed = [], False
        _FakeWriter.last = self

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, step, float(value)))

    def close(self):
        self.closed = True


class _EmptyLoader(list):
    def set_epoch(self, epoch):
        pass


def test_tensorboard_scalars_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setitem(sys.modules, "tensorboardX", types.SimpleNamespace(
        SummaryWriter=_FakeWriter))
    engine = pretrain.main(_argv(tmp_path, ", device_geometry: true"))
    port = _FakeWriter.last
    assert port.closed and engine.writer is None

    # the JAX engine's train_epoch over an empty loader writes its scalars
    jax_self = types.SimpleNamespace(
        meters=JaxMeterGroup(_JAX_METER_KEYS),
        train_loader=_EmptyLoader(), summary_writer=_FakeWriter(),
        log_interval=10, debug=True,
        scheduler=types.SimpleNamespace(lr=0.1),
        state=types.SimpleNamespace(step=jnp.zeros(())))
    JaxEngine.train_epoch(jax_self, 1)
    want = [(tag, step) for tag, step, _ in jax_self.summary_writer.calls]
    assert [(tag, step) for tag, step, _ in port.calls] == want
    assert want[0][0] == "train/clips_per_sec" and len(want) == 10
    values = {tag: v for tag, _, v in port.calls}
    assert values["train/loss"] == engine.meters["loss"].avg
    # the epoch's lr, before the scheduler steps (as in JAX)
    assert values["train/lr"] == engine.scheduler.base_lr


def _git(repo, *args):
    subprocess.run(["git", "-c", "user.name=t", "-c", "user.email=t@t",
                    *args], cwd=repo, check=True, capture_output=True)


def test_pack_code_in_and_outside_a_git_repo(tmp_path, monkeypatch, caplog):
    repo = tmp_path / "repo"
    repo.mkdir()
    (repo / "a.py").write_text("x = 1\n")
    _git(repo, "init", "-q")
    _git(repo, "add", "a.py")
    _git(repo, "commit", "-q", "-m", "a")
    (repo / "a.py").write_text("x = 2\n")
    monkeypatch.chdir(repo)
    for name, fn in (("port", pack_code), ("jax", jax_pack_code)):
        (tmp_path / name).mkdir()
        fn(tmp_path / name)
    with tarfile.open(tmp_path / "port" / "code.tar.gz") as tar:
        assert tar.getnames() == ["a.py"]
        assert tar.extractfile("a.py").read() == b"x = 1\n"
    patch = (tmp_path / "port" / "dirty.patch").read_text()
    assert "-x = 1" in patch and "+x = 2" in patch
    for f in ("code.tar.gz", "dirty.patch"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f

    outside = tmp_path / "plain"
    outside.mkdir()
    monkeypatch.chdir(outside)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    with caplog.at_level(logging.WARNING):
        pack_code(outside)
    assert "pack_code failed" in caplog.text
