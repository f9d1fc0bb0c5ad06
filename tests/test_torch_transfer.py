"""Checkpoints that both packages read, and ``--mc`` transfer.

- ``models/convert.py`` both ways: ``state_dict_to_variables`` inverts
  ``variables_to_state_dict`` exactly for the bare S3D-G, the pretraining
  wrapper and the finetuning one, and gives the JAX modules' own tree
  structure.
- A pretrain file that the JAX package's ``save_state`` wrote (with its
  optax state) loads into the port: ``load_pretrained_encoder`` (``--mc``)
  and ``PretrainEngine.load_checkpoint(model_only=True)`` give weights
  equal to the JAX trees; the optax state comes back as foreign objects
  and a full resume raises.
- A pretrain file that the port wrote, read through the JAX package's
  ``load_state`` and ``load_pretrained_encoder``: the JAX trees equal the
  port's weights, in the JAX modules' tree structure.
- A finetune file that the port wrote, loaded by the JAX package's
  ``FinetuneEngine.load_model_only``: the JAX model gives the port's
  logits (f64, atol 1e-8 / rtol 1e-7). A JAX-written finetune file loads
  into the port (``load_model_only``) with equal weights; a full resume
  of it raises.
- A flat reference-style ``encoder_q.encoder.*`` dict loads in both
  packages to the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.config import ConfigTree as JaxConfigTree
from rspnet_tpu.engines.classifier import TrainState
from rspnet_tpu.engines.finetune import FinetuneEngine as JaxFinetuneEngine
from rspnet_tpu.engines.transfer import \
    load_pretrained_encoder as jax_load_encoder
from rspnet_tpu.framework.checkpoint import load_state as jax_load_state
from rspnet_tpu.framework.checkpoint import save_state as jax_save_state
from rspnet_tpu.framework.lr_schedule import \
    build_optimizer as jax_build_optimizer
from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.engines import classifier
from rspnet_tpu_torch.engines import finetune as ft_engine
from rspnet_tpu_torch.engines.pretrain import PretrainEngine
from rspnet_tpu_torch.engines.transfer import (load_pretrained_encoder,
                                               merge_encoder_into)
from rspnet_tpu_torch.framework import bootstrap, load_state
from rspnet_tpu_torch.framework.checkpoint import ForeignObject
from rspnet_tpu_torch.models import convert
from rspnet_tpu_torch.models.s3dg import S3DG
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.conftest import REPO_ROOT
from tests.jax_models import init, jit_apply
from tests.test_step_parity import enable_x64
from tests.test_torch_finetune import finetune_argv
from tests.test_torch_pretrain import _argv as pretrain_argv
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
T, S, DIM, K, C = 8, 32, 128, 8, 4


@pytest.fixture(scope="module")
def jax_vars():
    """f32 numpy variables of the JAX pretraining and finetuning wrappers,
    moved off their init."""
    rng = np.random.RandomState(0)

    def moved(v):
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.1 * np.abs(rng.randn(*a.shape))
                       ).astype(np.float32), v)

    s3dg = get_model_class("s3dg")
    pre = init(JaxWrapper(encoder_factory=s3dg, num_classes=DIM,
                          axis_name=None), (1, T, S, S, 3))
    fine = init(JaxWrapper(encoder_factory=s3dg, num_classes=C,
                           finetune=True, axis_name=None), (1, T, S, S, 3))
    return {"pretrain": {k: moved(v) for k, v in pre.items()},
            "finetune": {k: moved(v) for k, v in fine.items()}}


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_state_equal(got: dict, want: dict):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
def test_conversion_round_trip(jax_vars, layout):
    v = jax_vars["finetune" if layout == "finetune" else "pretrain"]
    if layout == "backbone":
        v = {"params": v["params"]["encoder"],
             "batch_stats": v["batch_stats"]["encoder"]}
    sd = convert.variables_to_state_dict(v)
    back = convert.state_dict_to_variables(sd)
    _same_tree(back, {"params": v["params"],
                      "batch_stats": v["batch_stats"]})
    model = {"backbone": lambda: S3DG(),
             "pretrain": lambda: MultiTaskWrapper(S3DG(), DIM),
             "finetune": lambda: MultiTaskWrapper(S3DG(), C,
                                                  finetune=True)}[layout]()
    convert.load_converted(model, sd)
    again = convert.variables_to_state_dict(
        convert.state_dict_to_variables(model.state_dict()))
    _assert_state_equal(again, model.state_dict())
    with pytest.raises(KeyError):
        convert.state_dict_to_variables({**model.state_dict(),
                                         "extra.weight": torch.zeros(1)})


def _jax_pretrain_file(path, v):
    rng = np.random.RandomState(1)
    opt = jax_build_optimizer(JaxConfigTree.from_dict(
        {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}), 0.1)
    queue = rng.randn(DIM, K).astype(np.float32)
    params_k = jax.tree_util.tree_map(lambda a: a + 0.5, v["params"])
    jax_save_state({
        "epoch": 3, "arch": "s3dg",
        "model": {"params_q": v["params"], "params_k": params_k,
                  "batch_stats_q": v["batch_stats"],
                  "batch_stats_k": v["batch_stats"], "queue": queue,
                  "queue_ptr": np.asarray(2, np.int32)},
        "best_loss": 1.5, "optimizer": jax.jit(opt.init)(v["params"]),
        "scheduler": {"epoch": 3, "lr": 0.1, "base_lr": 0.1}}, path)
    return params_k, queue


def test_jax_pretrain_checkpoint_loads_into_port(jax_vars, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    v = jax_vars["pretrain"]
    path = tmp_path / "jax_pretrain.pth.tar"
    params_k, queue = _jax_pretrain_file(path, v)
    enc = {"params": v["params"]["encoder"],
           "batch_stats": v["batch_stats"]["encoder"]}
    want_enc = convert.variables_to_state_dict(enc)

    got = load_pretrained_encoder(path, "s3dg")
    assert sorted(got) == sorted(want_enc)
    _assert_state_equal(got, want_enc)
    model = MultiTaskWrapper(S3DG(), C, finetune=True)
    fc = model.fc.weight.detach().clone()
    merge_encoder_into(model, got)
    _assert_state_equal(model.encoder.state_dict(), want_enc)
    assert torch.equal(model.fc.weight, fc)

    ckpt = load_state(path)
    # optax's state, rebuilt without importing optax
    assert isinstance(ckpt["optimizer"], ForeignObject)
    assert ckpt["optimizer"].foreign_module.startswith("optax")
    engine = PretrainEngine(*bootstrap(pretrain_argv(tmp_path / "run")))
    engine.load_checkpoint(path, model_only=True)
    s = engine.state
    _assert_state_equal(s.model_q.state_dict(),
                        convert.variables_to_state_dict(v))
    _assert_state_equal(s.model_k.state_dict(),
                        convert.variables_to_state_dict(
                            {"params": params_k,
                             "batch_stats": v["batch_stats"]}))
    np.testing.assert_array_equal(s.queue.numpy(), queue)
    assert s.queue_ptr == 2
    with pytest.raises(ValueError, match="optimizer state"):
        engine.load_checkpoint(path)


def test_port_pretrain_checkpoint_read_by_jax(jax_vars, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(pretrain_argv(tmp_path, ", device_geometry: true"))
    path = tmp_path / "checkpoint.pth.tar"
    params, stats = jax_load_encoder(path, "s3dg")
    _assert_state_equal(
        convert.variables_to_state_dict({"params": params,
                                         "batch_stats": stats}),
        engine.state.model_q.encoder.state_dict())
    m = jax_load_state(path)["model"]
    ref = jax_vars["pretrain"]
    for which in ("q", "k"):
        assert (jax.tree_util.tree_structure(m[f"params_{which}"])
                == jax.tree_util.tree_structure(ref["params"]))
        assert (jax.tree_util.tree_structure(m[f"batch_stats_{which}"])
                == jax.tree_util.tree_structure(ref["batch_stats"]))
    _assert_state_equal(
        convert.variables_to_state_dict({"params": m["params_k"],
                                         "batch_stats": m["batch_stats_k"]}),
        engine.state.model_k.state_dict())
    assert m["queue_ptr"].shape == () and m["queue_ptr"].dtype == np.int32
    assert int(m["queue_ptr"]) == engine.state.queue_ptr
    np.testing.assert_array_equal(m["queue"], engine.state.queue.numpy())


def _jax_finetune_engine(mesh):
    """The JAX engine's loading methods on a bare engine object."""
    eng = JaxFinetuneEngine.__new__(JaxFinetuneEngine)
    eng.state = TrainState(None, None, None, 0)
    eng.mesh = mesh
    return eng


def test_finetune_checkpoints_cross_packages(jax_vars, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    port = ft_engine.FinetuneEngine(*bootstrap(finetune_argv(tmp_path /
                                                             "port")))
    convert.load_variables(port.model, jax_vars["finetune"])
    port.model.double()
    port.save_checkpoint(1, is_best=True)
    path = tmp_path / "port" / "model_best.pth.tar"
    x = np.random.RandomState(2).randn(2, T, S, S, 3)
    with enable_x64():
        eng = _jax_finetune_engine(mesh)
        eng.load_model_only(path)
        jm = JaxWrapper(encoder_factory=get_model_class("s3dg"),
                        num_classes=C, finetune=True, axis_name=None)
        ref = np.asarray(jit_apply(jm)({"params": eng.state.params,
                                        "batch_stats": eng.state.batch_stats},
                                       jnp.asarray(x)))
    port.model.eval()
    with torch.no_grad():
        logits = classifier.classify(port.model, torch.from_numpy(x))
    assert ref.dtype == np.float64 and logits.dtype == torch.float64
    np.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=RTOL)

    # a JAX-written finetune file into the port
    v = jax_vars["finetune"]
    opt = jax_build_optimizer(JaxConfigTree.from_dict(
        {"lr": 0.005, "momentum": 0.9, "weight_decay": 1e-4}), 0.005)
    jpath = tmp_path / "jax_finetune.pth.tar"
    jax_save_state({"epoch": 2, "arch": "s3dg", "model": v,
                    "best_acc1": 10.0,
                    "optimizer": jax.jit(opt.init)(v["params"]),
                    "scheduler": {"epoch": 2, "lr": 0.005,
                                  "base_lr": 0.005}}, jpath)
    other = ft_engine.FinetuneEngine(*bootstrap(finetune_argv(tmp_path /
                                                              "other")))
    other.load_model_only(jpath)
    _assert_state_equal(other.model.state_dict(),
                        convert.variables_to_state_dict(v))
    with pytest.raises(ValueError, match="optimizer state"):
        other.load_checkpoint(jpath)


def test_reference_flat_dict_loads_in_both(tmp_path):
    torch.manual_seed(3)
    enc = S3DG()
    with torch.no_grad():
        for name, b in enc.named_buffers():
            if not name.endswith("num_batches_tracked"):
                b.add_(torch.rand(b.shape))
    sd = enc.state_dict()
    flat = {f"encoder_q.encoder.{k}": v for k, v in sd.items()}
    head = MultiTaskWrapper(S3DG(), DIM)
    flat.update({f"encoder_q.{k}": v for k, v in head.state_dict().items()
                 if k.startswith("fc")})
    flat.update({f"encoder_k.encoder.{k}": v + 1.0 for k, v in sd.items()
                 if v.is_floating_point()})
    flat["queue"] = torch.randn(DIM, K)
    path = tmp_path / "reference.pth.tar"
    torch.save({"epoch": 5, "arch": "s3dg", "model": flat}, path)

    got = load_pretrained_encoder(path, "s3dg")
    assert sorted(got) == sorted(sd)
    _assert_state_equal(got, sd)
    params, stats = jax_load_encoder(path, "s3dg")
    _assert_state_equal(convert.variables_to_state_dict(
        {"params": params, "batch_stats": stats}), sd)
