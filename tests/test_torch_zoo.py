"""The port's C3D and 3-D ResNets (rspnet_tpu_torch/models) against the
JAX package's, f64 on the CPU.

- Forward parity of the bare backbones with their classifier, in train
  mode (the output and every updated BN statistic) and in eval mode, at
  atol 1e-8 / rtol 1e-7, for ``c3d``, ``resnet18`` with shortcut B and A,
  and a ``ResNet3D(block=Bottleneck, layers=(1, 1, 1, 1))`` built the same
  way in both packages, standing in for the 50+ family. Input
  [2, 8, 32, 32, 3], the archs' own widths; weights from the JAX init,
  scaled off it, and carried over by ``models/convert.py``. Float64 on
  both sides (jax_enable_x64 and torch.double), as tests/test_step_parity.py
  does.
- ``models/convert.py`` both ways for each arch, as a bare backbone, a
  pretraining wrapper and a finetuning one: JAX variables -> state_dict ->
  the port's module -> state_dict -> variables gives back the same tree,
  leaf for leaf (the JAX modules' own structure).
- The registry: every ported arch builds, with the JAX package's
  ``feature_dim`` (TSM with its default resnet50 base); another raises
  naming ROADMAP.md.

The MoCo step on C3D is in tests/test_torch_zoo_step.py, the bf16 blocks
in tests/test_torch_zoo_bf16.py (each file within its time budget), the
pool gradient at C3D's and ResNet's geometries in tests/test_torch_ops.py.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.models.resnet3d import Bottleneck as JaxBottleneck
from rspnet_tpu.models.resnet3d import ResNet3D as JaxResNet3D
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.models.resnet3d import Bottleneck, ResNet3D
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.test_step_parity import enable_x64

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
T, S, NC, DIM = 8, 32, 5, 8
# the stand-in for resnet50+ has its own layer counts, so its own mapping
BOTTLENECK = "resnet_bottleneck_1111"

# name -> (mapping arch, JAX factory, port factory); factories take
# (num_classes=..., with_classifier=..., [dtype=...]) as the wrappers call
# them
ARCHS = {
    "c3d": ("c3d", jax_model_class("c3d"), get_model_class("c3d")),
    "resnet18_B": ("resnet18", jax_model_class("resnet18"),
                   get_model_class("resnet18")),
    "resnet18_A": ("resnet18",
                   functools.partial(jax_model_class("resnet18"),
                                     shortcut_type="A"),
                   functools.partial(get_model_class("resnet18"),
                                     shortcut_type="A")),
    "bottleneck": (BOTTLENECK,
                   functools.partial(JaxResNet3D, block=JaxBottleneck,
                                     layers=(1, 1, 1, 1)),
                   functools.partial(ResNet3D, block=Bottleneck,
                                     layers=(1, 1, 1, 1))),
}


@pytest.fixture(scope="module", autouse=True)
def release_jax_memory():
    """Drop this module's compiled JAX programs when it ends: the suite's
    workers run many files each, and the f64 zoo programs are large."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def bottleneck_mapping(monkeypatch):
    monkeypatch.setitem(convert.KEY_MAPPERS, BOTTLENECK,
                        lambda: convert._resnet_mapping((1, 1, 1, 1), True))


def _np(tree, dtype=np.float64):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _random_variables(jm, rng, dtype):
    """Variables in the structure of the JAX module's init, drawn here
    (``jax.eval_shape``: nothing is compiled): kernels at unit fan-in
    variance, BN scale, bias and statistics off 1 and 0."""
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, T, S, S, 3), jnp.float32),
                        train=False))

    def draw(path, a):
        leaf = path[-1].key
        x = rng.standard_normal(a.shape, dtype)
        if leaf == "kernel":
            x *= 1 / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf in ("scale", "var"):
            x = 1 + 0.1 * np.abs(x)
        else:
            x *= 0.1
        return x
    return {coll: jax.tree_util.tree_map_with_path(draw, shapes[coll])
            for coll in ("params", "batch_stats")}


def _port(net):
    return net.double().to(memory_format=torch.channels_last_3d)


def backbone_forward_parity(jm, net, arch, x, seed=0):
    """``jm`` (JAX) and ``net`` (port, with its classifier) on ``x`` in
    train mode (the output and every updated BN statistic) and eval mode,
    f64, with variables drawn in ``jm``'s structure; returns the port's
    module."""
    v = _random_variables(jm, np.random.default_rng(seed), np.float64)
    with enable_x64():
        @jax.jit
        def run(variables, xb):
            out, mut = jm.apply(variables, xb, train=True,
                                mutable=["batch_stats"])
            return out, mut["batch_stats"], jm.apply(variables, xb,
                                                     train=False)

        out_j, stats_j, eval_j = run(v, jnp.asarray(x))

    net = _port(net)
    convert.load_converted(net, convert.variables_to_state_dict(v, arch))
    net.eval()
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(eval_j), atol=ATOL, rtol=RTOL)
    net.train()
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(out_j), atol=ATOL, rtol=RTOL)
    want = convert.variables_to_state_dict(
        {"params": v["params"], "batch_stats": _np(stats_j)}, arch)
    buffers = dict(net.named_buffers())
    stats = [k for k in want if k in buffers]
    assert len(stats) == 2 * sum(isinstance(
        m, torch.nn.modules.batchnorm._BatchNorm) for m in net.modules())
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), want[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    return net


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_backbone_forward_matches_jax(name):
    arch, jax_factory, port_factory = ARCHS[name]
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    backbone_forward_parity(jax_factory(num_classes=NC),
                            port_factory(num_classes=NC,
                                         with_classifier=True), arch, x)


def layout_modules(layout, jax_factory, port_factory):
    """(JAX module, port module) of a bare backbone with its classifier,
    a pretraining wrapper or a finetuning one."""
    if layout == "backbone":
        return (jax_factory(num_classes=NC),
                port_factory(num_classes=NC, with_classifier=True))
    if layout == "finetune":
        return (JaxWrapper(encoder_factory=jax_factory, num_classes=NC,
                           finetune=True, axis_name=None),
                MultiTaskWrapper(port_factory(), NC, finetune=True))
    return (JaxWrapper(encoder_factory=jax_factory, num_classes=DIM,
                       axis_name=None),
            MultiTaskWrapper(port_factory(), DIM))


def round_trip(arch, jm, module):
    """Random f32 variables of ``jm`` -> state_dict -> ``module`` ->
    state_dict -> variables: the same tree back, leaf for leaf."""
    v = _random_variables(jm, np.random.default_rng(1), np.float32)
    convert.load_converted(module, convert.variables_to_state_dict(v, arch))
    back = convert.state_dict_to_variables(module.state_dict(), arch)
    la, ta = jax.tree_util.tree_flatten(v)
    lb, tb = jax.tree_util.tree_flatten(back)
    assert ta == tb
    for a, b in zip(la, lb):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_conversion_round_trip(name, layout):
    arch, jax_factory, port_factory = ARCHS[name]
    round_trip(arch, *layout_modules(layout, jax_factory, port_factory))


@pytest.mark.parametrize("arch", ["c3d", "resnet10", "resnet18", "resnet34",
                                  "resnet50", "resnet101", "resnet152",
                                  "resnet200", "s3dg", "s3d", "r2plus1d-vcop",
                                  "r2plus1d-18", "tsm"])
def test_registry_builds_every_ported_arch(arch):
    jm = jax_model_class(arch)(with_classifier=False)
    net = get_model_class(arch)()
    assert net.feature_dim == jm.feature_dim
    if arch.startswith("resnet"):
        assert tuple(len(getattr(net, f"layer{s}"))
                     for s in (1, 2, 3, 4)) == tuple(jm.layers)


def test_registry_rejects_unported_arch():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model_class("slowfast")
