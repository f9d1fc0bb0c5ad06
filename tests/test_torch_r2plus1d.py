"""The port's R(2+1)D (rspnet_tpu_torch/models/r2plus1d.py) against the JAX
package's, on the CPU.

- Forward parity of ``r2plus1d-vcop`` and ``r2plus1d-18`` with their
  ``linear`` classifier, in train mode (the output and every updated BN
  statistic) and in eval mode, at atol 1e-8 / rtol 1e-7, f64 on both
  sides (jax_enable_x64 and torch.double, as tests/test_step_parity.py
  does), input [2, 8, 32, 32, 3], the archs' own widths; weights drawn in
  the structure of the JAX init and carried over by ``models/convert.py``.
- ``models/convert.py`` both ways for both archs as a bare backbone, a
  pretraining wrapper and a finetuning one: the same tree back, leaf for
  leaf, and the reference torch names (torch_bridge.py:_r2plus1d_mapping).
- The factored widths: the paper's formula gives the stem 83 and the
  projections 42, 85 and 170, as in the JAX package.
- bf16: a ``SpatioTemporalConv`` and ``ResBlock`` with and without its
  projection, against the JAX modules built with ``dtype=jnp.bfloat16``:
  within 2 ulps, and bit-equal in all but 1% of cells
  (tests/test_torch_zoo_bf16.py's rule), or 8% for the block without a
  projection. That block chains four convolutions at stride 1; fed the
  JAX stage's input, each of its stages (BN, spatial conv + BN + ReLU,
  temporal conv, residual add) is bit-equal in all but 0.05% of cells,
  and the convolutions that follow spread each flip over their windows
  (1.3-5.6% over three inputs). BN statistics f32 at rtol 1e-4 (atol
  1e-6; 1e-4, an 80th of a bf16 ulp at 1, for the block without a
  projection, whose second BN sees those flipped cells).
- The CLI on the CPU: ``config/pretrain/r2plus1d.jsonnet`` builds
  ``r2plus1d-vcop`` and trains; ``config/finetune/ucf101_r2plus1d.jsonnet``
  with ``--mc`` from it, as published (multitask) and as ``1stream``.
  (The ``1stream`` steps on R(2+1)D against the JAX package's are in
  tests/test_torch_one_stream.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.models.r2plus1d import ResBlock as JaxResBlock
from rspnet_tpu.models.r2plus1d import \
    SpatioTemporalConv as JaxSpatioTemporalConv
from rspnet_tpu.models.torch_bridge import KEY_MAPPERS as BRIDGE_MAPPERS
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.models.r2plus1d import (ResBlock, SpatioTemporalConv,
                                              intermediate_channels)
from tests.test_torch_bf16 import (_bf16_values, _converted, _perturbed,
                                   _within_ulps)
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import (backbone_forward_parity, layout_modules,
                                  round_trip)

torch.set_num_threads(1)
T, S, NC = 8, 32, 5
ARCHS = ("r2plus1d-vcop", "r2plus1d-18")


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_forward_matches_jax(arch):
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    backbone_forward_parity(jax_model_class(arch)(num_classes=NC),
                            get_model_class(arch)(num_classes=NC,
                                                  with_classifier=True),
                            arch, x)


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_round_trip(arch, layout):
    round_trip(arch, *layout_modules(layout, jax_model_class(arch),
                                     get_model_class(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_torch_names(arch):
    """The port's modules carry the reference torch names, as the JAX
    package's bridge spells them."""
    net = get_model_class(arch)(with_classifier=True)
    ours = {k for k in net.state_dict()
            if not k.endswith("num_batches_tracked")}
    assert ours == {k for k, _ in BRIDGE_MAPPERS[arch]()}


def test_factored_widths():
    net = get_model_class("r2plus1d-vcop")()
    assert net.conv1.spatial_conv.out_channels == 83
    mids = [getattr(net, f"conv{s}").block1.conv1.spatial_conv.out_channels
            for s in (2, 3, 4, 5)]
    down = [getattr(net, f"conv{s}").block1.downsampleconv.spatial_conv
            .out_channels for s in (3, 4, 5)]
    assert mids == [144, 230, 460, 921] and down == [42, 85, 170]
    assert intermediate_channels((3, 3, 3), 512, 512) == 1152


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

BF = torch.bfloat16
C_IN = 16


def _block_mapping(downsample):
    m = []
    for c in (1, 2):
        m += convert._stconv_mapping(f"m.conv{c}", f"m/conv{c}")
        m += convert._bn(f"m.bn{c}", f"m/bn{c}")
    if downsample:
        m += convert._stconv_mapping("m.downsampleconv", "m/downsampleconv")
        m += convert._bn("m.downsamplebn", "m/downsamplebn")
    return m


_JBF = dict(dtype=jnp.bfloat16)
# name -> (JAX module, port module, convert.py mapping, (unequal share,
# BN statistics' atol))
BLOCKS = {
    "stconv": (lambda: JaxSpatioTemporalConv(C_IN, 24, 3, 1, 1, **_JBF),
               lambda: SpatioTemporalConv(C_IN, 24, 3, 1, 1, BF),
               lambda: convert._stconv_mapping("m", "m"), (0.01, 1e-6)),
    "resblock_downsample": (
        lambda: JaxResBlock(C_IN, 24, 3, downsample=True, **_JBF),
        lambda: ResBlock(C_IN, 24, 3, True, BF), lambda: _block_mapping(True),
        (0.01, 1e-6)),
    "resblock": (lambda: JaxResBlock(C_IN, C_IN, 3, **_JBF),
                 lambda: ResBlock(C_IN, C_IN, 3, False, BF),
                 lambda: _block_mapping(False), (0.08, 1e-4)),
}


def bf16_block_parity(jm, port_module, mapping, x, unequal=0.01,
                      stats_atol=1e-6):
    """One bf16 train-mode forward of ``jm`` and ``port_module`` on the
    bf16 NDHWC input ``x``: within 2 ulps, bit-equal in all but
    ``unequal`` of the cells; BN statistics f32 at rtol 1e-4 and
    ``stats_atol``. Returns the port's output."""
    rng = np.random.RandomState(0)
    xj = jnp.asarray(x, jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), xj, train=False)
    v = {"params": _perturbed(v["params"], rng),
         "batch_stats": v.get("batch_stats", {})}
    out, mut = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    assert out.dtype == jnp.bfloat16
    port = nn.ModuleDict({"m": port_module})
    convert.load_converted(port, _converted(
        mapping, {"params": {"m": v["params"]},
                  "batch_stats": {"m": v["batch_stats"]}}))
    port.train()
    got = port["m"](torch.from_numpy(x).to(BF).permute(0, 4, 1, 2, 3))
    assert got.dtype == BF
    got = got.permute(0, 2, 3, 4, 1).float().detach().numpy()
    ref = np.asarray(out.astype(jnp.float32))
    assert _within_ulps(got, ref, 2)
    assert np.mean(got != ref) <= unequal, np.mean(got != ref)
    stats_j = _converted([e for e in mapping if e[1][0] == "batch_stats"],
                         {"batch_stats": {"m": mut.get("batch_stats", {})}})
    stats_p = {k: b.numpy() for k, b in port.named_buffers()
               if k in stats_j}
    assert set(stats_p) == set(stats_j)
    for k, ref_s in stats_j.items():
        assert stats_p[k].dtype == np.float32, k
        np.testing.assert_allclose(stats_p[k], ref_s, rtol=1e-4,
                                   atol=stats_atol, err_msg=k)
    return got


@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_bf16_block_matches_jax(which):
    jax_mod, port_mod, mapping, tol = BLOCKS[which]
    rng = np.random.RandomState(0)
    x = _bf16_values(np.maximum(rng.randn(2, 4, 10, 10, C_IN), 0)
                     + 0.1 * rng.randn(2, 4, 10, 10, C_IN))
    bf16_block_parity(jax_mod(), port_mod(), mapping(), x, *tol)


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

PRETRAIN_X = ('{dataset+: {name: "synthetic", num_samples: 4, height: 40, '
              'width: 48}, batch_size: 2, num_workers: 1, '
              'spatial_transforms+: {size: 32}, temporal_transforms+: '
              '{_size:: 8}, moco+: {k: 8}, device_geometry: true}')
FINETUNE_X = ('{dataset+: {name: "synthetic", num_samples: 4, num_classes: 4, '
              'height: 40, width: 48}, num_workers: 1, batch_size: 2, '
              'validate+: {batch_size: 2}, final_validate+: {batch_size: 2}, '
              'spatial_transforms+: {size: 32}, temporal_transforms+: '
              '{size: 8}, device_geometry: true%s}')


def test_cli_pretrain_then_finetune_one_stream(tmp_path, monkeypatch):
    from rspnet_tpu_torch import finetune, pretrain
    from tests.conftest import REPO_ROOT

    monkeypatch.chdir(REPO_ROOT)
    pre = tmp_path / "pretrain"
    engine = pretrain.main(["-c", "config/pretrain/r2plus1d.jsonnet", "-e",
                            str(pre), "-x", PRETRAIN_X, "-d", "--seed", "0",
                            "--device", "cpu"])
    assert type(engine.state.model_q.encoder).__name__ == "R2Plus1DNet"
    assert engine.arch == "r2plus1d-vcop" and len(engine.step_times) == 2
    assert np.isfinite(engine.meters["loss"].avg)
    ckpt = str(pre / "checkpoint.pth.tar")
    for model_type in ("multitask", "1stream"):
        ft, final = finetune.main([
            "-c", "config/finetune/ucf101_r2plus1d.jsonnet", "-e",
            str(tmp_path / model_type), "-x",
            FINETUNE_X % f", model_type: '{model_type}'", "-d", "--seed",
            "0", "--device", "cpu", "--mc", ckpt])
        assert ft.model_type == model_type
        assert len(ft.step_times) == 2 and np.isfinite(final["loss"])
        enc = ft.model.encoder if model_type == "multitask" else ft.model
        want = engine.state.model_q.encoder.state_dict()
        # the backbone came from the pretraining checkpoint and was trained
        # from there: its BN statistics moved off the checkpoint's, and its
        # classifier is the finetune config's
        assert enc.conv1.spatial_conv.weight.shape == \
            want["conv1.spatial_conv.weight"].shape
        assert (ft.model.fc if model_type == "multitask"
                else ft.model.linear).out_features == 4
