"""The port's TSM (rspnet_tpu_torch/models/tsm.py) against the JAX
package's, on the CPU.

- The shifts: ``temporal_shift`` and ``temporal_shift_grouped`` bit-equal
  to JAX's (pure data movement), and their output in
  ``torch.channels_last_3d`` memory; through the whole backbone every
  block's output, K1's input (the stem pool and the non-local pools) and
  the feature map stay channels-last, so no layout copy comes before a
  conv or K1.
- Forward parity with ``new_fc`` in train mode (output and every updated
  BN statistic) and eval mode, at atol 1e-8 / rtol 1e-7, f64 on both
  sides, input [2, 8, 32, 32, 3]: the BasicBlock base (resnet18's) and
  the Bottleneck base (resnet50's), both cut to ``layers=(1, 1, 1, 1)``
  in both packages; the BasicBlock base with ``non_local=True`` (cut to
  ``(1, 2, 2, 1)``, the least depth that holds non-local blocks: after
  ``layer2_0`` and ``layer3_0``); and with ``shift_groups=2``.
- ``models/convert.py`` both ways for the basic, bottleneck and non-local
  builds as a bare backbone, a pretraining wrapper and a finetuning one.
- bf16: a BasicBlock (identity and strided with its projection), a
  Bottleneck and a NonLocalBlock against the JAX modules built with
  ``dtype=jnp.bfloat16``: within 2 ulps everywhere and bit-equal in all
  but 1% of cells, or 8% for the non-local block. Its two einsums and its
  softmax round to bf16 where JAX rounds them (each stage fed the JAX
  stage's input is unequal in under 0.03% of cells; ``torch.softmax``,
  which rounds once, would be in 74%), but its BN normalises the
  attention's output, whose mean is large against its spread, and JAX's
  f32 variance, mean(x^2) - mean^2, cancels there: fed JAX's input, that
  BN alone is unequal in 6% of cells (4.7% end to end). BN statistics at
  rtol 1e-4.
  (The MoCo step on TSM is in tests/test_torch_tsm_step.py.)
- The config plumbing (tests/test_model_config_plumbing.py for the
  port): ``config/pretrain/tsm-r18.jsonnet`` builds a BasicBlock TSM with
  ``feature_dim`` 512, not a resnet50-based one; the CLI trains it with
  ``--device cpu``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models import tsm as jtsm
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.models import tsm
from tests.test_torch_bf16 import _bf16_values
from tests.test_torch_r2plus1d import BF, bf16_block_parity
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import (backbone_forward_parity, layout_modules,
                                  round_trip)

torch.set_num_threads(1)
T, S, NC = 8, 32, 5

# name -> TSM keyword arguments, the same in both packages
BUILDS = {
    "basic": dict(layers=(1, 1, 1, 1), basic=True),
    "bottleneck": dict(layers=(1, 1, 1, 1), basic=False),
    "non_local": dict(layers=(1, 2, 2, 1), basic=True, non_local=True),
    "shift_groups": dict(layers=(1, 1, 1, 1), basic=True, shift_groups=2),
}


def _factories(name):
    kw = BUILDS[name]
    return (functools.partial(jtsm.TSM, **kw),
            functools.partial(tsm.TSM, **kw))


def _channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("fold_div,groups", [(8, 1), (8, 2), (3, 2),
                                             (4, 3)])
def test_shift_bit_equal_to_jax(fold_div, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 4, 24).astype(np.float32)
    if groups == 1:
        ref = jtsm.temporal_shift(jnp.asarray(x), fold_div)
    else:
        ref = jtsm.temporal_shift_grouped(jnp.asarray(x), fold_div, groups)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)     # channels-last
    assert _channels_last(xt)
    got = (tsm.temporal_shift(xt, fold_div) if groups == 1 else
           tsm.temporal_shift_grouped(xt, fold_div, groups))
    assert _channels_last(got)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(ref))


def test_grouped_shift_rejects_what_jax_rejects():
    x = torch.zeros(1, 10, 2, 1, 1)
    for groups in (1, 3):
        with pytest.raises(ValueError):
            tsm.temporal_shift_grouped(x, 3, groups)


def test_channels_last_through_the_backbone(monkeypatch):
    pool_inputs = []
    real_pool = tsm.max_pool3d

    def pool(x, *geometry):
        pool_inputs.append(x.permute(0, 2, 3, 4, 1).is_contiguous())
        return real_pool(x, *geometry)

    monkeypatch.setattr(tsm, "max_pool3d", pool)
    net = _factories("non_local")[1]().to(memory_format=torch.channels_last_3d)
    outputs = []
    for name, nl in net.order:
        for m in (name, nl):
            if m is not None:
                getattr(net, m).register_forward_hook(
                    lambda mod, inp, out: outputs.append(_channels_last(out)))
    x = torch.randn(2, T, S, S, 3)
    feat = net.features(x.permute(0, 4, 1, 2, 3))
    assert _channels_last(feat)
    # the stem pool and the two pools of each of the two non-local blocks
    assert pool_inputs == [True] * 5
    assert outputs == [True] * (len(net.order) + 2)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_backbone_forward_matches_jax(name):
    jf, pf = _factories(name)
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    net = backbone_forward_parity(jf(num_classes=NC),
                                  pf(num_classes=NC, with_classifier=True),
                                  "tsm", x)
    assert net.feature_dim == (512 if BUILDS[name]["basic"] else 2048)


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
@pytest.mark.parametrize("name", ["basic", "bottleneck", "non_local"])
def test_conversion_round_trip(name, layout):
    round_trip("tsm", *layout_modules(layout, *_factories(name)))


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

C_IN = 16
_JBF = dict(dtype=jnp.bfloat16)


def _block_mapping(n_convs, downsample):
    m = []
    for c in range(1, n_convs + 1):
        m += convert._same_name_convbn(f"m.conv{c}")
    if downsample:
        m += convert._same_name_convbn("m.downsample")
    return m


def _nl_mapping():
    m = []
    for conv in ("theta", "phi", "g", "w"):
        m += convert._conv_with_bias(f"m.{conv}", f"m/{conv}")
    return m + convert._bn("m.bn", "m/bn")


# name -> (JAX module, port module, mapping, share of unequal cells)
BLOCKS = {
    "basic_identity": (
        lambda: jtsm.TsmBasicBlock(C_IN, **_JBF),
        lambda: tsm.TsmBasicBlock(C_IN, C_IN, dtype=BF),
        lambda: _block_mapping(2, False), 0.01),
    "basic_stride2": (
        lambda: jtsm.TsmBasicBlock(24, 2, needs_proj=True, **_JBF),
        lambda: tsm.TsmBasicBlock(C_IN, 24, 2, dtype=BF),
        lambda: _block_mapping(2, True), 0.01),
    "bottleneck": (
        lambda: jtsm.TsmBottleneck(8, 2, needs_proj=True, **_JBF),
        lambda: tsm.TsmBottleneck(C_IN, 8, 2, dtype=BF),
        lambda: _block_mapping(3, True), 0.01),
    "non_local": (
        lambda: jtsm.NonLocalBlock(**_JBF),
        lambda: tsm.NonLocalBlock(C_IN, dtype=BF), _nl_mapping, 0.08),
}


@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_bf16_block_matches_jax(which):
    jax_mod, port_mod, mapping, unequal = BLOCKS[which]
    rng = np.random.RandomState(0)
    x = _bf16_values(np.maximum(rng.randn(2, 8, 10, 10, C_IN), 0)
                     + 0.1 * rng.randn(2, 8, 10, 10, C_IN))
    bf16_block_parity(jax_mod(), port_mod(), mapping(), x, unequal)


# ---------------------------------------------------------------------------
# the config and the CLI
# ---------------------------------------------------------------------------

def test_model_cfg_keys_reach_the_constructor():
    """``model.base_model`` and ``num_segments`` reach TSM: the tsm-r18
    config builds the BasicBlock base (feature_dim 512, stages of 2)."""
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.moco import build_moco_model

    model, _ = build_moco_model(load_config("config/pretrain/tsm-r18.jsonnet"))
    enc = model.encoder
    assert isinstance(enc, tsm.TSM) and enc.feature_dim == 512
    assert enc.num_segments == 8
    assert [name for name, _ in enc.order] == [
        f"layer{s}_{i}" for s in (1, 2, 3, 4) for i in (0, 1)]
    assert isinstance(enc.layer1_0, tsm.TsmBasicBlock)
    n = sum(p.numel() for p in model.parameters())
    assert n < 2e7, f"{n} params: a BasicBlock resnet18 TSM expected"
    # a key TSM does not read, and any key for an arch that reads none
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model_class("tsm", base_model="resnet18", pretrain=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model_class("r2plus1d-vcop", num_segments=8)


def test_cli_pretrain_tsm_r18(tmp_path, monkeypatch):
    from rspnet_tpu_torch import pretrain
    from tests.conftest import REPO_ROOT
    from tests.test_torch_r2plus1d import PRETRAIN_X

    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(["-c", "config/pretrain/tsm-r18.jsonnet", "-e",
                            str(tmp_path), "-x", PRETRAIN_X, "-d", "--seed",
                            "0", "--device", "cpu"])
    enc = engine.state.model_q.encoder
    assert isinstance(enc, tsm.TSM) and enc.feature_dim == 512
    assert len(engine.step_times) == 2
    assert np.isfinite(engine.meters["loss"].avg)
    assert (tmp_path / "checkpoint.pth.tar").exists()
    # the checkpoint holds the JAX layout and reads back into the port
    from rspnet_tpu_torch.framework import load_state
    saved = load_state(tmp_path / "checkpoint.pth.tar")["model"]
    assert "layer4_1" in saved["params_q"]["encoder"]
    fresh = get_model_class("tsm", base_model="resnet18")()
    convert.load_variables(fresh, {
        "params": saved["params_q"]["encoder"],
        "batch_stats": saved["batch_stats_q"]["encoder"]}, "tsm")
    want = enc.state_dict()
    assert all(torch.equal(v, want[k])
               for k, v in fresh.state_dict().items()
               if not k.endswith("num_batches_tracked"))
