"""The port's SlowFast family (rspnet_tpu_torch/models/slowfast.py) against
the JAX package's, on the CPU.

- ``SPECS`` equal to JAX's, name by name and field by field; the registry
  builds ``slowfast`` by ``variant``, by a string ``cfg_file`` and by a
  mapping ``cfg_file`` (the default variant), and every spec name.
- Forward parity in f64 at atol 1e-8 / rtol 1e-7 (``forward_grad_parity``,
  run by tests/test_torch_slowfast_forward.py for the time budget):
  in train mode the output, every updated BN statistic and the gradient
  of every parameter; in eval mode the output and ``features``. Published
  widths, depths cut with ``dataclasses.replace`` in both packages:
  two-pathway ``SLOWFAST_NLN_4x16_R50`` (``dot_product`` non-local blocks
  in res3 and res4, lateral fusion, T 16 -> slow frames [0, 15]),
  single-pathway ``I3D_NLN_8x8_R50`` (``softmax`` non-local blocks, the
  (2,1,1) temporal pool after res2, I3D's temporal kernels), and
  ``SLOWFAST_4x16_R50`` with ``norm_type: sub_batchnorm``, 2 splits, at
  batch 4. The input is [B, T, 48, 48, 3]: res4's map is 3², so its
  non-local pool has a floor tail. The JAX ``SubBatchNorm`` casts to f32
  even under x64 (rspnet_tpu/models/common.py:144); for the f64 case its
  ``jnp.float32`` is read as f64 (the port takes its statistics in at
  least f32, so the two agree in f32 and bf16), and ``SubBatchNorm``
  alone is held to the unmodified JAX module in f32 at 2e-5.
- ``SubBatchNorm``: per-split statistics, ``[k, C]`` running statistics,
  the aggregate in eval mode, a batch ``k`` does not divide raises; the
  precise-BN guard (F6) raises on a real SlowFast with it.
- ``models/convert.py`` both ways for the two-pathway and sub-batchnorm
  builds as a bare backbone, a pretraining wrapper and a finetuning one.
- bf16: the non-local block, both instantiations, against the JAX block
  built with ``dtype=jnp.bfloat16`` (tests/test_torch_bf16.py's style).
- ``only_train_fc`` on a SlowFast ``1stream`` model trains ``head_fc``
  alone, where the JAX package trains nothing (F11, ROADMAP.md §3); two
  ``1stream`` steps with the JAX step's dropout masks at 1e-8.
- The CLI: ``-x '{arch: "slowfast"}'`` (the preset's mapping
  ``cfg_file``) and a YAML ``cfg_file`` on the CPU at test sizes.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models import common as jcommon
from rspnet_tpu.models import slowfast as jsf
from rspnet_tpu_torch.models import common, convert, get_model_class
from rspnet_tpu_torch.models import slowfast as sf
from tests.test_step_parity import enable_x64
from tests.test_torch_bf16 import _bf16_values
from tests.test_torch_r2plus1d import BF, bf16_block_parity
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import (_np, _random_variables, layout_modules,
                                  round_trip)
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
S, NC = 48, 5
# the bf16 non-local block (see its test): the share of unequal cells and
# the absolute and relative tolerances of its BN's running statistics
UNEQUAL_NL, NL_STATS_ATOL, NL_STATS_RTOL = 0.01, 0.05, 2e-3


def _cut(name, depths, nl_blocks=None, **kw):
    """A spec of ``SPECS`` at its widths, cut to ``depths`` (and its
    temporal-kernel counts with them), the same in both packages."""
    extra = dict(depths=depths, nbtk_slow=depths, nbtk_fast=depths, **kw)
    if nl_blocks is not None:
        extra["nl_blocks"] = nl_blocks
    return (dataclasses.replace(jsf.SPECS[name], **extra),
            dataclasses.replace(sf.SPECS[name], **extra))


# name -> (JAX spec, port spec, T, batch)
CUTS = {
    "slowfast_nln": (*_cut("SLOWFAST_NLN_4x16_R50", (1, 1, 1, 1),
                           ((), (0,), (0,), ())), 16, 2),
    "i3d_nln": (*_cut("I3D_NLN_8x8_R50", (1, 2, 2, 1),
                      ((), (1,), (1,), ())), 8, 2),
    "slowfast_subbn": (*_cut("SLOWFAST_4x16_R50", (1, 1, 1, 1),
                             norm_type="sub_batchnorm", bn_num_splits=2),
                       16, 4),
}


def _modules(name, with_classifier=True):
    jspec, pspec, _, _ = CUTS[name]
    return (jsf.SlowFast(spec=jspec, num_classes=NC, dropout_rate=0.0,
                         with_classifier=with_classifier),
            sf.SlowFast(spec=pspec, num_classes=NC, dropout_rate=0.0,
                        with_classifier=with_classifier))


class _F64Numpy(types.ModuleType):
    """jax.numpy whose ``float32`` is float64."""

    def __init__(self):
        super().__init__("jnp_f64")

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _port(net):
    return net.double().to(memory_format=torch.channels_last_3d)


def forward_grad_parity(jm, net, arch, x, seed=0):
    """``jm`` (JAX) and ``net`` (port, with its classifier; dropout off)
    on ``x`` [B, T, H, W, 3] in f64: in train mode the output, every
    updated BN statistic and every parameter's gradient of a random
    linear function of the output; in eval mode the output and
    ``features``. Returns the port's module."""
    rng = np.random.default_rng(seed)
    v = _random_variables(jm, rng, np.float64)
    with enable_x64():
        @jax.jit
        def run(variables, xb, cot):
            def loss(params):
                out, mut = jm.apply(
                    {"params": params, "batch_stats":
                     variables["batch_stats"]}, xb, train=True,
                    mutable=["batch_stats"])
                return jnp.sum(out * cot), (out, mut["batch_stats"])
            (_, (out, stats)), grads = jax.value_and_grad(
                loss, has_aux=True)(variables["params"])
            return (out, stats, grads, jm.apply(variables, xb, train=False),
                    jm.apply(variables, xb, train=False, method="features"))

        out_shape = jax.eval_shape(
            lambda: jm.apply(v, jnp.asarray(x), train=False)).shape
        cot = rng.standard_normal(out_shape)
        out_j, stats_j, grads_j, eval_j, feat_j = run(v, jnp.asarray(x),
                                                      jnp.asarray(cot))
    net = _port(net)
    convert.load_converted(net, convert.variables_to_state_dict(v, arch))
    xt = torch.from_numpy(x)
    net.eval()
    np.testing.assert_allclose(net(xt).detach().numpy(), np.asarray(eval_j),
                               atol=ATOL, rtol=RTOL)
    feat = net.features(xt.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(feat_j),
                               atol=ATOL, rtol=RTOL)
    net.train()
    out = net(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(cot)).sum().backward()
    want = convert.variables_to_state_dict(
        {"params": _np(grads_j), "batch_stats": _np(stats_j)}, arch)
    params = dict(net.named_parameters())
    assert set(params) <= set(want)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k], atol=ATOL,
                                   rtol=RTOL, err_msg=f"grad {k}")
    buffers = {k: b for k, b in net.named_buffers()
               if not k.endswith("num_batches_tracked")}
    n_norm = sum(isinstance(m, (torch.nn.BatchNorm3d, common.SubBatchNorm))
                 for m in net.modules())
    assert len(buffers) == 2 * n_norm and set(buffers) <= set(want)
    for k, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    return net


def test_specs_equal_jax():
    assert list(sf.SPECS) == list(jsf.SPECS)
    fields = [f.name for f in dataclasses.fields(jsf.SlowFastSpec)]
    assert [f.name for f in dataclasses.fields(sf.SlowFastSpec)] == fields
    for name, spec in jsf.SPECS.items():
        for f in fields:
            assert getattr(sf.SPECS[name], f) == getattr(spec, f), (name, f)


def test_slow_pathway_frames_are_linspace():
    """T 16, alpha 8: the slow pathway sees frames 0 and 15."""
    net = sf.SlowFast(spec=CUTS["slowfast_nln"][1])
    seen = []
    net.slow.stem.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0][0, 0, :, 0, 0].clone()))
    x = torch.arange(16.0).view(1, 16, 1, 1, 1).expand(1, 16, 32, 32, 3)
    with torch.no_grad():
        net.eval().features(x.permute(0, 4, 1, 2, 3))
    assert seen[0].tolist() == [0.0, 15.0]


def _jax_sub_bn(x, scale, bias, stats, train):
    m = jcommon.SubBatchNorm(num_splits=stats["mean"].shape[0])
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
    if train:
        out, mut = m.apply(v, x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]
    return m.apply(v, x, train=False), stats


@pytest.mark.parametrize("train", [True, False])
def test_sub_batch_norm_matches_jax_in_f32(train):
    rng = np.random.default_rng(3)
    k, c = 3, 6
    x = (rng.standard_normal((6, 2, 3, 5, c)) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    stats = {"mean": (0.3 * rng.standard_normal((k, c))).astype(np.float32),
             "var": (1 + np.abs(rng.standard_normal((k, c)))).astype(
                 np.float32)}
    out_j, stats_j = _jax_sub_bn(jnp.asarray(x), scale, bias, stats, train)
    bn = common.SubBatchNorm(c, k)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    bn.train(train)
    out = bn(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(out_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats_j["mean"]), atol=2e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats_j["var"]), atol=2e-5,
                               rtol=2e-5)


def test_sub_batch_norm_semantics():
    """Per-split statistics (sample i in split i % k), unbiased running
    variance per split, the aggregate in eval mode, one affine pair, and
    a batch k does not divide raises."""
    torch.manual_seed(0)
    k, c = 2, 3
    bn = common.SubBatchNorm(c, k, flax_momentum=0.0).double()
    x = torch.randn(4, c, 2, 3, 3, dtype=torch.float64)
    x[1::2] = x[1::2] * 3 + 5                      # split 1 differs
    y = bn.train()(x)
    for split in range(k):
        xs = x[split::k]
        ref = (xs - xs.mean((0, 2, 3, 4), keepdim=True)) / torch.sqrt(
            xs.var((0, 2, 3, 4), unbiased=False, keepdim=True) + 1e-5)
        torch.testing.assert_close(y[split::k], ref)
        torch.testing.assert_close(bn.running_mean[split],
                                   xs.mean((0, 2, 3, 4)))
        torch.testing.assert_close(bn.running_var[split],
                                   xs.var((0, 2, 3, 4), unbiased=True))
    assert bn.running_mean.shape == (k, c) and bn.weight.shape == (c,)
    m = bn.running_mean.mean(0)
    v = bn.running_var.mean(0) + ((bn.running_mean - m) ** 2).mean(0)
    torch.testing.assert_close(
        bn.eval()(x), (x - m.view(1, c, 1, 1, 1))
        / torch.sqrt(v.view(1, c, 1, 1, 1) + 1e-5))
    with pytest.raises(ValueError, match="not divisible"):
        bn.train()(x[:3])


def test_precise_bn_raises_on_sub_batch_norm():
    """F6: the guard meets a real SubBatchNorm now."""
    from rspnet_tpu_torch.engines.precise_bn import recalibrate_bn_stats
    net = sf.SlowFast(spec=CUTS["slowfast_subbn"][1])
    assert any(isinstance(m, common.SubBatchNorm) for m in net.modules())
    with pytest.raises(NotImplementedError, match="SubBatchNorm"):
        recalibrate_bn_stats(net, [torch.zeros(2, 16, 32, 32, 3)])


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
@pytest.mark.parametrize("name", ["slowfast_nln", "slowfast_subbn"])
def test_conversion_round_trip(name, layout):
    jspec, pspec, _, _ = CUTS[name]

    def jax_factory(**kw):
        return jsf.SlowFast(spec=jspec, **kw)

    def port_factory(**kw):
        return sf.SlowFast(spec=pspec, **kw)

    round_trip("slowfast", *layout_modules(layout, jax_factory,
                                           port_factory))


def test_registry_builds_slowfast():
    yaml = "config/slowfast-configs/Kinetics/C2D_NLN_8x8_R50.yaml"
    net = get_model_class("slowfast", cfg_file=yaml)()
    assert net.spec == dataclasses.replace(sf.SPECS["C2D_NLN_8x8_R50"],
                                           name="C2D_NLN_8x8_R50")
    preset = {"slowfast_4x16_r50": "config/slowfast-configs/Kinetics/"
                                   "SLOWFAST_4x16_R50.yaml"}
    assert get_model_class("slowfast", cfg_file=preset)().spec == \
        sf.SPECS["SLOWFAST_4x16_R50"]
    assert get_model_class("slowfast", variant="SLOW_8x8_R50")().spec == \
        sf.SPECS["SLOW_8x8_R50"]
    for name, spec in sf.SPECS.items():
        with torch.device("meta"):        # built, not allocated
            net = get_model_class(name)(num_classes=NC, with_classifier=True)
        jm = jsf.get_model_class(name)(num_classes=NC)
        assert net.spec == spec and net.feature_dim == jm.feature_dim
        assert net.head_fc.out_features == NC
        assert sum(isinstance(m, sf.Bottleneck) for m in net.modules()) == \
            sum(spec.depths) * (2 if spec.two_pathway else 1)
    with pytest.raises(ValueError, match="Unknown SlowFast variant"):
        get_model_class("slowfast", variant="SLOWFAST_1x1_R18")
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model_class("slowfast", pretrain=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model_class("C2D_8x8_R50", variant="C2D_8x8_R50")


@pytest.mark.parametrize("inst", ["dot_product", "softmax"])
def test_bf16_non_local_block(inst):
    """The non-local block in bf16 at res4's width (1024 channels) on a
    [2, 2, 5, 5] map (a floor tail in its pool), against the JAX block
    with ``dtype=jnp.bfloat16`` (tests/test_torch_r2plus1d.py:
    bf16_block_parity: within 2 ulps, bit-equal in all but ``unequal`` of
    the cells; its BN's scale drawn off zero). Stage by stage theta, phi,
    g, both products and the division are bit-equal; the ``out`` conv
    (512 -> 1024) flips one bf16 ulp in 0.015% of its cells, where its
    values reach 4096 (an ulp of 32): over a channel's 100 cells that
    moves the BN's running mean (momentum 0.1) by 0.032 and its running
    variance (about 1e4-1e6 here) by up to 8e-4 of itself, hence the
    statistics' tolerances of 0.05 and 2e-3 (1e-4 for the other blocks).
    """
    c = 1024
    jm = jsf.NonLocal(inner=c // 2, instantiation=inst, dtype=jnp.bfloat16)
    net = sf.NonLocal(c, c // 2, inst, dtype=BF)
    mapping = convert._slowfast_mapping(
        [f"m.{k}" for k in net.state_dict()])
    rng = np.random.RandomState(0)
    x = _bf16_values(np.maximum(rng.randn(2, 2, 5, 5, c), 0)
                     + 0.1 * rng.randn(2, 2, 5, 5, c))
    bf16_block_parity(jm, net, mapping, x, UNEQUAL_NL, NL_STATS_ATOL,
                      NL_STATS_RTOL)


def test_linear_probe_trains_nothing_f11():
    """F11 (ROADMAP.md §3), repaired in the port: the JAX linear probe
    masks the parameters whose whole first key is ``fc`` / ``linear`` /
    ``head`` / ``new_fc`` (rspnet_tpu/engines/classifier.py:40), and
    SlowFast's classifier is ``head_fc``, so one ``only_train_fc`` step of
    a ``1stream`` SlowFast moves no parameter in JAX. The port's probe
    (``classifier.PROBE_NAMES``) trains ``head_fc`` and nothing else: every
    other parameter and every BN statistic keeps its bits. The loss agrees
    (f64, 1e-8). ``multitask`` probes, which train the wrapper's ``fc``,
    stay pinned to JAX by tests/test_torch_classifier.py."""
    import optax

    from rspnet_tpu.engines.classifier import (TrainState,
                                               make_classifier_train_step)
    from rspnet_tpu_torch.config import ConfigTree
    from rspnet_tpu_torch.engines import classifier
    from rspnet_tpu_torch.framework.lr_schedule import build_optimizer

    jspec, pspec = _cut("SLOWFAST_4x16_R50", (1, 1, 1, 1))
    jm = jsf.SlowFast(spec=jspec, num_classes=NC)
    net = _port(sf.SlowFast(spec=pspec, num_classes=NC,
                            with_classifier=True))
    v = _random_variables(jm, np.random.default_rng(4), np.float64)
    convert.load_converted(net, convert.variables_to_state_dict(
        v, "slowfast"))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    rng = np.random.RandomState(5)
    clips = rng.randn(2, 16, 32, 32, 3)
    labels = rng.randint(0, NC, 2).astype(np.int32)
    optimizer = optax.chain(optax.add_decayed_weights(1e-4),
                            optax.sgd(0.1, momentum=0.9))
    with enable_x64():
        state = TrainState(v["params"], v["batch_stats"],
                           jax.jit(optimizer.init)(v["params"]),
                           jnp.zeros((), jnp.int32))
        step = jax.jit(make_classifier_train_step(
            jm, optimizer, axis_name=None, only_train_fc=True))
        new, jmetrics = step(state, jnp.asarray(clips), jnp.asarray(labels),
                             jax.random.PRNGKey(0))
        for a, b in zip(jax.tree_util.tree_leaves(new.params),
                        jax.tree_util.tree_leaves(v["params"])):
            np.testing.assert_array_equal(np.asarray(a), b)
    opt = build_optimizer(ConfigTree.from_dict(
        {"lr": 0.1, "momentum": 0.9, "dampening": 0, "nesterov": False,
         "weight_decay": 1e-4}), net.parameters(), 0.1)
    metrics = classifier.train_step(net, opt, torch.from_numpy(clips),
                                    torch.from_numpy(labels),
                                    only_train_fc=True)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), atol=ATOL, rtol=RTOL)
    trained = {n for n, p in net.named_parameters() if p.requires_grad}
    assert trained == {"head_fc.weight", "head_fc.bias"}
    for k, t in net.state_dict().items():
        if k in trained:
            assert not torch.equal(t, before[k]), k
        else:
            assert torch.equal(t, before[k]), k


def _slowfast_x(extra):
    from tests.test_torch_r2plus1d import PRETRAIN_X
    return PRETRAIN_X[:-1] + ", arch: 'slowfast'" + extra + "}"


@pytest.mark.parametrize("extra", [
    "", ", model+: {cfg_file: 'config/slowfast-configs/Kinetics/"
        "SLOWFAST_NLN_4x16_R50.yaml'}"])
def test_cli_pretrain_slowfast(tmp_path, monkeypatch, extra):
    """``-x '{arch: "slowfast"}'`` on config/pretrain/moco-train-base
    .jsonnet at test sizes, R50 depth: the default variant, and the NLN
    YAML through the port's reader (5 non-local blocks)."""
    from rspnet_tpu_torch import pretrain
    from tests.conftest import REPO_ROOT

    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(["-c", "config/pretrain/moco-train-base.jsonnet",
                            "-e", str(tmp_path), "-x", _slowfast_x(extra),
                            "-d", "--seed", "0", "--device", "cpu"])
    enc = engine.state.model_q.encoder
    assert isinstance(enc, sf.SlowFast) and enc.feature_dim == 2304
    want = "SLOWFAST_NLN_4x16_R50" if extra else "SLOWFAST_4x16_R50"
    assert enc.spec.name == want and enc.spec.depths == (3, 4, 6, 3)
    assert sum(isinstance(m, sf.NonLocal) for m in enc.modules()) == (
        5 if extra else 0)
    assert len(engine.step_times) == 2
    assert np.isfinite(engine.meters["loss"].avg)
    from rspnet_tpu_torch.framework import load_state
    saved = load_state(tmp_path / "checkpoint.pth.tar")["model"]
    assert set(saved["params_q"]["encoder"]) == {
        "slow", "fast", "fuse_stem", "fuse_s2", "fuse_s3", "fuse_s4"}


def test_slowfast_one_stream_steps_match_jax():
    """Two ``model_type: 1stream`` classifier steps (tests/
    test_torch_one_stream.py's check) of ``SLOWFAST_4x16_R50`` cut to
    depths (1, 1, 1, 1), its ``head_fc`` dropout masks read from the JAX
    step's key and injected (tests/test_torch_one_stream_s3dg.py's)."""
    from tests.test_torch_one_stream import one_stream_steps
    from tests.test_torch_one_stream_s3dg import _s3dg_dropout_masks
    jspec, pspec = _cut("SLOWFAST_4x16_R50", (1, 1, 1, 1))
    net = one_stream_steps("slowfast", dropout_masks=_s3dg_dropout_masks,
                           modules=(
                               jsf.SlowFast(spec=jspec, num_classes=NC),
                               sf.SlowFast(spec=pspec, num_classes=NC,
                                           with_classifier=True),
                               jsf.SlowFast(spec=jspec,
                                            with_classifier=False)))
    assert net.head_fc is not None and net.drop_prob == 0.5
