"""The port's MFNet-3D (rspnet_tpu_torch/models/mfnet.py) against the JAX
package's, on the CPU.

- Forward parity in f64 at atol 1e-8 / rtol 1e-7, input [2, 8, 32, 32,
  3], published widths and depths: in train mode the output, every
  updated BN statistic and every parameter's gradient, in eval mode the
  output and ``features`` (tests/test_torch_slowfast.py:
  forward_grad_parity).
- The module names are the reference's, the torch side of
  rspnet_tpu/models/torch_bridge.py:_mfnet_mapping; Xavier-uniform init.
- ``models/convert.py`` both ways as a bare backbone, a pretraining
  wrapper and a finetuning one.
- bf16: a first and a later multi-fiber unit (grouped 16 ways) against
  the JAX units built with ``dtype=jnp.bfloat16``
  (tests/test_torch_r2plus1d.py:bf16_block_parity).
- One MoCo step on MFNet: tests/test_torch_mfnet_step.py.
- The CLI: ``-x '{arch: "mfnet"}'`` on config/pretrain/moco-train-base
  .jsonnet at test sizes; its checkpoint is read by the JAX package's
  ``load_pretrained_encoder`` into the JAX MFNet's tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.models import mfnet as jmfnet
from rspnet_tpu.models.torch_bridge import KEY_MAPPERS as BRIDGE_MAPPERS
from rspnet_tpu_torch.models import convert, get_model_class, mfnet
from tests.test_torch_bf16 import _bf16_values, _converted, _perturbed
from tests.test_torch_r2plus1d import BF, bf16_block_parity
from tests.test_torch_slowfast import forward_grad_parity
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import layout_modules, round_trip
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
T, S, NC = 8, 32, 5


def test_forward_and_gradients_match_jax():
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    net = forward_grad_parity(
        jax_model_class("mfnet")(num_classes=NC),
        get_model_class("mfnet")(num_classes=NC, with_classifier=True),
        "mfnet", x)
    assert net.feature_dim == 768


def test_reference_names_and_init():
    net = get_model_class("mfnet")(with_classifier=True)
    names = {k for k in net.state_dict()
             if not k.endswith("num_batches_tracked")}
    assert names == {k for k, _ in BRIDGE_MAPPERS["mfnet"]()}
    assert net.conv2.B01.conv_m1.conv.groups == 16
    assert net.conv2.B01.conv_m1.conv.stride == (2, 1, 1)
    assert net.conv3.B01.conv_m1.conv.stride == (1, 2, 2)
    assert net.conv2.B02.conv_w1 is None
    # Xavier uniform: |w| <= sqrt(6 / (fan_in + fan_out))
    w = net.conv1.conv.weight
    bound = np.sqrt(6 / (3 * 75 + 16 * 75))
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
def test_conversion_round_trip(layout):
    round_trip("mfnet", *layout_modules(layout, jax_model_class("mfnet"),
                                        get_model_class("mfnet")))


# first unit? -> its share of unequal cells end to end (see the test)
MF_UNEQUAL = {True: 0.15, False: 0.01}


def _mf_units(first):
    c_in = 96 if first else 192
    stride = (1, 2, 2) if first else (1, 1, 1)
    jm = jmfnet.MFUnit(num_mid=192, num_out=192, groups=16, strides=stride,
                       first_block=first, dtype=jnp.bfloat16)
    net = mfnet.MFUnit(c_in, 192, 192, 16, stride, first, dtype=BF)
    mapping = convert._slowfast_mapping(
        [f"m.{k}" for k in net.state_dict()])
    x = _bf16_values(np.random.RandomState(0).randn(2, 4, 8, 8, c_in))
    return jm, net, mapping, x


@pytest.mark.parametrize("first", [True, False])
def test_bf16_mf_unit(first):
    """Stage 3's first unit (96 -> 192, stride (1,2,2), its ``conv_w1``
    shortcut) and a later one (192 -> 192) in bf16 against the JAX units
    (tests/test_torch_r2plus1d.py:bf16_block_parity): within 2 ulps
    everywhere; bit-equal in all but 15% (first unit) and 1% (later
    unit) of the cells; BN statistics at rtol 1e-4 / atol 1e-5. Each
    ``BnAcConv`` fed the JAX stage's own input is bit-equal in all but
    0.5% of its cells (0.27% the most seen): its BN's statistics differ
    in the last f32 bits (torch's variance against JAX's mean(x^2) -
    mean^2), which flips a rounding now and then. In the first unit such
    flips reach the input of ``conv_m1``'s BN (the fiber mixer's sum) and
    of ``conv_w1``'s, whose statistics then move every cell of a channel
    a little, so the flips spread: 14.2% of the unit's cells end to end,
    0.74% in the later unit, and the statistics move by up to 1.8e-5."""
    jm, net, mapping, x = _mf_units(first)
    bf16_block_parity(jm, net, mapping, x, MF_UNEQUAL[first], 5e-5)
    # each stage alone, fed the JAX stage's input
    rng = np.random.RandomState(0)
    xj = jnp.asarray(x, jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), xj, train=False)
    v = {"params": _perturbed(v["params"], rng),
         "batch_stats": v["batch_stats"]}
    _, mut = jm.apply(v, xj, train=True, capture_intermediates=True,
                      mutable=["batch_stats", "intermediates"])
    out = {k: d["__call__"][0] for k, d in mut["intermediates"].items()
           if k.startswith("conv_")}
    ins = {"conv_i1": xj, "conv_i2": out["conv_i1"],
           "conv_m1": xj + out["conv_i2"], "conv_m2": out["conv_m1"],
           "conv_w1": xj}
    port = torch.nn.ModuleDict({"m": net})
    convert.load_converted(port, _converted(
        mapping, {"params": {"m": v["params"]},
                  "batch_stats": {"m": v["batch_stats"]}}))
    port.train()
    for name, ref in out.items():
        inp = torch.from_numpy(np.asarray(ins[name].astype(jnp.float32)))
        got = getattr(net, name)(inp.to(BF).permute(0, 4, 1, 2, 3))
        got = got.permute(0, 2, 3, 4, 1).float().detach().numpy()
        assert np.mean(got != np.asarray(ref.astype(jnp.float32))) <= 0.005


def test_cli_pretrain_mfnet_checkpoint_read_by_jax(tmp_path, monkeypatch):
    from rspnet_tpu.engines.transfer import load_pretrained_encoder
    from rspnet_tpu_torch import pretrain
    from tests.conftest import REPO_ROOT
    from tests.test_torch_r2plus1d import PRETRAIN_X

    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(["-c", "config/pretrain/moco-train-base.jsonnet",
                            "-e", str(tmp_path), "-x",
                            PRETRAIN_X[:-1] + ", arch: 'mfnet'}", "-d",
                            "--seed", "0", "--device", "cpu"])
    enc = engine.state.model_q.encoder
    assert isinstance(enc, mfnet.MFNet3D) and engine.arch == "mfnet"
    assert len(engine.step_times) == 2
    assert np.isfinite(engine.meters["loss"].avg)
    params, stats = load_pretrained_encoder(
        str(tmp_path / "checkpoint.pth.tar"), "mfnet")
    want = convert.variables_to_state_dict(
        {"params": params, "batch_stats": stats}, "mfnet")
    got = enc.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(), k)
    assert set(params) == {"stem_conv", "stem_bn", "tail_bn"} | {
        f"conv{s}_B{i:02d}" for s, n in zip((2, 3, 4, 5), mfnet.K_SEC)
        for i in range(1, n + 1)}
