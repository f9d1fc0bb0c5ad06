"""C3D's conv stage and ResNet-3D's residual blocks in bf16, against the JAX
modules built with ``dtype=jnp.bfloat16``, on the CPU.

As on the card (parameters and BN statistics f32, each conv in bf16), on a
bf16 input in train mode: C3D's conv with a bias before BN, a ResNet
``BasicBlock`` with shortcut B and A at stride 2 and without a projection,
and a ``Bottleneck`` with shortcut B. In bf16 ulps as
tests/test_torch_bf16.py counts them: within 2 ulps everywhere (of the
cell, or of the output's RMS where the cell is smaller) and bit-equal in all
but 1% of cells; the BN statistics f32 at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rspnet_tpu.models.common import ConvBN as JaxConvBN
from rspnet_tpu.models.resnet3d import BasicBlock as JaxBasicBlock
from rspnet_tpu.models.resnet3d import Bottleneck as JaxBottleneck
from rspnet_tpu_torch.models import convert
from rspnet_tpu_torch.models.common import BatchNorm, conv_bn, make_conv
from rspnet_tpu_torch.models.resnet3d import BasicBlock, Bottleneck
from tests.test_torch_bf16 import (_bf16_values, _converted, _perturbed,
                                   _within_ulps)
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)
BF = torch.bfloat16
C_IN = 16


class _ConvBias(nn.Module):
    """C3D's stage: a conv with a bias, BN and a ReLU."""

    def __init__(self):
        super().__init__()
        self.conv = make_conv(C_IN, 24, 3, 1, 1, use_bias=True)
        self.bn = BatchNorm(24, dtype=BF)

    def forward(self, x):
        return conv_bn(self.conv, self.bn, x, BF)


def _block_mapping(n_convs: int, downsample: bool) -> list:
    m = []
    for c in range(1, n_convs + 1):
        m += convert._conv_bn(f"m.conv{c}", f"m.bn{c}", f"m/conv{c}")
    if downsample:
        m += convert._conv_bn("m.downsample.0", "m.downsample.1",
                              "m/downsample")
    return m


_JBF = dict(dtype=jnp.bfloat16)
# name -> (JAX module, port module, convert.py mapping)
BLOCKS = {
    "c3d_conv_bias": (
        lambda: JaxConvBN(24, 3, 1, 1, use_bias=True, **_JBF),
        _ConvBias, lambda: convert._conv_bn("m.conv", "m.bn", "m", True)),
    "basic_B_stride2": (
        lambda: JaxBasicBlock(24, 2, "B", needs_proj=True, **_JBF),
        lambda: BasicBlock(C_IN, 24, 2, "B", BF),
        lambda: _block_mapping(2, True)),
    "basic_A_stride2": (
        lambda: JaxBasicBlock(24, 2, "A", needs_proj=True, **_JBF),
        lambda: BasicBlock(C_IN, 24, 2, "A", BF),
        lambda: _block_mapping(2, False)),
    "basic_identity": (
        lambda: JaxBasicBlock(C_IN, 1, "B", **_JBF),
        lambda: BasicBlock(C_IN, C_IN, 1, "B", BF),
        lambda: _block_mapping(2, False)),
    "bottleneck_B": (
        lambda: JaxBottleneck(8, 2, "B", needs_proj=True, **_JBF),
        lambda: Bottleneck(C_IN, 8, 2, "B", BF),
        lambda: _block_mapping(3, True)),
}


@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_bf16_block_matches_jax(which):
    jax_mod, port_mod, mapping = BLOCKS[which]
    rng = np.random.RandomState(0)
    x = _bf16_values(np.maximum(rng.randn(2, 4, 10, 10, C_IN), 0)
                     + 0.1 * rng.randn(2, 4, 10, 10, C_IN))
    xj = jnp.asarray(x, jnp.bfloat16)
    jm = jax_mod()
    v = jm.init(jax.random.PRNGKey(0), xj, train=False)
    v = {"params": _perturbed(v["params"], rng),
         "batch_stats": v["batch_stats"]}
    out, mut = jm.apply(v, xj, train=True, mutable=["batch_stats"])
    assert out.dtype == jnp.bfloat16
    port = nn.ModuleDict({"m": port_mod()})
    convert.load_converted(port, _converted(
        mapping(), {"params": {"m": v["params"]},
                    "batch_stats": {"m": v["batch_stats"]}}))
    port.train()
    got = port["m"](torch.from_numpy(x).to(BF).permute(0, 4, 1, 2, 3))
    assert got.dtype == BF
    got = got.permute(0, 2, 3, 4, 1).float().detach().numpy()
    ref = np.asarray(out.astype(jnp.float32))
    assert _within_ulps(got, ref, 2)
    assert np.mean(got != ref) <= 0.01, np.mean(got != ref)
    stats_j = _converted([e for e in mapping() if e[1][0] == "batch_stats"],
                         {"batch_stats": {"m": mut["batch_stats"]}})
    stats_p = {k: b.numpy() for k, b in port.named_buffers()
               if k in stats_j}
    assert stats_p and set(stats_p) == set(stats_j)
    for k, ref_s in stats_j.items():
        assert stats_p[k].dtype == np.float32, k
        np.testing.assert_allclose(stats_p[k], ref_s, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
