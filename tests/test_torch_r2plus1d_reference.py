"""The port's R(2+1)D-10 (``r2plus1d-vcop``) against the benchmark's plain
float32 reference backbone (``benchmark/reference/backbones/
r2plus1d-vcop.py``), on the CPU in float32 at batch 2, 8 frames, 32 x 32:
one state dict seeded by the benchmark's ``make_weights`` loaded into
both, then the conv5 features and every parameter's gradient compared.
"""
import pytest
import torch

from benchmark.reference import models
from benchmark.run import make_weights
from rspnet_tpu_torch.models.r2plus1d import r2plus1d_vcop

torch.set_num_threads(1)

ARCH = "r2plus1d-vcop"
# Tolerances. Both sides compute in float32 (eps 1.2e-7) with the same
# operations, but the port's convolutions see channels-last tensors and
# sum in another order. Ten batch norms carry those roundings on: the
# features differ by 1.1e-5 to 1.4e-5 of their norm (8 seeds). A gradient
# leaf is held by its gap over the larger of its norm and the median
# leaf's, as the benchmark's check does: the BN shifts of stage 2 sum
# thousands of terms that nearly cancel, and read gaps up to 6.9e-3 (8
# seeds); the rest stay under 1e-4.
FEATURES_RTOL = 1e-4
GRAD_GAP = 3e-2


def _backbones(seed):
    state = {k[len("encoder."):]: v
             for k, v in make_weights(ARCH, 128, seed, "cpu").items()
             if k.startswith("encoder.")}
    port = r2plus1d_vcop()
    ref = models.build(ARCH, 128).encoder
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port.train(), ref.train()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_features_and_gradients_match_the_reference(seed):
    port, ref = _backbones(seed)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 8, 32, 32, 3, generator=gen).permute(0, 4, 1, 2, 3)
    pf, rf = port.features(x), ref.features(x)
    assert pf.shape == rf.shape == (2, 512, 1, 2, 2)
    assert (pf - rf).norm() <= FEATURES_RTOL * rf.norm()

    w = torch.randn(rf.shape, generator=gen)
    names = [n for n, _ in ref.named_parameters()]
    assert names == [n for n, _ in port.named_parameters()]
    pg = torch.autograd.grad((pf * w).sum(), list(port.parameters()))
    rg = torch.autograd.grad((rf * w).sum(), list(ref.parameters()))
    norms = torch.stack([g.norm() for g in rg])
    med = norms.median()
    for n, a, b, nb in zip(names, pg, rg, norms):
        assert (a - b).norm() <= GRAD_GAP * torch.maximum(nb, med), n
