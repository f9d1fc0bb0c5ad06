"""The port's SlowFast-NLN R50 4x16 against the benchmark's plain float32
reference backbone (``benchmark/reference/backbones/
SLOWFAST_NLN_4x16_R50.py``), on the CPU in float32 at a cut: one
bottleneck a stage, a non-local block after res3's and res4's, batch 2,
16 frames, 32 x 32. Every kind of module of the published spec is still
there: both stems and their pools, the four lateral fusions, the
non-local pools and products, the projections. One state dict seeded by
the benchmark's ``make_weights`` (at the cut) is loaded into both, then
the features and every parameter's gradient are compared. And the
pyslowfast YAML the configuration names reads as the spec the port
builds.
"""
import dataclasses

import pytest
import torch

from benchmark.reference import models
from benchmark.run import make_weights
from rspnet_tpu_torch.models import slowfast as sf

torch.set_num_threads(1)

ARCH = "SLOWFAST_NLN_4x16_R50"
YAML = "config/slowfast-configs/Kinetics/SLOWFAST_NLN_4x16_R50.yaml"
DEPTHS = (1, 1, 1, 1)
NONLOCAL = ((), (0,), (0,), ())
# Tolerances. Both sides compute in float32 (eps 1.2e-7) with the same
# operations, but the port's convolutions see channels-last tensors and
# the attention's products sum in another order; the batch norms on the
# way carry those roundings on: the features differ by 1.0e-5 to 1.5e-5
# of their norm (8 seeds, one thread). A gradient leaf is held by its gap
# over the larger of its norm and the median leaf's, as the benchmark's
# check does. Most leaves read under 1.6e-4; the BN shifts of the first
# bottlenecks read up to 1.5e-2 (8 seeds): their gradients nearly cancel
# (the batch norms after them take the mean out), and the reference's
# slow pathway is NCDHW-contiguous after its frame selection, where a
# one-thread batch-norm backward sums each channel in one running f32
# sum (seed 0, against float64: 3.3e-3 in the reference, 8e-5 in the
# port). A non-local block's output bias feeds a batch norm, where a
# bias cancels: its gradient is rounding alone, held by the median
# leaf's norm.
FEATURES_RTOL = 1e-4
GRAD_GAP = 5e-2


def _cut_spec():
    return dataclasses.replace(sf.SPECS[ARCH], depths=DEPTHS,
                               nbtk_slow=DEPTHS, nbtk_fast=DEPTHS,
                               nl_blocks=NONLOCAL)


def _backbones(seed, monkeypatch):
    mod = models._load(models.BACKBONE_DIR / f"{ARCH}.py")
    build = mod.build
    monkeypatch.setattr(mod, "build", lambda: build(DEPTHS, NONLOCAL))
    state = {k[len("encoder."):]: v
             for k, v in make_weights(ARCH, 128, seed, "cpu").items()
             if k.startswith("encoder.")}
    port = sf.SlowFast(spec=_cut_spec())
    ref = models.build(ARCH, 128).encoder
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port.train(), ref.train()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_features_and_gradients_match_the_reference(seed, monkeypatch):
    port, ref = _backbones(seed, monkeypatch)
    assert port.feature_dim == ref.feature_dim == 2304
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 32, 32, 3, generator=gen).permute(0, 4, 1, 2, 3)
    pf, rf = port.features(x), ref.features(x)
    assert pf.shape == rf.shape == (2, 2304, 2, 1, 1)
    assert (pf - rf).norm() <= FEATURES_RTOL * rf.norm()

    w = torch.randn(rf.shape, generator=gen)
    names = [n for n, _ in ref.named_parameters()]
    assert sorted(names) == sorted(n for n, _ in port.named_parameters())
    port_params = dict(port.named_parameters())
    pg = torch.autograd.grad((pf * w).sum(),
                             [port_params[n] for n in names])
    rg = torch.autograd.grad((rf * w).sum(), list(ref.parameters()))
    norms = torch.stack([g.norm() for g in rg])
    med = norms.median()
    for n, a, b, nb in zip(names, pg, rg, norms):
        assert (a - b).norm() <= GRAD_GAP * torch.maximum(nb, med), n


def test_the_published_yaml_is_the_spec():
    spec = sf.spec_from_yaml(YAML)
    assert dataclasses.replace(spec, name=ARCH) == sf.SPECS[ARCH]
