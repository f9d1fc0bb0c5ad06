"""SlowFast's forward, every gradient and the BN statistics against the
JAX package's in f64 at atol 1e-8 / rtol 1e-7, for the three cuts of
tests/test_torch_slowfast.py (two-pathway NLN, single-pathway I3D NLN,
sub-batchnorm; see its docstring), in their own file for the time budget.
"""
import numpy as np
import pytest
import torch

from rspnet_tpu.models import common as jcommon
from rspnet_tpu_torch.models import slowfast as sf
from tests.test_torch_slowfast import (CUTS, S, _F64Numpy, _modules,
                                       forward_grad_parity)
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(CUTS))
def test_forward_and_gradients_match_jax(name, monkeypatch):
    if name == "slowfast_subbn":
        monkeypatch.setattr(jcommon, "jnp", _F64Numpy())
    _, _, t, b = CUTS[name]
    x = np.random.RandomState(0).randn(b, t, S, S, 3)
    net = forward_grad_parity(*_modules(name), "slowfast", x)
    spec = CUTS[name][1]
    assert net.feature_dim == (2304 if spec.two_pathway else 2048)
    n_nl = sum(isinstance(m, sf.NonLocal) for m in net.modules())
    assert n_nl == sum(len(s) for s in spec.nl_blocks)
