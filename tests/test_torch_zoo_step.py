"""One MoCo + RSP train step on C3D, the port against the JAX package, f64.

``moco/step.py:train_step`` on ``MultiTaskWrapper(C3D)`` against the JAX
``make_train_step``, with the JAX step's permutation and speed row injected:
params, BN statistics (C3D's conv biases before BN included), queue and
metrics at atol 1e-8 / rtol 1e-7 (tests/test_torch_step.py, run on C3D).
"""
import torch

from tests import test_torch_step
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def test_c3d_train_step_matches_jax():
    with enable_x64():
        test_torch_step._run("c3d")
