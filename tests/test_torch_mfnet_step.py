"""One MoCo + RSP train step on MFNet-3D (published widths and depths),
the port against the JAX package, f64: params, BN statistics, queue and
metrics at atol 1e-8 / rtol 1e-7 (tests/test_torch_step.py's check, run
on ``mfnet``; its own file for the time budget).
"""
import torch

from tests import test_torch_step
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def test_mfnet_train_step_matches_jax():
    with enable_x64():
        test_torch_step._run("mfnet")
