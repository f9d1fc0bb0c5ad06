"""One MoCo + RSP train step with the ``speednet`` heads, the port against
the JAX package, f64.

``moco/step.py:train_step`` on ``MultiTaskWrapper(TSM, fc_type=
"speednet")`` (the resnet18 base, the cheapest backbone to step in f64)
against the JAX ``make_train_step``, with the JAX step's permutation and
speed row injected: the unchanged step's dot products and margin loss on
the [B, 1] sigmoid RSP outputs; params, BN statistics, queue and metrics
at atol 1e-8 / rtol 1e-7 (tests/test_torch_step.py's check).
"""
import torch

from tests import test_torch_step
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def test_speednet_train_step_matches_jax():
    with enable_x64():
        test_torch_step._run("tsm", {"base_model": "resnet18"},
                             fc_type="speednet")
