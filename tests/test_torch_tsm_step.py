"""One MoCo + RSP train step on TSM (the resnet18 base, as
config/pretrain/tsm-r18.jsonnet builds it), the port against the JAX
package, f64.

``moco/step.py:train_step`` on ``MultiTaskWrapper(TSM)`` against the JAX
``make_train_step``, with the JAX step's permutation and speed row
injected: params, BN statistics, queue and metrics at atol 1e-8 / rtol
1e-7 (tests/test_torch_step.py's check, run on ``tsm`` with
``model.base_model: resnet18``; its own file for the time budget).
"""
import torch

from tests import test_torch_step
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def test_tsm_train_step_matches_jax():
    with enable_x64():
        test_torch_step._run("tsm", {"base_model": "resnet18"})
