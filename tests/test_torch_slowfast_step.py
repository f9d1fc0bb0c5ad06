"""One MoCo + RSP train step on SlowFast, the port against the JAX
package, f64: params, BN statistics, queue and metrics at atol 1e-8 /
rtol 1e-7 (tests/test_torch_step.py's check). The spec is
``SLOWFAST_NLN_4x16_R50`` at its published widths, cut to depths
(1, 1, 1, 1) in both packages with a ``dot_product`` non-local block
after res3's and res4's block (tests/test_torch_slowfast.py's cut): the
fused 2B key
pass, the lateral fusion and the non-local pools, at [4, 16, 32, 32, 3]
(8 frames after the speed gather: one slow frame).
"""
import functools

import torch

from rspnet_tpu.models import slowfast as jsf
from rspnet_tpu_torch.models import slowfast as sf
from tests import test_torch_step
from tests.test_step_parity import enable_x64
from tests.test_torch_slowfast import CUTS
from tests.test_torch_zoo import release_jax_memory  # noqa: F401

torch.set_num_threads(1)


def test_slowfast_train_step_matches_jax():
    jspec, pspec, _, _ = CUTS["slowfast_nln"]
    with enable_x64():
        test_torch_step._run("slowfast", factories=(
            functools.partial(jsf.SlowFast, spec=jspec),
            functools.partial(sf.SlowFast, spec=pspec)))

