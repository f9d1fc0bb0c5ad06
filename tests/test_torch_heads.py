"""The pretraining heads of the port (rspnet_tpu_torch/moco/wrapper.py)
against the JAX package's, f64 on the CPU.

- ``MultiTaskWrapper`` with each ``fc_type`` the port added, ``mlp``,
  ``conv``, ``convbn`` and ``speednet``, on ``r2plus1d-vcop``: both
  heads' outputs in train mode (every updated BN statistic too: the
  ``convbn`` head's BN) and in eval mode, at atol 1e-8 / rtol 1e-7,
  input [2, 8, 32, 32, 3]; weights drawn in the structure of the JAX
  init, carried over by ``models/convert.py`` (which reads the heads'
  kind from their names). speednet's RSP head is a [B, 1] sigmoid.
(The MoCo step with the speednet heads is in
tests/test_torch_heads_step.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import _np, _random_variables

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
T, S, DIM = 8, 32, 8
ARCH = "r2plus1d-vcop"


@pytest.mark.parametrize("fc_type", ["mlp", "conv", "convbn", "speednet"])
def test_head_wrapper_matches_jax(fc_type):
    jm = JaxWrapper(encoder_factory=jax_model_class(ARCH), num_classes=DIM,
                    fc_type=fc_type, axis_name=None)
    v = _random_variables(jm, np.random.default_rng(0), np.float64)
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    with enable_x64():
        @jax.jit
        def run(variables, xb):
            out, mut = jm.apply(variables, xb, train=True,
                                mutable=["batch_stats"])
            return out, mut["batch_stats"], jm.apply(variables, xb,
                                                     train=False)

        out_j, stats_j, eval_j = run(v, jnp.asarray(x))
    net = MultiTaskWrapper(get_model_class(ARCH)(), DIM, fc_type=fc_type)
    net = net.double().to(memory_format=torch.channels_last_3d)
    convert.load_converted(net, convert.variables_to_state_dict(v, ARCH))
    assert convert.state_dict_to_variables(net.state_dict(), ARCH)[
        "params"].keys() == v["params"].keys()
    for mode, ref in (("eval", eval_j), ("train", out_j)):
        net.train(mode == "train")
        got = net(torch.from_numpy(x))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                       atol=ATOL, rtol=RTOL, err_msg=mode)
    if fc_type == "speednet":
        assert got[1].shape == (2, 1)
        assert bool(((got[1] > 0) & (got[1] < 1)).all())
    want = convert.variables_to_state_dict(
        {"params": v["params"], "batch_stats": _np(stats_j)}, ARCH)
    buffers = dict(net.named_buffers())
    stats = [k for k in want if k in buffers]
    assert any(k.startswith("fc1.conv1.bn.") for k in stats) == (
        fc_type == "convbn")
    for k in stats:
        np.testing.assert_allclose(buffers[k].numpy(), want[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
