"""The port's S3D-G (rspnet_tpu_torch/models) against the JAX S3D-G, f64.

Weights are made by the JAX model's init and carried over by
rspnet_tpu_torch/models/convert.py. One train-mode forward at
[2, 8, 32, 32, 3] (every pool site on its CPU plain version): the output,
the gradient of every parameter and every updated BN running statistic
agree at atol 1e-8 / rtol 1e-7. Float64 on both sides (jax_enable_x64 and
torch.double), as tests/test_step_parity.py does: in f32 cross-framework
rounding through BN backward swamps any semantic difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models.s3dg import S3DG as JaxS3DG
from rspnet_tpu_torch.models.convert import (load_converted,
                                             variables_to_state_dict)
from rspnet_tpu_torch.models.s3dg import S3DG
from tests.test_step_parity import enable_x64

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_s3dg_forward_and_gradients_match_jax():
    with enable_x64():
        model = JaxS3DG(with_classifier=False)
        rng = np.random.RandomState(0)
        x = rng.randn(2, 8, 32, 32, 3)
        variables = jax.jit(lambda k, v: model.init(k, v, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32))
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), dict(variables))
        # perturb every parameter so BN scale/bias leave their identity
        # init
        variables["params"] = jax.tree_util.tree_map(
            lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape)),
            variables["params"])
        # cotangent scaled so the gradients are O(1): at 32x32 the deep
        # stages are 1x1, BN there sees 2 values per channel and amplifies
        # gradients ~1e4, which would make atol 1e-8 a 1e-12 relative test
        w = rng.randn(2, 1024) * 1e-4

        def loss(params, stats, xb):
            out, mut = model.apply({"params": params, "batch_stats": stats},
                                   xb, train=True, mutable=["batch_stats"])
            return jnp.sum(out * w), (out, mut["batch_stats"])

        grads, (out_j, stats_j) = jax.jit(jax.grad(loss, has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(x))

        net = S3DG().double().to(memory_format=torch.channels_last_3d)
        load_converted(net, variables_to_state_dict(_np_tree(variables)))
        net.train()
        out_t = net(torch.from_numpy(x))
        (out_t * torch.from_numpy(w)).sum().backward()

        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   atol=ATOL, rtol=RTOL)
        want = variables_to_state_dict({"params": _np_tree(grads),
                                        "batch_stats": _np_tree(stats_j)})
        params = dict(net.named_parameters())
        buffers = dict(net.named_buffers())
        assert set(params) | {k for k in buffers
                              if not k.endswith("num_batches_tracked")} \
            == set(want)
        for name, ref in want.items():
            got = (params[name].grad if name in params
                   else buffers[name]).detach().numpy()
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                       err_msg=name)


def test_convert_rejects_unported_arch():
    with pytest.raises(NotImplementedError):
        variables_to_state_dict({"params": {}}, arch="mfnet")
