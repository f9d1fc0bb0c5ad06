"""The classifier train step of the port against the JAX step, f64.

``engines/classifier.py:train_step`` against
``make_classifier_train_step(axis_name=None)`` on the multitask S3D-G
(``MultiTaskWrapper(finetune=True)``, a 7-way head) with SGD (momentum,
weight decay), f64 on both sides: after one step the parameters, the BN
statistics, loss, acc1 and acc5 agree at atol 1e-8 / rtol 1e-7. Also as
the linear probe (``only_train_fc``) on a 2-crop clip: the backbone's
parameters and BN statistics stay as they were, bit for bit, the model is
in eval mode, and the head matches JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rspnet_tpu.engines.classifier import (TrainState,
                                           make_classifier_train_step)
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.engines import classifier
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
from tests.test_step_parity import enable_x64
from tests.test_torch_finetune import (ATOL, RTOL, B, T, S, _assert_model,
                                       jax_variables, port_classifier)

torch.set_num_threads(1)
LR, WD, MOMENTUM = 0.05, 1e-4, 0.9


@pytest.mark.parametrize("only_train_fc,n_crop", [(False, 1), (True, 2)],
                         ids=["train", "only_train_fc"])
def test_train_step_matches_jax(only_train_fc, n_crop):
    with enable_x64():
        _train_step(only_train_fc, n_crop)


def _train_step(only_train_fc, n_crop):
    rng = np.random.RandomState(1)
    jm, params, stats = jax_variables(rng)
    optimizer = optax.chain(optax.add_decayed_weights(WD),
                            optax.sgd(LR, momentum=MOMENTUM))
    state = TrainState(params, stats, jax.jit(optimizer.init)(params),
                       jnp.zeros((), jnp.int32))
    clips = rng.randn(B, n_crop * T, S, S, 3)
    labels = np.array([0, 3, 6, 3], np.int32)
    step = jax.jit(make_classifier_train_step(
        jm, optimizer, n_crop=n_crop, axis_name=None,
        only_train_fc=only_train_fc))
    new_state, jmetrics = step(state, jnp.asarray(clips),
                               jnp.asarray(labels), jax.random.PRNGKey(2))

    net = port_classifier(params, stats)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = build_optimizer(ConfigTree.from_dict(
        {"lr": LR, "momentum": MOMENTUM, "dampening": 0, "nesterov": False,
         "weight_decay": WD}), net.parameters(), LR)
    metrics = classifier.train_step(
        net, opt, torch.from_numpy(clips), torch.from_numpy(labels),
        n_crop=n_crop, only_train_fc=only_train_fc)

    for name in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    # a 7-way head: top-5 is not trivially all hits
    assert float(jmetrics["acc5"]) < 100.0 or float(jmetrics["acc1"]) > 0
    _assert_model(net, new_state.params, new_state.batch_stats, "model")
    after = net.state_dict()
    frozen = [k for k in after if not k.startswith("fc.")]
    changed = [k for k in frozen if not torch.equal(after[k], before[k])]
    if only_train_fc:
        assert not changed, changed[:5]
        assert not net.training
        assert not torch.equal(after["fc.weight"], before["fc.weight"])
    else:
        assert any(k.endswith("running_mean") for k in changed)
        assert any(k.endswith("conv3d.weight") for k in changed)
