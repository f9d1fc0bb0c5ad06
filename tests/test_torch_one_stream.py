"""``model_type: 1stream`` in the port against the JAX package, f64 on the
CPU.

- Finetune: two classifier steps on R(2+1)D (``r2plus1d-vcop``), and on
  S3D-G with its dropout masks taken from the JAX step's own draws and
  injected (tests/test_torch_one_stream_s3dg.py, for the time budget). Each package builds the model with its
  ``build_classifier_model`` from one config and overlays a pretraining
  encoder with its ``merge_encoder_into``, which leaves the backbone's
  own classifier (``fc``, ``linear``) as built. The merged models, then
  after each step loss, acc1, acc5, every parameter and every BN
  statistic, agree at atol 1e-8 / rtol 1e-7.
- Retrieval: ``engines/retrieval.py:crop_features`` on a bare TSM
  backbone (the 1stream model, resnet18 base cut to ``(1, 1, 1, 1)``) at
  2 crops against the JAX engine's function (the backbone's
  ``method="features"``, the global average and the crop mean,
  rspnet_tpu/engines/retrieval.py:85-97), at atol 1e-8 / rtol 1e-7.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from rspnet_tpu.engines.classifier import (TrainState,
                                           make_classifier_train_step)
from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.models import tsm as jtsm
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.engines import classifier
from rspnet_tpu_torch.engines.retrieval import crop_features
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
from rspnet_tpu_torch.models import convert, tsm
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import _np, _random_variables

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
T, S, NC, B = 8, 32, 5, 4


def _port(net):
    return net.double().to(memory_format=torch.channels_last_3d)


def _assert_model(net, params, stats, arch, what):
    want = convert.variables_to_state_dict(
        {"params": _np(params), "batch_stats": _np(stats)}, arch)
    got = net.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref, atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what}: {name}")


def one_stream_steps(arch, n_steps=2, dropout_masks=None, seed=0,
                     lr=0.05, modules=None):
    """``n_steps`` SGD steps (``lr``, momentum, weight decay) of a
    ``1stream`` model in both packages from one merged state (module
    docstring). ``dropout_masks(jm)`` gives a function (state, clips, key)
    -> the JAX step's dropout mask, for the port. ``modules``, when
    given, is (JAX model, port model, JAX encoder without its classifier)
    in place of the ones ``arch``'s config builds."""
    from rspnet_tpu.config import ConfigTree as JaxConfigTree
    from rspnet_tpu.engines.finetune import \
        build_classifier_model as jax_build
    from rspnet_tpu.engines.transfer import merge_encoder_into as jax_merge
    from rspnet_tpu_torch.engines.finetune import build_classifier_model
    from rspnet_tpu_torch.engines.transfer import merge_encoder_into

    rng = np.random.RandomState(seed)
    d = {"model": {"arch": arch}, "model_type": "1stream",
         "dataset": {"num_classes": NC}}
    if modules is None:
        jm, model_type = jax_build(JaxConfigTree.from_dict(d),
                                   axis_name=None)
        assert model_type == "1stream"
        net, model_type = build_classifier_model(ConfigTree.from_dict(d))
        assert model_type == "1stream"
        jenc = jax_model_class(arch)(with_classifier=False)
    else:
        jm, net, jenc = modules
    v = _random_variables(jm, np.random.default_rng(seed), np.float64)
    # a pretraining encoder: the backbone without its classifier
    enc = _random_variables(jenc, np.random.default_rng(seed + 1),
                            np.float64)
    params, stats = jax_merge(v["params"], v["batch_stats"], enc["params"],
                              enc["batch_stats"], "1stream")
    head = [k for k in v["params"] if k not in enc["params"]]
    assert head and all(params[k] is v["params"][k] for k in head)

    net = _port(net)
    convert.load_converted(net, convert.variables_to_state_dict(v, arch))
    before = {k: t.clone() for k, t in net.state_dict().items()}
    merge_encoder_into(net, convert.variables_to_state_dict(enc, arch),
                       "1stream")
    _assert_model(net, params, stats, arch, "after the merge")
    for k, t in net.state_dict().items():
        if k.split(".")[0] in head:      # the classifier stays as built
            assert torch.equal(t, before[k]), k

    wd, momentum = 1e-4, 0.9
    optimizer = optax.chain(optax.add_decayed_weights(wd),
                            optax.sgd(lr, momentum=momentum))
    opt = build_optimizer(ConfigTree.from_dict(
        {"lr": lr, "momentum": momentum, "dampening": 0, "nesterov": False,
         "weight_decay": wd}), net.parameters(), lr)
    with enable_x64():
        state = TrainState(params, stats, jax.jit(optimizer.init)(params),
                           jnp.zeros((), jnp.int32))
        step = jax.jit(make_classifier_train_step(jm, optimizer, n_crop=1,
                                                  axis_name=None))
        masks = dropout_masks(jm) if dropout_masks is not None else None
        for i in range(n_steps):
            clips = rng.randn(B, T, S, S, 3)
            labels = rng.randint(0, NC, B).astype(np.int32)
            key = jax.random.PRNGKey(10 + i)
            mask = None if masks is None else masks(state, clips, key)
            state, jmetrics = step(state, jnp.asarray(clips),
                                   jnp.asarray(labels), key)
            metrics = classifier.train_step(
                net, opt, torch.from_numpy(clips), torch.from_numpy(labels),
                dropout_mask=mask)
            for name in ("loss", "acc1", "acc5"):
                np.testing.assert_allclose(float(metrics[name]),
                                           float(jmetrics[name]), atol=ATOL,
                                           rtol=RTOL, err_msg=name)
            _assert_model(net, state.params, state.batch_stats, arch,
                          f"step {i + 1}")
    return net


def test_r2plus1d_one_stream_steps_match_jax():
    net = one_stream_steps("r2plus1d-vcop")
    assert net.linear is not None


def test_one_stream_retrieval_features_match_jax():
    kw = dict(layers=(1, 1, 1, 1), basic=True)
    jm = jtsm.TSM(num_classes=NC, **kw)
    v = _random_variables(jm, np.random.default_rng(2), np.float64)
    n_crop = 2
    clips = np.random.RandomState(3).randn(3, n_crop * T, S, S, 3)
    with enable_x64():
        @jax.jit
        def feats(variables, x):
            # rspnet_tpu/engines/retrieval.py:85-97, one replica
            b = x.shape[0]
            x = x.reshape((b * n_crop, T) + x.shape[2:])
            fmap = jm.apply(variables, x, train=False, method="features")
            f = jnp.mean(fmap, axis=(1, 2, 3))
            return f.reshape(b, n_crop, -1).mean(axis=1)

        ref = np.asarray(feats(v, jnp.asarray(clips)))
    net = _port(functools.partial(tsm.TSM, **kw)(num_classes=NC,
                                                 with_classifier=True))
    convert.load_converted(net, convert.variables_to_state_dict(v, "tsm"))
    net.eval()
    got = crop_features(net, torch.from_numpy(clips), n_crop)
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
