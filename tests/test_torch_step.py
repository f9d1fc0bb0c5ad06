"""One MoCo + RSP train step of the port against the JAX step, f64.

The JAX side is ``moco.builder.make_train_step(..., axis_name=None)`` with
its default fused 2B key pass, on ``MultiTaskWrapper(S3DG)`` with the linear
heads; the port is ``rspnet_tpu_torch.moco.step.train_step``. Weights, BN
statistics and queue are the JAX state carried over by convert.py; the
permutation and speed row are the ones the JAX step draws from its key,
injected into the port. After one step, params_q, params_k, both BN
statistics, the queue, the queue pointer and every metric agree at atol
1e-8 / rtol 1e-7 (float64 on both sides, see tests/test_step_parity.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MoCoConfig as JaxMoCoConfig
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.moco.builder import MoCoState as JaxState
from rspnet_tpu.moco.builder import make_train_step
from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework.lr_schedule import build_optimizer
from rspnet_tpu_torch.models.convert import (load_converted,
                                             variables_to_state_dict)
from rspnet_tpu_torch.models import get_model_class as port_model_class
from rspnet_tpu_torch.moco import MoCoConfig, MoCoState, MultiTaskWrapper
from rspnet_tpu_torch.moco.step import train_step
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
B, T, S, DIM, K = 4, 16, 32, 8, 16


def _port_model(params, stats, arch="s3dg", model_cfg=None,
                fc_type="linear", factory=None):
    factory = factory or port_model_class(arch, **(model_cfg or {}))
    net = MultiTaskWrapper(factory(), num_classes=DIM, fc_type=fc_type)
    net = net.double().to(memory_format=torch.channels_last_3d)
    load_converted(net, variables_to_state_dict(
        {"params": np_tree(params), "batch_stats": np_tree(stats)}, arch))
    return net


def _assert_model(net, params, stats, what, arch="s3dg"):
    want = variables_to_state_dict({"params": np_tree(params),
                                    "batch_stats": np_tree(stats)}, arch)
    got = net.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref, atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what}: {name}")


def test_train_step_matches_jax():
    with enable_x64():
        _run()


def _run(arch="s3dg", model_cfg=None, fc_type="linear", factories=None):
    """One step of ``arch`` (built from ``model_cfg``, or by ``factories``,
    a (JAX, port) pair of backbone constructors, with ``fc_type`` heads)
    in both packages, compared (also run on C3D by
    tests/test_torch_zoo_step.py, on TSM by tests/test_torch_tsm.py, with
    the speednet heads by tests/test_torch_heads.py, on MFNet and on
    SlowFast by tests/test_torch_{mfnet,slowfast}_step.py)."""
    model_cfg = model_cfg or {}
    jax_factory, port_factory = factories or (
        get_model_class(arch, **model_cfg), None)
    jmodel = JaxWrapper(encoder_factory=jax_factory,
                        num_classes=DIM, fc_type=fc_type, axis_name=None)
    rng = np.random.RandomState(0)
    variables = init(jmodel, (1, T // 2, S, S, 3))
    params_q = np_tree(variables["params"])
    # the key encoder starts from other weights than the query encoder so
    # that the EMA is visible
    params_k = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), params_q)
    stats = np_tree(variables["batch_stats"])
    queue = rng.randn(DIM, K)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)

    cfg = JaxMoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=(2,),
                        fc_type=fc_type, margin=2.0)
    optimizer = optax.chain(optax.add_decayed_weights(1e-4),
                            optax.sgd(0.05, momentum=0.9))
    state = JaxState(params_q=params_q, params_k=params_k,
                     batch_stats_q=stats, batch_stats_k=stats,
                     queue=jnp.asarray(queue),
                     queue_ptr=jnp.zeros((), jnp.int32),
                     opt_state=jax.jit(optimizer.init)(params_q),
                     step=jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step(jmodel, optimizer, cfg, axis_name=None))
    x_q = rng.randn(B, T, S, S, 3)
    x_k = rng.randn(B, T, S, S, 3)
    key = jax.random.PRNGKey(7)

    # the JAX step's own draws (step_core.py:314-315, :181-205)
    rng_speed, _ = jax.random.split(key)
    key_perm, key_speed = jax.random.split(rng_speed)
    perm = np.array(jax.random.permutation(key_perm, B))
    speed_index = int(jax.random.randint(key_speed, (), 0, 1))

    # the port, from the same state
    model_q = _port_model(params_q, stats, arch, model_cfg, fc_type,
                          port_factory)
    model_k = _port_model(params_k, stats, arch, model_cfg, fc_type,
                          port_factory)
    for p in model_k.parameters():
        p.requires_grad_(False)
    opt = build_optimizer(ConfigTree.from_dict(
        {"lr": 0.05, "momentum": 0.9, "dampening": 0, "nesterov": False,
         "weight_decay": 1e-4}), model_q.parameters(), 0.05)
    pstate = MoCoState(model_q, model_k, torch.from_numpy(queue.copy()), 0,
                       opt)
    pcfg = MoCoConfig(dim=DIM, k=K, m=0.999, t=0.07, diff_speed=(2,),
                      fc_type=fc_type)
    metrics = train_step(pstate, torch.from_numpy(x_q), torch.from_numpy(x_k),
                         pcfg, perm=torch.from_numpy(perm),
                         speed_index=speed_index)

    new_state, jmetrics = step(state, jnp.asarray(x_q), jnp.asarray(x_k), key)

    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    _assert_model(pstate.model_q, new_state.params_q, new_state.batch_stats_q,
                  "encoder q", arch)
    _assert_model(pstate.model_k, new_state.params_k, new_state.batch_stats_k,
                  "encoder k", arch)
    np.testing.assert_allclose(pstate.queue.numpy(),
                               np.asarray(new_state.queue), atol=ATOL,
                               rtol=RTOL)
    assert pstate.queue_ptr == int(new_state.queue_ptr) == B
