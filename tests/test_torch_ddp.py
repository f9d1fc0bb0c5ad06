"""Two gloo ranks of the port against the JAX package on a 2-device mesh
(the conftest's CPU devices), f64.

- The 1-D data-parallel MoCo step: two steps of exact multi-speed's
  speed-4 branch (``diff_speed: [4, 2]``, T_real 2 of an 8-frame window;
  one JAX compile) through the JAX ``make_variable_speed_train_steps`` on
  ``create_mesh(2)``, with the fused 2B key pass and cross-replica BN
  (the plain single-speed step is pinned in tests/test_torch_ddp_2d.py),
  against two ranks of the port's
  ``train_step`` under ``data_parallel_layout``, each rank on its rows of
  the global batch with the permutation its JAX replica draws
  (``fold_in(key, replica)``). TSM on resnet18 (tests/test_torch_tsm_step.py),
  a BN arch whose clip length rides the input. After both steps params_q,
  params_k, both BN statistics, the queue (the keys of both ranks, in rank
  order: F3), the pointer and the metrics of each step agree at atol 1e-8
  / rtol 1e-7 (tests/test_torch_step.py's tolerances), and the two ranks
  hold bit-equal state.
- The loader (F1): rank r's batch of a loader built with
  ``batch_multiplier = 2`` is rows [rB, (r+1)B) of the JAX loader's
  global batch, bit for bit.
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
from rspnet_tpu.moco.builder import make_variable_speed_train_steps
from rspnet_tpu.parallel import create_mesh
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64
from tests.test_torch_multispeed import _jax_draws
from tests.test_torch_step import ATOL, RTOL, _port_model
from tests.torch_ddp_ranks import run_ranks
from rspnet_tpu_torch.models.convert import variables_to_state_dict

torch.set_num_threads(1)

B, T, S, DIM, K = 2, 8, 16, 8, 16       # B rows a rank, global batch 2B
MODEL_CFG = {"base_model": "resnet18"}
OPT = {"lr": 0.05, "momentum": 0.9, "dampening": 0, "nesterov": False,
       "weight_decay": 1e-4}


def replica_perms(key, n=2, b=B):
    """Each JAX replica's permutation: the 1-D layout folds in the replica
    index (builder.py:121), the 2-D one the flat index d * M + m."""
    return [torch.from_numpy(_jax_draws(
        jax.random.split(jax.random.fold_in(key, r))[0], b)[0])
        for r in range(n)]


def assert_state(state, params, stats, what, arch="tsm"):
    want = variables_to_state_dict({"params": np_tree(params),
                                    "batch_stats": np_tree(stats)}, arch)
    for name, ref in want.items():
        np.testing.assert_allclose(state[name].numpy(), ref, atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what}: {name}")


def assert_ranks_equal(outs, layout):
    """Every rank holds the same parameters, BN statistics, queue and
    pointer, bit for bit."""
    a, b = outs[0][layout], outs[1][layout]
    assert a["ptr"] == b["ptr"]
    assert torch.equal(a["queue"], b["queue"])
    for which in ("q", "k"):
        for name, t in a[which].items():
            assert torch.equal(t, b[which][name]), (layout, which, name)


def jax_setup(axis_name, speeds, mesh, k=K):
    """(JAX model, optimizer, config, f64 state replicated over ``mesh``,
    the ranks' inputs, rng) of a TSM MoCo whose key encoder is moved off
    the query encoder. The trees are built in numpy (eager JAX ops would
    each compile) and placed on the mesh before the first step, so that
    the step compiles once."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmodel = JaxWrapper(encoder_factory=get_model_class("tsm", **MODEL_CFG),
                        num_classes=DIM, axis_name=axis_name)
    rng = np.random.RandomState(0)
    variables = init(jmodel, (1, 4, S, S, 3))
    params_q = np_tree(variables["params"])
    params_k = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), params_q)
    stats = np_tree(variables["batch_stats"])
    queue = rng.randn(DIM, k)
    queue /= np.linalg.norm(queue, axis=0, keepdims=True)
    cfg = JaxMoCoConfig(dim=DIM, k=k, m=0.999, t=0.07, diff_speed=speeds)
    optimizer = optax.chain(optax.add_decayed_weights(OPT["weight_decay"]),
                            optax.sgd(OPT["lr"], momentum=OPT["momentum"]))
    state = JaxState(params_q=params_q, params_k=params_k,
                     batch_stats_q=stats,
                     batch_stats_k=jax.tree_util.tree_map(np.copy, stats),
                     queue=queue, queue_ptr=np.zeros((), np.int32),
                     opt_state=jax.jit(optimizer.init)(params_q),
                     step=np.zeros((), np.int32))
    if "model" in mesh.shape:     # the queue sharded over K
        from rspnet_tpu.moco import shard_moco_state_2d
        state = shard_moco_state_2d(state, mesh)
    else:
        state = jax.device_put(state, NamedSharding(mesh, P()))
    port = {"arch": "tsm", "model_cfg": MODEL_CFG, "dim": DIM,
            "state_q": _port_model(params_q, stats, "tsm",
                                   MODEL_CFG).state_dict(),
            "state_k": _port_model(params_k, stats, "tsm",
                                   MODEL_CFG).state_dict(),
            "queue": torch.from_numpy(queue.copy()), "opt": OPT,
            "batch": B,
            "cfg": {"dim": DIM, "k": k, "m": 0.999, "t": 0.07,
                    "diff_speed": speeds}}
    return jmodel, optimizer, cfg, state, port, rng


def test_two_ranks_match_jax_data_parallel_steps():
    with enable_x64():
        _data_parallel_steps()


def _data_parallel_steps():
    speeds = (4, 2)
    mesh = create_mesh(2)
    jmodel, optimizer, cfg, state, port, rng = jax_setup("data", speeds,
                                                         mesh)
    steps = make_variable_speed_train_steps(jmodel, optimizer, cfg, mesh)
    port_steps, jmetrics = [], []
    for i, speed in enumerate((4, 4)):
        x_q = rng.randn(2 * B, T, S, S, 3)
        x_k = rng.randn(2 * B, T, S, S, 3)
        key = jax.random.PRNGKey(7 + i)
        port_steps.append({"speed": speed, "x_q": torch.from_numpy(x_q),
                           "x_k": torch.from_numpy(x_k),
                           "perms": replica_perms(key)})
        state, m = steps[speed](state, jnp.asarray(x_q), jnp.asarray(x_k),
                                key)
        jmetrics.append({k: float(v) for k, v in m.items()})
    outs = run_ranks("moco", {**port, "layouts": ["1d"],
                              "steps": port_steps})
    assert_ranks_equal(outs, "1d")
    got = outs[0]["1d"]
    for i, (mine, ref) in enumerate(zip(got["metrics"], jmetrics)):
        assert set(mine) == set(ref)
        for name in ref:
            np.testing.assert_allclose(mine[name], ref[name], atol=ATOL,
                                       rtol=RTOL,
                                       err_msg=f"step {i}: {name}")
    assert_state(got["q"], state.params_q, state.batch_stats_q, "encoder q")
    assert_state(got["k"], state.params_k, state.batch_stats_k, "encoder k")
    np.testing.assert_allclose(got["queue"].numpy(), np.asarray(state.queue),
                               atol=ATOL, rtol=RTOL)
    assert got["ptr"] == int(state.queue_ptr) == 2 * 2 * B % K


LOADER_EXT = ('{dataset+: {name: "synthetic", num_samples: 12, height: 40, '
              'width: 48}, batch_size: 3, num_workers: 1, seed: 5, '
              'spatial_transforms+: {size: 32}, temporal_transforms+: '
              '{_size:: 4}, device_geometry: true}')


def test_loader_shards_the_jax_global_batch():
    from rspnet_tpu.config import load_config
    from rspnet_tpu.data.pipeline import build_loader
    cfg = load_config("config/pretrain/s3dg.jsonnet", [LOADER_EXT])
    ld = build_loader(cfg, "train", vid=True, batch_multiplier=2)
    assert ld.cfg.process_count == 1
    ref = next(iter(ld))
    outs = run_ranks("loader", {"config": "config/pretrain/s3dg.jsonnet",
                                "ext": LOADER_EXT})
    b = 3
    for r, out in enumerate(outs):
        assert out["index"] == (r, 2)
        np.testing.assert_array_equal(out["labels"].numpy(),
                                      ref["labels"][r * b:(r + 1) * b])
        for got, want in zip(out["clips"], ref["clips"]):
            np.testing.assert_array_equal(got.numpy(),
                                          want[r * b:(r + 1) * b])

