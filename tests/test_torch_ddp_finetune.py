"""Finetune, precise-BN and retrieval on two gloo ranks of the port
against the JAX package on a 2-device mesh, f64 at atol 1e-8 / rtol 1e-7
(tests/test_torch_finetune.py's tolerances). The model is the multitask
TSM-r18 classifier (7 classes) with its weights and BN statistics moved
off their init.

- ``engines/classifier.py:train_step`` with ``group`` against
  ``make_classifier_train_step(axis_name="data")`` under
  ``shard_classifier_step``: one SGD step (momentum, weight decay); the
  parameters, the BN statistics (cross-replica) and the loss, acc1 and
  acc5 (averaged over the ranks), on each rank.
- Then ``eval_step`` with ``group`` on a 2-crop global batch of 4 whose
  last row is padding (``mask`` False) against the JAX eval step: the
  masked sums, summed over the ranks, and the logits gathered in rank
  order.
- Precise-BN (``recalibrate_bn_stats``, each BN's moments over the group)
  over two global batches against ``recalibrate_batch_stats``
  (``make_stats_fn``'s cross-replica forward).
- Retrieval's ``crop_features`` on each rank's rows, then ``fetch_global``,
  against the JAX engine's feature function on the mesh: the features of
  the global batch on every rank; the mask and the labels come back in
  rank order.
- The retrieval CLI with ``--ws 2`` against ``--ws 1`` on one pretrain
  checkpoint: the same R@k and, within f32 rounding, the same features;
  rank 0 alone writes them.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from rspnet_tpu.engines import retrieval as jax_retrieval
from rspnet_tpu.engines.classifier import (TrainState,
                                           make_classifier_eval_step,
                                           make_classifier_train_step,
                                           shard_classifier_step)
from rspnet_tpu.engines.precise_bn import recalibrate_batch_stats
from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.parallel import create_mesh
from rspnet_tpu_torch.framework import save_state
from rspnet_tpu_torch.models import convert
from rspnet_tpu_torch.models import get_model_class as port_model_class
from rspnet_tpu_torch.models.convert import state_dict_to_variables
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.conftest import REPO_ROOT
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64
from tests.test_torch_ddp import (ATOL, MODEL_CFG, OPT, RTOL, S, T,
                                  assert_state)
from tests.test_torch_retrieval import ARTIFACTS, SYNTH
from tests.torch_ddp_ranks import run_ranks
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
C = 7
B = 2           # rows a rank


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_classifier_precise_bn_and_features_match_jax():
    with enable_x64():
        _finetune_jobs()


def _finetune_jobs():
    mesh = create_mesh(2)
    rng = np.random.RandomState(4)
    jm = JaxWrapper(encoder_factory=get_model_class("tsm", **MODEL_CFG),
                    num_classes=C, finetune=True, axis_name="data")
    v = init(jm, (1, 4, S, S, 3))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), np_tree(v["params"]))
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)),
        np_tree(v["batch_stats"]))
    net = MultiTaskWrapper(port_model_class("tsm", **MODEL_CFG)(),
                           num_classes=C, finetune=True).double()
    convert.load_variables(net, {"params": params, "batch_stats": stats},
                           "tsm")
    model = {"arch": "tsm", "model_cfg": MODEL_CFG, "num_classes": C,
             "state": net.state_dict(), "batch": B}

    # the train step, then the padded 2-crop validation batch
    optimizer = optax.chain(optax.add_decayed_weights(OPT["weight_decay"]),
                            optax.sgd(OPT["lr"], momentum=OPT["momentum"]))
    state = TrainState(params, stats, jax.jit(optimizer.init)(params),
                       np.zeros((), np.int32))
    clips = rng.randn(2 * B, T, S, S, 3)
    labels = np.array([0, 3, 6, 3], np.int32)
    step = shard_classifier_step(make_classifier_train_step(
        jm, optimizer, n_crop=1, axis_name="data"), mesh, donate=False)
    new_state, jmetrics = step(state, jnp.asarray(clips),
                               jnp.asarray(labels), jax.random.PRNGKey(2))
    ev_clips = rng.randn(2 * B, 2 * T, S, S, 3)
    ev_labels = np.array([1, 5, 2, 4], np.int32)
    ev_mask = np.array([True, True, True, False])
    ev = shard_classifier_step(make_classifier_eval_step(
        jm, n_crop=2, axis_name="data", return_logits=True), mesh,
        is_eval=True)
    jsums = ev(new_state, jnp.asarray(ev_clips), jnp.asarray(ev_labels),
               jnp.asarray(ev_mask))

    # precise-BN over two global batches
    batches = [rng.randn(2 * B, T, S, S, 3) for _ in range(2)]
    jstats = recalibrate_batch_stats(jm, mesh, params, stats, batches,
                                     jax.random.PRNGKey(5))

    # retrieval features of a 2-crop global batch
    stub = type("Stub", (), {})()
    stub.n_crop, stub.model, stub.mesh = 2, jm, mesh
    feature_fn = jax_retrieval.RetrievalEngine._build_feature_fn(stub)
    f_clips = rng.randn(2 * B, 2 * T, S, S, 3)
    f_mask = np.array([True, False, True, True])
    f_labels = np.array([3, 1, 4, 1], np.int32)
    jfeats = feature_fn(TrainState(params, stats, None, jnp.zeros(())),
                        jnp.asarray(f_clips))

    t = torch.from_numpy
    outs = run_ranks("several", {"jobs": [
        ("classifier", {**model, "clips": t(clips), "labels": t(labels),
                        "opt": OPT,
                        "eval": {"clips": t(ev_clips),
                                 "labels": t(ev_labels), "mask": t(ev_mask),
                                 "n_crop": 2, "batch": B}}),
        ("precise_bn", {**model, "batches": [t(x) for x in batches]}),
        ("features", {**model, "clips": t(f_clips), "mask": t(f_mask),
                      "labels": t(f_labels), "n_crop": 2})]})

    for rank, (cls, pbn, feats) in enumerate(outs):
        what = f"rank {rank}"
        for name in ("loss", "acc1", "acc5"):
            _close(cls["metrics"][name], jmetrics[name], f"{what} {name}")
        assert_state(cls["state"], new_state.params, new_state.batch_stats,
                     f"{what} classifier")
        for name in ("loss_sum", "correct1", "correct5", "count", "logits"):
            _close(cls["sums"][name].numpy(), jsums[name], f"{what} {name}")
        assert float(cls["sums"]["count"]) == 3.0
        assert pbn["n"] == 2
        assert_state(pbn["state"], params, jstats, f"{what} precise-BN")
        _close(feats["feats"], jfeats, f"{what} features")
        np.testing.assert_array_equal(feats["mask"], f_mask)
        np.testing.assert_array_equal(feats["labels"], f_labels)
    # the step moved the statistics that precise-BN then replaced
    assert not np.allclose(np.asarray(
        jax.tree_util.tree_leaves(jstats)[0]), np.asarray(
        jax.tree_util.tree_leaves(stats)[0]))


def _pretrain_checkpoint(path):
    """A pretrain checkpoint of a random C3D (the retrieval config's
    arch) in the port's layout."""
    torch.manual_seed(0)
    net = MultiTaskWrapper(port_model_class("c3d")(), num_classes=8)
    v = state_dict_to_variables(net.state_dict(), "c3d")
    save_state({"epoch": 1, "arch": "c3d", "model": {
        "params_q": v["params"], "params_k": v["params"],
        "batch_stats_q": v["batch_stats"], "batch_stats_k": v["batch_stats"],
        "queue": np.zeros((8, 8), np.float32),
        "queue_ptr": np.zeros((), np.int32)}}, path)


def _retrieval(exp, ckpt, ws):
    # no -d: it would cap each split at 3 batches, of 1 and of 2 clips
    argv = ["-c", "config/retrieval/ucf101_c3d.jsonnet", "-e", str(exp),
            "-x", SYNTH, "{dataset+: {num_samples: 8}}", "--seed", "1",
            "--device", "cpu", "--mc", str(ckpt), "--ws", str(ws)]
    proc = subprocess.run(
        [sys.executable, "-m", "rspnet_tpu_torch.retrieval", *argv],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = list(exp.glob("run_*"))
    assert len(runs) == 1, runs
    return runs[0]


def test_retrieval_cli_two_ranks(tmp_path):
    ckpt = tmp_path / "c3d.pth.tar"
    _pretrain_checkpoint(ckpt)
    one = _retrieval(tmp_path / "one", ckpt, 1)
    two = _retrieval(tmp_path / "two", ckpt, 2)
    names = {p.name for p in two.iterdir()
             if p.suffix in (".npy", ".json") and p.name != "config.json"}
    assert names == ARTIFACTS
    assert (json.loads((two / "topk_correct.json").read_text())
            == json.loads((one / "topk_correct.json").read_text()))
    for name in ARTIFACTS - {"topk_correct.json"}:
        got, want = np.load(two / name), np.load(one / name)
        if "feat" in name:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)
