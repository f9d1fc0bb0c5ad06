"""The finetune workload of the port against the JAX package, on the CPU.

- The eval step (``engines/classifier.py:eval_step``) on the multitask
  S3D-G (``MultiTaskWrapper(finetune=True)``) against
  ``make_classifier_eval_step`` at ``n_crop=2`` with a masked tail, f64:
  the four sums at atol 1e-8 / rtol 1e-7.
- ``center_crop_params`` equal, and ``eval_preprocess`` (f32 in both
  packages by design: the uint8 clip is scaled in f32) at atol 1e-6, as
  ``crop_resize`` is held in tests/test_torch_ops.py.
- The eval step's masked top-k counts equal to JAX's ``masked_accuracy``
  (as counts); top-k accuracy on bf16 logits equal to JAX's (fault F9).
- bf16, in tests/test_torch_bf16.py's style: the head (``dense`` on the
  pooled features) and the loss on bf16 logits, against the JAX modules
  built with ``dtype=jnp.bfloat16`` and optax's cross entropy: logits
  within 2 bf16 ulps and bit-equal in at least 92% of cells, the per-sample
  losses within 2 ulps, the batch loss within 1 ulp, and the head's
  gradient as the logits.
  (The train step's parity is in tests/test_torch_classifier.py.)
- The CLI: ``python -m rspnet_tpu_torch.pretrain`` then
  ``python -m rspnet_tpu_torch.finetune --mc`` on synthetic data at 32²
  and 8 frames, on the CPU; ``--validate`` from its checkpoint; the
  default device and unported options raise; ``cache_device`` builds both
  splits' device caches.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rspnet_tpu.engines.classifier import (TrainState,
                                           make_classifier_eval_step)
from rspnet_tpu.framework.metrics import accuracy as jax_accuracy
from rspnet_tpu.framework.metrics import masked_accuracy as jax_masked_acc
from rspnet_tpu.models import get_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu.ops import augment as jaug
from rspnet_tpu_torch import finetune
from rspnet_tpu_torch.data.device_cache import DeviceCachedLoader
from rspnet_tpu_torch.engines import classifier
from rspnet_tpu_torch.engines import finetune as ft_engine
from rspnet_tpu_torch.framework.metrics import (accuracy,
                                                masked_topk_correct)
from rspnet_tpu_torch.models import convert
from rspnet_tpu_torch.models.s3dg import S3DG
from rspnet_tpu_torch.moco import MultiTaskWrapper
from rspnet_tpu_torch.moco.wrapper import dense
from rspnet_tpu_torch.ops import augment as taug
from tests.conftest import REPO_ROOT
from tests.jax_models import init, np_tree
from tests.test_step_parity import enable_x64
from tests.test_torch_bf16 import _bf16_values, _within_ulps, ulp_bf16
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
ATOL, RTOL = 1e-8, 1e-7
B, T, S, C = 4, 8, 32, 7


def jax_classifier(num_classes=C, dtype=None):
    return JaxWrapper(encoder_factory=get_model_class("s3dg"),
                      num_classes=num_classes, finetune=True, dtype=dtype,
                      axis_name=None)


def jax_variables(rng, num_classes=C):
    """f64 JAX variables of the multitask S3D-G classifier, moved off
    their init (BN running statistics too, so eval-mode BN normalizes)."""
    jm = jax_classifier(num_classes)
    v = init(jm, (1, T, S, S, 3))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.randn(*a.shape), np_tree(v["params"]))
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)),
        np_tree(v["batch_stats"]))
    return jm, params, stats


def port_classifier(params, stats, num_classes=C):
    net = MultiTaskWrapper(S3DG(), num_classes=num_classes,
                           finetune=True).double()
    net = net.to(memory_format=torch.channels_last_3d)
    convert.load_variables(net, {"params": np_tree(params),
                                 "batch_stats": np_tree(stats)})
    return net


def _assert_model(net, params, stats, what):
    want = convert.variables_to_state_dict({"params": np_tree(params),
                                            "batch_stats": np_tree(stats)})
    got = net.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref, atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what}: {name}")


def test_eval_step_matches_jax_masked_multicrop():
    with enable_x64():
        rng = np.random.RandomState(3)
        jm, params, stats = jax_variables(rng)
        n = 2
        clips = rng.randn(3, n * T, S, S, 3)
        labels = np.array([1, 5, 2], np.int32)
        mask = np.array([True, True, False])
        state = TrainState(params, stats, None, jnp.zeros((), jnp.int32))
        ref = jax.jit(make_classifier_eval_step(jm, n_crop=n,
                                                axis_name=None))(
            state, jnp.asarray(clips), jnp.asarray(labels),
            jnp.asarray(mask))
        net = port_classifier(params, stats)
        net.train()
        before = {k: v.clone() for k, v in net.state_dict().items()}
        got = classifier.eval_step(net, torch.from_numpy(clips),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(mask), n_crop=n)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert float(got["count"]) == 2.0 and float(got["loss_sum"]) > 0
    assert net.training
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_eval_preprocess_and_center_crop_match_jax():
    rng = np.random.default_rng(4)
    batch = rng.integers(0, 256, (2, 3, 20, 30, 3), dtype=np.uint8)
    for hw, ratio in (((20, 30), 1.0), ((30, 20), 1.0), ((20, 30), 4 / 3)):
        p_t = taug.center_crop_params(2, [hw], ratio)
        p_j = jaug.center_crop_params(2, [hw], ratio)
        for f in ("boxes", "flip", "jitter", "order", "gray", "blur"):
            np.testing.assert_array_equal(getattr(p_t, f), getattr(p_j, f))
    p = taug.center_crop_params(2, [(20, 30)])
    kw = dict(size=(16, 16), mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.25))
    ref = np.asarray(jaug.eval_preprocess(jnp.asarray(batch), p.boxes, **kw))
    got = taug.eval_preprocess(torch.from_numpy(batch), p.boxes, **kw)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_masked_topk_correct_matches_jax():
    """The eval step's masked top-k counts: JAX's ``masked_accuracy``
    times the valid rows over 100."""
    rng = np.random.RandomState(5)
    out = rng.randn(6, 4)
    target = np.array([0, 1, 2, 3, 0, 1])
    mask = np.array([True, True, True, False, True, False])
    for topk in ((1,), (1, 5), (2, 3)):
        ref = jax_masked_acc(jnp.asarray(out), jnp.asarray(target),
                             jnp.asarray(mask), topk)
        got = masked_topk_correct(torch.from_numpy(out),
                                  torch.from_numpy(target),
                                  torch.from_numpy(mask), topk)
        assert [float(g) for g in got] == [
            round(float(r) * mask.sum() / 100.0) for r in ref]


def test_accuracy_of_bf16_logits_in_f32():
    """Fault F9 (repaired here), on bf16 logits: the port's top-k accuracy
    was a bf16 product, 8 significant bits, where JAX counts in f32
    (rspnet_tpu/framework/metrics.py:26-30); and ``torch.topk`` ranked
    tied logits in no fixed order, where ``jax.lax.top_k`` ranks the lower
    class first."""
    rng = np.random.RandomState(7)
    logits = _bf16_values(rng.randn(64, 10))
    # 16 rows whose top logit is tied between classes 2 and 7
    logits[:16, 2] = logits[:16, 7] = 4.0
    target = np.where(rng.rand(64) < 0.6, logits.argmax(1),
                      (logits.argmax(1) + 1) % 10)
    ref = jax_accuracy(jnp.asarray(logits, jnp.bfloat16),
                       jnp.asarray(target), topk=(1, 5))
    got = accuracy(torch.from_numpy(logits).to(torch.bfloat16),
                   torch.from_numpy(target), topk=(1, 5))
    assert [g.dtype for g in got] == [torch.float32] * 2
    assert [float(g) for g in got] == [float(r) for r in ref]
    # the percentage has more significant bits than bf16 holds
    assert float(torch.tensor(float(got[0])).to(torch.bfloat16)) != float(
        got[0])


def test_bf16_head_and_loss_match_jax():
    """The classifier head on bf16 features and optax's cross entropy on
    its bf16 logits, as the JAX step computes them on its accelerator."""
    import flax.linen as fnn
    from rspnet_tpu.models.common import global_avg_pool

    class JaxHead(fnn.Module):
        @fnn.compact
        def __call__(self, feat):
            return fnn.Dense(101, dtype=jnp.bfloat16, name="fc")(
                global_avg_pool(feat))

    rng = np.random.RandomState(6)
    feat = _bf16_values(np.abs(rng.randn(16, 2, 3, 3, 64)))
    labels = rng.randint(0, 101, 16).astype(np.int32)
    jm = JaxHead()
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(feat, jnp.bfloat16))
    kernel = (np.asarray(v["params"]["fc"]["kernel"])
              + 0.2 * rng.randn(64, 101)).astype(np.float32)
    bias = (0.5 * rng.randn(101)).astype(np.float32)
    v = {"params": {"fc": {"kernel": kernel, "bias": bias}}}

    def jax_loss(v):
        logits = jm.apply(v, jnp.asarray(feat, jnp.bfloat16))
        per = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels))
        return per.mean(), (logits, per)

    (loss_j, (logits_j, per_j)), grads_j = jax.value_and_grad(
        jax_loss, has_aux=True)(v)
    assert logits_j.dtype == loss_j.dtype == jnp.bfloat16

    fc = torch.nn.Linear(64, 101)
    convert.load_converted(fc, {"weight": convert._dense_w(kernel),
                                "bias": bias})
    x = torch.from_numpy(feat).permute(0, 4, 1, 2, 3).to(torch.bfloat16)
    logits = dense(x.mean(dim=(2, 3, 4)), fc, torch.bfloat16)
    per = classifier.cross_entropy(logits, torch.from_numpy(labels))
    loss = classifier._mean(per)
    loss.backward()
    assert logits.dtype == per.dtype == loss.dtype == torch.bfloat16

    got_l = logits.detach().float().numpy()
    ref_l = np.asarray(logits_j.astype(jnp.float32))
    assert _within_ulps(got_l, ref_l, 2)
    assert np.mean(got_l != ref_l) <= 0.08, np.mean(got_l != ref_l)
    assert _within_ulps(per.detach().float().numpy(),
                        np.asarray(per_j.astype(jnp.float32)), 2)
    assert abs(float(loss.detach()) - float(loss_j)) <= ulp_bf16(float(loss_j))
    # the gradient reaches the f32 head through the same roundings
    got_g = fc.weight.grad.numpy().T
    ref_g = np.asarray(grads_j["params"]["fc"]["kernel"])
    assert _within_ulps(got_g, ref_g, 2)
    assert np.mean(got_g != ref_g) <= 0.08, np.mean(got_g != ref_g)


# ---------------------------------------------------------------------------
# the CLI and the engine on the CPU
# ---------------------------------------------------------------------------

PRETRAIN_X = ('{dataset+: {name: "synthetic", num_samples: 8, height: 40, '
              'width: 48}, batch_size: 2, num_workers: 1, '
              'spatial_transforms+: {size: 32}, temporal_transforms+: '
              '{_size:: 8}, moco+: {k: 8}, device_geometry: true}')
FINETUNE_X = ('{dataset+: {name: "synthetic", num_samples: 8, num_classes: 4, '
              'height: 40, width: 48}, num_workers: 1, '
              'spatial_transforms+: {size: 32}, temporal_transforms+: '
              '{size: 8}, device_geometry: true%s}')


def finetune_argv(exp, extra="", *more):
    return ["-c", "config/finetune/ucf101_s3dg.jsonnet", "-e", str(exp),
            "-x", FINETUNE_X % extra, "-d", "--seed", "0", "--device", "cpu",
            *more]


def _cli(module, argv):
    # one intra-op thread, as in this process: the suite runs in parallel
    # workers
    proc = subprocess.run([sys.executable, "-m", module, *argv],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def test_cli_pretrain_then_finetune_mc(tmp_path):
    pre = tmp_path / "pretrain"
    _cli("rspnet_tpu_torch.pretrain",
         ["-c", "config/pretrain/s3dg.jsonnet", "-e", str(pre), "-x",
          PRETRAIN_X, "-d", "--seed", "0", "--device", "cpu"])
    ft = tmp_path / "finetune"
    log = _cli("rspnet_tpu_torch.finetune", finetune_argv(
        ft, ", bn_recalibrate: 2", "--mc", str(pre / "checkpoint.pth.tar")))
    assert "Loading MoCo checkpoint" in log
    assert "Precise-BN done" in log
    assert (ft / "checkpoint.pth.tar").exists()
    assert (ft / "model_best.pth.tar").exists()
    assert "Final validate: acc1=" in log
    # TensorBoard scalars where tensorboardX is installed
    try:
        import tensorboardX  # noqa: F401
        assert list(ft.glob("events.out.tfevents.*"))
    except ImportError:
        assert "tensorboardX is not installed" in log


def test_validate_from_checkpoint_and_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    train = tmp_path / "train"
    engine, _ = finetune.main(finetune_argv(train))
    assert len(engine.step_times) == 2 and engine.validation["count"] == 8
    ckpt = train / "checkpoint.pth.tar"
    # --validate: only the final 10-crop validation, on the checkpoint
    none, result = finetune.main(finetune_argv(
        tmp_path / "val", "", "--validate", "--load-checkpoint", str(ckpt)))
    assert none is None and result["count"] == 8
    assert np.isfinite(result["loss"])
    assert not list((tmp_path / "val").glob("*.pth.tar"))
    # a resume restores the epoch, the optimizer and the model
    args = ft_engine_args(tmp_path / "resume")
    eng = ft_engine.FinetuneEngine(*args)
    eng.load_checkpoint(ckpt)
    assert eng.current_epoch == 1
    sd, ref = eng.model.state_dict(), engine.model.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in ref
               if not k.endswith("num_batches_tracked"))
    for a, b in zip(eng.optimizer.state_dict()["state"].values(),
                    engine.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    with pytest.raises(SystemExit):
        finetune.main(finetune_argv(tmp_path / "none", "", "--validate"))


def ft_engine_args(exp, extra=""):
    from rspnet_tpu_torch.framework import bootstrap
    return bootstrap(finetune_argv(exp, extra))


@pytest.mark.parametrize("extra", [", model+: {arch: 'slowfast', "
                                   "pretrain: true}",
                                   ", cache_device: true",
                                   ", model+: {pretrain: true}"])
def test_unported_options_raise(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(REPO_ROOT)
    if "cache_device" in extra:
        # ported since (data/device_cache.py): both splits come from the
        # cache, and a value the cache does not know raises
        eng = ft_engine.FinetuneEngine(*ft_engine_args(tmp_path, extra))
        assert isinstance(eng.train_loader, DeviceCachedLoader)
        assert isinstance(eng.validate_loader, DeviceCachedLoader)
        with pytest.raises(ValueError, match="cache_device"):
            ft_engine.FinetuneEngine(*ft_engine_args(
                tmp_path / "bad", ", cache_device: 'val'"))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|ported"):
        ft_engine.FinetuneEngine(*ft_engine_args(tmp_path, extra))


def test_cuda_default_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in finetune_argv(tmp_path) if a not in ("--device",
                                                             "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(argv)


def test_tensorboard_missing_warns_and_writes_nothing(tmp_path, monkeypatch):
    """Without tensorboardX (as on the card machine) the training engine
    warns once and writes no scalars; the final-validation engine asks for
    no writer."""
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    engine, _ = finetune.main(finetune_argv(tmp_path))
    assert engine.writer is None
    log = next(tmp_path.glob("run_*/experiment.log")).read_text()
    assert log.count("tensorboardX is not installed") == 1
    assert not list(tmp_path.glob("events.out.tfevents.*"))


# ---------------------------------------------------------------------------
# the earlier slices' code on the finetune path, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("final_validate,geometry", [
    (False, "device"), (True, "device"), (True, "host")])
def test_val_loader_matches_jax(final_validate, geometry):
    """The validation loader with EvenNCrop (n_crop 1, and final_n_crop 10)
    and a padded, masked tail: the same uint8 clips, labels and mask as the
    JAX package's loader."""
    if geometry == "host":
        pytest.importorskip("cv2")
    from rspnet_tpu.config import ConfigTree as JaxConfigTree
    from rspnet_tpu.data.pipeline import build_loader as jax_build_loader
    from rspnet_tpu_torch.config import ConfigTree
    from rspnet_tpu_torch.data.pipeline import build_loader

    d = {"dataset": {"name": "synthetic", "num_samples": 6,
                     "num_classes": 4, "height": 40, "width": 48,
                     "num_frames": 30},
         "temporal_transforms": {"size": 8, "validate": {
             "n_crop": 1, "final_n_crop": 10, "stride": 1}},
         "spatial_transforms": {"size": 32},
         "validate": {"batch_size": 4}, "final_validate": {"batch_size": 4},
         "num_workers": 1, "seed": 0,
         "device_geometry": geometry == "device"}
    ref = list(jax_build_loader(JaxConfigTree.from_dict(d), "val",
                                final_validate=final_validate))
    got = list(build_loader(ConfigTree.from_dict(d), "val",
                            final_validate=final_validate))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["clips"][0], r["clips"][0])
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_array_equal(g["mask"], r["mask"])
    assert got[0]["clips"][0].shape[1] == (80 if final_validate else 8)
    assert got[1]["mask"].tolist() == [True, True, False, False]


def test_finetune_schedule_matches_jax():
    """Cosine to eta_min = lr / 1000 over the epochs, as the JAX engine
    builds it (rspnet_tpu/engines/finetune.py:79-85)."""
    from rspnet_tpu.framework.lr_schedule import \
        build_scheduler as jax_build_scheduler
    from rspnet_tpu_torch.framework.lr_schedule import build_scheduler

    lr = 0.005
    for schedule in ("cosine", "multi_step", "plateau", "none"):
        kw = dict(num_epochs=5, milestones=[2, 4], patience=1,
                  eta_min=lr / 1000.0)
        a = build_scheduler(schedule, lr, **kw)
        b = jax_build_scheduler(schedule, lr, **kw)
        for metric in (3.0, 2.0, 2.0, 2.0, 1.0):
            assert a.step(metric) == b.step(metric), schedule
        assert a.state_dict() == b.state_dict()
