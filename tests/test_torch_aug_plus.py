"""``moco.aug_plus`` in the port against the JAX package, on the CPU.

- The gaussian kernels and ``ops.color.gaussian_blur`` (depthwise 3x3,
  sigma 1.5, zero padding) against rspnet_tpu/ops/color.py at 1e-6.
- ``ops.augment.augment_batch(use_blur=True, gray_before_jitter=False)``
  against JAX's on the same drawn parameters, in both geometries, with
  flipped, blurred and unjittered rows mixed (rows both flipped and
  blurred among them: K3 flips an identity-geometry clip before the blur,
  JAX after it), f32 at 1e-5.
- ``sample_train_params`` in the engine's ``aug_plus`` mode, bit-equal
  from one numpy seed; the engine's ``_augment_clip`` against the JAX
  engine's on one uint8 batch, each engine drawing from its own
  ``default_rng(seed)``.
- The pretrain CLI with ``aug_plus`` on the CPU.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.engines.pretrain import PretrainEngine as JaxEngine
from rspnet_tpu.ops import augment as jaug
from rspnet_tpu.ops import color as jcolor
from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.engines.pretrain import PretrainEngine
from rspnet_tpu_torch.ops import augment as taug
from rspnet_tpu_torch.ops import color as tcolor
from tests.conftest import REPO_ROOT
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)

AUG_PLUS = dict(h_flip=0.5, gray_p=0.2, jitter=(0.4, 0.4, 0.4, 0.1),
                jitter_p=0.8, blur_p=0.5)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("size,sigma", [(3, 1.5), (5, 0.8), (4, 2.0)])
def test_gaussian_kernels_match_jax(size, sigma):
    np.testing.assert_allclose(
        tcolor.gaussian_kernel1d(size, sigma).numpy(),
        np.asarray(jcolor.gaussian_kernel1d(size, sigma)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tcolor.gaussian_kernel2d((size, 3), (sigma, 1.5)).numpy(),
        np.asarray(jcolor.gaussian_kernel2d((size, 3), (sigma, 1.5))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 9, 11, 3), (2, 5, 4, 3)])
def test_gaussian_blur_matches_jax(shape):
    x = np.random.default_rng(1).random(shape, np.float32)
    ref = np.asarray(jcolor.gaussian_blur(jnp.asarray(x)))
    out = tcolor.gaussian_blur(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    # a batch axis in front rides the batch like the clip's frames
    batched = tcolor.gaussian_blur(torch.from_numpy(np.stack([x, x])))
    np.testing.assert_array_equal(batched[1].numpy(), out)


def _mixed_params(rng, n, hw, crop_area):
    """aug_plus draws, then rows forced to cover every case: flip x blur
    both ways, two rows unjittered (factors (1, 1, 1, 0)), one gray."""
    p = taug.sample_train_params(rng, n, [hw], crop_area=crop_area,
                                 **AUG_PLUS)
    p.flip = np.arange(n) % 2 == 1
    p.blur = (np.arange(n) // 2) % 2 == 1
    p.jitter[[0, 3]] = (1.0, 1.0, 1.0, 0.0)
    p.gray[:] = False
    p.gray[5] = True
    return p


@pytest.mark.parametrize("identity", [True, False],
                         ids=["identity_geometry", "device_geometry"])
def test_augment_batch_blur_matches_jax(identity):
    S, n = 8, 8
    hw = (S, S) if identity else (12, 10)
    rng = np.random.default_rng(4)
    p = _mixed_params(rng, n, hw, (1.0, 1.0) if identity else (0.4, 1.0))
    assert (p.flip & p.blur).any() and (p.blur & ~p.flip).any()
    batch = rng.integers(0, 256, (n, 3, *hw, 3), dtype=np.uint8)
    kw = dict(size=(S, S), mean=MEAN, std=STD, gray_before_jitter=False,
              identity_geometry=identity)
    ref = np.asarray(jaug.augment_batch(
        jnp.asarray(batch), p.boxes, p.flip, p.jitter, p.order, p.gray,
        p.blur, use_blur=True, **kw))
    out = taug.augment_batch(torch.from_numpy(batch), p, use_blur=True,
                             **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # the blurred rows differ from the same chain without the blur
    plain = taug.augment_batch(torch.from_numpy(batch), p, use_blur=False,
                               **kw).numpy()
    assert not np.allclose(out[p.blur], plain[p.blur], atol=1e-3)
    np.testing.assert_array_equal(out[~p.blur], plain[~p.blur])


def test_sample_train_params_aug_plus_bit_equal():
    kw = dict(crop_area=(0.4, 1.0), **AUG_PLUS)
    a = jaug.sample_train_params(np.random.default_rng(9), 64, [(128, 171)],
                                 **kw)
    b = taug.sample_train_params(np.random.default_rng(9), 64, [(128, 171)],
                                 **kw)
    for field in ("boxes", "flip", "jitter", "order", "gray", "blur"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
    # some rows drew no jitter: neutral factors
    assert (b.jitter == (1.0, 1.0, 1.0, 0.0)).all(axis=1).any()


def _fake_engine(seed, device=None):
    """The attributes ``_augment_clip`` reads, for either package's
    engine class."""
    return types.SimpleNamespace(
        rng=np.random.default_rng(seed), aug_plus=True, size=8,
        normalize=(MEAN, STD), device=device,
        train_loader=types.SimpleNamespace(cfg=types.SimpleNamespace(
            device_geometry=True, crop_area=(0.4, 1.0))))


def test_engine_augment_clip_matches_jax():
    clip = np.random.default_rng(2).integers(0, 256, (6, 2, 12, 10, 3),
                                             dtype=np.uint8)
    ref = np.asarray(JaxEngine._augment_clip(_fake_engine(3), clip))
    out = PretrainEngine._augment_clip(
        _fake_engine(3, torch.device("cpu")), clip).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_cli_aug_plus(tmp_path, monkeypatch):
    from tests.test_torch_pretrain import _argv
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path, ", device_geometry: true, "
                                 "moco+: {k: 8, aug_plus: true}"))
    assert engine.aug_plus and len(engine.step_times) == 3
    assert np.isfinite(engine.meters["loss"].avg)
    assert (tmp_path / "checkpoint.pth.tar").exists()
