"""The port's CAM visualization (rspnet_tpu_torch/engines/visualization.py,
rspnet_tpu_torch/utils/image.py) against the JAX package's and OpenCV, on
the CPU.

- ``cam_maps`` against the JAX function in f64: 1e-10 relative.
- The OpenCV-free image helper against cv2 on the same uint8 inputs: the
  JET table and ``resize_linear_u8`` bit-equal to ``cv2.applyColorMap``
  and ``cv2.resize`` (INTER_LINEAR) at up- and downscales, square and not;
  ``cam_rgbmask`` and ``mask_clip`` bit-equal to the JAX package's (which
  call cv2); every PNG ``write_png`` writes reads back through
  ``cv2.imread`` as its array.
- One engine batch (C3D at 64², 8 frames, batch 2, ``-d``) with the JAX
  engine's drawn speed pairing injected into the port's: each of the 4 × 2
  maps within f32 tolerance (1e-4 of its largest value) of the JAX
  engine's, both from one pretrain checkpoint whose key encoder differs
  from its query encoder; the reference's PNG names.
- Two port runs with one seed write byte-identical PNGs; a non-``linear``
  ``fc_type`` raises; the CLI runs as a module on S3D-G.
"""
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.engines import visualization as jax_vis
from rspnet_tpu.framework import bootstrap as jax_bootstrap
from rspnet_tpu.framework.checkpoint import save_state as jax_save_state
from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.moco import MultiTaskWrapper as JaxWrapper
from rspnet_tpu_torch import visualization
from rspnet_tpu_torch.engines import visualization as port_vis
from rspnet_tpu_torch.framework import bootstrap
from rspnet_tpu_torch.utils import image
from tests.conftest import REPO_ROOT
from tests.test_step_parity import enable_x64
from tests.test_torch_zoo import (  # noqa: F401 (a fixture)
    _random_variables, release_jax_memory)
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
DIM, B, SEED = 8, 2, 1
SYNTH = ('{dataset: {name: "synthetic", num_samples: 8, num_classes: 4, '
         'num_frames: 40, height: 72, width: 96}, batch_size: %d, '
         'num_workers: 2, spatial_transforms+: {size: %d}, '
         'moco+: {k: 16, dim: 8%s}, temporal_transforms+: {_size: %d}, '
         'device_geometry: true}')


def argv(arch, exp, size=64, moco_extra="", *more, frames=8):
    return ["-c", f"config/pretrain/{arch}.jsonnet", "-e", str(exp), "-x",
            SYNTH % (B, size, moco_extra, frames), "-d", "--seed", str(SEED),
            *more]


def test_cam_maps_match_jax():
    rng = np.random.RandomState(0)
    fq, fk = rng.randn(2, 3, 4, 5, 16), rng.randn(2, 3, 4, 5, 16)
    ws = [rng.randn(DIM, 16) for _ in range(4)]
    with enable_x64():
        want = jax_vis.cam_maps(jnp.asarray(fq), jnp.asarray(fk),
                                *map(jnp.asarray, ws))
    got = port_vis.cam_maps(torch.from_numpy(fq), torch.from_numpy(fk),
                            *map(torch.from_numpy, ws))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (2, 3, 4, 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(w)).max())


def test_jet_table_is_opencvs():
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[..., ::-1]
    np.testing.assert_array_equal(image.apply_jet(ramp), want)


@pytest.mark.parametrize("src,dst", [
    ((7, 7), (224, 224)), ((4, 4), (112, 112)), ((2, 2), (64, 64)),
    ((14, 14), (224, 224)), ((1, 1), (32, 32)), ((1, 7), (5, 224)),
    ((3, 5), (40, 17)), ((13, 11), (8, 6)), ((224, 224), (32, 32)),
    ((5, 9), (7, 13))])
def test_resize_is_opencvs(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for _ in range(5):
        m = rng.integers(0, 256, src, dtype=np.uint8)
        np.testing.assert_array_equal(image.resize_linear_u8(m, dst),
                                      cv2.resize(m, dst[::-1]))


@pytest.mark.parametrize("cam_shape,out_hw", [((8, 2, 2), (64, 64)),
                                              ((2, 7, 7), (224, 224)),
                                              ((3, 1, 1), (32, 32))])
def test_heatmap_and_blend_match_jax(cam_shape, out_hw):
    rng = np.random.RandomState(1)
    cam = (rng.randn(*cam_shape) * 3).astype(np.float32)
    heat = port_vis.cam_rgbmask(cam, out_hw)
    np.testing.assert_array_equal(heat, jax_vis.cam_rgbmask(cam, out_hw))
    clip = rng.randn(cam_shape[0], *out_hw, 3).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    np.testing.assert_array_equal(port_vis.mask_clip(clip, heat, mean, std),
                                  jax_vis.mask_clip(clip, heat, mean, std))


def test_png_reads_back_through_opencv(tmp_path):
    rng = np.random.default_rng(2)
    for shape in [(1, 1, 3), (5, 9, 3), (64, 512, 3)]:
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        image.write_png(tmp_path / "a.png", a)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "a.png"))[..., ::-1], a)
    frames = rng.integers(0, 256, (10, 8, 6, 3), dtype=np.uint8)
    port_vis.save_strip(tmp_path / "p.png", frames)
    jax_vis.VisualizationEngine._save_strip(tmp_path / "j.png", frames)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
    assert cv2.imread(str(tmp_path / "p.png")).shape == (8, 48, 3)


@pytest.fixture(scope="module")
def c3d_checkpoint(tmp_path_factory):
    """A JAX-written C3D pretrain checkpoint, key encoder != query."""
    jm = JaxWrapper(encoder_factory=jax_model_class("c3d"), num_classes=DIM,
                    axis_name=None)
    q = _random_variables(jm, np.random.default_rng(6), np.float32)
    k = _random_variables(jm, np.random.default_rng(7), np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "c3d.pth.tar"
    jax_save_state({"epoch": 1, "arch": "c3d", "model": {
        "params_q": q["params"], "params_k": k["params"],
        "batch_stats_q": q["batch_stats"], "batch_stats_k": k["batch_stats"],
        "queue": np.zeros((DIM, 16), np.float32),
        "queue_ptr": np.zeros((), np.int32)}}, path)
    return str(path)


def _record_cams(monkeypatch, module):
    cams = []
    inner = module.cam_rgbmask

    def recording(cam, out_hw):
        cams.append(np.array(cam, np.float32))
        return inner(cam, out_hw)
    monkeypatch.setattr(module, "cam_rgbmask", recording)
    return cams


def _jax_speed_draws(bi, batch):
    """The JAX engine's draws of batch ``bi`` (visualization.py:109, :200;
    moco/step_core.py:181-205)."""
    rng_b = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(SEED), 0x5eed), bi)
    key_perm, key_speed = jax.random.split(rng_b)
    return (torch.from_numpy(np.array(jax.random.permutation(key_perm,
                                                             batch))),
            int(jax.random.randint(key_speed, (), 0, 1)))


def _port_engine(argv_):
    args, cfg = bootstrap(argv_)
    return args, port_vis.VisualizationEngine(args, cfg)


def test_engine_maps_match_jax(c3d_checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    jax_cams = _record_cams(monkeypatch, jax_vis)
    port_cams = _record_cams(monkeypatch, port_vis)
    args, cfg = jax_bootstrap(argv("c3d", tmp_path / "jax"))
    jax_engine = jax_vis.VisualizationEngine(args, cfg)
    jax_engine.load_moco_checkpoint(c3d_checkpoint)
    assert jax_engine.visual_epoch() == 4 * B
    args, engine = _port_engine(argv("c3d", tmp_path / "port", 64, "",
                                     "--device", "cpu"))
    engine.load_moco_checkpoint(c3d_checkpoint)
    assert engine.visual_epoch(speed_draws=_jax_speed_draws) == 4 * B
    assert len(port_cams) == len(jax_cams) == 4 * B
    for got, want in zip(port_cams, jax_cams):
        assert got.shape == want.shape == (1, 4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    names = sorted(p.name for p in (args.run_dir / "cam").iterdir())
    assert names == sorted(f"sample0_{b}_{n}.png" for b in range(B)
                           for n in ("qA", "qM", "kA", "kM"))
    # the first 8 of the clip's frames, each blended with the one map frame
    strip = cv2.imread(str(args.run_dir / "cam" / names[0]))
    assert strip.shape == (64, 8 * 64, 3)


def test_same_seed_same_bytes(c3d_checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    outs = []
    for name in ("a", "b"):
        engine = visualization.main(argv("c3d", tmp_path / name, 32, "",
                                         "--device", "cpu", "--mc",
                                         c3d_checkpoint))
        assert engine.n_saved == 4 * B
        cam = engine.args.run_dir / "cam"
        outs.append({p.name: p.read_bytes() for p in cam.iterdir()})
    assert len(outs[0]) == 4 * B and outs[0] == outs[1]


def test_non_linear_heads_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    with pytest.raises(NotImplementedError, match="linear heads"):
        _port_engine(argv("c3d", tmp_path, 32, ", fc_type: 'mlp'",
                          "--device", "cpu"))


def test_two_frame_maps_are_aligned_f10():
    """F10: the JAX engine's ``mask_clip`` broadcasts the map against the
    clip and raises for a 2-frame map of a 16-frame clip (S3D-G or C3D at
    16 frames); the port gives each clip frame the map frame covering it,
    which for a one-frame map is that broadcast, bit for bit."""
    rng = np.random.RandomState(3)
    mean = np.zeros(3, np.float32)
    std = np.ones(3, np.float32)
    clip = rng.rand(16, 8, 8, 3).astype(np.float32)
    heat = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="broadcast"):
        jax_vis.mask_clip(clip, heat, mean, std)
    aligned = port_vis.align_frames(heat, 16)
    np.testing.assert_array_equal(aligned[:8], np.repeat(heat[:1], 8, 0))
    np.testing.assert_array_equal(aligned[8:], np.repeat(heat[1:], 8, 0))
    one = heat[:1]
    np.testing.assert_array_equal(
        port_vis.mask_clip(clip, port_vis.align_frames(one, 16), mean, std),
        jax_vis.mask_clip(clip, one, mean, std))


def test_cli_module_runs_on_cpu(tmp_path):
    """S3D-G at 16 frames: a two-frame map (F10), an 8-frame strip."""
    proc = subprocess.run(
        [sys.executable, "-m", "rspnet_tpu_torch.visualization",
         *argv("s3dg", tmp_path, 32, "", "--device", "cpu", frames=16)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    cams = sorted((next(tmp_path.glob("run_0_*")) / "cam").iterdir())
    assert len(cams) == 4 * B
    assert cv2.imread(str(cams[0])).shape == (32, 8 * 32, 3)

