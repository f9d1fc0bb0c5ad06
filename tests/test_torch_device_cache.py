"""The port's device-resident dataset cache (rspnet_tpu_torch/data/
device_cache.py) against the JAX package's (rspnet_tpu/data/
device_cache.py), on the CPU.

- The same config through both packages' ``build_loader`` with
  ``cache_device: true``: the same uint8 clips, labels and masks, bit for
  bit and in the same order, over 2 epochs, for a MoCo train split (two
  clips a sample, the epoch permutation drawn from numpy) and a validation
  split whose padded tail is masked; the validation cache equals the
  uncached loader too (EvenNCrop and the centre crop are deterministic).
- The guards: the preflight refuses from the first batch, before the full
  decode pass, and closes the loader; the limit on the whole cache (here
  met only by the padded tail, which the preflight does not count);
  ``"train"`` caches the train split alone; a value the cache does not
  know raises ``ValueError``; under two gloo ranks the cache refuses, as
  the JAX cache refuses more than one process.
- ``clip_to_device`` hands a cached tensor through without a copy and
  counts the copies of host arrays (the tracer's ``loader.h2d_calls`` and
  ``loader.h2d_bytes``).
- Each engine runs from the cache on the CPU: pretrain and CAM
  visualization with ``cache_device: true`` (no clip copied to the
  device), finetune with ``"train"``, retrieval with ``true``, whose test
  features equal the uncached run's (its train split is a train split:
  the cache's epoch order is its own).
"""
import os

import numpy as np
import pytest
import torch

from rspnet_tpu_torch.data.device_cache import (DeviceCachedLoader,
                                                clip_to_device)
from rspnet_tpu_torch.framework import tracing
from tests.conftest import REPO_ROOT
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401
from tests.torch_ddp_ranks import run_ranks

torch.set_num_threads(1)

PRETRAIN = "config/pretrain/s3dg.jsonnet"
TRAIN_EXT = ('{dataset+: {name: "synthetic", num_samples: 10, height: 40, '
             'width: 48}, batch_size: 3, num_workers: 2, seed: 5, '
             'spatial_transforms+: {size: 32}, temporal_transforms+: '
             '{_size:: 4}, device_geometry: true%s}')
VAL = {"dataset": {"name": "synthetic", "num_samples": 7, "num_classes": 4,
                   "height": 40, "width": 48, "num_frames": 30},
       "temporal_transforms": {"size": 8, "validate": {
           "n_crop": 1, "final_n_crop": 2, "stride": 1}},
       "spatial_transforms": {"size": 32},
       "validate": {"batch_size": 3}, "final_validate": {"batch_size": 3},
       "num_workers": 1, "seed": 0, "device_geometry": True}


def _jax_train(extra=", cache_device: true"):
    from rspnet_tpu.config import load_config
    from rspnet_tpu.data.pipeline import build_loader
    return build_loader(load_config(PRETRAIN, [TRAIN_EXT % extra]), "train",
                        vid=True)


def _port_train(extra=", cache_device: true", **kw):
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.data.pipeline import build_loader
    return build_loader(load_config(PRETRAIN, [TRAIN_EXT % extra]), "train",
                        vid=True, device="cpu", **kw)


def _val_cfgs(cache):
    from rspnet_tpu.config import ConfigTree as JaxConfigTree
    from rspnet_tpu_torch.config import ConfigTree
    d = {**VAL, "cache_device": cache}
    return JaxConfigTree.from_dict(d), ConfigTree.from_dict(d)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g["clips"]) == len(r["clips"])
        for gc, rc in zip(g["clips"], r["clips"]):
            assert torch.is_tensor(gc) and gc.dtype == torch.uint8
            np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(g["labels"], np.asarray(r["labels"]))
        np.testing.assert_array_equal(g["mask"], np.asarray(r["mask"]))


def _epochs(loader, n=2):
    out = []
    for e in range(n):
        loader.set_epoch(e)
        out.append(list(loader))
    return out


def test_train_cache_equals_jax_over_two_epochs():
    ref, got = _jax_train(), _port_train()
    assert isinstance(got, DeviceCachedLoader)
    assert got.device == torch.device("cpu")
    assert len(got) == len(ref) == 3 and got.num_samples == 10
    assert got.nbytes == sum(np.asarray(c).nbytes for c in ref._cache)
    e_ref, e_got = _epochs(ref), _epochs(got)
    for g, r in zip(e_got, e_ref):
        _assert_batches_equal(g, r)
    # the order is drawn anew each epoch
    assert not np.array_equal(e_got[0][0]["labels"], e_got[1][0]["labels"]) \
        or not np.array_equal(e_got[0][0]["clips"][0].numpy(),
                              e_got[1][0]["clips"][0].numpy())


@pytest.mark.parametrize("final_validate", [False, True])
def test_val_cache_equals_jax_and_the_loader(final_validate):
    from rspnet_tpu.data.pipeline import build_loader as jax_build_loader
    from rspnet_tpu_torch.data.pipeline import build_loader
    jcfg, pcfg = _val_cfgs(True)
    ref = jax_build_loader(jcfg, "val", final_validate=final_validate)
    got = build_loader(pcfg, "val", final_validate=final_validate,
                       device=torch.device("cpu"))
    assert isinstance(got, DeviceCachedLoader)
    assert got.num_valid_samples() == ref.num_valid_samples() == 7
    for g, r in zip(_epochs(got), _epochs(ref)):
        _assert_batches_equal(g, r)
    batches = list(got)
    assert batches[-1]["mask"].tolist() == [True, False, False]
    _, plain = _val_cfgs(False)
    uncached = list(build_loader(plain, "val", final_validate=final_validate))
    _assert_batches_equal(batches, uncached)


class _CountingCatalog:
    def __init__(self, catalog):
        self.catalog, self.loaded = catalog, 0

    def __len__(self):
        return len(self.catalog)

    def __getitem__(self, i):
        self.loaded += 1
        return self.catalog[i]


def test_preflight_refuses_before_the_full_pass(monkeypatch):
    from rspnet_tpu_torch.config import load_config
    from rspnet_tpu_torch.data.catalogs import build_catalog
    from rspnet_tpu_torch.data.pipeline import build_loader
    cfg = load_config(PRETRAIN, [TRAIN_EXT % ", cache_device: true"])
    catalog = _CountingCatalog(build_catalog(cfg, "train"))
    # one sample is 2 clips x 4 frames x 40 x 48 x 3 bytes = 46080 bytes
    monkeypatch.setenv("RSPNET_CACHE_LIMIT_MB", "0.2")
    with pytest.raises(ValueError, match="preflight"):
        build_loader(cfg, "train", vid=True, device="cpu", catalog=catalog)
    assert 0 < catalog.loaded < len(catalog)
    monkeypatch.setenv("RSPNET_CACHE_LIMIT_MB", "0.2")
    with pytest.raises(ValueError, match="preflight"):
        _jax_train()


def test_limit_on_the_whole_cache(monkeypatch):
    """7 samples estimated, 9 rows cached (the padded tail): a limit
    between the two passes the preflight and stops the cache."""
    from rspnet_tpu.data.pipeline import build_loader as jax_build_loader
    from rspnet_tpu_torch.data.pipeline import build_loader
    per_sample = 8 * 40 * 48 * 3
    monkeypatch.setenv("RSPNET_CACHE_LIMIT_MB", str(8 * per_sample / 1e6))
    jcfg, pcfg = _val_cfgs(True)
    for build, cfg, kw in ((build_loader, pcfg, {"device": "cpu"}),
                           (jax_build_loader, jcfg, {})):
        with pytest.raises(ValueError, match="must fit"):
            build(cfg, "val", **kw)


def test_train_only_and_bad_values():
    from rspnet_tpu.data.pipeline import build_loader as jax_build_loader
    from rspnet_tpu_torch.data.pipeline import (VideoDataLoader,
                                                build_loader)
    assert isinstance(_port_train(', cache_device: "train"'),
                      DeviceCachedLoader)
    jcfg, pcfg = _val_cfgs("train")
    assert type(build_loader(pcfg, "val", device="cpu")) is VideoDataLoader
    assert type(jax_build_loader(jcfg, "val")).__name__ == "VideoDataLoader"
    jcfg, pcfg = _val_cfgs("val")
    with pytest.raises(ValueError, match="cache_device must be"):
        build_loader(pcfg, "val", device="cpu")
    with pytest.raises(ValueError, match="cache_device must be"):
        jax_build_loader(jcfg, "val")
    jcfg, pcfg = _val_cfgs(True)
    with pytest.raises(ValueError, match="device"):
        build_loader(pcfg, "val")


def test_two_ranks_refuse_the_cache():
    outs = run_ranks("cache_refused", {"config": PRETRAIN,
                                       "ext": TRAIN_EXT % ", cache_device: "
                                                          "true"})
    for out in outs:
        assert "multi-process" in (out["error"] or ""), out


def _host_copies():
    return {"calls": tracing.counter("loader.h2d_calls"),
            "bytes": tracing.counter("loader.h2d_bytes")}


def test_clip_to_device_copies_host_arrays_only():
    before = _host_copies()
    t = torch.zeros(2, 3, dtype=torch.uint8)
    assert clip_to_device(t, torch.device("cpu")) is t
    assert _host_copies() == before
    a = np.ones((2, 3), np.uint8)
    got = clip_to_device(a, torch.device("cpu"))
    assert torch.equal(got, torch.ones(2, 3, dtype=torch.uint8))
    assert _host_copies() == {"calls": before["calls"] + 1,
                              "bytes": before["bytes"] + 6}


# ---------------------------------------------------------------------------
# the engines, from the cache
# ---------------------------------------------------------------------------

def _pretrain_argv(exp, extra=""):
    return ["-c", PRETRAIN, "-e", str(exp), "-x",
            ('{dataset+: {name: "synthetic", num_samples: 8, height: 40, '
             'width: 48}, batch_size: 2, num_workers: 1, spatial_transforms+: '
             '{size: 32}, temporal_transforms+: {_size:: 8}, moco+: {k: 8}, '
             'device_geometry: true%s}' % extra),
            "-d", "--seed", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A cached pretrain run (its checkpoint feeds the other engines) and
    the clip copies it made."""
    from rspnet_tpu_torch import pretrain
    cwd = os.getcwd()
    os.chdir(REPO_ROOT)
    try:
        exp = tmp_path_factory.mktemp("cached_pretrain")
        copies = _host_copies()
        engine = pretrain.main(_pretrain_argv(exp, ", cache_device: true"))
        copies = _host_copies()["calls"] - copies["calls"]
    finally:
        os.chdir(cwd)
    return engine, copies, exp / "checkpoint.pth.tar"


def test_pretrain_runs_from_the_cache(pretrained):
    engine, copies, ckpt = pretrained
    assert isinstance(engine.train_loader, DeviceCachedLoader)
    assert len(engine.step_times) == 3
    assert np.isfinite(engine.meters["loss"].avg)
    assert copies == 0
    assert ckpt.exists()


def test_visualization_runs_from_the_cache(pretrained, tmp_path,
                                           monkeypatch):
    from rspnet_tpu_torch import visualization
    monkeypatch.chdir(REPO_ROOT)
    before = _host_copies()["calls"]
    engine = visualization.main(_pretrain_argv(
        tmp_path, ", cache_device: true") + ["--mc", str(pretrained[2])])
    assert isinstance(engine.loader, DeviceCachedLoader)
    assert _host_copies()["calls"] == before
    assert len(list(tmp_path.rglob("cam/*.png"))) == 4 * 2


def test_finetune_caches_the_train_split(pretrained, tmp_path, monkeypatch):
    from rspnet_tpu_torch import finetune
    from rspnet_tpu_torch.data.pipeline import VideoDataLoader
    monkeypatch.chdir(REPO_ROOT)
    argv = ["-c", "config/finetune/ucf101_s3dg.jsonnet", "-e", str(tmp_path),
            "-x", '{dataset+: {name: "synthetic", num_samples: 8, '
            'num_classes: 4, height: 40, width: 48}, num_workers: 1, '
            'spatial_transforms+: {size: 32}, temporal_transforms+: '
            '{size: 8}, device_geometry: true, cache_device: "train"}',
            "-d", "--seed", "0", "--device", "cpu",
            "--mc", str(pretrained[2])]
    engine, _ = finetune.main(argv)
    assert isinstance(engine.train_loader, DeviceCachedLoader)
    assert type(engine.validate_loader) is VideoDataLoader
    assert len(engine.step_times) == 2
    assert np.isfinite(engine.train_meters["loss"].avg)


def test_retrieval_features_equal_uncached(tmp_path, monkeypatch):
    """C3D retrieval, random weights from the seed: the cached run's test
    features equal the uncached run's bit for bit."""
    from rspnet_tpu_torch import retrieval
    monkeypatch.chdir(REPO_ROOT)
    feats = {}
    for cache in ("false", "true"):
        exp = tmp_path / cache
        retrieval.main(
            ["-c", "config/retrieval/ucf101_c3d.jsonnet", "-e", str(exp),
             "-x", '{dataset: {name: "synthetic", num_samples: 6, '
             'num_classes: 3, num_frames: 24, height: 40, width: 48}, '
             'batch_size: 1, num_workers: 1, spatial_transforms+: '
             '{size: 32}, temporal_transforms+: {size: 8, validate+: '
             '{final_n_crop: 2}}, validate: {batch_size: 2}, '
             'final_validate: {batch_size: 2}, device_geometry: true, '
             'cache_device: %s}' % cache, "-d", "--seed", "0", "--device",
             "cpu"])
        feats[cache] = {p.name: np.load(p) for p in exp.rglob("*.npy")}
    assert set(feats["true"]) == set(feats["false"]) and feats["true"]
    for name, v in feats["false"].items():
        if name.startswith("test_"):
            np.testing.assert_array_equal(feats["true"][name], v,
                                          err_msg=name)
