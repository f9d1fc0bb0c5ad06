"""The port's export to the reference torch layout (rspnet_tpu_torch/
engines/export.py) against the JAX package's (rspnet_tpu/engines/
export.py), on the CPU.

For every arch that rspnet_tpu/models/torch_bridge.py maps, a pretraining
wrapper of the port (``MultiTaskWrapper`` around the arch's backbone, its
weights moved off their init, linear heads; mlp heads on S3D-G, whose
Linears go to ``.2`` and ``.4``; conv heads on C3D, which both exports
skip) is written as the port's pretrain engine writes it (the JAX layout,
``models/convert.py``). Both exports read that file: the returned dicts
and the written files are equal key for key and bit for bit
(``encoder_q.encoder.*`` / ``encoder_k.encoder.*``, the heads, ``queue``
and ``queue_ptr`` of shape (1,)).

The models are built directly, not through a CLI: the archs' own widths,
with the deep ones cut in depth. resnet18 and resnet34 are exported from
resnet10 (their mappings' missing blocks are left out by both exports),
resnet50 to resnet200 from a bottleneck ResNet of one block a stage,
r2plus1d-18 from r2plus1d-vcop, torchvision-resnet18 from its one block a
stage. An arch the bridge does not map raises in both.
"""
import functools

import numpy as np
import pytest
import torch

from rspnet_tpu.engines.export import \
    export_reference_checkpoint as jax_export
from rspnet_tpu.models.torch_bridge import KEY_MAPPERS as JAX_MAPPERS
from rspnet_tpu_torch.engines.export import export_reference_checkpoint
from rspnet_tpu_torch.framework import load_state, save_state
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.models.r2plus1d import R2Plus1DNet
from rspnet_tpu_torch.models.resnet3d import Bottleneck, ResNet3D
from rspnet_tpu_torch.models.video_resnet import VideoResNet
from rspnet_tpu_torch.moco import MultiTaskWrapper
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
DIM, K = 8, 16
_BOTTLENECK = functools.partial(ResNet3D, block=Bottleneck,
                                layers=(1, 1, 1, 1))
# export arch -> (backbone factory, heads)
CASES = {
    "c3d": (get_model_class("c3d"), "conv"),
    "s3dg": (get_model_class("s3dg"), "mlp"),
    "s3d": (get_model_class("s3d"), "linear"),
    "mfnet": (get_model_class("mfnet"), "linear"),
    "resnet10": (get_model_class("resnet10"), "linear"),
    "resnet18": (get_model_class("resnet10"), "linear"),
    "resnet34": (get_model_class("resnet10"), "linear"),
    "resnet50": (_BOTTLENECK, "linear"),
    "resnet101": (_BOTTLENECK, "linear"),
    "resnet152": (_BOTTLENECK, "linear"),
    "resnet200": (_BOTTLENECK, "linear"),
    "r2plus1d-vcop": (get_model_class("r2plus1d-vcop"), "linear"),
    "r2plus1d-18": (functools.partial(R2Plus1DNet, layer_sizes=(1, 1, 1, 1)),
                    "linear"),
    "torchvision-resnet18": (functools.partial(VideoResNet,
                                               layers=(1, 1, 1, 1)),
                             "linear"),
}


def test_every_bridged_arch_is_covered():
    assert set(CASES) == set(JAX_MAPPERS)


def _variables(net, arch, rng, monkeypatch):
    """The wrapper's weights, moved off their init, as the JAX-layout
    trees the port's checkpoints hold. A cut backbone takes the entries of
    the arch's mapping that it has."""
    sd = {k: v + torch.from_numpy(
              rng.standard_normal(tuple(v.shape)).astype(np.float32))
          if v.is_floating_point() else v
          for k, v in net.state_dict().items()}
    names = {k[len("encoder."):] for k in sd if k.startswith("encoder.")}
    cut = f"export_test_{arch}"
    monkeypatch.setitem(convert.KEY_MAPPERS, cut, lambda: [
        e for e in convert.KEY_MAPPERS[arch]() if e[0] in names])
    return convert.state_dict_to_variables(sd, cut)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(g):
            g = g.numpy()
        if torch.is_tensor(w):
            w = w.numpy()
        w = np.asarray(w)
        assert np.asarray(g).dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_export_equals_jax(arch, tmp_path, monkeypatch):
    factory, heads = CASES[arch]
    rng = np.random.default_rng(sorted(CASES).index(arch))
    torch.manual_seed(0)
    net = MultiTaskWrapper(factory(num_classes=1, with_classifier=False),
                           num_classes=DIM, fc_type=heads)
    q = _variables(net, arch, rng, monkeypatch)
    k = _variables(net, arch, rng, monkeypatch)
    del net
    src = tmp_path / "checkpoint.pth.tar"
    save_state({"epoch": 3, "arch": arch, "best_loss": 1.5, "model": {
        "params_q": q["params"], "params_k": k["params"],
        "batch_stats_q": q["batch_stats"], "batch_stats_k": k["batch_stats"],
        "queue": rng.standard_normal((DIM, K)).astype(np.float32),
        "queue_ptr": np.asarray(8, np.int32)}}, src)
    dst, jdst = tmp_path / "ref.pth.tar", tmp_path / "ref_jax.pth.tar"
    try:
        got = export_reference_checkpoint(src, dst)
        want = jax_export(src, jdst)
        assert {k: v for k, v in got.items() if k != "model"} == {
            k: v for k, v in want.items() if k != "model"}
        assert got["arch"] == arch and got["epoch"] == 3
        flat = got["model"]
        _assert_same(flat, want["model"])
        assert flat["queue_ptr"].shape == (1,) and flat["queue_ptr"][0] == 8
        assert flat["queue_ptr"].dtype == np.int64
        for enc in ("encoder_q", "encoder_k"):
            assert any(n.startswith(f"{enc}.encoder.") for n in flat)
            linears = {n for n in flat if n.startswith(f"{enc}.fc")}
            assert linears == {
                "conv": set(),
                "linear": {f"{enc}.fc{h}.2.{p}" for h in (1, 2)
                           for p in ("weight", "bias")},
                "mlp": {f"{enc}.fc{h}.{i}.{p}" for h in (1, 2)
                        for i in (2, 4) for p in ("weight", "bias")},
            }[heads]
        _assert_same(load_state(dst)["model"], load_state(jdst)["model"])
    finally:
        for p in (src, dst, jdst):
            p.unlink(missing_ok=True)


def test_unmapped_arch_raises(tmp_path):
    src = tmp_path / "checkpoint.pth.tar"
    save_state({"arch": "tsm", "model": {
        "params_q": {"encoder": {}}, "params_k": {"encoder": {}},
        "batch_stats_q": {"encoder": {}}, "batch_stats_k": {"encoder": {}},
        "queue": np.zeros((2, 2), np.float32),
        "queue_ptr": np.asarray(0, np.int32)}}, src)
    for export in (export_reference_checkpoint, jax_export):
        with pytest.raises(NotImplementedError, match="tsm"):
            export(src, tmp_path / "out.pth.tar")
    save_state({"arch": "s3dg", "model": {"params": {}}}, src)
    with pytest.raises(ValueError, match="pretrain checkpoint"):
        export_reference_checkpoint(src, tmp_path / "out.pth.tar")
