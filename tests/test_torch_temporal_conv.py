"""The temporal (kt, 1, 1) convolutions as 2-D convolutions
(rspnet_tpu_torch/models/common.py ``temporal_conv2d``) against the plain
``F.conv3d``, on the CPU.

On a card, ``conv3d`` runs a bf16 or fp16 (kt, 1, 1) convolution with kt >
1, a spatial stride of 1 and no spatial padding on a channels-last input as
``F.conv2d`` with a (kt, 1) kernel on the free [N, C, T, H*W] view. The CPU
path never takes it by itself, so these tests call ``temporal_conv2d``
directly, in f64 and f32, over the temporal strides, paddings, widths and
groups the backbones have: the same output, input gradient and weight
gradient as the 3-D call, and a channels-last output from a channels-last
input. They also pin which convolutions of the built backbones
``temporal_as_2d`` takes (with a stand-in for a card's tensor), ``conv3d``'s
routing, and the ``backbone.temporal_2d_calls`` counter a forward and a
MoCo step.
"""
import functools
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from rspnet_tpu_torch.config import ConfigTree
from rspnet_tpu_torch.framework import tracing
from rspnet_tpu_torch.models import common, get_model_class
from rspnet_tpu_torch.models.common import (conv3d, make_conv,
                                            temporal_as_2d, temporal_conv2d)
from rspnet_tpu_torch.moco import build_moco_model, init_moco_state
from rspnet_tpu_torch.moco import train_step

torch.set_num_threads(1)
CL = torch.channels_last_3d
COUNTER = "backbone.temporal_2d_calls"

# name -> (C_in, C_out, kt, temporal stride, temporal padding, groups,
# clip [T, H, W]): R(2+1)D's stem (83), conv2 (144) and conv5's strided
# first block (921), S3D-G's sepConv1 (kt 7), no padding, a grouped
# convolution; odd T throughout
CASES = {
    "k3.s1.p1.c83": (83, 16, 3, 1, 1, 1, (5, 3, 4)),
    "k3.s1.p0.c144": (144, 16, 3, 1, 0, 1, (7, 2, 3)),
    "k3.s2.p1.c921": (921, 8, 3, 2, 1, 1, (5, 2, 2)),
    "k7.s1.p3.c83": (83, 8, 7, 1, 3, 1, (9, 3, 2)),
    "k7.s2.p0.c144": (144, 8, 7, 2, 0, 1, (11, 2, 3)),
    "k3.s2.p3.c144": (144, 8, 3, 2, 3, 1, (3, 3, 3)),
    "k3.s1.p1.groups4": (16, 12, 3, 1, 1, 4, (5, 3, 5)),
}
# the 2-D form against the 3-D call, relative to each tensor's largest
# element: the same products, summed in another order
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _close(got, ref, tol):
    torch.testing.assert_close(got, ref, rtol=tol,
                               atol=tol * float(ref.detach().abs().max()))


def _inputs(case, dtype, channels_last=True, seed=0):
    c_in, c_out, kt, _, _, groups, clip = CASES[case]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, c_in, *clip), generator=g, dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=CL)
    w = torch.randn((c_out, c_in // groups, kt, 1, 1), generator=g,
                    dtype=dtype) * 0.05
    return x, w


def _grads(y, inputs, seed=1):
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=y.dtype)
    return torch.autograd.grad(y, inputs, g)


@pytest.mark.parametrize("channels_last", [True, False],
                         ids=["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_conv3d(case, dtype, channels_last):
    """Output, input gradient and weight gradient of the 2-D form equal the
    3-D call's."""
    _, _, kt, st, pt, groups, _ = CASES[case]
    x, w = _inputs(case, dtype, channels_last)
    x.requires_grad_()
    w.requires_grad_()
    stride, padding = (st, 1, 1), (pt, 0, 0)
    ref = F.conv3d(x, w, None, stride, padding, groups=groups)
    got = temporal_conv2d(x, w, stride, padding, groups)
    assert got.shape == ref.shape and got.dtype == dtype
    if channels_last:
        assert got.is_contiguous(memory_format=CL)
    _close(got, ref, TOL[dtype])
    for g, r in zip(_grads(got, (x, w)), _grads(ref, (x, w))):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, TOL[dtype])


def test_views_share_the_input_and_weight(monkeypatch):
    """The [N, C, T, H*W] view of a channels-last input and the (kt, 1)
    view of the weight are the same storage: no copy."""
    x, w = _inputs("k3.s1.p1.c83", torch.float32)
    seen, real = {}, F.conv2d

    def conv2d(xx, ww, *args, **kw):
        seen["x"], seen["w"] = xx, ww
        return real(xx, ww, *args, **kw)

    monkeypatch.setattr(F, "conv2d", conv2d)
    temporal_conv2d(x, w, (1, 1, 1), (1, 0, 0))
    assert seen["x"].data_ptr() == x.data_ptr()
    assert seen["x"].shape == (2, 83, 5, 12)
    assert seen["x"].is_contiguous(memory_format=torch.channels_last)
    assert seen["w"].data_ptr() == w.data_ptr()
    assert seen["w"].shape == (16, 83, 3, 1)


# backbone -> (the model keys of its pretrain config, the convolutions
# ``temporal_as_2d`` takes: a forward's count)
ARCHS = {
    "r2plus1d-vcop": ({}, 5),
    "s3dg": ({}, 11),
    "slowfast": ({}, 19),
    "mfnet": ({}, 0),
    "resnet18": ({}, 0),
    "torchvision-resnet18": ({}, 0),
    "c3d": ({}, 0),
    "tsm": ({"base_model": "resnet18", "num_segments": 8}, 0),
}


@functools.lru_cache(maxsize=None)
def _model(arch):
    return get_model_class(arch, **ARCHS[arch][0])()


def _on_cuda(x):
    """A stand-in for a card's tensor: ``temporal_as_2d`` reads ``is_cuda``
    and the memory format."""
    return SimpleNamespace(is_cuda=True, dtype=x.dtype,
                           is_contiguous=x.is_contiguous)


CL_INPUT = torch.zeros(1, 8, 2, 2, 2).contiguous(memory_format=CL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_takes_the_temporal_convs_of_the_backbones(arch, dtype):
    """The (kt, 1, 1) convolutions with kt > 1 and at most 128 outputs:
    R(2+1)D-10's temporal halves of the stem, conv2 and conv3 (not its
    1^3 projections, not conv4's and conv5's 256 and 512 wide ones), the
    temporal convs of S3D-G's ``SepConv``s up to 128 features, SlowFast's
    fast pathway and its first three fusions; nothing of MFNet,
    ResNet-18, r3d_18, C3D or TSM; and f32 nowhere."""
    taken = [name for name, m in _model(arch).named_modules()
             if isinstance(m, nn.Conv3d)
             and temporal_as_2d(m, _on_cuda(CL_INPUT), dtype)]
    assert len(taken) == ARCHS[arch][1]
    temporal = [m for m in _model(arch).modules()
                if isinstance(m, nn.Conv3d) and m.kernel_size[0] > 1
                and m.kernel_size[1:] == (1, 1)]
    assert len(taken) == sum(m.out_channels <= 128 for m in temporal)
    if arch == "r2plus1d-vcop":
        assert taken == ["conv1.temporal_conv"] + [
            f"conv{s}.block1.conv{i}.temporal_conv"
            for s in (2, 3) for i in (1, 2)]
    if arch == "s3dg":
        assert all(n.endswith("sep_conv.1.conv3d") for n in taken)
        assert "feature.sepConv1.sep_conv.1.conv3d" in taken
    if arch == "slowfast":
        assert sum(n.startswith("fast.") for n in taken) == 16
        assert not any(n.startswith("slow.") for n in taken)
    assert not any(temporal_as_2d(m, _on_cuda(CL_INPUT), torch.float32)
                   for m in _model(arch).modules()
                   if isinstance(m, nn.Conv3d))


@pytest.mark.parametrize("case", ["f32", "f64", "cpu_bf16", "contiguous",
                                  "kt_1", "spatial_k", "full_k",
                                  "spatial_stride", "spatial_pad",
                                  "dilation", "outputs_129"])
def test_other_convs_keep_the_3d_call(case):
    """No 2-D form in f32 or f64, on the CPU, on an NCDHW input, for a 1^3
    projection, a (kt, k, k) or (1, k, k) kernel, a spatial stride or
    padding, a dilation, or more than 128 outputs; the CPU's bf16 temporal
    conv runs the 3-D call and counts nothing."""
    x = torch.randn(2, 8, 5, 4, 4).contiguous(memory_format=CL)
    conv = make_conv(8, 128, (3, 1, 1), 1, (1, 0, 0))
    dtype, where = torch.bfloat16, _on_cuda
    assert temporal_as_2d(conv, where(x), dtype)
    if case in ("f32", "f64"):
        dtype = torch.float32 if case == "f32" else torch.float64
    elif case == "cpu_bf16":
        where = lambda t: t  # noqa: E731
    elif case == "contiguous":
        x = x.contiguous()
    elif case == "kt_1":
        conv = make_conv(8, 16, 1, (2, 1, 1))
    elif case == "spatial_k":
        conv = make_conv(8, 16, (1, 3, 3), 1, (0, 1, 1))
    elif case == "full_k":
        conv = make_conv(8, 16, 3, 1, 1)
    elif case == "spatial_stride":
        conv = make_conv(8, 16, (3, 1, 1), (1, 2, 2), (1, 0, 0))
    elif case == "spatial_pad":
        conv = make_conv(8, 16, (3, 1, 1), 1, (1, 1, 0))
    elif case == "dilation":
        conv = nn.Conv3d(8, 16, (3, 1, 1), 1, (2, 0, 0), (2, 1, 1),
                         bias=False)
    elif case == "outputs_129":
        conv = make_conv(8, 129, (3, 1, 1), 1, (1, 0, 0))
    assert not temporal_as_2d(conv, where(x), dtype)
    if case == "cpu_bf16":
        before = tracing.counter(COUNTER)
        y = conv3d(conv, x, dtype)
        assert tracing.counter(COUNTER) == before
        torch.testing.assert_close(y, F.conv3d(
            x.to(dtype), conv.weight.to(dtype), None, 1, (1, 0, 0)))


@pytest.mark.parametrize("channels_last", [True, False],
                         ids=["channels_last", "contiguous"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("case", ["k3.s2.p1.c921", "k3.s1.p1.groups4"])
def test_conv3d_routes_a_temporal_conv(case, bias, channels_last,
                                       monkeypatch):
    """``conv3d`` on the 2-D form (forced here: the CPU never takes it)
    gives the 3-D call's output, bias and memory format included, and the
    same gradients of the input and of the module's parameters; it counts
    one forward."""
    c_in, c_out, kt, st, pt, groups, _ = CASES[case]
    torch.manual_seed(0)
    conv = nn.Conv3d(c_in, c_out, (kt, 1, 1), (st, 1, 1), (pt, 0, 0),
                     groups=groups, bias=bias).double()
    if bias:
        torch.nn.init.normal_(conv.bias)
    x, _ = _inputs(case, torch.float64, channels_last)
    x.requires_grad_()
    inputs = [x, *conv.parameters()]
    ref = conv3d(conv, x, None)
    ref_grads = _grads(ref, inputs)
    monkeypatch.setattr(common, "temporal_as_2d", lambda *a: True)
    before = tracing.counter(COUNTER)
    got = conv3d(conv, x, None)
    assert tracing.counter(COUNTER) == before + 1
    if channels_last:
        assert got.is_contiguous(memory_format=CL)
    _close(got, ref, TOL[torch.float64])
    for g, r in zip(_grads(got, inputs), ref_grads):
        _close(g, r, TOL[torch.float64])


def _as_on_a_card(monkeypatch):
    """``conv3d`` decides as on a card in bf16 (the rule sees a CUDA tensor
    and bf16) and computes in the model's own dtype."""
    rule = common.temporal_as_2d
    monkeypatch.setattr(
        common, "temporal_as_2d",
        lambda conv, x, dt: rule(conv, _on_cuda(x), torch.bfloat16))


# (arch, clip [T, H, W]) of the forwards below: as small as each backbone
# takes
FORWARDS = {"r2plus1d-vcop": (4, 16, 16), "s3dg": (8, 32, 32)}


@pytest.mark.parametrize("arch", list(FORWARDS))
def test_a_forward_counts_its_sites_and_matches(arch, monkeypatch):
    """A forward in f64 on the 2-D form counts each taken convolution once
    (5 on R(2+1)D-10, 11 on S3D-G), with or without a gradient, and gives
    the 3-D forward's features and parameter gradients."""
    torch.manual_seed(0)
    net = get_model_class(arch)().double().eval()
    x = torch.randn(1, *FORWARDS[arch], 3, dtype=torch.float64).permute(
        0, 4, 1, 2, 3).contiguous(memory_format=CL)
    params = list(net.parameters())
    ref = net.features(x)
    ref_grads = _grads(ref, params)
    _as_on_a_card(monkeypatch)
    n = ARCHS[arch][1]
    before = tracing.counter(COUNTER)
    got = net.features(x)
    assert tracing.counter(COUNTER) == before + n
    assert got.is_contiguous(memory_format=CL)
    _close(got, ref, 1e-10)
    for g, r in zip(_grads(got, params), ref_grads):
        _close(g, r, 1e-10)
    assert tracing.counter(COUNTER) == before + n
    with torch.no_grad():
        net.features(x)
    assert tracing.counter(COUNTER) == before + 2 * n


def test_a_moco_step_counts_10_on_r2plus1d(monkeypatch):
    """A MoCo step of R(2+1)D-10 (the fused key pass and the query pass)
    counts 10; its backward counts nothing."""
    cfg = ConfigTree.from_dict({
        "model": {"arch": "r2plus1d-vcop"},
        "moco": {"dim": 16, "k": 8, "m": 0.999, "t": 0.07,
                 "diff_speed": [2], "fc_type": "linear"},
        "temporal_transforms": {"size": 8}})
    model, mcfg = build_moco_model(cfg)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    state = init_moco_state(model, mcfg, opt, torch.Generator())
    gen = torch.Generator().manual_seed(0)
    views = [torch.randn(2, 8, 32, 32, 3, generator=gen) for _ in range(2)]
    _as_on_a_card(monkeypatch)
    before = tracing.counter(COUNTER)
    train_step(state, views[0], views[1], mcfg, perm=torch.tensor([1, 0]),
               speed_index=0)
    assert tracing.counter(COUNTER) == before + 10
