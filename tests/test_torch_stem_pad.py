"""The packed RGB stem convolution (rspnet_tpu_torch/models/common.py
``SpaceToDepthConv3d``) against the plain ``F.conv3d``, on the CPU.

On a card, ``conv3d`` runs a bf16 or fp16 convolution with fewer than 8
input channels and a spatial stride of 2 (the RGB stems) on 2x2 pixel
blocks folded into zero-padded channels. The CPU path never takes it by
itself, so these tests call the Function directly, in f64 and f32, at each
zoo stem's kernel, stride and padding, as the built backbones have them
(small clips, batch 2): the same
output, weight gradient and input gradient as the plain call, a
channels-last output, and nothing packed kept for the backward. They also
pin the packing's layout, when ``conv3d`` takes the path, and the
``backbone.stem_pad_calls`` counter.
"""
import functools
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from rspnet_tpu_torch.framework import tracing
from rspnet_tpu_torch.models import common, get_model_class
from rspnet_tpu_torch.models.common import (SpaceToDepthConv3d, conv3d,
                                            make_conv, packs_stem)

torch.set_num_threads(1)
CL = torch.channels_last_3d
COUNTER = "backbone.stem_pad_calls"

# name -> (arch, which of its convolutions with fewer than 8 input channels,
# clip [T, H, W]): each backbone's RGB stem at a spatial stride of 2, its
# geometry read from the built model (C3D's stride-1 stem keeps the plain
# call)
MODEL_STEMS = {
    "s3dg.sepConv1": ("s3dg", 0, (8, 16, 16)),
    "resnet3d.conv1": ("resnet18", 0, (8, 16, 16)),
    "r2plus1d.spatial": ("r2plus1d-vcop", 0, (4, 16, 16)),
    "tsm.stem": ("tsm", 0, (4, 16, 16)),
    "slowfast.slow": ("slowfast", 0, (2, 16, 16)),
    "slowfast.fast": ("slowfast", 1, (8, 16, 16)),
    "mfnet.conv1": ("mfnet", 0, (8, 16, 16)),
    "r3d_18.stem": ("torchvision-resnet18", 0, (8, 16, 16)),
}
# the model keys of each arch's pretrain config that shape its stem
MODEL_KEYS = {"tsm": {"base_model": "resnet18", "num_segments": 8}}
# name -> (C_out, kernel, stride, padding, clip) of two geometries no stem
# has: even taps on an odd plane whose last row no window reads (the packing
# drops it), odd planes and a stride of 2 in time
ODD_STEMS = {
    "even_taps.odd_plane": (8, (1, 4, 4), (1, 2, 2), (0, 0, 0), (3, 17, 15)),
    "odd_plane": (8, (3, 7, 5), (2, 2, 2), (1, 3, 1), (5, 17, 19)),
}
STEMS = [*MODEL_STEMS, *ODD_STEMS]


@functools.lru_cache(maxsize=None)
def _model_stems(arch):
    """The convolutions of ``arch``'s backbone with fewer than 8 input
    channels, in module order."""
    model = get_model_class(arch, **MODEL_KEYS.get(arch, {}))()
    return [m for m in model.modules()
            if isinstance(m, nn.Conv3d) and m.in_channels < 8]


def _geometry(name):
    """(C_out, kernel, stride, padding, clip) of stem ``name``."""
    if name in ODD_STEMS:
        return ODD_STEMS[name]
    arch, which, clip = MODEL_STEMS[name]
    conv = _model_stems(arch)[which]
    return (conv.out_channels, conv.kernel_size, conv.stride, conv.padding,
            clip)


# the packed call against the plain one, relative to each tensor's largest
# element: the added taps and channels add exact zeros, so the two differ
# only in the order of the sums
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _close(got, ref, tol):
    torch.testing.assert_close(got, ref, rtol=tol,
                               atol=tol * float(ref.detach().abs().max()))


def _stem_inputs(name, dtype, c_in=3, seed=0):
    c_out, k, _, _, clip = _geometry(name)
    g = torch.Generator().manual_seed(seed)
    # NDHWC clips viewed as NCDHW, as the backbones take them
    x = torch.randn((2, *clip, c_in), generator=g, dtype=dtype)
    w = torch.randn((c_out, c_in, *k), generator=g, dtype=dtype) * 0.05
    return x.permute(0, 4, 1, 2, 3), w


def _grads(y, inputs, seed=1):
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=y.dtype)
    return torch.autograd.grad(y, inputs, g)


@pytest.mark.parametrize("input_grad", [False, True],
                         ids=["weight_grad", "input_grad"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", STEMS)
def test_matches_plain_conv(name, dtype, input_grad):
    _, _, stride, padding, _ = _geometry(name)
    x, w = _stem_inputs(name, dtype)
    x.requires_grad_(input_grad)
    w.requires_grad_()
    inputs = (x, w) if input_grad else (w,)
    ref = F.conv3d(x, w, None, stride, padding)
    got = SpaceToDepthConv3d.apply(x, w, stride, padding)
    assert got.shape == ref.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=CL)
    _close(got, ref, TOL[dtype])
    for g, r in zip(_grads(got, inputs), _grads(ref, inputs)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close(g, r, TOL[dtype])


@pytest.mark.parametrize("c_in", [1, 2])
def test_fewer_channels(c_in):
    """Grey or two-channel inputs (4 or 8 folded channels, padded to 8), in
    NCDHW memory."""
    _, _, stride, padding, _ = _geometry("resnet3d.conv1")
    x, w = _stem_inputs("resnet3d.conv1", torch.float64, c_in)
    x = x.contiguous()
    w.requires_grad_()
    ref = F.conv3d(x, w, None, stride, padding)
    got = SpaceToDepthConv3d.apply(x, w, stride, padding)
    _close(got, ref, TOL[torch.float64])
    _close(_grads(got, (w,))[0], _grads(ref, (w,))[0], TOL[torch.float64])


def test_packing_layout():
    """The packed input: 16 channels for an RGB clip, each 2x2 block of the
    padded plane in (row, column, channel) order, the 4 extra channels and
    the padding zero, channels-last; the weight's taps alike."""
    x = torch.arange(2 * 3 * 2 * 5 * 6, dtype=torch.float64).view(
        2, 2, 5, 6, 3).permute(0, 4, 1, 2, 3) + 1
    w = torch.ones(4, 3, 1, 3, 3, dtype=torch.float64)
    xp, wp, stride, padding = common._pack_stem(x, w, (2, 2, 2), (1, 1, 1))
    assert (stride, padding) == ((2, 1, 1), (1, 0, 0))
    # output 3 x 3 from 2 taps: a plane of 2 x (3 + 2 - 1) = 8 rows, columns
    assert xp.shape == (2, 16, 2, 4, 4) and wp.shape == (4, 16, 1, 2, 2)
    assert xp.is_contiguous(memory_format=CL)
    plane = torch.zeros(2, 3, 2, 8, 8, dtype=torch.float64)
    plane[:, :, :, 1:6, 1:7] = x
    for i in range(2):
        for j in range(2):
            block = xp[:, 3 * (2 * i + j):3 * (2 * i + j + 1)]
            assert torch.equal(block, plane[:, :, :, i::2, j::2])
    assert not xp[:, 12:].any()
    assert wp[:, :12].sum() == 4 * 27 and not wp[:, 12:].any()
    back = common._depth_to_space(xp, 3, (1, 1), (5, 6))
    assert torch.equal(back, x)


@pytest.mark.parametrize("name", ["s3dg.sepConv1", "resnet3d.conv1",
                                  "r3d_18.stem"])
def test_backward_keeps_the_unpacked_input(name):
    """What the backward keeps: the input and the weight as given (3
    channels, their own planes), never their packed copies."""
    _, _, stride, padding, _ = _geometry(name)
    x, w = _stem_inputs(name, torch.float32)
    w.requires_grad_()
    y = SpaceToDepthConv3d.apply(x, w, stride, padding)
    saved = y.grad_fn.saved_tensors
    assert [t.shape for t in saved] == [x.shape, w.shape]
    assert saved[0].numel() * saved[0].element_size() <= (
        x.numel() * x.element_size())


def test_casts_the_input_in_the_packing_copy():
    """An input in another dtype than the weight's is cast as the plain
    path casts it (``x.to(w.dtype)``), and its gradient comes back in its
    own dtype."""
    _, _, stride, padding, _ = _geometry("resnet3d.conv1")
    x, w = _stem_inputs("resnet3d.conv1", torch.float64)
    x = x.to(torch.float32).requires_grad_()
    w.requires_grad_()
    ref = F.conv3d(x.to(torch.float64), w, None, stride, padding)
    got = SpaceToDepthConv3d.apply(x, w, stride, padding)
    _close(got, ref, TOL[torch.float64])
    gx, gw = _grads(got, (x, w))
    rx, rw = _grads(ref, (x, w))
    assert gx.dtype == torch.float32
    torch.testing.assert_close(gx, rx)
    _close(gw, rw, TOL[torch.float64])


def test_no_grad_keeps_nothing():
    """The key pass's call (no gradient asked): no tensor kept."""
    _, _, stride, padding, _ = _geometry("s3dg.sepConv1")
    x, w = _stem_inputs("s3dg.sepConv1", torch.float32)
    with torch.no_grad():
        y = SpaceToDepthConv3d.apply(x, w, stride, padding)
    assert y.grad_fn is None
    _close(y, F.conv3d(x, w, None, stride, padding), TOL[torch.float32])


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("name", ["resnet3d.conv1", "mfnet.conv1"])
def test_conv3d_routes_a_stem(name, bias, monkeypatch):
    """``conv3d`` on the packed path (forced here: the CPU never takes it)
    gives the plain path's output, bias and memory format included, and
    the same gradients of the module's parameters."""
    c_out, k, stride, padding, clip = _geometry(name)
    torch.manual_seed(0)
    conv = make_conv(3, c_out, k, stride, padding, use_bias=bias).double()
    if bias:
        torch.nn.init.normal_(conv.bias)
    x, _ = _stem_inputs(name, torch.float64)
    ref = conv3d(conv, x, None)
    ref_grads = _grads(ref, list(conv.parameters()))
    monkeypatch.setattr(common, "packs_stem", lambda *a: True)
    before = tracing.counter(COUNTER)
    got = conv3d(conv, x, None)
    assert tracing.counter(COUNTER) == before + 1
    assert got.is_contiguous(memory_format=CL)
    _close(got, ref, TOL[torch.float64])
    for g, r in zip(_grads(got, list(conv.parameters())), ref_grads):
        _close(g, r, TOL[torch.float64])


def _on_cuda(x):
    """A stand-in for a card's tensor: ``packs_stem`` reads ``is_cuda``."""
    return SimpleNamespace(is_cuda=True, dtype=x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", list(MODEL_STEMS))
def test_packs_half_precision_stems_on_a_card(name, dtype):
    c_out, k, stride, padding, _ = _geometry(name)
    x = torch.zeros(1, 3, 1, 1, 1)
    for c_in in (1, 3, 7):
        conv = make_conv(c_in, c_out, k, stride, padding)
        assert packs_stem(conv, _on_cuda(x), dtype)


@pytest.mark.parametrize("case", ["c_in_8", "c_in_64", "f32", "f64",
                                  "cpu_bf16", "groups", "c3d_stride_1",
                                  "stride_1_2", "stride_2_3"])
def test_other_convs_keep_the_plain_call(case):
    """No packing at C_in >= 8, in f32 or f64, on the CPU, for a grouped
    conv, or off a spatial stride of 2 (C3D's stem, (1, 2), (2, 3)); the
    CPU's bf16 stem runs the plain call and counts nothing."""
    x = torch.randn(2, 3, 4, 8, 8).to(memory_format=CL)
    conv = make_conv(3, 16, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    dtype, where = torch.bfloat16, _on_cuda
    if case == "c_in_8":
        conv = make_conv(8, 16, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    elif case == "c_in_64":
        conv = make_conv(64, 16, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    elif case in ("f32", "f64"):
        dtype = torch.float32 if case == "f32" else torch.float64
    elif case == "groups":
        conv = torch.nn.Conv3d(6, 6, 3, (1, 2, 2), 1, groups=3, bias=False)
    elif case == "c3d_stride_1":
        conv, = _model_stems("c3d")
    elif case == "stride_1_2":
        conv = make_conv(3, 16, (1, 7, 7), (1, 1, 2), (0, 3, 3))
    elif case == "stride_2_3":
        conv = make_conv(3, 16, (1, 7, 7), (1, 2, 3), (0, 3, 3))
    else:
        where = lambda t: t  # noqa: E731
    assert not packs_stem(conv, where(x), dtype)
    if case == "cpu_bf16":
        before = tracing.counter(COUNTER)
        y = conv3d(conv, x, dtype)
        assert tracing.counter(COUNTER) == before
        torch.testing.assert_close(y, F.conv3d(
            x.to(dtype), conv.weight.to(dtype), None, (1, 2, 2), (0, 3, 3)))


def test_counts_one_a_forward():
    """``backbone.stem_pad_calls``: one a forward, with or without a
    gradient; the backward counts nothing."""
    _, _, stride, padding, _ = _geometry("tsm.stem")
    x, w = _stem_inputs("tsm.stem", torch.float32)
    w.requires_grad_()
    before = tracing.counter(COUNTER)
    y = SpaceToDepthConv3d.apply(x, w, stride, padding)
    with torch.no_grad():
        SpaceToDepthConv3d.apply(x, w, stride, padding)
    assert tracing.counter(COUNTER) == before + 2
    y.sum().backward()
    assert tracing.counter(COUNTER) == before + 2
