"""The port's 2-D -> 3-D inflation (rspnet_tpu_torch/models/convert.py
``inflate_2d_state_dict``) against the JAX package's
(rspnet_tpu/models/torch_bridge.py:284), on the CPU.

A synthetic "2-D ImageNet" dict in the reference's MFNet2D layout (4-D
kernels under the 3-D names, BN tensors, a 1000-class head named
``classifier``, which both skip), plus a kernel of the wrong shape (both
skip it), inflates the port's MFNet-3D and the JAX package's from the same
starting weights: the same tensors loaded and skipped, in the same order,
and the results equal bit for bit (kernels with kt > 1 divided by kt and
replicated, kt == 1 reshaped, the rest copied). The same for ResNet-10.
The inflated dict loads into the port's model. A method other than
``inflation`` and an unmapped arch raise in both.
"""
import numpy as np
import pytest
import torch

from rspnet_tpu.models.torch_bridge import \
    inflate_2d_state_dict as jax_inflate
from rspnet_tpu_torch.models import convert, get_model_class
from rspnet_tpu_torch.models.convert import inflate_2d_state_dict

torch.set_num_threads(1)


def _sd2d(sd, rng):
    out = {}
    for k, v in sd.items():
        a = v.numpy()
        if k.endswith("num_batches_tracked"):
            continue
        if a.ndim == 5:
            o, i, kt, kh, kw = a.shape
            out[k] = rng.standard_normal((o, i, kh, kw)).astype(np.float32)
        elif k.startswith("fc."):
            shape = (1000, a.shape[-1]) if a.ndim == 2 else (1000,)
            out["classifier." + k.split(".", 1)[1]] = (
                rng.standard_normal(shape).astype(np.float32))
        else:
            out[k] = rng.standard_normal(a.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("arch,conv_key", [
    ("mfnet", "conv2.B01.conv_m1.conv.weight"),
    ("resnet10", "layer2.0.conv1.weight")])
def test_inflation_equals_jax(arch, conv_key):
    torch.manual_seed(0)
    net = get_model_class(arch)(num_classes=6, with_classifier=True)
    sd = net.state_dict()
    rng = np.random.default_rng(3)
    sd2d = _sd2d(sd, rng)
    o, i, kh, kw = sd2d[conv_key].shape
    sd2d[conv_key] = rng.standard_normal((o, i + 1, kh, kw)).astype(
        np.float32)                                   # wrong shape: skipped
    kts = {sd[k].shape[2] for k, v in sd2d.items()
           if k in sd and v.ndim == 4}
    assert {1, 3} <= kts                              # both kinds of kernel

    got, loaded, skipped = inflate_2d_state_dict(sd, sd2d, arch)
    variables = convert.state_dict_to_variables(sd, arch)
    ref, jloaded, jskipped = jax_inflate(variables, sd2d, arch)
    assert loaded == jloaded and skipped == jskipped
    assert conv_key in skipped and "fc.weight" in skipped
    assert len(loaded) > 50
    want = convert.variables_to_state_dict(ref, arch)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k])
            continue
        assert v.dtype == sd[k].dtype and v.shape == sd[k].shape, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # a 3-kernel is the 2-D kernel over kt, kt times
    k3 = next(k for k in loaded if got[k].ndim == 5 and got[k].shape[2] == 3)
    np.testing.assert_array_equal(
        got[k3].numpy(), np.repeat((sd2d[k3] / 3.0)[:, :, None], 3, axis=2))
    net.load_state_dict(got)


def test_unsupported_raise():
    sd = get_model_class("mfnet")(num_classes=6).state_dict()
    with pytest.raises(NotImplementedError, match="inflation"):
        inflate_2d_state_dict(sd, {}, "mfnet", method="random")
    with pytest.raises(NotImplementedError, match="inflation"):
        jax_inflate({"params": {}}, {}, "mfnet", method="random")
    with pytest.raises(NotImplementedError, match="tsm"):
        inflate_2d_state_dict(sd, {}, "tsm")
    with pytest.raises(NotImplementedError, match="tsm"):
        jax_inflate({"params": {}}, {}, "tsm")
