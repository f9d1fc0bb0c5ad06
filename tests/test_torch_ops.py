"""The port's ops (rspnet_tpu_torch/ops) against the JAX package on the CPU.

Same numpy-seeded inputs through the JAX function and the port's function.
On the CPU the port's kernel wrappers take their plain-torch versions (the
CUDA kernels are held against those on the card by chip_smoke.py).

- max pool: forward bit-equal to ``_max_pool3d_separable_rw``, NaN where
  its window holds one, as there; gradient on
  unique values equal to ``jax.vjp`` of it; on ties equal to the first-match
  routings ``max_pool3d_pallas(..., interpret=True)`` (stride 1) and
  ``_make_max_pool3d_fm()`` (strided). At S3D-G's geometries the plain
  backward is pinned to the rw-sep VJP (the JAX S3D-G's default pool) on
  unique, tie-heavy and -inf inputs (also at C3D's pool1, whose other
  geometry and ResNet's are S3D-G's): in f32 at rtol / atol 1e-5, in bf16
  bit-equal at the strided geometries and within 2.5 bf16 ulps of A per
  cell at stride 1 (A: the f32 backward of |g|; ``ops/max_pool3d.py``
  derives the bound). Windows that hold a NaN are the one stated
  deviation.
- colour augment: ``augment_batch`` at atol 1e-5 over all 24 op orders in
  both geometries; ``fused_color_augment(..., interpret=True)`` at its own
  bf16 tolerance 0.12 (tests/test_pallas_augment.py:52).
- ``sample_train_params``: bit-equal draws from the same generator state.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspnet_tpu.models.common import (_make_max_pool3d_fm,
                                      _max_pool3d_separable_rw)
from rspnet_tpu.ops import augment as jaug
from rspnet_tpu.ops.pallas_augment import fused_color_augment
from rspnet_tpu.ops.pallas_pool import max_pool3d_pallas
from rspnet_tpu_torch.ops import augment as taug
from rspnet_tpu_torch.ops import color_augment as tca
from rspnet_tpu_torch.ops import max_pool3d as tmp
from tests.test_pooling import CASES

torch.set_num_threads(1)

# the pooling suite's geometries plus S3D-G's strided sites with a floor
# tail (odd spatial size; pool4 on T=4 / 7x7 drops the last row)
POOL_CASES = CASES + [
    ((4, 7, 7, 5), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ((8, 9, 9, 4), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    ((4, 7, 7, 3), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
]
_fm = _make_max_pool3d_fm()


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _port_pool_grad(x: np.ndarray, g: np.ndarray, k, s, p) -> np.ndarray:
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmp.max_pool3d(xt, k, s, p)
    out.backward(torch.from_numpy(g))
    return xt.grad.numpy()


@pytest.mark.parametrize("ishape,k,s,p", POOL_CASES)
def test_pool_forward_bit_equal(ishape, k, s, p):
    k, s, p = _t3(k), _t3(s), _t3(p)
    x = np.random.RandomState(0).randn(2, *ishape).astype(np.float32)
    ref = np.asarray(_max_pool3d_separable_rw(jnp.asarray(x), k, s, p))
    out = tmp.max_pool3d(torch.from_numpy(x), k, s, p).numpy()
    np.testing.assert_array_equal(out, ref)
    xb = jnp.asarray(x, jnp.bfloat16)
    refb = np.asarray(_max_pool3d_separable_rw(xb, k, s, p).astype(
        jnp.float32))
    outb = tmp.max_pool3d(torch.from_numpy(x).to(torch.bfloat16), k, s, p)
    np.testing.assert_array_equal(outb.float().numpy(), refb)


@pytest.mark.parametrize("ishape,k,s,p", POOL_CASES)
def test_pool_forward_nan_like_jax(ishape, k, s, p):
    """A window holding a NaN pools to NaN, as in the JAX pool."""
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(5)
    x = rng.randn(2, *ishape).astype(np.float32)
    x[rng.rand(*x.shape) < 0.03] = np.nan
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(_max_pool3d_separable_rw(
            jnp.asarray(x, jdt), k, s, p).astype(jnp.float32))
        out = tmp.max_pool3d(torch.from_numpy(x).to(tdt), k, s, p)
        out, nan = out.float().numpy(), np.isnan(ref)
        assert nan.any()
        np.testing.assert_array_equal(np.isnan(out), nan)
        np.testing.assert_array_equal(out[~nan], ref[~nan])


@pytest.mark.parametrize("ishape,k,s,p", POOL_CASES)
def test_pool_gradient_unique_values(ishape, k, s, p):
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(1)
    n = int(np.prod((2, *ishape)))
    x = rng.permutation(n).reshape((2, *ishape)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: _max_pool3d_separable_rw(v, k, s, p),
                       jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_port_pool_grad(x, g, k, s, p),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ishape,k,s,p", POOL_CASES)
def test_pool_gradient_ties_first_match(ishape, k, s, p):
    """ReLU-like inputs quantized to halves: windows full of exact ties."""
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(2)
    x = np.maximum(np.round(rng.randn(2, *ishape) * 2) / 2, 0).astype(
        np.float32)
    if all(v == 1 for v in s):
        fn = lambda v: max_pool3d_pallas(v, k, s, p, True)  # noqa: E731
    else:
        fn = lambda v: _fm(v, k, s, p)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    got = _port_pool_grad(x, g, k, s, p)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the first-match rule conserves the gradient sum
    np.testing.assert_allclose(got.sum(), g.sum(), rtol=1e-5)


@pytest.mark.parametrize("ishape,k,p", [
    ((4, 5, 5, 2), (3, 3, 3), (1, 1, 1)),
    ((8, 14, 14, 6), (3, 3, 3), (1, 1, 1)),
    ((5, 9, 11, 4), (3, 3, 3), (0, 0, 0)),
    ((4, 6, 6, 3), (1, 3, 3), (0, 1, 1)),
])
def test_pool_gradient_nan_and_neginf_like_pallas(ishape, k, p):
    """Windows that hold a NaN, and all -inf windows whose offset-0 cell is
    padding, drop their cotangent in the plain backward as in the Pallas
    kernel's (stride 1, the only stride it takes)."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, *ishape).astype(np.float32)
    x[rng.rand(*x.shape) < 0.03] = -np.inf
    x[:, :2, :2, :2] = -np.inf
    x[(0, *(rng.randint(d) for d in ishape))] = np.nan
    out, vjp = jax.vjp(lambda v: max_pool3d_pallas(v, k, (1, 1, 1), p, True),
                       jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref)
    got = tmp.max_pool3d_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   k, 1, p).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], ref[~nan])
    # some cotangent was dropped: the sums differ
    assert not np.isclose(got.sum(dtype=np.float64), g.sum(dtype=np.float64))


# S3D-G's four pool geometries plus the stride-1 (1,3,3) window
# S3D-G's geometries; C3D pools at 1x2x2_s122 (pool1) and 2x2x2_s2, the
# 3-D ResNets at 3x3x3_s2
POOL_GEOMETRIES = {
    "1x2x2_s122": ((1, 2, 2), (1, 2, 2), (0, 0, 0)),
    "3x3x3_s1": ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "1x3x3_s122": ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
    "3x3x3_s2": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "2x2x2_s2": ((2, 2, 2), (2, 2, 2), (0, 0, 0)),
    "1x3x3_s1": ((1, 3, 3), (1, 1, 1), (0, 1, 1)),
}
POOL_SHAPE = (2, 8, 14, 14, 6)


def _pool_input(kind: str) -> np.ndarray:
    rng = np.random.RandomState(11)
    if kind == "unique":
        n = int(np.prod(POOL_SHAPE))
        return (rng.permutation(n).reshape(POOL_SHAPE) / 7.0).astype(
            np.float32)
    if kind == "ties":          # ReLU'd halves: windows full of ties
        return np.maximum(np.round(rng.randn(*POOL_SHAPE) * 2) / 2,
                          0).astype(np.float32)
    x = rng.randn(*POOL_SHAPE).astype(np.float32)
    x[rng.rand(*POOL_SHAPE) < 0.03] = -np.inf
    return x


def _rw_sep_grad(x, g, k, s, p):
    _, vjp = jax.vjp(lambda v: _max_pool3d_separable_rw(v, k, s, p),
                     jnp.asarray(x))
    return vjp(jnp.asarray(g))[0]


@pytest.mark.parametrize("kind", ["unique", "ties", "neginf"])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMETRIES))
def test_pool_gradient_f32_like_default_jax_pool(geom, kind):
    """F7: apart from NaN windows, the first-match backward equals the VJP
    of the JAX S3D-G's default pool in f32."""
    k, s, p = POOL_GEOMETRIES[geom]
    x = _pool_input(kind)
    g = np.random.RandomState(12).randn(
        *tmp.max_pool3d_fwd_plain(torch.from_numpy(x), k, s, p).shape
    ).astype(np.float32)
    ref = np.asarray(_rw_sep_grad(x, g, k, s, p))
    got = tmp.max_pool3d_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   k, s, p).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _ulp_bf16(v: np.ndarray) -> np.ndarray:
    v = np.abs(v.astype(np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("kind", ["unique", "ties", "neginf"])
@pytest.mark.parametrize("geom", sorted(POOL_GEOMETRIES))
def test_pool_gradient_bf16_like_default_jax_pool(geom, kind):
    """F8: in bf16 the first-match backward equals the default pool's VJP
    bit for bit at the strided geometries, and at stride 1 lies within
    2.5 ulp_bf16(A) of it, A the f32 backward of |g|."""
    k, s, p = POOL_GEOMETRIES[geom]
    xt = torch.from_numpy(_pool_input(kind)).to(torch.bfloat16)
    gt = torch.from_numpy(np.random.RandomState(12).randn(
        *tmp.max_pool3d_fwd_plain(xt, k, s, p).shape)).to(torch.bfloat16)
    ref = np.asarray(_rw_sep_grad(
        jnp.asarray(xt.float().numpy(), jnp.bfloat16),
        jnp.asarray(gt.float().numpy(), jnp.bfloat16), k, s, p).astype(
            jnp.float32))
    got = tmp.max_pool3d_bwd_plain(xt, gt, k, s, p).float().numpy()
    if any(v > 1 for v in s):
        np.testing.assert_array_equal(got, ref)
    else:
        a = tmp.max_pool3d_bwd_plain(xt.float(), gt.float().abs(), k, s,
                                     p).numpy()
        assert np.all(np.abs(got - ref) <= 2.5 * _ulp_bf16(a))
        assert np.any(got != ref)       # the two do round differently


def test_pool_cpu_path_launches_no_kernel():
    before = dict(tmp.launches)
    x = torch.randn(1, 4, 6, 6, 2, requires_grad=True)
    tmp.max_pool3d(x, 3, 1, 1).sum().backward()
    assert tmp.launches == before


def test_pool_generic_build_takes_the_same_source():
    """The build chip_smoke.py times the K1 and K2 generic instances with:
    the same source under a define that turns the compile-time instances
    off."""
    from rspnet_tpu_torch.ops import _build
    src, flags = _build._source("max_pool3d_generic")
    assert src == _build._source("max_pool3d")[0]
    assert flags == [*_build.NVCC_FLAGS, "-DRSP_POOL_GENERIC"]
    # one guard in front of K1's instances, one in front of K2's
    assert src.read_text().count("#ifndef RSP_POOL_GENERIC") == 2
    assert (_build._lib_path("max_pool3d_generic")
            != _build._lib_path("max_pool3d"))
    x, g = torch.randn(1, 4, 6, 6, 4), torch.randn(1, 4, 6, 6, 4)
    assert torch.equal(
        tmp.max_pool3d_bwd(x, g, 3, 1, 1, build="max_pool3d_generic"),
        tmp.max_pool3d_bwd_plain(x, g, 3, 1, 1))
    assert torch.equal(
        tmp.max_pool3d_fwd(x, 3, 1, 1, build="max_pool3d_generic"),
        tmp.max_pool3d_fwd_plain(x, 3, 1, 1))


def test_pool_rejects_unsupported_geometry():
    x = torch.zeros(1, 4, 8, 8, 2)
    with pytest.raises(ValueError):
        tmp.max_pool3d_fwd(x, (4, 3, 3), 1, 1)       # k > 3
    with pytest.raises(ValueError):
        tmp.max_pool3d_fwd(x, 2, 3, 0)               # s > k
    with pytest.raises(ValueError):
        tmp.max_pool3d_fwd(x, 2, 2, 2)               # p > k // 2


def test_sample_train_params_bit_equal():
    for kw in (dict(crop_area=(0.4, 1.0), gray_p=0.2,
                    jitter=(0.4, 0.4, 0.4, 0.4)),
               dict(crop_area=(1.0, 1.0), gray_p=0.5,
                    jitter=(0.4, 0.0, 0.4, 0.1), jitter_p=0.8, blur_p=0.5)):
        a = jaug.sample_train_params(np.random.default_rng(5), 16,
                                     [(128, 171)], **kw)
        b = taug.sample_train_params(np.random.default_rng(5), 16,
                                     [(128, 171)], **kw)
        for field in ("boxes", "flip", "jitter", "order", "gray", "blur"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)


def test_crop_resize_matches_jax():
    rng = np.random.RandomState(3)
    clips = rng.rand(3, 2, 12, 10, 3).astype(np.float32)
    boxes = np.array([[1, 2, 9, 7], [0, 0, 12, 10], [3, 1, 5, 8]],
                     np.float32)
    flip = np.array([False, True, True])
    ref = np.stack([np.asarray(jaug.crop_resize(
        jnp.asarray(clips[b]), jnp.asarray(boxes[b]), (8, 8),
        flip=jnp.asarray(flip[b]))) for b in range(3)])
    out = taug.crop_resize(torch.from_numpy(clips), torch.from_numpy(boxes),
                           (8, 8), flip=torch.from_numpy(flip)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def _all_order_params(rng, hw, crop_area):
    """24 clips, one per op order, with gray and flip alternating."""
    orders = np.asarray(list(itertools.permutations(range(4))), np.int32)
    n = len(orders)
    p = jaug.sample_train_params(rng, n, [hw], crop_area=crop_area,
                                 gray_p=0.0, jitter=(0.4, 0.4, 0.4, 0.4))
    p.order = orders
    p.gray = np.arange(n) % 3 == 0
    p.flip = np.arange(n) % 2 == 1
    return p


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("gray_first", [True, False])
def test_augment_batch_matches_jax_all_orders(identity, gray_first):
    S = 8
    hw = (S, S) if identity else (12, 10)
    rng = np.random.default_rng(4)
    p = _all_order_params(rng, hw, (1.0, 1.0) if identity else (0.4, 1.0))
    batch = rng.integers(0, 256, (len(p.order), 2, *hw, 3), dtype=np.uint8)
    kw = dict(size=(S, S), mean=(0.485, 0.456, 0.406),
              std=(0.229, 0.224, 0.225), gray_before_jitter=gray_first,
              identity_geometry=identity)
    ref = np.asarray(jaug.augment_batch(
        jnp.asarray(batch), p.boxes, p.flip, p.jitter, p.order, p.gray,
        p.blur, use_blur=False, **kw))
    out = taug.augment_batch(torch.from_numpy(batch), p, **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_color_augment_matches_pallas_kernel():
    rng = np.random.RandomState(0)
    B, T, S = 4, 4, 16
    batch = (rng.rand(B, T, S, S, 3) * 255).astype(np.uint8)
    order = np.stack([np.random.RandomState(i).permutation(4)
                      for i in range(B)]).astype(np.int32)
    factors = np.array([[1.2, 0.8, 1.3, 0.1], [1.0, 1.0, 1.0, 0.0],
                        [0.7, 1.1, 0.9, -0.2], [1.4, 0.6, 1.0, 0.4]],
                       np.float32)
    flags = np.array([[0, 1], [1, 0], [0, 0], [1, 1]], np.int32)
    ref = np.asarray(fused_color_augment(
        jnp.asarray(batch), jnp.asarray(order), jnp.asarray(factors),
        jnp.asarray(flags), interpret=True))
    out = tca.color_augment(
        torch.from_numpy(batch), order, factors, flags[:, 0].astype(bool),
        flags[:, 1].astype(bool), mean=(0.485, 0.456, 0.406),
        std=(0.229, 0.224, 0.225)).numpy()
    # the Pallas kernel computes in bf16 (tests/test_pallas_augment.py:52)
    np.testing.assert_allclose(out, ref, atol=0.12)
    assert np.median(np.abs(out - ref)) < 0.02


def test_color_augment_cpu_path_launches_no_kernel():
    before = dict(tca.launches)
    x = torch.zeros(2, 1, 4, 4, 3, dtype=torch.uint8)
    tca.color_augment(x, np.tile(np.arange(4), (2, 1)), np.ones((2, 4)),
                      np.zeros(2, bool), np.zeros(2, bool),
                      mean=(0, 0, 0), std=(1, 1, 1))
    assert tca.launches == before
