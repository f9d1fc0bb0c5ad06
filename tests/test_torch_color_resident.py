"""A CPU model of K3's resident instance, pinned to the plain colour augment.

The resident K3 (``augment_resident`` in
rspnet_tpu_torch/csrc/color_augment.cu) runs on the card only. Its
algorithm is modelled here with torch ops, step for step:

- the row partition: a clip is T*H rows of W pixels; each of nCTA CTAs owns
  R = ceil(T*H / nCTA) whole rows (the last CTA with rows may be ragged,
  the CTAs after it have none), cut into chunks of ceil(R / 8) rows;
- pass 1, per CTA: the chain up to contrast on its rows in storage order,
  the result held in place as the pixel state, and one luma partial summed
  as the kernel sums it (each of 512 threads over its groups of 4 pixels,
  or 1 when W % 4 != 0, chunk after chunk; a butterfly over each warp; the
  16 warp sums in order);
- the grid barrier: the partials of every CTA summed in the same fixed
  order (lane j of CTA 0's warp 0 over partials j, j+32, ...; a
  butterfly), over T*H*W pixels: the clip mean of luma;
- pass 2, per CTA, from the held state: the flip inside each row, contrast
  against that mean, the rest of the chain, gray after the jitter and the
  normalize (one fma with 1/std and -mean/std);
- the kernel's own arithmetic where it differs from the plain version's:
  the hue turn as one piecewise-linear function a channel (``hue_model``)
  and uint8 / 255 as a product and one correction (exact).

Each case holds the model to ``color_augment_plain`` over all 24 op orders
x gray x flip, gray before or after the jitter, uint8 and f32 input, to
1e-5 (as tests/test_torch_ops.py holds K3: f32 sums taken in another
order). The model is also bit-identical for two nCTA that give the same
partition of rows.
"""
import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch

from rspnet_tpu_torch.ops import _build
from rspnet_tpu_torch.ops import color
from rspnet_tpu_torch.ops import color_augment as tca

torch.set_num_threads(1)

THREADS, WARP, CHUNKS = 512, 32, 8   # kResThreads, warp, kChunkTarget
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
_LANES = torch.arange(WARP)


def hue_model(img, factor):
    """The kernel's hue turn (hue_n): with H = 6 h in [0, 6] and delta =
    max - min, r = v - delta sat(2 - |H - 3|), g = v - delta sat(|H - 2| -
    1), b = v - delta sat(|H - 4| - 1); the numerator picked by the pairwise
    >= chain, as in the plain version."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(r, torch.maximum(g, b))
    delta = v - torch.minimum(r, torch.minimum(g, b))
    d = torch.where(v == 0, torch.zeros_like(v), delta)
    r_max, g_max = (r >= g) & (r >= b), g >= b
    num = torch.where(r_max, g - b, torch.where(g_max, b - r, r - g))
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    off = torch.where(r_max, 0.0, torch.where(g_max, 2.0, 4.0))
    H = (num / safe + off) + torch.tensor(6.0 * np.float32(factor),
                                          dtype=torch.float32)
    H = H - 6.0 * torch.floor(H * (1.0 / 6.0))
    w = [(2.0 - (H - 3.0).abs()), (H - 2.0).abs() - 1.0,
         (H - 4.0).abs() - 1.0]
    return torch.stack([v - d * c.clamp(0.0, 1.0) for c in w], -1)


_OPS = (color.adjust_brightness, None, color.adjust_saturation, hue_model)


def partition(rows, ncta):
    """(R, CR, [(row0, nrows)] per CTA) of the kernel's plan."""
    R = -(-rows // ncta)
    CR = -(-R // CHUNKS)
    return R, CR, [(k * R, max(0, min(R, rows - k * R))) for k in range(ncta)]


def _butterfly(v):
    """__shfl_xor_sync sums over the last axis of 32 lanes; lane 0."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., _LANES ^ off]
    return v[..., 0]


def cta_partial(lum, n):
    """The kernel's luma partial of one CTA: lum [nrows, W] f32, summed by
    each thread over its groups of the slice, round after round."""
    acc = torch.zeros(THREADS)
    groups = lum.reshape(-1, n)
    rounds = -(-groups.shape[0] // THREADS)
    pad = torch.zeros(rounds * THREADS, n)
    pad[:groups.shape[0]] = groups
    for it in range(rounds):
        for j in range(n):
            acc = acc + pad[it * THREADS:(it + 1) * THREADS, j]
    warps = _butterfly(acc.reshape(THREADS // WARP, WARP))
    part = torch.zeros(())
    for w in warps:
        part = part + w
    return part


def grid_mean(partials, npix):
    """Every CTA's sum of partials[clip, :], in the kernel's fixed order."""
    lanes = torch.zeros(WARP)
    for lo in range(0, partials.numel(), WARP):
        chunk = partials[lo:lo + WARP]
        lanes[:chunk.numel()] = lanes[:chunk.numel()] + chunk
    return _butterfly(lanes) / npix


def resident_model(x, order, factors, gray, flip, *, ncta,
                   gray_before_jitter):
    B, T, H, W, _ = x.shape
    rows, n = T * H, 4 if W % 4 == 0 else 1
    R, CR, slices = partition(rows, ncta)
    scale = 1.0 / torch.tensor(STD)
    shift = -torch.tensor(MEAN) * scale
    out = torch.empty(x.shape, dtype=torch.float32)
    for b in range(B):
        clip = x[b].reshape(rows, W, 3)
        clip = clip.float() / 255.0 if x.dtype == torch.uint8 else clip
        kc = list(order[b]).index(1)
        # pass 1: each CTA's state, held in place, and its partial
        states, partials = [], []
        for row0, nr in slices:
            if nr == 0:                 # a CTA with no rows adds +0.0
                states.append(None)
                partials.append(torch.zeros(()))
                continue
            st = clip[row0:row0 + nr]
            if gray[b] and gray_before_jitter:
                st = color.rgb_to_grayscale(st)
            for op in order[b][:kc]:
                st = _OPS[op](st, float(factors[b, op]))
            states.append(st)
            partials.append(cta_partial(color.luma(st), n))
        cmean = grid_mean(torch.stack(partials), rows * W)
        # pass 2: from the held state, the flip inside each row
        for (row0, nr), st in zip(slices, states):
            if nr == 0:
                continue
            if flip[b]:
                st = st.flip(1)
            st = color._blend(st, cmean, float(factors[b, 1]))
            for op in order[b][kc + 1:]:
                st = _OPS[op](st, float(factors[b, op]))
            if gray[b] and not gray_before_jitter:
                st = color.rgb_to_grayscale(st)
            out[b].view(rows, W, 3)[row0:row0 + nr] = (
                st.double() * scale.double() + shift.double()).float()
    return out


def _inputs(shape, dtype, seed=0):
    """All 24 orders x gray x flip, one clip each."""
    combos = [(o, g, f) for o in itertools.permutations(range(4))
              for g in (False, True) for f in (False, True)]
    rng = np.random.default_rng(seed)
    n = len(combos)
    order = np.asarray([c[0] for c in combos], np.int64)
    gray = np.asarray([c[1] for c in combos])
    flip = np.asarray([c[2] for c in combos])
    factors = np.stack([rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
                        rng.uniform(0.6, 1.4, n), rng.uniform(-0.4, 0.4, n)],
                       1).astype(np.float32)
    if dtype == torch.uint8:
        x = torch.from_numpy(rng.integers(0, 256, (n, *shape, 3),
                                          dtype=np.uint8))
    else:
        x = torch.from_numpy(rng.random((n, *shape, 3), dtype=np.float32))
    return x, order, factors, gray, flip


def test_partition_has_empty_and_ragged_ctas():
    # T*H = 24 rows of the [*, 4, 6, W, 3] clips below
    assert partition(24, 7)[2][-1] == (24, 0)          # a CTA with no rows
    assert partition(24, 5)[2][-1] == (20, 4)          # ragged last CTA
    R, CR, slices = partition(24, 1)
    assert (R, CR, slices) == (24, 3, [(0, 24)])       # 8 chunks of 3 rows
    for ncta in (1, 5, 7, 64):
        _, _, slices = partition(24, ncta)
        assert sum(nr for _, nr in slices) == 24


@pytest.mark.parametrize("ncta", [1, 5, 7, 64])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32],
                         ids=["u8", "f32"])
@pytest.mark.parametrize("gray_first", [True, False],
                         ids=["gray_before", "gray_after"])
@pytest.mark.parametrize("W", [10, 12], ids=["W10_scalar", "W12_vec4"])
def test_resident_model_matches_plain(W, gray_first, dtype, ncta):
    x, order, factors, gray, flip = _inputs((4, 6, W), dtype)
    out = resident_model(x, order, factors, gray, flip, ncta=ncta,
                         gray_before_jitter=gray_first)
    ref = tca.color_augment_plain(x, order, factors, gray, flip, mean=MEAN,
                                  std=STD, gray_before_jitter=gray_first)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pair", [(9, 11), (64, 100)])
def test_resident_model_same_partition_same_bits(pair):
    """nCTA 9 and 11 both give R = 3 on 24 rows, 64 and 100 both R = 1:
    the same slices, partials padded with zero partials, the same bits."""
    assert len({partition(24, n)[:2] for n in pair}) == 1
    x, order, factors, gray, flip = _inputs((4, 6, 12), torch.float32, 1)
    a, b = (resident_model(x, order, factors, gray, flip, ncta=n,
                           gray_before_jitter=True) for n in pair)
    assert torch.equal(a, b)


def test_generic_build_takes_the_same_source():
    """The build chip_smoke.py times K3's generic instance with: the same
    source under a define that turns the resident plan off."""
    src, flags = _build._source("color_augment_generic")
    assert src == _build._source("color_augment")[0]
    assert flags == [*_build.NVCC_FLAGS, "-DRSP_K3_GENERIC"]
    assert src.read_text().count("#ifndef RSP_K3_GENERIC") == 1
    assert (_build._lib_path("color_augment_generic")
            != _build._lib_path("color_augment"))
    x, order, factors, gray, flip = _inputs((2, 3, 4), torch.uint8)
    kw = dict(mean=MEAN, std=STD)
    assert torch.equal(
        tca.color_augment(x, order, factors, gray, flip,
                          build="color_augment_generic", **kw),
        tca.color_augment_plain(x, order, factors, gray, flip, **kw))


@pytest.mark.parametrize("factor", [-0.5, -0.4, -0.17, 0.0, 0.23, 0.4, 0.5])
def test_hue_model_matches_plain(factor):
    """The kernel's hue turn against color.adjust_hue: random pixels, uint8
    levels, ties between channels, gray and black pixels."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((4096, 3), generator=gen)
    x[:512] = torch.randint(0, 256, (512, 3), generator=gen).float() / 255
    x[512:768] = torch.randint(0, 3, (256, 3), generator=gen).float() / 2
    x[768:832, 1] = x[768:832, 0]
    x[832:896, 2] = x[832:896, 1]
    x[896:900] = 0.0
    torch.testing.assert_close(hue_model(x, factor),
                               color.adjust_hue(x, factor), atol=2e-6,
                               rtol=0)


def test_u8_scale_is_exact():
    """load_px's uint8 / 255: q0 = u * RN(1/255), then one fma correction,
    is the correctly rounded quotient for every u (exact arithmetic)."""
    def rn(v):                                  # round a rational to f32
        f = np.float32(float(v))
        near = [np.nextafter(f, np.float32(-1)), f,
                np.nextafter(f, np.float32(2))]
        return min(near, key=lambda c: (abs(Fraction(float(c)) - v),
                                        int(c.view(np.int32)) & 1))
    inv = rn(Fraction(1, 255))
    for u in range(256):
        q0 = rn(u * Fraction(float(inv)))
        r = rn(u - 255 * Fraction(float(q0)))
        q1 = rn(Fraction(float(q0)) + Fraction(float(r)) * Fraction(float(inv)))
        assert q1 == np.float32(u) / np.float32(255), u
