"""A CPU model of K2's tiled instances, pinned bit for bit to the plain
max-pool backward.

The tiled K2 (``route_tile`` and ``gather_tile`` in
rspnet_tpu_torch/csrc/max_pool3d.cu) runs on the card only. Its algorithm
is modelled here with vectorised torch ops, step for step:

- the plan: the vector width V (8 in bf16 where C % 8 == 0 and every
  tensor is 16-byte aligned, 4 where C % 4 == 0 and the tensors are
  aligned for it, else 1) and the C-adaptive thread map: a block of 256
  threads covers CVr element vectors (the least power of two >= C / V, at
  most 8) x 8 columns x 32 / CVr groups of RH rows, so that every thread
  owns an element vector at narrow C;
- route pass: per output lane, (value, key) pairs with key dw*16 + dh*4
  + dt (base-4 digits: keys order as (dw, dh, dt)), held as the value 128
  + key in the lane's own type; a strict > scan
  over W (dw order), then the pair reduction over H and over T (the larger
  value wins, on a tie the smaller key), with max.NaN carrying a NaN; the
  -inf cells of the tile's box (padding, the tensor's edge) take part with
  their keys; the lane's byte is dt*9 + dh*3 + dw of the key, or 0x7F
  where the max is NaN or
  is -inf with the offset-0 cell in the padding; V lanes packed into one
  little-endian route word (64 bits at V = 8);
- gather pass: the route bytes rewritten digit by digit (``route_digits``:
  dw | dh << 2 | dt << 4, with the kernel's byte-parallel arithmetic on
  32-bit words) and the separable sum of the plain version's stages:
  gW(to, ho, w) over dw where the route's dw matches, tagged with the
  (dh, dt) digits of its routes; gH(to, h, w) over dh where gW's dh
  matches, tagged with dt; dx over dt; each in window-offset order, summed
  in f32, each pooled level rounded to the dtype; the staged box of each
  block's input tile (the tile plus its halo) holds every window the tile
  reads.

Each case asserts ``torch.equal`` with ``max_pool3d_bwd_plain`` (NaN masks
equal, values equal outside them), which tests/test_torch_ops.py pins to
the JAX first-match oracle; the route also equals the strict-scan model of
tests/test_torch_pool_route.py, which the generic instance still runs.
"""
import numpy as np
import pytest
import torch

from rspnet_tpu_torch.ops import max_pool3d as tmp
from tests.test_torch_pool_route import route_model

torch.set_num_threads(1)

NO_ROUTE = 0x7F                 # kNoRouteByte of the kernel
THREADS, COLS = 256, 8          # kThreads, kTileCols of the kernel
# ([T, H, W, C], k, s, p) per clip, narrow and short
CASES = [
    ((8, 28, 28, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),    # S3D-G maxPool1/2
    ((4, 9, 9, 16), (3, 3, 3), (1, 1, 1), (1, 1, 1)),     # S3D-G branch3
    ((8, 14, 14, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),    # S3D-G 4b pool
    ((4, 14, 14, 16), (2, 2, 2), (2, 2, 2), (0, 0, 0)),   # S3D-G 5b pool
    ((4, 14, 14, 8), (3, 3, 3), (2, 2, 2), (1, 1, 1)),    # ResNet-18 pool
    ((4, 14, 14, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1)),    # C = 8 stem
    ((4, 14, 14, 16), (1, 3, 3), (1, 2, 2), (0, 1, 1)),   # C = 16 stem
    ((2, 14, 14, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),   # C = 64 stem
    ((2, 7, 7, 16), (1, 2, 2), (1, 2, 2), (0, 0, 0)),     # 7² non-local
    ((4, 6, 6, 8), (2, 1, 1), (2, 1, 1), (0, 0, 0)),      # C2D pool1
    ((4, 9, 13, 12), (1, 3, 3), (1, 2, 2), (0, 1, 1)),    # C = 12: V = 4
    ((3, 7, 9, 12), (3, 3, 3), (1, 1, 1), (1, 1, 1)),     # C = 12: V = 4
]


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _out(shape, k, s, p):
    return [tmp.out_len(d, kk, ss, pp) for d, kk, ss, pp in
            zip(shape[1:4], k, s, p)]


# ---------------------------------------------------------------------------
# the plan and the thread map
# ---------------------------------------------------------------------------

def plan_vec(c, dtype, offsets):
    """make_plan's vector width for a call whose tensors start ``offsets``
    bytes into 256-byte aligned storage."""
    esize = 2 if dtype == torch.bfloat16 else 4
    for v in ((8, 4) if esize == 2 else (4,)):
        if c % v == 0 and all(o % (v * esize) == 0 for o in offsets):
            return v
    return 1


def thread_map(cv_n, rh):
    """(CVr, row groups, tile rows) of a tiled block at cv_n vectors."""
    cvl = 0
    while cvl < 3 and (1 << cvl) < cv_n:
        cvl += 1
    cvr = 1 << cvl
    nr = THREADS // (COLS * cvr)
    return cvr, nr, nr * rh


def tile_owners(cv_n, rows, cols, rh):
    """How many threads of the tile grid own each (row, column, vector) of a
    [rows, cols, cv_n] plane (the same map in both passes)."""
    cvr, nr, th = thread_map(cv_n, rh)
    ncc = -(-cv_n // cvr)
    count = torch.zeros(rows, cols, cv_n, dtype=torch.int64)
    tid = torch.arange(THREADS)
    v, col, rg = tid % cvr, tid // cvr % COLS, tid // (cvr * COLS)
    assert int(rg.max()) + 1 == nr
    for ht in range(-(-rows // th)):
        for wt in range(-(-cols // COLS)):
            for cc in range(ncc):
                for r in range(rh):
                    h = ht * th + rg * rh + r
                    w = wt * COLS + col
                    c = cc * cvr + v
                    ok = (h < rows) & (w < cols) & (c < cv_n)
                    count.index_put_((h[ok], w[ok], c[ok]),
                                     torch.ones(int(ok.sum()),
                                                dtype=torch.int64),
                                     accumulate=True)
    return count


# ---------------------------------------------------------------------------
# route pass
# ---------------------------------------------------------------------------

def _window_cells(xp, off, n, s):
    return xp[:, off[0]:off[0] + (n[0] - 1) * s[0] + 1:s[0],
              off[1]:off[1] + (n[1] - 1) * s[1] + 1:s[1],
              off[2]:off[2] + (n[2] - 1) * s[2] + 1:s[2]]


def _combine(a, ka, b, kb):
    """The pair reduction: the larger value, on a tie the smaller key;
    max.NaN for the value."""
    take = (b > a) | ((b == a) & (kb < ka))
    return torch.maximum(a, b), torch.where(take, kb, ka)


def route_tiled(x, k, s, p):
    """uint8 [B, To, Ho, Wo, C]: route_tile's bytes."""
    B, T, H, W, C = x.shape
    n = _out(x.shape, k, s, p)
    # the boxes' cells: the tensor, -inf around it (padding, edges, tails)
    ext = [max((nn - 1) * ss + kk, pp + d) for nn, ss, kk, pp, d in
           zip(n, s, k, p, (T, H, W))]
    xp = torch.full((B, *ext, C), float("-inf"), dtype=x.dtype)
    xp[:, p[0]:p[0] + T, p[1]:p[1] + H, p[2]:p[2] + W] = x
    # keys as the value 128 + key in the lane's own type (exact, ordered)
    key = lambda kk: torch.tensor(128.0 + kk, dtype=x.dtype)  # noqa: E731
    vh, kh = [], []
    for dt in range(k[0]):
        vw, kw = [], []
        for dh in range(k[1]):
            v = _window_cells(xp, (dt, dh, 0), n, s)
            kv = key(0).expand(v.shape)
            for dw in range(1, k[2]):          # strict > scan, keys rise
                c = _window_cells(xp, (dt, dh, dw), n, s)
                kv = torch.where(c > v, key(16 * dw), kv)
                v = torch.maximum(v, c)
            vw.append(v)
            kw.append(kv)
        a, ka = vw[0], kw[0]
        for dh in range(1, k[1]):
            a, ka = _combine(a, ka, vw[dh], kw[dh] + 4 * dh)
        vh.append(a)
        kh.append(ka)
    m, mk = vh[0], kh[0]
    for dt in range(1, k[0]):
        m, mk = _combine(m, mk, vh[dt], kh[dt] + dt)
    # offset 0 of each window lies in the tensor
    in0 = torch.ones(n, dtype=torch.bool)
    for axis, (d, ss, pp) in enumerate(zip((T, H, W), s, p)):
        first = torch.arange(n[axis]) * ss - pp
        shape = [1, 1, 1]
        shape[axis] = n[axis]
        in0 = in0 & ((first >= 0) & (first < d)).view(shape)
    drop = torch.isnan(m) | ((m == float("-inf")) & ~in0[None, ..., None])
    kk = (mk.float() - 128).to(torch.int64)
    byte = ((kk & 3) * 9 + (kk >> 2 & 3) * 3 + (kk >> 4)).to(torch.uint8)
    return torch.where(drop, torch.tensor(NO_ROUTE, dtype=torch.uint8), byte)


def pack_route_words(route, v):
    """route_bytes: the V lane bytes of each element vector as one
    little-endian word (uint64 at V = 8)."""
    lanes = route.reshape(-1, v).to(torch.int64)
    return sum(lanes[:, lane] << (8 * lane) for lane in range(v))


# ---------------------------------------------------------------------------
# gather pass
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def route_digits(words):
    """The kernel's route_digits on 32-bit words (int64 holding uint32)."""
    def ge(r, c):               # per byte: 1 where byte >= c
        return ((r + (128 - c) * 0x01010101) & M32) >> 7 & 0x01010101
    dt = ge(words, 9) + ge(words, 18)
    r2 = (words - dt * 9) & M32
    dh = ge(r2, 3) + ge(r2, 6)
    return ((r2 - dh * 3) & M32) | dh << 2 | dt << 4


def byte_hits(w, code, mask):
    """The kernel's byte_hits: bit 7 of byte l set where byte l of w
    matches code under mask (0x80 - x, no byte borrowing)."""
    return (0x80808080 - ((w ^ code) & mask)) & M32


def _bytes(words, c):
    """uint8 [..., C] from int64 words of 4 bytes each."""
    lanes = [(words >> (8 * i)) & 0xFF for i in range(4)]
    return torch.stack(lanes, -1).reshape(*words.shape[:-1], c)


def _words(b):
    """int64 words of 4 bytes from uint8 [..., C] (C % 4 == 0)."""
    q = b.to(torch.int64).reshape(*b.shape[:-1], -1, 4)
    return sum(q[..., i] << (8 * i) for i in range(4))


def gather_tiled(route, g, xshape, dtype, k, s, p):
    """dx from the route and g, by gather_tile's three levels."""
    B, T, H, W, C = xshape
    To, Ho, Wo = route.shape[1:4]
    digits = _bytes(route_digits(_words(route)), C)
    # sums in f32, as the plain version adds; bf16 levels of at most two
    # terms: gather_tile's rounded bf16 adds, modelled as the exact sum
    # (f64 holds the sum of two bf16 values exactly) rounded once
    packed = dtype == torch.bfloat16 and all(-(-kk // ss) <= 2 for kk, ss
                                             in zip(k, s))
    acc_dtype = torch.float64 if packed else torch.float32
    gf = g.to(acc_dtype)

    def rnd(v):                 # every level is rounded to the dtype
        return v.to(dtype).to(acc_dtype)

    def level(src_v, src_t, n_out, n_in, kk, ss, pp, axis, code_of, mask,
              tag_mask):
        """One level along ``axis``: for each input position i, the sum in
        offset order of the source cells (i + p - off) / s whose digit
        (under ``mask``) is ``off``; the tag the OR of the hits' bits under
        ``tag_mask``. Positions out of range hold no route (value 0, digit
        3 / tag 0), as the staged box does."""
        shape = list(src_v.shape)
        shape[axis] = n_in
        acc = torch.zeros(shape, dtype=src_v.dtype)
        tag = torch.zeros(shape, dtype=torch.int64)
        for off in range(kk):
            num = torch.arange(n_in) + pp - off
            ok = (num % ss == 0) & (num >= 0) & (num // ss < n_out)
            idx = (num // ss).clamp(0, n_out - 1)
            v = src_v.index_select(axis, idx)
            t = src_t.index_select(axis, idx)
            okv = ok.view([-1 if a == axis else 1 for a in range(5)])
            hit = okv & ((t & mask) == code_of(off))
            acc = acc + torch.where(hit, v, torch.zeros(()))
            tag = tag | torch.where(hit, t & tag_mask, torch.zeros((),
                                    dtype=torch.int64))
        return acc, tag

    d = digits.to(torch.int64)
    gw, tw = level(gf, d, Wo, W, k[2], s[2], p[2], 3, lambda o: o, 0x03,
                   0x3C)
    gh, th = level(rnd(gw), tw, Ho, H, k[1], s[1], p[1], 2,
                   lambda o: o << 2, 0x0C, 0x30)
    dx, _ = level(rnd(gh), th, To, T, k[0], s[0], p[0], 1,
                  lambda o: o << 4, 0x30, 0)
    return dx.to(dtype).contiguous()


def gather_box_covers(xshape, k, s, p, rh):
    """Every window a gather tile reads lies in its staged box: rows
    [hoA, hoA + BHo) and columns [woA, woA + BWo), the tile plus its
    halo, as gather_tile computes them."""
    _, _, H, W, C = xshape
    for cv_n in sorted({1, 2, 3, 4, 8, C // 4}):
        _, _, th = thread_map(cv_n, rh)
        for d, n_tile, kk, ss, pp in ((H, th, k[1], s[1], p[1]),
                                      (W, COLS, k[2], s[2], p[2])):
            box = (n_tile - 1 + kk - 1) // ss + 1
            for t0 in range(0, d, n_tile):
                first = -((-(t0 + pp - (kk - 1))) // ss)     # ceil
                for i in range(t0, t0 + n_tile):
                    for off in range(kk):
                        num = i + pp - off
                        if num % ss:
                            continue
                        assert first <= num // ss < first + box


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _input(rng, ishape, k, p, kind, dtype):
    x = rng.randn(2, *ishape)
    if kind == "ties":
        # post-ReLU, quantized to halves: windows full of exact ties
        x = np.maximum(np.round(x * 2) / 2, 0)
    elif kind == "special":
        # NaN, -inf cells and all -inf windows at both corners
        x[rng.rand(*x.shape) < 0.03] = -np.inf
        x[rng.rand(*x.shape) < 0.01] = np.nan
        x[:, :k[0], :k[1], :k[2]] = -np.inf
        x[:, -k[0]:, -k[1]:, -k[2]:] = -np.inf
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _same(out, ref):
    nan = torch.isnan(ref)
    return (out.dtype == ref.dtype and out.shape == ref.shape
            and torch.equal(torch.isnan(out), nan)
            and torch.equal(out[~nan], ref[~nan]))


@pytest.mark.parametrize("kind", ["unique", "ties", "special"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ishape,k,s,p", CASES)
def test_tiled_model_bit_equal_plain(ishape, k, s, p, dtype, kind):
    k, s, p = _t3(k), _t3(s), _t3(p)
    rng = np.random.RandomState(11)
    x = _input(rng, ishape, k, p, kind, dtype)
    oshape = tmp._out_shape(x.shape, k, s, p)
    g = torch.from_numpy(rng.randn(*oshape).astype(np.float32)).to(dtype)
    route = route_tiled(x, k, s, p)
    # the pair reduction routes as the strict scan of the generic instance
    assert torch.equal(route, route_model(x, k, s, p))
    if kind == "special":
        assert bool((route == NO_ROUTE).any())
    dx = gather_tiled(route, g, x.shape, dtype, k, s, p)
    assert _same(dx, tmp.max_pool3d_bwd_plain(x, g, k, s, p))


@pytest.mark.parametrize("rh", [1, 2, 4])
@pytest.mark.parametrize("ishape,k,s,p", CASES)
def test_gather_box_holds_every_window(ishape, k, s, p, rh):
    k, s, p = _t3(k), _t3(s), _t3(p)
    gather_box_covers((1, *ishape), k, s, p, rh)


@pytest.mark.parametrize("c", [8, 16, 24, 64, 480, 528, 832])
@pytest.mark.parametrize("rh", [1, 2])
def test_thread_map_covers_each_vector_once(c, rh):
    """At V = 8 (bf16): every element vector of the output plane belongs to
    exactly one thread, and at narrow C no thread idles."""
    cv_n = c // 8
    cvr, nr, th = thread_map(cv_n, rh)
    assert cvr * COLS * nr == THREADS and cvr == min(8, 1 << (cv_n - 1)
                                                     .bit_length())
    count = tile_owners(cv_n, 14, 14, rh)
    assert bool((count == 1).all())
    if cv_n <= 8:
        assert cvr == cv_n or cv_n == 3      # no idle vector lane


def test_route_words_pack_lanes_little_endian():
    """V = 8 route words: lane l in byte l, so a 64-bit word unpacks to the
    route bytes in channel order; route_digits rewrites every byte and
    leaves kNoRouteByte unmatched by any dw."""
    rng = np.random.RandomState(3)
    route = torch.from_numpy(rng.randint(0, 27, size=(4, 16))
                             .astype(np.uint8))
    route[0, 3] = NO_ROUTE
    words = pack_route_words(route, 8)
    back = torch.stack([(words >> (8 * lane)) & 0xFF for lane in range(8)],
                       -1).reshape(route.shape).to(torch.uint8)
    assert torch.equal(back, route)
    assert torch.equal(route.view(-1, 8).contiguous().view(torch.int64)
                       .flatten(), words)
    codes = torch.arange(27, dtype=torch.int64)
    want = codes % 3 | (codes // 3 % 3) << 2 | (codes // 9) << 4
    r = torch.cat([codes, torch.tensor([NO_ROUTE])]).to(torch.uint8)
    digits = route_digits(_words(r[None]))
    dig = _bytes(digits, 28)[0].to(torch.int64)
    assert torch.equal(dig[:27], want)
    assert int(dig[27]) & 3 == 3
    # the W level's test: byte l of the hits is 0xFF where dw matches
    for dw in range(3):
        hits = _bytes(byte_hits(digits, dw * 0x01010101, 0x03030303), 28)[0]
        assert torch.equal(hits[:27] >= 0x80, codes % 3 == dw)
        assert int(hits[27]) < 0x80


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plan_vector_width(dtype):
    """make_plan: V = 8 only in bf16 with C % 8 == 0 and 16-byte aligned
    tensors; V = 4 where C % 4 == 0 and the tensors are aligned for it; a
    view two elements into its storage takes V = 1 in f32 and bf16 (4 and 8
    bytes off: not aligned for any vector the plan can take)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    wide = 8 if dtype == torch.bfloat16 else 4
    assert plan_vec(64, dtype, [0, 0, 0]) == wide
    assert plan_vec(12, dtype, [0, 0, 0]) == 4
    assert plan_vec(6, dtype, [0, 0, 0]) == 1
    assert plan_vec(64, dtype, [0, 2 * esize, 0]) == 1
    if dtype == torch.bfloat16:
        assert plan_vec(64, dtype, [8, 0, 0]) == 4     # 8-byte aligned
