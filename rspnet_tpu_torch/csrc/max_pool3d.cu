// 3-D max pool, forward (K1) and backward (K2), for NDHWC tensors on sm_90a.
//
// Replaces the Pallas kernels rspnet_tpu/ops/pallas_pool.py:_fwd_kernel and
// :_bwd_kernel. Semantics: torch MaxPool3d in floor mode with -inf padding,
// 1 <= k <= 3, 1 <= s <= k, 0 <= p <= k/2 per axis. The gradient routes each
// cotangent to the FIRST matching offset of its window, one axis at a time
// (W, then H, then T), which is the rule of the Pallas kernel and of
// rspnet_tpu/models/common.py:_make_max_pool3d_fm.
//
// The least time of both directions is set by device-memory traffic (read
// x [and g], write out [or dx]); what holds each above it is said below.
// Every max of the forward propagates NaN (a window holding a NaN gives
// NaN), as the plain version's torch.maximum and the JAX pool's jnp.maximum
// do.
//
// - Forward (K1), one launch. The bound is x read once and out written
//   once. What held the first design (pool_fwd: one thread an output
//   vector, its whole window from global memory) above it were the window
//   re-reads: 27 loads an output at stride 1, most of them from L2. The
//   tiled instances (max_tile) walk K2's route tile (walk_tile): a block
//   owns an output tile of th x 8 pixels x CVr element vectors, each
//   frame's input box is copied once into shared memory (cp.async, two
//   stages), and each lane takes the max W -> H from the box and T over a
//   ring of its last KT frames in registers, then stores 16 bytes a row.
//   Designed for bf16 on Hopper:
//   - V = 8 in bf16 (16-byte copies and stores; cp.async.cg), 4 in f32,
//     4 in bf16 where C % 8 != 0; the plan checks that x and out are
//     aligned for the vector and takes V = 1 (the generic instance) where
//     they are not;
//   - the max in the lanes' own type, max.NaN.bf16x2 or max.NaN.f32 on
//     32-bit words from shared memory: nothing is widened to f32. The max
//     is exact, so the W -> H -> T order changes no bit;
//   - K2's C-adaptive thread map (tile_rows): at C = 8 in bf16 a thread
//     owns one pixel's 8 channels and the tile is 32 rows tall;
//   - instances for S3D-G's four geometries, (1,2,2)/(1,2,2) (C3D's pool1,
//     the non-local pools) and (2,1,1)/(2,1,1) (C2D / I3D's pool1);
//   - a small tile grid (under 1.5 blocks an SM) splits each clip's frame
//     walk into chunks of output frames, one block a chunk, each walking
//     its own frames and a halo of KT - ST frames (fwd_tile_plan).
//   What holds it above its bound: the box's halo rows and columns, read
//   from L2 by the next tile (1.56 times the input at (3,3,3)/1), a
//   ragged last channel chunk (C = 480, 528), and at small pools the
//   host's call (about 12-16 us; a 7^2 site's kernel takes 3-8 us).
//   Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), bf16,
//   batch 64: the 13 S3D-G sites take 1.27-1.32 ms against a 1.074 ms
//   bound (the tile designed for f32, before: 1.62-1.65; the generic
//   instance 4.36-4.43); at the fused key pass's batch 128 2.46-2.47
//   (bound 2.148); f32 2.47-2.49 (bound 2.148).
// - Backward (K2), two launches. Composed W -> H -> T, the first-match rule
//   sends each output's cotangent to exactly one input: the
//   lexicographically first in-bounds cell, in (dw, dh, dt) order, that
//   holds the window max (the first W column holding it, in that column
//   the first H row, in that row the first T frame). One byte holds its
//   offset dt*9 + dh*3 + dw.
//   1. Route: each output element's offset into a uint8 [B, To, Ho, Wo, C]
//      buffer.
//   2. Gather: each input element's dx, the cotangents of the windows that
//      route to it, summed as the staged plain version sums them (W stage,
//      then H, then T, each in window-offset order; in bf16 each pooled
//      stage rounded to bf16). x is not read. No atomics: the result is
//      deterministic and bit-equal to the plain version in f32 and bf16.
//   Bytes: x read, route written and read back, g read, dx written. The
//   tiled instances (route_tile, gather_tile) take the (3,3,3)/1,
//   (1,3,3)/(1,2,2), (3,3,3)/2, (2,2,2)/2 and (1,2,2)/(1,2,2) pools on
//   32-bit plans, designed for bf16 on Hopper:
//   - V = 8 in bf16 (16-byte vectors, a 64-bit route word), 4 in f32, and
//     4 in bf16 where C % 8 != 0; the plan checks that x, g and dx are
//     aligned for the vector (a view may start anywhere) and takes V = 1,
//     the generic instance, where they are not.
//   - A block of 256 threads covers CVr vectors (the least power of two
//     >= C / V, at most 8) x 8 columns x 32 / CVr row groups, so at narrow
//     C the block takes more pixels and no thread idles (at C = 8 in bf16
//     a thread owns one pixel's 8 channels).
//   - The route pass is K1's walk (walk_tile) with another op: each
//     frame's input box is copied into shared memory once (cp.async, two
//     stages) and each lane reduces (value, key) pairs W -> H -> T in
//     bf16x2 lanes (max.NaN, compares that give masks: no widening).
//   - The gather factors the nested sum by level (every route through a
//     cell of a stage reaches it by the same (dh, dt)): per output frame
//     the route bytes and g of the tile's covering outputs are staged in
//     shared memory once, the W level is computed once per staged row and
//     column, the H level per thread into a ring of the last KT frames in
//     registers, and an input frame is summed over T once its last
//     covering frame is in the ring; an element checks at most 3 windows a
//     level, not 27. In bf16 a level of at most two terms sums in bf16x2
//     lanes with a rounded add (equal to rounding the f32 sum).
//   Every other call (other geometries, V = 1, 64-bit plans), and every
//   call of the build with RSP_POOL_GENERIC defined, takes the generic
//   instance, the first design: pool_route and pool_gather, one thread an
//   element vector, its 27 window loads served by L1.
//   Measured by chip_smoke.py on an H100 (700 W), bf16, batch 64: the 13
//   S3D-G sites take 3.9-4.1 ms against the generic instance's 12.3,
//   aten's backward's 28.4 and a 1.83 ms bound; f32 6.9-7.2 (bound 3.67).
//   What holds them above the bound: the stride-1 gather's instructions
//   (three f32 sums of masked lanes a level) and the walks' latency (a
//   third pipeline stage, or a block a frame, measured no faster).
//   A window routes to no cell, and its cotangent is dropped, as the JAX
//   kernel and the plain version drop it, in two cases: (a) it holds a NaN
//   (its max is NaN, which equals no cell); (b) its max is -inf and its
//   offset-0 cell lies in the -inf padding, which is then the first match.
//   Such a route is the byte kNoRouteByte, which the gather never matches.
//   Case (a) is a deviation from the JAX S3D-G's default pool,
//   rspnet_tpu/models/common.py:_max_pool3d_separable_rw, whose VJP (one
//   select-and-scatter per axis) routes a NaN window's cotangent to a cell;
//   on every input without NaN the two route alike. In bf16 the two also
//   round differently at stride 1 (up to 2.5 bf16 ulps of the cotangent
//   mass reaching a cell; ops/max_pool3d.py states the rule).
// - Index arithmetic is 32-bit whenever the tensors allow it (64-bit integer
//   division is a long software sequence on the card); the forward's
//   grid-stride loop counter stays 64-bit so it cannot wrap.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() after its launches (K2 returns
// cudaErrorInvalidConfiguration instead for a shape its grid cannot hold).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// -- V contiguous elements <-> float[V] -------------------------------------
template <int V>
__device__ __forceinline__ void loadv(const float* p, float* v) {
  if constexpr (V == 4) {
    float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    uint2 r = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void storev(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}
template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<uint32_t*>(&a);
    r.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = r;
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

struct Geom {
  int B, T, H, W, C;     // input
  int To, Ho, Wo;        // output
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
};

// max(a, b), NaN when either is NaN (torch.maximum, jnp.maximum).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// out[b, to, ho, wo, c..c+V) = max over the window; pad cells are skipped
// (they hold -inf in the reference and never win). The generic instance of
// K1: every call that max_tile does not take.
template <typename T, int V, typename I>
__global__ void pool_fwd(const T* __restrict__ x, T* __restrict__ out,
                         Geom g) {
  const I cv_n = g.C / V;
  const I total = (I)g.B * g.To * g.Ho * g.Wo * cv_n;
  for (int64_t i64 = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i64 < total; i64 += (int64_t)gridDim.x * blockDim.x) {
    const I idx = (I)i64;
    I r = idx / cv_n;
    const I c = (idx - r * cv_n) * V;
    const int wo = (int)(r % g.Wo); r /= g.Wo;
    const int ho = (int)(r % g.Ho); r /= g.Ho;
    const int to = (int)(r % g.To);
    const I b = r / g.To;
    float m[V], v[V];
#pragma unroll
    for (int l = 0; l < V; ++l) m[l] = -CUDART_INF_F;
    for (int dt = 0; dt < g.kt; ++dt) {
      const int t = to * g.st - g.pt + dt;
      if (t < 0 || t >= g.T) continue;
      for (int dh = 0; dh < g.kh; ++dh) {
        const int h = ho * g.sh - g.ph + dh;
        if (h < 0 || h >= g.H) continue;
        const T* row = x + ((b * g.T + t) * g.H + h) * g.W * g.C + c;
        for (int dw = 0; dw < g.kw; ++dw) {
          const int w = wo * g.sw - g.pw + dw;
          if (w < 0 || w >= g.W) continue;
          loadv<V>(row + (I)w * g.C, v);
#pragma unroll
          for (int l = 0; l < V; ++l) m[l] = max_nan(m[l], v[l]);
        }
      }
    }
    storev<V>(out + idx * V, m);
  }
}

// The V route bytes of one element vector as one word, lanes in channel
// order (little-endian); V = 1: the byte.
template <int V>
__device__ __forceinline__ uint32_t load_route(const uint8_t* p) {
  if constexpr (V == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *p;
}
template <int V>
__device__ __forceinline__ void store_route(uint8_t* p, const int* r) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = (uint32_t)r[0] | (uint32_t)r[1] << 8 |
                                      (uint32_t)r[2] << 16 |
                                      (uint32_t)r[3] << 24;
  } else {
    *p = (uint8_t)r[0];
  }
}

// A route byte, and word, that matches no code (codes are < 27; bit 7 stays
// clear).
constexpr int kNoRouteByte = 0x7F;
constexpr uint32_t kNoRoute = 0x7F7F7F7Fu;

// 0x80 in byte l of the result where lane l of the word routes to code.
// Route bytes and codes are < 128, so byte l of x + 0x7F..7F carries into
// its bit 7 exactly when byte l of x is nonzero, and never into byte l + 1.
template <int V>
__device__ __forceinline__ uint32_t route_hits(uint32_t word, uint32_t code) {
  const uint32_t x = word ^ (V == 4 ? code * 0x01010101u : code);
  return ~(x + kNoRoute) & (V == 4 ? 0x80808080u : 0x80u);
}

// A float rounded to T and back: how the plain version stores a stage's
// cotangent.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(v));
  else return v;
}

// Thread -> element map of both passes of the generic K2 (pool_route,
// pool_gather; the first design): each thread owns one element
// vector (V channels of one pixel), and a block of kThreads covers a tile
// of 2 (T) x 2 (H) x 4 (W) pixels x 16 vectors, so that the window re-reads
// of neighbouring threads hit L1. A warp holds 16 vectors of 2 pixels, so
// a route-word load touches at most 2 lines. The grid of tiles is 3-D:
// x = W tile x channel chunk (chunk fastest), y = H tile, z = batch x T
// tile (T fastest), so a thread finds its tile with two 32-bit divisions
// by block-uniform counts. y and z are limited to 65535 blocks (H up to
// 131070, B * ceil(T / 2) up to 65535); a larger call returns
// cudaErrorInvalidConfiguration and launches nothing.
constexpr int kTileV = 16, kTileW = 4, kTileH = 2, kTileT = 2;
static_assert(kTileV * kTileW * kTileH * kTileT == kThreads, "tile != block");

template <typename I>
struct Pos {
  I b;
  int v, t, h, w;
  bool ok;
};

// The element vector of this thread in a [B, T, H, W, V * cv_n] tensor.
template <typename I>
__device__ __forceinline__ Pos<I> tile_pos(int T, int H, int W, int cv_n) {
  const unsigned ncc = (cv_n + kTileV - 1) / kTileV;
  const unsigned ntt = (T + kTileT - 1) / kTileT;
  const unsigned tw = blockIdx.x / ncc, b = blockIdx.z / ntt;
  const int tid = threadIdx.x, pix = tid / kTileV;
  Pos<I> q;
  q.b = (I)b;
  q.v = (int)(blockIdx.x - tw * ncc) * kTileV + tid % kTileV;
  q.w = (int)tw * kTileW + pix % kTileW;
  q.h = (int)blockIdx.y * kTileH + pix / kTileW % kTileH;
  q.t = (int)(blockIdx.z - b * ntt) * kTileT + pix / (kTileW * kTileH);
  q.ok = q.v < cv_n && q.w < W && q.h < H && q.t < T;
  return q;
}

// Both K2 passes are templates on the window (KT, KH, KW) and strides
// (ST, SH, SW). A nonzero value is a compile-time constant, which lets the
// window loops unroll and the window arithmetic fold; 0 reads the value
// from Geom at run time (the generic instance). Padding is always read at
// run time.
#define RSP_K2_PARAMS int KT, int KH, int KW, int ST, int SH, int SW
#define RSP_K2_ARGS KT, KH, KW, ST, SH, SW
#define RSP_K2_WINDOW                                              \
  const int kt = KT ? KT : g.kt, kh = KH ? KH : g.kh;              \
  const int kw = KW ? KW : g.kw, st = ST ? ST : g.st;              \
  const int sh = SH ? SH : g.sh, sw = SW ? SW : g.sw;

// K2 pass 1, generic. route[b, to, ho, wo, c..c+V) = dt*9 + dh*3 + dw of
// the first window cell, in (dw, dh, dt) order, that holds the window max,
// with the -inf padding counted as cells: the scan starts at offset 0
// (kNoRouteByte when that cell is padding) and moves only to strictly
// greater values, so a window of -inf keeps its start. A lane whose window
// holds a NaN routes to kNoRouteByte: beside the scan it sums |v|, which is
// NaN exactly when a NaN was added (one full-rate add a cell; a
// NaN-propagating max beside the scan made K2 25% slower on the card).
// Capped at 32 registers (8 blocks per SM): the window loads need threads
// in flight more than registers, and the cap measured faster on the card
// despite a few spilled words.
template <typename T, int V, typename I, RSP_K2_PARAMS>
__global__ void __launch_bounds__(kThreads, 8)
    pool_route(const T* __restrict__ x, uint8_t* __restrict__ route,
               Geom g) {
  RSP_K2_WINDOW
  const int cv_n = g.C / V;
  const Pos<I> q = tile_pos<I>(g.To, g.Ho, g.Wo, cv_n);
  if (!q.ok) return;
  const int t0 = q.t * st - g.pt, h0 = q.h * sh - g.ph, w0 = q.w * sw - g.pw;
  bool in_t[3], in_h[3], in_w[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    in_t[d] = d < kt && t0 + d >= 0 && t0 + d < g.T;
    in_h[d] = d < kh && h0 + d >= 0 && h0 + d < g.H;
    in_w[d] = d < kw && w0 + d >= 0 && w0 + d < g.W;
  }
  const I row = (I)g.W * g.C, frame = (I)g.H * row;
  const T* clip = x + q.b * g.T * frame + q.v * V;
  float m[V], v[V], nan_sum[V];
  int best[V];
  const int start = in_t[0] && in_h[0] && in_w[0] ? 0 : kNoRouteByte;
#pragma unroll
  for (int l = 0; l < V; ++l) {
    m[l] = -CUDART_INF_F;
    nan_sum[l] = 0.0f;
    best[l] = start;
  }
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        if (!(in_w[dw] && in_h[dh] && in_t[dt])) continue;
        loadv<V>(clip + (I)(t0 + dt) * frame + (I)(h0 + dh) * row +
                     (I)(w0 + dw) * g.C, v);
#pragma unroll
        for (int l = 0; l < V; ++l) {
          if (v[l] > m[l]) {
            m[l] = v[l];
            best[l] = dt * 9 + dh * 3 + dw;
          }
          nan_sum[l] += fabsf(v[l]);
        }
      }
    }
  }
  const I idx = (((q.b * g.To + q.t) * g.Ho + q.h) * g.Wo + q.w) * cv_n + q.v;
#pragma unroll
  for (int l = 0; l < V; ++l)
    if (nan_sum[l] != nan_sum[l]) best[l] = kNoRouteByte;
  store_route<V>(route + idx * V, best);
}

// The windows of one axis that cover input position i, by window offset:
// on[off] = (i + p - off) / s where that is exact and in [0, n), else -1.
// s <= 3, so the division is by a constant.
__device__ __forceinline__ void covering(int i, int n, int k, int s, int p,
                                         int* on) {
#pragma unroll
  for (int off = 0; off < 3; ++off) {
    const int num = i + p - off;
    on[off] = -1;
    if (off >= k || num < 0) continue;
    const int q = s == 1 ? num : s == 2 ? num >> 1 : (int)((unsigned)num / 3u);
    if (q * s == num && q < n) on[off] = q;
  }
}

// K2 pass 2, generic. dx[b, t, h, w, c..c+V) = the cotangents of the
// windows whose route names (t, h, w), summed T (outer) / H / W (inner) in
// window-offset order; a pooled W or H level is rounded to T before it is
// added up. Per T window that covers the element, the route words of its
// H x W covering windows are loaded together, then g where some lane's
// route hits.
template <typename T, int V, typename I, RSP_K2_PARAMS>
__global__ void pool_gather(const uint8_t* __restrict__ route,
                            const T* __restrict__ gout, T* __restrict__ dx,
                            Geom g) {
  RSP_K2_WINDOW
  // At stride 1 on every axis g is loaded with the route words (one round
  // trip, not two; each g vector serves up to 27 neighbours from L1). A
  // strided pool reads g only where a route hits: there most covering
  // windows route elsewhere, and the eager loads measured slower.
  constexpr bool kEager = ST == 1 && SH == 1 && SW == 1;
  const bool pool_h = !(kh == 1 && sh == 1 && g.ph == 0);
  const bool pool_w = !(kw == 1 && sw == 1 && g.pw == 0);
  const int cv_n = g.C / V;
  const Pos<I> q = tile_pos<I>(g.T, g.H, g.W, cv_n);
  if (!q.ok) return;
  int on_t[3], on_h[3], on_w[3];
  covering(q.t, g.To, kt, st, g.pt, on_t);
  covering(q.h, g.Ho, kh, sh, g.ph, on_h);
  covering(q.w, g.Wo, kw, sw, g.pw, on_w);
  const I c = q.v * V;
  float acc_t[V];
#pragma unroll
  for (int l = 0; l < V; ++l) acc_t[l] = 0.0f;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    if (on_t[dt] < 0) continue;
    I off[3][3];
    uint32_t word[3][3];
    float ge[3][3][kEager ? V : 1];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      const I row = ((q.b * g.To + on_t[dt]) * g.Ho + on_h[dh]) * g.Wo;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        off[dh][dw] = (row + on_w[dw]) * g.C + c;
        word[dh][dw] = kNoRoute;
        if (on_h[dh] >= 0 && on_w[dw] >= 0) {
          word[dh][dw] = load_route<V>(route + off[dh][dw]);
          if constexpr (kEager) loadv<V>(gout + off[dh][dw], ge[dh][dw]);
        }
      }
    }
    float acc_h[V];
#pragma unroll
    for (int l = 0; l < V; ++l) acc_h[l] = 0.0f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) {
      if (on_h[dh] < 0) continue;
      uint32_t hits[3];
      float gv[3][V];
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        hits[dw] = route_hits<V>(word[dh][dw], dt * 9 + dh * 3 + dw);
        if constexpr (kEager) {
#pragma unroll
          for (int l = 0; l < V; ++l) gv[dw][l] = ge[dh][dw][l];
        } else if (hits[dw]) {
          loadv<V>(gout + off[dh][dw], gv[dw]);
        } else {
#pragma unroll
          for (int l = 0; l < V; ++l) gv[dw][l] = 0.0f;
        }
      }
      float acc_w[V];
#pragma unroll
      for (int l = 0; l < V; ++l) acc_w[l] = 0.0f;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
        for (int l = 0; l < V; ++l)
          if (hits[dw] & (0x80u << (8 * l))) acc_w[l] += gv[dw][l];
      }
#pragma unroll
      for (int l = 0; l < V; ++l)
        acc_h[l] += pool_w ? round_to<T>(acc_w[l]) : acc_w[l];
    }
#pragma unroll
    for (int l = 0; l < V; ++l)
      acc_t[l] += pool_h ? round_to<T>(acc_h[l]) : acc_h[l];
  }
  const I idx = (((q.b * g.T + q.t) * g.H + q.h) * g.W + q.w) * cv_n + q.v;
  storev<V>(dx + idx * V, acc_t);
}

// -- K2, tiled instances -----------------------------------------------------
// prmt.b32 in its default mode: byte n of the result is byte s[n] & 7 of
// {b, a}, or, where bit 3 of nibble n is set, that byte's bit 7 copied
// into all eight bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// An element vector is held as NW 32-bit words: bf16 packs two lanes in a
// word (the lower channel in the low half), f32 one. Lanes<T, V> holds the
// lane arithmetic: every operation is exact (max, compares that yield
// masks), so bf16 is never widened to f32 to be compared.
template <typename T, int V>
struct Lanes;

template <int V>
struct Lanes<__nv_bfloat16, V> {
  static constexpr int NW = V / 2;
  static constexpr uint32_t kNegInf = 0xFF80FF80u;
  // A route key k < 128 is held as the value 128 + k (bits 0x4300 + k):
  // exact, ordered as k, and k is its low 7 bits.
  static constexpr uint32_t kKey0 = 0x43004300u, kKeyOne = 0x00010001u;
  __device__ __forceinline__ static uint32_t max_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // 0xFFFF in each half where the comparison holds (false on NaN)
  __device__ __forceinline__ static uint32_t gt(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t eq(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t isnan(uint32_t a) {
    uint32_t d;
    asm("set.nan.u32.bf16x2 %0, %1, %1;" : "=r"(d) : "r"(a));
    return d;
  }
  // the smaller of a and b per lane; a NaN loses to a number
  __device__ __forceinline__ static uint32_t min(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // OR'd into a key: +inf or NaN (a key that no key exceeds), whose low
  // byte stays below 0xB0 for the keys and offsets added here
  static constexpr uint32_t kKeyNone = 0x7F807F80u;
  // The route bytes of the lanes of words key[0..NW) (0x7F where drop is
  // set), lanes in channel order: key dw*16 + dh*4 + dt becomes the byte
  // dt*9 + dh*3 + dw.
  __device__ __forceinline__ static void route_bytes(const uint32_t* key,
                                                     const uint32_t* drop,
                                                     uint8_t* p) {
    uint32_t b[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint32_t k = key[j];
      b[j] = ((k & 0x00030003u) * 9u + (k >> 2 & 0x00030003u) * 3u +
              (k >> 4 & 0x00030003u)) | (drop[j] & 0x007F007Fu);
    }
    if constexpr (NW == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(
          __byte_perm(b[0], b[1], 0x6420), __byte_perm(b[2], b[3], 0x6420));
    } else {
      *reinterpret_cast<uint32_t*>(p) = __byte_perm(b[0], b[1], 0x6420);
    }
  }
  // Value word j with each lane kept where its hit byte (bit 7 of byte l
  // of the hit words, for lane l) is set, else +0.
  __device__ __forceinline__ static uint32_t keep(uint32_t w,
                                                  const uint32_t* hit, int j) {
    return w & prmt(hit[(2 * j) >> 2], 0, (j & 1) ? 0xBBAA : 0x9988);
  }
  // the same as two f32 lanes
  __device__ __forceinline__ static void masked(uint32_t w, const uint32_t* hit,
                                                int j, float* f) {
    const uint32_t x = keep(w, hit, j);
    f[0] = __uint_as_float(x << 16);
    f[1] = __uint_as_float(x & 0xFFFF0000u);
  }
  // a + b per lane, rounded to nearest even
  __device__ __forceinline__ static uint32_t add2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    __nv_bfloat162 r = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&r);
  }
};

template <>
struct Lanes<float, 4> {
  static constexpr int NW = 4;
  static constexpr uint32_t kNegInf = 0xFF800000u;
  // key k as the f32 value 128 + k: k sits in bits 16..22
  static constexpr uint32_t kKey0 = 0x43000000u, kKeyOne = 1u << 16;
  __device__ __forceinline__ static uint32_t max_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t gt(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t eq(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("set.eq.u32.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ static uint32_t isnan(uint32_t a) {
    uint32_t d;
    asm("set.nan.u32.f32 %0, %1, %1;" : "=r"(d) : "r"(a));
    return d;
  }
  __device__ __forceinline__ static uint32_t min(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static constexpr uint32_t kKeyNone = 0x7F800000u;
  __device__ __forceinline__ static void route_bytes(const uint32_t* key,
                                                     const uint32_t* drop,
                                                     uint8_t* p) {
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t k = key[j] >> 16;
      r |= (((k & 3u) * 9u + (k >> 2 & 3u) * 3u + (k >> 4 & 3u)) |
            (drop[j] & 0x7Fu)) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(p) = r;
  }
  __device__ __forceinline__ static void masked(uint32_t w, const uint32_t* hit,
                                                int j, float* f) {
    f[0] = __uint_as_float(w & prmt(hit[0], 0, 0x8888 + 0x1111 * j));
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};

// n 32-bit words between shared memory and registers, as one access
template <int N>
__device__ __forceinline__ void ld_words(const uint32_t* p, uint32_t* w) {
  if constexpr (N == 4) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (N == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x; w[1] = r.y;
  } else {
    w[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void st_words(uint32_t* p, const uint32_t* w) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *p = w[0];
  }
}

// 4 * N bytes copied to shared memory without passing through registers.
template <int N>
__device__ __forceinline__ void copy_async_words(uint32_t* smem,
                                                 const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (N == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(4 * N)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest committed group
__device__ __forceinline__ void copy_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A tiled block: kThreads threads as CVr element vectors (CVr = 1 << cvl,
// up to kMaxCV) x kTileCols pixel columns x (kThreads / (8 * CVr)) groups of
// RH rows. CVr follows C (the smallest power of two >= C / V, at most 8), so
// that at narrow C the block covers more pixels and no thread idles: at
// C / V = 1 a thread owns one pixel's V channels.
constexpr int kMaxCV = 8, kTileCols = 8;

__host__ __device__ constexpr int tile_rows(int cvl, int rh) {
  return kThreads / (kTileCols << cvl) * rh;
}
// The route pass's box cells a stage (the box at CVr = kMaxCV has the most)
// and its shared memory in bytes (nw words a vector).
__host__ __device__ constexpr int route_cells(int kh, int kw, int sh, int sw,
                                              int rh) {
  return ((tile_rows(3, rh) - 1) * sh + kh) * ((kTileCols - 1) * sw + kw) *
         kMaxCV;
}
__host__ __device__ constexpr int route_smem(int kh, int kw, int sh, int sw,
                                             int rh, int nw) {
  return 2 * route_cells(kh, kw, sh, sw, rh) * nw * 4;
}
// The output rows that cover th consecutive input rows (the gather's staged
// rows), and their most times CVr over every CVr (sizes its buffers).
__host__ __device__ constexpr int gather_rows(int kh, int sh, int th) {
  return (th - 1 + kh - 1) / sh + 1;
}
__host__ __device__ constexpr int gather_rows_x_cv(int kh, int sh, int rh) {
  int most = 0;
  for (int c = 0; c <= 3; ++c) {
    const int n = gather_rows(kh, sh, tile_rows(c, rh)) << c;
    most = n > most ? n : most;
  }
  return most;
}
// The gather's staged output cells a stage, its W level's cells, and its
// shared memory in bytes (nw / nr value and route words a vector).
__host__ __device__ constexpr int gather_cells(int kh, int kw, int sh, int sw,
                                               int rh) {
  return gather_rows_x_cv(kh, sh, rh) * ((kTileCols - 1 + kw - 1) / sw + 1);
}
__host__ __device__ constexpr int gather_wcells(int kh, int sh, int rh) {
  return gather_rows_x_cv(kh, sh, rh) * kTileCols;
}
__host__ __device__ constexpr int gather_smem(int kh, int kw, int sh, int sw,
                                              int rh, int nw, int nr) {
  return (2 * gather_cells(kh, kw, sh, sw, rh) + gather_wcells(kh, sh, rh)) *
         (nw + nr) * 4;
}

// 1-D index helpers for strides 1 and 2: floor(a / s) and ceil(a / s) for
// any sign of a, and whether s divides a.
template <int S>
__device__ __forceinline__ int floor_div(int a) {
  static_assert(S == 1 || S == 2, "stride 1 or 2");
  return S == 1 ? a : a >> 1;
}
template <int S>
__device__ __forceinline__ int ceil_div(int a) {
  return S == 1 ? a : (a + 1) >> 1;
}
template <int S>
__device__ __forceinline__ bool divides(int a) {
  return S == 1 || (a & 1) == 0;
}

// Bit 7 of each byte set where byte & mask equals code & mask (the bytes
// of x are below 0x80, so 0x80 - x keeps bit 7 exactly where x is 0, and
// no byte borrows from the next); hit_bytes spreads it over the byte.
__device__ __forceinline__ uint32_t byte_hits(uint32_t w, uint32_t code,
                                              uint32_t mask) {
  return 0x80808080u - ((w ^ code) & mask);
}
__device__ __forceinline__ uint32_t hit_bytes(uint32_t h) {
  return prmt(h, 0, 0xBA98);
}

// One level of the gather: the kept terms of an element vector summed in
// window-offset order, in f32 lanes and rounded to T at the end (the plain
// version's sum, and its store of a stage). PACKED (bf16, at most two
// terms a level): the same sum in bf16 lanes with a rounded add, which is
// equal: round(a + b) from an f32 sum is the bf16 sum of a and b, since
// the f32 sum of two bf16 values is exact or lies within an f32 ulp of
// the larger, too near it to round elsewhere. Kept terms are +0 where a
// window routes elsewhere, and adding +0 changes no sum (a sum from +0 is
// never -0).
template <typename T, int V, bool PACKED>
struct LevelSum {
  using L = Lanes<T, V>;
  static constexpr int NW = L::NW, LW = V / NW;   // words, lanes a word
  float acc[V];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0.0f;
  }
  __device__ __forceinline__ void add(const uint32_t* w, const uint32_t* hit) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      float f[LW];
      L::masked(w[k], hit, k, f);
#pragma unroll
      for (int l = 0; l < LW; ++l) acc[k * LW + l] += f[l];
    }
  }
  __device__ __forceinline__ void out(uint32_t* w) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = L::pack(&acc[k * LW]);
  }
};

template <int V>
struct LevelSum<__nv_bfloat16, V, true> {
  using L = Lanes<__nv_bfloat16, V>;
  static constexpr int NW = L::NW;
  uint32_t acc[NW];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < NW; ++k) acc[k] = 0;
  }
  __device__ __forceinline__ void add(const uint32_t* w, const uint32_t* hit) {
#pragma unroll
    for (int k = 0; k < NW; ++k)
      acc[k] = L::add2(acc[k], L::keep(w[k], hit, k));
  }
  __device__ __forceinline__ void out(uint32_t* w) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = acc[k];
  }
};

// -- the tiled walk: K1, and K2's route pass ---------------------------------
// A tiled block owns an output tile of th = tile_rows(cvl, RH) rows x
// kTileCols columns x CVr element vectors of one clip, and the output
// frames [to0, to1) of it. It walks the frames of their windows in order,
// from to0*ST - pt to (to1-1)*ST - pt + KT - 1: each frame's input box,
// ((th-1)*SH+KH) x (7*SW+KW) pixels of the tile's vectors, is copied once
// into shared memory (cp.async, two stages, so that the next frame loads
// while this one is reduced). Cells outside the tensor hold -inf, and a
// frame outside [0, T) is -inf and is not loaded. The op reduces each frame
// from the thread's cells of the box (Op::frame; Op::pad for a frame
// outside) into a ring of its last KT frames in registers, and writes
// output frame to once its last frame, to*ST - pt + KT - 1, is in
// (Op::emit). Each thread owns an output column and RH rows (see tile_rows).
struct TilePos {
  int b, cvl;          // the clip; log2 of CVr
  int wo, ho0, cv;     // the thread's output column, first row, vector
  bool store;          // its column and vector exist
};

template <typename T, int V, RSP_K2_PARAMS, int RH, class Op>
__device__ __forceinline__ void walk_tile(const T* __restrict__ x,
                                          const Geom& g, int cvl, int b,
                                          int to0, int to1, uint32_t* smem,
                                          Op& op) {
  constexpr int NW = Lanes<T, V>::NW, TW = kTileCols;
  constexpr int BW = (TW - 1) * SW + KW;
  constexpr int CELLS = route_cells(KH, KW, SH, SW, RH);
  constexpr int PER = (CELLS + kThreads - 1) / kThreads;
  auto box = [&](int stage) { return smem + stage * CELLS * NW; };

  const int tid = threadIdx.x, cvr = 1 << cvl;
  const int th = tile_rows(cvl, RH);
  const int cells = ((th - 1) * SH + KH) * BW << cvl;
  const int cv_n = g.C / V;
  const int ncc = (cv_n + cvr - 1) >> cvl;
  const int wt = blockIdx.x / ncc, cc = blockIdx.x - wt * ncc;
  const int ht = blockIdx.y;
  const int h0 = ht * th * SH - g.ph, w0 = wt * TW * SW - g.pw;
  const int c0 = cc << cvl;

  // The box cells this thread copies, as element offsets in a frame; -1
  // for a cell it does not copy. A cell outside the tensor holds -inf in
  // both stages from the start.
  int src[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kThreads;
    src[j] = -1;
    if (i >= cells) continue;
    const int v = i & (cvr - 1), px = i >> cvl;
    const int h = h0 + px / BW, w = w0 + px % BW;
    if (h >= 0 && h < g.H && w >= 0 && w < g.W) {
      if (c0 + v < cv_n) src[j] = (h * g.W + w) * g.C + (c0 + v) * V;
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        box(0)[i * NW + k] = Lanes<T, V>::kNegInf;
        box(1)[i * NW + k] = Lanes<T, V>::kNegInf;
      }
    }
  }

  const int frame = g.H * g.W * g.C;
  const T* clip = x + b * g.T * frame;
  auto load = [&](int t, int stage) {
    const T* f = clip + t * frame;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (src[j] >= 0)
        copy_async_words<NW>(&box(stage)[(tid + j * kThreads) * NW],
                             f + src[j]);
  };

  const int v = tid & (cvr - 1), col = (tid >> cvl) % TW;
  const int row0 = (tid >> cvl) / TW * RH;
  TilePos p;
  p.b = b;
  p.cvl = cvl;
  p.wo = wt * TW + col;
  p.ho0 = ht * th + row0;
  p.cv = c0 + v;
  p.store = p.cv < cv_n && p.wo < g.Wo;
  op.start(p, g);
  // the thread's first cell: box row row0 * SH, column col * SW
  const int cell = ((((row0 * SH) * BW + col * SW) << cvl) + v) * NW;

  const int t_first = to0 * ST - g.pt, t_last = (to1 - 1) * ST - g.pt + KT - 1;
  if (t_first >= 0) load(t_first, 0);
  copy_commit();
  for (int t = t_first; t <= t_last; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 <= t_last && t + 1 >= 0 && t + 1 < g.T) load(t + 1, stage ^ 1);
    copy_commit();
    copy_wait_prev();
    __syncthreads();
    op.advance();
    if (t >= 0 && t < g.T) op.frame(box(stage) + cell);
    else op.pad();
    // output frame to ends with frame t
    const int j = t + g.pt - (KT - 1);
    if (p.store && j >= to0 * ST && j % ST == 0) op.emit(j / ST, g);
    __syncthreads();
  }
}

// K2 pass 1's op on the walk (the (3,3,3)/1, (1,3,3)/(1,2,2), (3,3,3)/2,
// (2,2,2)/2 and (1,2,2)/(1,2,2) pools, V = 4 or 8). Each lane reduces
// (value, key) pairs, key = dw*16 + dh*4 + dt (the offsets as base-4
// digits, so keys order as (dw, dh, dt)): the larger value wins, on equal
// values the smaller key. That reduction is associative, so W (a strict >
// scan in dw order, whose keys rise), then H, then T (over the last KT
// frames, in registers), each taken as the max and then the least key
// among the pairs equal to it, give the lexicographically first cell in
// (dw, dh, dt) order that holds the window max: the route of the strict
// scan of pool_route. The -inf cells of the box take part with their
// keys, so a window whose max is -inf ends on key 0; it routes nowhere
// when that cell is padding, and so does a window whose max is NaN
// (max.NaN carries it; no compare holds).
template <typename T, int V, RSP_K2_PARAMS, int RH>
struct RouteOp {
  using L = Lanes<T, V>;
  static constexpr int NW = L::NW, BW = (kTileCols - 1) * SW + KW;
  static constexpr int ROWS = (RH - 1) * SH + KH;   // box rows of a thread
  uint8_t* route;
  TilePos p;
  bool w_in0;   // offset 0 of the window in W lies in the tensor
  // ring[d]: the (value, key) pair of the H x W window of frame
  // t - (KT - 1) + d, for this thread's rows; keys without the dt term
  uint32_t ring[KT][RH][NW], ringk[KT][RH][NW];

  __device__ __forceinline__ void start(const TilePos& q, const Geom& g) {
    p = q;
    w_in0 = p.wo * SW - g.pw >= 0 && p.wo * SW - g.pw < g.W;
#pragma unroll
    for (int d = 0; d < KT; ++d)
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          ring[d][r][k] = L::kNegInf;
          ringk[d][r][k] = L::kKey0;
        }
  }

  // The pair reduction of n (value, key) pairs, keys offset by off * i
  // key units for pair i: the max, and the least key among the pairs equal
  // to it (a pair below the max, or every pair when the max is NaN, offers
  // a key of +inf or NaN, which min passes over).
  __device__ __forceinline__ static void reduce(uint32_t (*v)[NW],
                                                uint32_t (*kv)[NW], int n,
                                                int stride, uint32_t off,
                                                uint32_t* m, uint32_t* mk) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      m[k] = v[0][k];
#pragma unroll
      for (int i = 1; i < 3; ++i)
        if (i < n) m[k] = L::max_nan(m[k], v[i * stride][k]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (i < n) {
          const uint32_t key = (kv[i * stride][k] + i * off) |
                               (~L::eq(v[i * stride][k], m[k]) & L::kKeyNone);
          mk[k] = i == 0 ? key : L::min(mk[k], key);
        }
    }
  }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int d = 0; d + 1 < KT; ++d)
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          ring[d][r][k] = ring[d + 1][r][k];
          ringk[d][r][k] = ringk[d + 1][r][k];
        }
  }

  __device__ __forceinline__ void frame(const uint32_t* cell) {
    // W: a strict > scan over KW columns of each of the thread's box rows
    uint32_t rowv[ROWS][NW], rowk[ROWS][NW];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const uint32_t* c0 = cell + ((rr * BW * NW) << p.cvl);
      ld_words<NW>(c0, rowv[rr]);
#pragma unroll
      for (int k = 0; k < NW; ++k) rowk[rr][k] = L::kKey0;
#pragma unroll
      for (int dw = 1; dw < KW; ++dw) {
        uint32_t c[NW];
        ld_words<NW>(c0 + ((dw * NW) << p.cvl), c);
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const uint32_t m = L::gt(c[k], rowv[rr][k]);
          rowv[rr][k] = L::max_nan(rowv[rr][k], c[k]);
          rowk[rr][k] = (m & (L::kKey0 + 16 * dw * L::kKeyOne)) |
                        (~m & rowk[rr][k]);
        }
      }
    }
    // H: KH rows for each output row, keys + dh*4
#pragma unroll
    for (int r = 0; r < RH; ++r)
      reduce(&rowv[r * SH], &rowk[r * SH], KH, 1, 4 * L::kKeyOne,
             ring[KT - 1][r], ringk[KT - 1][r]);
  }

  __device__ __forceinline__ void pad() {
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        ring[KT - 1][r][k] = L::kNegInf;
        ringk[KT - 1][r][k] = L::kKey0;
      }
  }

  __device__ __forceinline__ void emit(int to, const Geom& g) {
    const int j = to * ST;
    const bool t_in0 = j - g.pt >= 0 && j - g.pt < g.T;
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int ho = p.ho0 + r;
      if (ho >= g.Ho) continue;
      uint32_t m[NW], mk[NW];
      reduce(&ring[0][r], &ringk[0][r], KT, RH, L::kKeyOne, m, mk);
      const int h_first = ho * SH - g.ph;
      const bool in0 = t_in0 && w_in0 && h_first >= 0 && h_first < g.H;
      uint32_t drop[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k)
        drop[k] = L::isnan(m[k]) | (in0 ? 0u : L::eq(m[k], L::kNegInf));
      L::route_bytes(mk, drop,
                     route + (((p.b * g.To + to) * g.Ho + ho) * g.Wo + p.wo) *
                                 g.C + p.cv * V);
    }
  }
};

// K2 pass 1, tiled: the route of every output of the block's tile, its
// clip's frames walked whole.
template <typename T, int V, RSP_K2_PARAMS, int RH>
__global__ void __launch_bounds__(kThreads, 2)
    route_tile(const T* __restrict__ x, uint8_t* __restrict__ route, Geom g,
               int cvl) {
  // dynamic shared memory (route_smem bytes): the box, two stages
  extern __shared__ __align__(16) uint32_t smem[];
  RouteOp<T, V, RSP_K2_ARGS, RH> op;
  op.route = route;
  walk_tile<T, V, RSP_K2_ARGS, RH>(x, g, cvl, blockIdx.z, 0, g.To, smem, op);
}

// K1's op on the walk: the max of each window, W then H from the box in
// shared memory and T over the ring, in the lanes' own type (max.NaN.bf16x2
// or max.NaN.f32 on 32-bit words: no widening; the max is exact, so the
// W -> H -> T order changes no bit), stored as one vector a row.
template <typename T, int V, RSP_K2_PARAMS, int RH>
struct MaxOp {
  using L = Lanes<T, V>;
  static constexpr int NW = L::NW, BW = (kTileCols - 1) * SW + KW;
  static constexpr int ROWS = (RH - 1) * SH + KH;   // box rows of a thread
  T* out;
  TilePos p;
  // ring[d]: the H x W max of frame t - (KT - 1) + d, for this thread's rows
  uint32_t ring[KT][RH][NW];

  __device__ __forceinline__ void start(const TilePos& q, const Geom&) {
    p = q;
#pragma unroll
    for (int d = 0; d < KT; ++d)
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k) ring[d][r][k] = L::kNegInf;
  }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int d = 0; d + 1 < KT; ++d)
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k) ring[d][r][k] = ring[d + 1][r][k];
  }

  __device__ __forceinline__ void frame(const uint32_t* cell) {
    // W: the max of KW columns in each of the thread's box rows
    uint32_t rowm[ROWS][NW];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const uint32_t* c0 = cell + ((rr * BW * NW) << p.cvl);
      ld_words<NW>(c0, rowm[rr]);
#pragma unroll
      for (int dw = 1; dw < KW; ++dw) {
        uint32_t c[NW];
        ld_words<NW>(c0 + ((dw * NW) << p.cvl), c);
#pragma unroll
        for (int k = 0; k < NW; ++k) rowm[rr][k] = L::max_nan(rowm[rr][k], c[k]);
      }
    }
    // H: the max of KH rows for each output row
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        uint32_t m = rowm[r * SH][k];
#pragma unroll
        for (int dh = 1; dh < KH; ++dh) m = L::max_nan(m, rowm[r * SH + dh][k]);
        ring[KT - 1][r][k] = m;
      }
  }

  __device__ __forceinline__ void pad() {
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int k = 0; k < NW; ++k) ring[KT - 1][r][k] = L::kNegInf;
  }

  __device__ __forceinline__ void emit(int to, const Geom& g) {
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int ho = p.ho0 + r;
      if (ho >= g.Ho) continue;
      uint32_t m[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        m[k] = ring[0][r][k];
#pragma unroll
        for (int d = 1; d < KT; ++d) m[k] = L::max_nan(m[k], ring[d][r][k]);
      }
      st_words<NW>(reinterpret_cast<uint32_t*>(
                       out + (((p.b * g.To + to) * g.Ho + ho) * g.Wo + p.wo) *
                                 g.C + p.cv * V),
                   m);
    }
  }
};

// K1, tiled: blockIdx.z = b * nch + chunk; chunk c takes the output frames
// [c * per, min(To, (c + 1) * per)) of clip b (nch = 1, per = To: the
// whole clip; see fwd_tile_plan).
template <typename T, int V, RSP_K2_PARAMS, int RH>
__global__ void __launch_bounds__(kThreads)
    max_tile(const T* __restrict__ x, T* __restrict__ out, Geom g, int cvl,
             int nch, int per) {
  // dynamic shared memory (route_smem bytes): the box, two stages
  extern __shared__ __align__(16) uint32_t smem[];
  const int b = blockIdx.z / nch, to0 = (blockIdx.z - b * nch) * per;
  MaxOp<T, V, RSP_K2_ARGS, RH> op;
  op.out = out;
  walk_tile<T, V, RSP_K2_ARGS, RH>(x, g, cvl, b, to0, min(g.To, to0 + per),
                                   smem, op);
}

// The route byte dt*9 + dh*3 + dw of each lane of a route word, rewritten
// as dw | dh << 2 | dt << 4 (digit by digit, no byte carries into the
// next: every byte is < 128). kNoRouteByte becomes a byte whose low two
// bits are 3, which matches no dw.
__device__ __forceinline__ uint32_t route_digits(uint32_t r) {
  const uint32_t dt = ((r + 0x77777777u) >> 7 & 0x01010101u) +   // >= 9
                      ((r + 0x6E6E6E6Eu) >> 7 & 0x01010101u);    // >= 18
  const uint32_t r2 = r - dt * 9u;
  const uint32_t dh = ((r2 + 0x7D7D7D7Du) >> 7 & 0x01010101u) +  // >= 3
                      ((r2 + 0x7A7A7A7Au) >> 7 & 0x01010101u);   // >= 6
  return (r2 - dh * 3u) | dh << 2 | dt << 4;
}

// a bool as a type, to pick a branch of a generic lambda at compile time
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// K2 pass 2, tiled: the gather of the plain version's stages. Composed
// W -> H -> T, every output that routes through a cell of an intermediate
// stage reaches it by the same (dh, dt) (the first match of that cell's
// H x T column), so the nested sum of pool_gather factors by level:
//   gW(to, ho, w) = sum over dw of g(to, ho, wo) where the route's dw is
//                   dw; its tag is the (dh, dt) of those routes;
//   gH(to, h, w)  = sum over dh of round(gW(to, ho, w)) where gW's dh is dh;
//   dx(t, h, w)   = sum over dt of round(gH(to, h, w)) where gH's dt is dt;
// each in window-offset order, each pooled level rounded to T (as the plain
// version stores each stage). A cell reached by no route holds 0 and tag 0,
// and adding +0 changes no sum, so the levels test no bounds. Per level an
// element checks at most 3 windows (27 without the factoring).
// The block owns an input tile of TH x 8 pixels x CVr vectors and walks its
// clip by output frame: each output frame's route bytes and g over the
// tile's covering outputs (the tile plus a halo of KH-1 rows and KW-1
// columns at stride 1, about half the tile at stride 2) are copied once
// into shared memory (cp.async, two stages), the route bytes rewritten by
// route_digits. The W level is computed once per staged row and column of
// the tile into shared memory, the H level per thread for its RH rows into
// a ring of the last KT output frames in registers, and an input frame is
// summed over T and stored once its last covering output frame is in the
// ring. No atomics.
template <typename T, int V, RSP_K2_PARAMS, int RH>
__global__ void __launch_bounds__(kThreads, 3)
    gather_tile(const uint8_t* __restrict__ route, const T* __restrict__ gout,
                T* __restrict__ dx, Geom g, int cvl) {
  using L = Lanes<T, V>;
  constexpr int NW = L::NW, NR = V / 4;       // value and route words
  // bf16 levels of at most two terms each sum in bf16 lanes
  constexpr bool kPacked = sizeof(T) == 2 && (KT + ST - 1) / ST <= 2 &&
                           (KH + SH - 1) / SH <= 2 && (KW + SW - 1) / SW <= 2;
  using Sum = LevelSum<T, V, kPacked>;
  constexpr int TW = kTileCols;
  constexpr int BWO = (TW - 1 + KW - 1) / SW + 1;   // staged output columns
  constexpr int CELLS = gather_cells(KH, KW, SH, SW, RH);
  constexpr int WCELLS = gather_wcells(KH, SH, RH);
  constexpr int PER = (CELLS + kThreads - 1) / kThreads;
  // dynamic shared memory (gather_smem bytes): g and the route bytes of
  // the staged outputs, two stages each, then the W level's values and tags
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const sg0 = smem;
  uint32_t* const sr0 = sg0 + 2 * CELLS * NW;
  uint32_t* const swv = sr0 + 2 * CELLS * NR;
  uint32_t* const swt = swv + WCELLS * NW;
  auto sg = [&](int stage) { return sg0 + stage * CELLS * NW; };
  auto sr = [&](int stage) { return sr0 + stage * CELLS * NR; };

  const int tid = threadIdx.x, cvr = 1 << cvl;
  const int th = tile_rows(cvl, RH);
  const int bho = gather_rows(KH, SH, th);
  const int cells = bho * BWO << cvl;
  const int cv_n = g.C / V;
  const int ncc = (cv_n + cvr - 1) >> cvl;
  const int wt = blockIdx.x / ncc, cc = blockIdx.x - wt * ncc;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * th, w0 = wt * TW, c0 = cc << cvl;
  // the first staged output row and column
  const int hoA = ceil_div<SH>(h0 + g.ph - (KH - 1));
  const int woA = ceil_div<SW>(w0 + g.pw - (KW - 1));

  // The staged cells this thread copies, as element offsets in an output
  // frame (the same in g and route); -1 for a cell it does not copy. A cell
  // outside the output holds the digits of no route in both stages.
  int src[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kThreads;
    src[j] = -1;
    if (i >= cells) continue;
    const int v = i & (cvr - 1), px = i >> cvl;
    const int ho = hoA + px / BWO, wo = woA + px % BWO;
    if (ho >= 0 && ho < g.Ho && wo >= 0 && wo < g.Wo && c0 + v < cv_n) {
      src[j] = (ho * g.Wo + wo) * g.C + (c0 + v) * V;
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        sr(0)[i * NR + k] = 0x03030303u;
        sr(1)[i * NR + k] = 0x03030303u;
      }
    }
  }

  const int oframe = g.Ho * g.Wo * g.C;
  const T* gclip = gout + b * g.To * oframe;
  const uint8_t* rclip = route + b * g.To * oframe;
  auto load = [&](int to, int stage) {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (src[j] >= 0) {
        const int i = tid + j * kThreads;
        copy_async_words<NW>(&sg(stage)[i * NW], gclip + to * oframe + src[j]);
        copy_async_words<NR>(&sr(stage)[i * NR], rclip + to * oframe + src[j]);
      }
  };

  const int v = tid & (cvr - 1), col = (tid >> cvl) % TW;
  const int rg = (tid >> cvl) / TW;
  const int w = w0 + col;
  const bool store = c0 + v < cv_n && w < g.W;
  // the W level's map: column cwl, rows wrow + nr * i (nr = 32 / CVr)
  const int nr = kThreads / (TW << cvl);
  const int cwl = tid >> 5, wrow = (tid >> cvl) & (nr - 1), cw = w0 + cwl;

  // ring[d]: gH of output frame to - d for this thread's rows (in T), and
  // the dt digits of its routes (bits 4-5 of each byte)
  uint32_t ring[KT][RH][NW], ringt[KT][RH][NR];
#pragma unroll
  for (int d = 0; d < KT; ++d)
#pragma unroll
    for (int r = 0; r < RH; ++r) {
#pragma unroll
      for (int k = 0; k < NW; ++k) ring[d][r][k] = 0;
#pragma unroll
      for (int k = 0; k < NR; ++k) ringt[d][r][k] = 0;
    }
  int t_next = 0;                       // the next input frame to store

  load(0, 0);
  copy_commit();
  for (int to = 0; to < g.To; ++to) {
    const int stage = to & 1;
    if (to + 1 < g.To) load(to + 1, stage ^ 1);
    copy_commit();
    copy_wait_prev();
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (src[j] >= 0) {
        uint32_t* p = &sr(stage)[(tid + j * kThreads) * NR];
#pragma unroll
        for (int k = 0; k < NR; ++k) p[k] = route_digits(p[k]);
      }
    __syncthreads();
    // W: gW and its (dh, dt) tag for every staged row and tile column;
    // thread (v, a) takes column a / nr and rows a % nr, + nr, ... (nr a
    // power of two), so that a warp shares a column and skips the windows
    // that do not cover it together
    for (int hr = wrow; hr < bho; hr += nr) {
      Sum acc;
      uint32_t tag[NR];
      acc.clear();
#pragma unroll
      for (int k = 0; k < NR; ++k) tag[k] = 0;
#pragma unroll
      for (int dw = 0; dw < KW; ++dw) {
        const int num = cw + g.pw - dw;
        if (!divides<SW>(num)) continue;
        const int cell = (((hr * BWO + floor_div<SW>(num) - woA)) << cvl) + v;
        uint32_t rb[NR], gv[NW], hit[NR];
        ld_words<NR>(&sr(stage)[cell * NR], rb);
        ld_words<NW>(&sg(stage)[cell * NW], gv);
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          hit[k] = byte_hits(rb[k], dw * 0x01010101u, 0x03030303u);
          tag[k] |= rb[k] & 0x3C3C3C3Cu & hit_bytes(hit[k]);
        }
        acc.add(gv, hit);
      }
      // rounded to T: a pooled level as the plain version stores it, an
      // unpooled one holds one g or 0, which T holds exactly
      uint32_t out[NW];
      acc.out(out);
      const int wc = ((hr * TW + cwl) << cvl) + v;
      st_words<NW>(&swv[wc * NW], out);
      st_words<NR>(&swt[wc * NR], tag);
    }
    __syncthreads();
    // H: gH for this thread's rows, pushed into the ring
#pragma unroll
    for (int d = KT - 1; d > 0; --d)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
#pragma unroll
        for (int k = 0; k < NW; ++k) ring[d][r][k] = ring[d - 1][r][k];
#pragma unroll
        for (int k = 0; k < NR; ++k) ringt[d][r][k] = ringt[d - 1][r][k];
      }
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const int h = h0 + rg * RH + r;
      Sum acc;
      uint32_t tag[NR];
      acc.clear();
#pragma unroll
      for (int k = 0; k < NR; ++k) tag[k] = 0;
#pragma unroll
      for (int dh = 0; dh < KH; ++dh) {
        const int num = h + g.ph - dh;
        if (!divides<SH>(num)) continue;
        const int cell = ((((floor_div<SH>(num) - hoA)) * TW + col) << cvl) + v;
        uint32_t tw[NR], gv[NW], hit[NR];
        ld_words<NR>(&swt[cell * NR], tw);
        ld_words<NW>(&swv[cell * NW], gv);
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          hit[k] = byte_hits(tw[k], (dh << 2) * 0x01010101u, 0x0C0C0C0Cu);
          tag[k] |= tw[k] & 0x30303030u & hit_bytes(hit[k]);
        }
        acc.add(gv, hit);
      }
      acc.out(ring[0][r]);
#pragma unroll
      for (int k = 0; k < NR; ++k) ringt[0][r][k] = tag[k];
    }
    // T: store every input frame whose last covering output frame is to
    // (at the last output frame, every frame left, the floor tail as 0)
    int t_end = (to + 1) * ST - g.pt - 1;
    if (to == g.To - 1 || t_end > g.T - 1) t_end = g.T - 1;
    for (; t_next <= t_end; ++t_next) {
      const int t = t_next;
      // the ring slot of window offset dt is to - (t + pt - dt) / ST; at
      // stride 1 in the walk's steady state it is dt, known at compile
      // time (no select among the slots)
      const bool steady = ST == 1 && to - t - g.pt == 0;
      auto sum_t = [&](auto fixed, int r, uint32_t* out) {
        Sum acc;
        acc.clear();
#pragma unroll
        for (int dt = 0; dt < KT; ++dt) {
          const int num = t + g.pt - dt;
          if (num < 0 || !divides<ST>(num) || floor_div<ST>(num) > to)
            continue;
          const int d = decltype(fixed)::value ? dt : to - floor_div<ST>(num);
          uint32_t gv[NW], tt[NR], hit[NR];
#pragma unroll
          for (int dd = 0; dd < KT; ++dd)
            if (dd == d) {
#pragma unroll
              for (int k = 0; k < NW; ++k) gv[k] = ring[dd][r][k];
#pragma unroll
              for (int k = 0; k < NR; ++k) tt[k] = ringt[dd][r][k];
            }
#pragma unroll
          for (int k = 0; k < NR; ++k)
            hit[k] = byte_hits(tt[k], (dt << 4) * 0x01010101u, 0x30303030u);
          acc.add(gv, hit);
        }
        acc.out(out);
      };
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const int h = h0 + rg * RH + r;
        if (!store || h >= g.H) continue;
        uint32_t out[NW];
        if constexpr (KT == 1 && ST == 1) {
          // an unpooled T (pt = 0): the input frame is output frame to
#pragma unroll
          for (int k = 0; k < NW; ++k) out[k] = ring[0][r][k];
        } else if (steady) {
          sum_t(Flag<true>(), r, out);
        } else {
          sum_t(Flag<false>(), r, out);
        }
        st_words<NW>(reinterpret_cast<uint32_t*>(
                         dx + (((b * g.T + t) * g.H + h) * g.W + w) * g.C +
                         (c0 + v) * V),
                     out);
      }
    }
    __syncthreads();
  }
}

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return blocks < 1 ? 1 : blocks;
}

// The tile grid of a K2 pass over a [B, T, H, W, V * cv_n] tensor (see
// tile_pos); false when it passes the grid limits.
bool tile_grid(int B, int T, int H, int W, int cv_n, dim3* grid) {
  const int64_t x = (int64_t)((cv_n + kTileV - 1) / kTileV) *
                    ((W + kTileW - 1) / kTileW);
  const int64_t y = (H + kTileH - 1) / kTileH;
  const int64_t z = (int64_t)B * ((T + kTileT - 1) / kTileT);
  *grid = dim3((unsigned)x, (unsigned)y, (unsigned)z);
  return x < ((int64_t)1 << 31) && y <= 65535 && z <= 65535;
}

Geom make_geom(const int64_t* shape, const int* kspec) {
  Geom g;
  g.B = (int)shape[0]; g.T = (int)shape[1]; g.H = (int)shape[2];
  g.W = (int)shape[3]; g.C = (int)shape[4];
  g.kt = kspec[0]; g.kh = kspec[1]; g.kw = kspec[2];
  g.st = kspec[3]; g.sh = kspec[4]; g.sw = kspec[5];
  g.pt = kspec[6]; g.ph = kspec[7]; g.pw = kspec[8];
  g.To = (g.T + 2 * g.pt - g.kt) / g.st + 1;
  g.Ho = (g.H + 2 * g.ph - g.kh) / g.sh + 1;
  g.Wo = (g.W + 2 * g.pw - g.kw) / g.sw + 1;
  return g;
}

// The launch plan shared by every kernel of one call: element type, vector
// width and index width.
struct Plan {
  int dtype;     // 0 = f32, 1 = bf16
  int vec;       // elements a vector: 8 (bf16 only), 4 or 1
  bool wide;     // some tensor has >= 2^31 elements
};

template <typename T, int V, typename I>
void fwd_t(const void* x, void* out, const Geom& g, cudaStream_t st) {
  const int64_t work = (int64_t)g.B * g.To * g.Ho * g.Wo * (g.C / V);
  pool_fwd<T, V, I><<<(unsigned)grid_for(work), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g);
}

bool geometry_is(const Geom& g, int kt, int kh, int kw, int st, int sh,
                 int sw) {
  return g.kt == kt && g.kh == kh && g.kw == kw && g.st == st &&
         g.sh == sh && g.sw == sw;
}

// A K1 tile grid of fewer blocks than kFwdSplitBlocks (1.5 an SM of the
// H100's 132) walks its clips in chunks of output frames, one block a
// chunk, for about kFwdMinBlocks blocks (two an SM) in all.
constexpr int kFwdSplitBlocks = 198, kFwdMinBlocks = 264;

// The launch of a tiled K1 instance: its rows a thread (0: the generic
// instance takes the call), thread map, frame chunks and grid.
struct FwdTile {
  int rh, cvl, nch, per;
  dim3 grid;
};

// The tiled K1's launch at V elements a vector and RH rows a thread: CVr =
// 1 << cvl, the least power of two >= C / V, at most kMaxCV; grid x = W
// tiles x channel chunks, y = H tiles, z = B x frame chunks. A small grid
// cuts each clip's To output frames into chunks of per frames, at least
// 2 (KT - ST) / ST of them, so that the KT - ST frames of halo a chunk walks
// before its own are at most half of them (more halo measured slower than
// the whole walk on the card). False when the grid passes its limits.
bool fwd_tile_plan(const Geom& g, int V, int rh, FwdTile* ft) {
  const int cv_n = g.C / V;
  int cvl = 0;
  while (cvl < 3 && (1 << cvl) < cv_n) ++cvl;
  const int th = tile_rows(cvl, rh);
  const int64_t x = (int64_t)((cv_n + (1 << cvl) - 1) >> cvl) *
                    ((g.Wo + kTileCols - 1) / kTileCols);
  const int64_t y = (g.Ho + th - 1) / th;
  const int64_t blocks = x * y * g.B;
  int per = g.To;
  if (blocks < kFwdSplitBlocks) {
    const int want = (int)((kFwdMinBlocks + blocks - 1) / blocks);
    const int least = (2 * (g.kt - g.st) + g.st - 1) / g.st;
    per = (g.To + want - 1) / want;
    if (per < least) per = least;
    if (per > g.To) per = g.To;
  }
  ft->rh = rh;
  ft->cvl = cvl;
  ft->per = per;
  ft->nch = (g.To + per - 1) / per;
  const int64_t z = (int64_t)g.B * ft->nch;
  ft->grid = dim3((unsigned)x, (unsigned)y, (unsigned)z);
  return x < ((int64_t)1 << 31) && y <= 65535 && z <= 65535;
}

// Launches the tiled K1 for this geometry (or, given plan, only writes its
// launch there); false, launching nothing, when its grid does not fit.
template <typename T, int V, RSP_K2_PARAMS, int RH>
bool fwd_tile(const void* x, void* out, const Geom& g, cudaStream_t st,
              FwdTile* plan) {
  FwdTile ft;
  if (!fwd_tile_plan(g, V, RH, &ft)) return false;
  if (plan) {
    *plan = ft;
    return true;
  }
  constexpr int kSmem = route_smem(KH, KW, SH, SW, RH, Lanes<T, V>::NW);
  // above 48 KB a kernel must ask for its dynamic shared memory, once
  static const bool sized =
      cudaFuncSetAttribute(max_tile<T, V, RSP_K2_ARGS, RH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem) == cudaSuccess;
  if (!sized) return false;
  max_tile<T, V, RSP_K2_ARGS, RH><<<ft.grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g, ft.cvl, ft.nch,
      ft.per);
  return true;
}

// The tiled K1 instances at one vector width, by geometry, with their rows
// a thread; false when the geometry has none (or its grid does not fit).
template <typename T, int V>
bool fwd_tiled(const void* x, void* out, const Geom& g, cudaStream_t st,
               FwdTile* plan) {
  if (geometry_is(g, 3, 3, 3, 1, 1, 1))
    return fwd_tile<T, V, 3, 3, 3, 1, 1, 1, 2>(x, out, g, st, plan);
  if (geometry_is(g, 1, 3, 3, 1, 2, 2))
    return fwd_tile<T, V, 1, 3, 3, 1, 2, 2, 1>(x, out, g, st, plan);
  if (geometry_is(g, 3, 3, 3, 2, 2, 2))
    return fwd_tile<T, V, 3, 3, 3, 2, 2, 2, 1>(x, out, g, st, plan);
  if (geometry_is(g, 2, 2, 2, 2, 2, 2))
    return fwd_tile<T, V, 2, 2, 2, 2, 2, 2, 1>(x, out, g, st, plan);
  if (geometry_is(g, 1, 2, 2, 1, 2, 2))
    return fwd_tile<T, V, 1, 2, 2, 1, 2, 2, 1>(x, out, g, st, plan);
  if (geometry_is(g, 2, 1, 1, 2, 1, 1))
    return fwd_tile<T, V, 2, 1, 1, 2, 1, 1, 2>(x, out, g, st, plan);
  return false;
}

// Every call with a tiled instance (a 32-bit plan, V = 8 in bf16 or 4)
// takes it; any other call takes the generic pool_fwd (V = 4 or 1), and so
// does every call of a build with RSP_POOL_GENERIC defined (chip_smoke.py
// times the two). Given plan, launches nothing and writes there the launch
// of the tiled instance, or rh = 0 for the generic one.
template <typename T>
void fwd_dispatch(const Plan& pl, const void* x, void* out, const Geom& g,
                  cudaStream_t st, FwdTile* plan) {
#ifndef RSP_POOL_GENERIC
  if (!pl.wide) {
    bool done = false;
    if constexpr (sizeof(T) == 2) {
      if (pl.vec == 8) done = fwd_tiled<T, 8>(x, out, g, st, plan);
    }
    if (pl.vec == 4) done = fwd_tiled<T, 4>(x, out, g, st, plan);
    if (done) return;
  }
#endif
  if (plan) {
    plan->rh = 0;
    return;
  }
  if (pl.vec >= 4) {
    if (pl.wide) fwd_t<T, 4, int64_t>(x, out, g, st);
    else fwd_t<T, 4, int32_t>(x, out, g, st);
  } else {
    if (pl.wide) fwd_t<T, 1, int64_t>(x, out, g, st);
    else fwd_t<T, 1, int32_t>(x, out, g, st);
  }
}

void fwd(const Plan& pl, const void* x, void* out, const Geom& g,
         cudaStream_t st, FwdTile* plan = nullptr) {
  if (pl.dtype == 0) fwd_dispatch<float>(pl, x, out, g, st, plan);
  else fwd_dispatch<__nv_bfloat16>(pl, x, out, g, st, plan);
}

// One K2 call: the route launch over the output, the gather over the input.
// Returns cudaErrorInvalidConfiguration, launching nothing, when a tile grid
// passes its limits.
template <typename T, int V, typename I, RSP_K2_PARAMS>
int bwd_t(const void* x, const void* gout, void* dx, void* route,
          const Geom& g, cudaStream_t st) {
  dim3 grid_out, grid_in;
  if (!tile_grid(g.B, g.To, g.Ho, g.Wo, g.C / V, &grid_out) ||
      !tile_grid(g.B, g.T, g.H, g.W, g.C / V, &grid_in))
    return (int)cudaErrorInvalidConfiguration;
  pool_route<T, V, I, RSP_K2_ARGS><<<grid_out, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(route), g);
  pool_gather<T, V, I, RSP_K2_ARGS><<<grid_in, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(route), static_cast<const T*>(gout),
      static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// The tiled K2 (route_tile, then gather_tile) for one geometry; false,
// launching nothing, when its grid passes the limits. RHR / RHG: rows of a
// thread in the route and gather passes.
template <typename T, int V, RSP_K2_PARAMS, int RHR, int RHG>
bool bwd_tile(const void* x, const void* gout, void* dx, void* route,
              const Geom& g, cudaStream_t st) {
  const int cv_n = g.C / V;
  int cvl = 0;
  while (cvl < 3 && (1 << cvl) < cv_n) ++cvl;
  const int64_t ncc = (cv_n + (1 << cvl) - 1) >> cvl;
  const int thr = tile_rows(cvl, RHR), thg = tile_rows(cvl, RHG);
  const int64_t xr = ncc * ((g.Wo + kTileCols - 1) / kTileCols);
  const int64_t xg = ncc * ((g.W + kTileCols - 1) / kTileCols);
  const int64_t yr = (g.Ho + thr - 1) / thr, yg = (g.H + thg - 1) / thg;
  if (xr >= ((int64_t)1 << 31) || xg >= ((int64_t)1 << 31) || yr > 65535 ||
      yg > 65535 || g.B > 65535)
    return false;
  constexpr int NW = Lanes<T, V>::NW;
  constexpr int kSmemR = route_smem(KH, KW, SH, SW, RHR, NW);
  constexpr int kSmemG = gather_smem(KH, KW, SH, SW, RHG, NW, V / 4);
  // above 48 KB a kernel must ask for its dynamic shared memory, once
  static const bool sized =
      cudaFuncSetAttribute(route_tile<T, V, RSP_K2_ARGS, RHR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemR) == cudaSuccess &&
      cudaFuncSetAttribute(gather_tile<T, V, RSP_K2_ARGS, RHG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemG) == cudaSuccess;
  if (!sized) return false;
  route_tile<T, V, RSP_K2_ARGS, RHR>
      <<<dim3((unsigned)xr, (unsigned)yr, g.B), kThreads, kSmemR, st>>>(
          static_cast<const T*>(x), static_cast<uint8_t*>(route), g, cvl);
  gather_tile<T, V, RSP_K2_ARGS, RHG>
      <<<dim3((unsigned)xg, (unsigned)yg, g.B), kThreads, kSmemG, st>>>(
          static_cast<const uint8_t*>(route), static_cast<const T*>(gout),
          static_cast<T*>(dx), g, cvl);
  return true;
}

// The tiled instances at one vector width, by geometry; false when the
// geometry has none (or its grid does not fit).
template <typename T, int V>
bool bwd_tiled(const void* x, const void* gout, void* dx, void* route,
               const Geom& g, cudaStream_t st) {
  if (geometry_is(g, 3, 3, 3, 1, 1, 1))
    return bwd_tile<T, V, 3, 3, 3, 1, 1, 1, 2, 2>(x, gout, dx, route, g, st);
  if (geometry_is(g, 1, 3, 3, 1, 2, 2)) {
    // the stems' gather: 4 rows a thread where CVr = 8 (measured faster;
    // at narrow C the tile is tall already)
    if (g.C / V >= kMaxCV)
      return bwd_tile<T, V, 1, 3, 3, 1, 2, 2, 1, 4>(x, gout, dx, route, g, st);
    return bwd_tile<T, V, 1, 3, 3, 1, 2, 2, 1, 2>(x, gout, dx, route, g, st);
  }
  if (geometry_is(g, 3, 3, 3, 2, 2, 2))
    return bwd_tile<T, V, 3, 3, 3, 2, 2, 2, 1, 2>(x, gout, dx, route, g, st);
  if (geometry_is(g, 2, 2, 2, 2, 2, 2))
    return bwd_tile<T, V, 2, 2, 2, 2, 2, 2, 1, 2>(x, gout, dx, route, g, st);
  if (geometry_is(g, 1, 2, 2, 1, 2, 2))
    return bwd_tile<T, V, 1, 2, 2, 1, 2, 2, 1, 2>(x, gout, dx, route, g, st);
  return false;
}

// Every call with a tiled instance (a 32-bit plan, V = 8 in bf16 or 4)
// takes it; any other call takes the generic instance (today's two
// passes, pool_route + pool_gather with every window parameter read at run
// time), and so does every call of a build with RSP_POOL_GENERIC defined
// (chip_smoke.py times the two).
template <typename T>
int bwd_dispatch(const Plan& pl, const void* x, const void* gout, void* dx,
                 void* route, const Geom& g, cudaStream_t st) {
#ifndef RSP_POOL_GENERIC
  if (!pl.wide) {
    bool done = false;
    if constexpr (sizeof(T) == 2) {
      if (pl.vec == 8) done = bwd_tiled<T, 8>(x, gout, dx, route, g, st);
    }
    if (pl.vec == 4) done = bwd_tiled<T, 4>(x, gout, dx, route, g, st);
    if (done) return (int)cudaGetLastError();
  }
#endif
  if (pl.vec >= 4) {
    if (pl.wide)
      return bwd_t<T, 4, int64_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
    return bwd_t<T, 4, int32_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
  }
  if (pl.wide)
    return bwd_t<T, 1, int64_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
  return bwd_t<T, 1, int32_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan of a call on tensors at ptrs[0..n): the widest vector, up to
// max_vec elements, that divides C and at which every tensor is aligned
// for a vector access (a view may start anywhere in its storage); a call
// that fits none takes V = 1.
Plan make_plan(int dtype, const Geom& g, const void* const* ptrs, int n,
               int max_vec) {
  Plan pl;
  pl.dtype = dtype;
  const int esize = dtype == 0 ? 4 : 2;
  pl.vec = 1;
  for (int v = max_vec; v >= 4 && pl.vec == 1; v /= 2) {
    bool ok = g.C % v == 0;
    for (int i = 0; i < n; ++i) ok = ok && aligned(ptrs[i], v * esize);
    if (ok) pl.vec = v;
  }
  // input or output (k = 2, p = 1 makes an axis one longer)
  const int64_t in = (int64_t)g.B * g.T * g.H * g.W * g.C;
  const int64_t out = (int64_t)g.B * g.To * g.Ho * g.Wo * g.C;
  pl.wide = (in > out ? in : out) >= ((int64_t)1 << 31);
  return pl;
}

// the forward's widest vector by dtype (f32, bf16): 16 bytes
constexpr int kFwdMaxVec[2] = {4, 8};

}  // namespace

extern "C" {

// x, out: NDHWC contiguous. shape = {B, T, H, W, C};
// kspec = {kt, kh, kw, st, sh, sw, pt, ph, pw}; dtype 0 = f32, 1 = bf16.
int rsp_maxpool3d_fwd(const void* x, void* out, int dtype,
                      const int64_t* shape, const int* kspec, void* stream) {
  Geom g = make_geom(shape, kspec);
  const void* ptrs[2] = {x, out};
  fwd(make_plan(dtype, g, ptrs, 2, kFwdMaxVec[dtype]), x, out, g,
      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The forward's launch for a call on 16-byte aligned tensors, launching
// nothing: plan = {V, rows a thread of the tiled instance (0: the generic
// instance, whose V is 4 or 1, and zeros), log2 CVr, frame chunks, output
// frames a chunk, grid x, y, z}.
int rsp_maxpool3d_fwd_plan(int dtype, const int64_t* shape, const int* kspec,
                           int* plan) {
  Geom g = make_geom(shape, kspec);
  const void* ptrs[2] = {nullptr, nullptr};
  const Plan pl = make_plan(dtype, g, ptrs, 2, kFwdMaxVec[dtype]);
  FwdTile ft = {};
  fwd(pl, nullptr, nullptr, g, nullptr, &ft);
  const int vec = ft.rh ? pl.vec : pl.vec >= 4 ? 4 : 1;
  const int got[8] = {vec, ft.rh, ft.cvl, ft.nch, ft.per,
                      ft.rh ? (int)ft.grid.x : 0, ft.rh ? (int)ft.grid.y : 0,
                      ft.rh ? (int)ft.grid.z : 0};
  for (int i = 0; i < 8; ++i) plan[i] = got[i];
  return 0;
}

// dx = d maxpool(x) / dx applied to g: two launches, route then gather.
// route is uint8 scratch of the output's shape [B, To, Ho, Wo, C]; x, g and
// dx are NDHWC contiguous in the dtype of x.
int rsp_maxpool3d_bwd(const void* x, const void* g, void* dx, void* route,
                      int dtype, const int64_t* shape, const int* kspec,
                      void* stream) {
  Geom geo = make_geom(shape, kspec);
  const void* ptrs[3] = {x, g, dx};
  Plan pl = make_plan(dtype, geo, ptrs, 3, dtype == 0 ? 4 : 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.dtype == 0) return bwd_dispatch<float>(pl, x, g, dx, route, geo, st);
  return bwd_dispatch<__nv_bfloat16>(pl, x, g, dx, route, geo, st);
}

}  // extern "C"
