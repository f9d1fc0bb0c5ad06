// 3-D max pool, forward (K1) and backward (K2), for NDHWC tensors on sm_90a.
//
// Replaces the Pallas kernels rspnet_tpu/ops/pallas_pool.py:_fwd_kernel and
// :_bwd_kernel. Semantics: torch MaxPool3d in floor mode with -inf padding,
// 1 <= k <= 3, 1 <= s <= k, 0 <= p <= k/2 per axis. The gradient routes each
// cotangent to the FIRST matching offset of its window, one axis at a time
// (W, then H, then T), which is the rule of the Pallas kernel and of
// rspnet_tpu/models/common.py:_make_max_pool3d_fm.
//
// Both directions are bound by device-memory traffic (read x [and g], write
// out [or dx]); the window arithmetic is a handful of compares per element.
// Every max of the forward propagates NaN (a window holding a NaN gives
// NaN), as the plain version's torch.maximum and the JAX pool's jnp.maximum
// do.
//
// - Forward (K1). What held the first design (one thread per output pixel
//   and 4 channels, the whole window from global memory) above its bytes
//   was the window re-reads, not DRAM: at stride 1 each output made 27
//   16-byte loads, and the H and T neighbours of a window lay in other
//   blocks, so most re-reads went to L2. The tiled design (pool_fwd_tile)
//   gives a block an output tile of TH x 8 pixels x 8 element vectors
//   (32 channels) and walks it through the clip frame by frame. Each
//   frame's input box, ((TH-1)*sh+kh) x (7*sw+kw) pixels of the tile's
//   channels, is copied once into shared memory (cp.async, two stages, so
//   the next frame loads while this one is reduced); cells outside the
//   tensor hold -inf and never win. Each thread then takes the max along
//   W, then H, for its output column and TH/4 rows, from shared memory,
//   and along T in registers over the last kt frames. An input vector
//   thus comes from L2 about box/tile times (1.56 at (3,3,3)/1, no T
//   halo), and a stride-1 output costs 6 shared-memory reads instead of
//   27 loads. The max is exact, so the W -> H -> T order changes no bit.
//   Compile-time instances for the four pool geometries of S3D-G (V = 4,
//   32-bit plans); pool_fwd, the first design, is the generic instance
//   for every other call. Measured by chip_smoke.py on an H100 (700 W),
//   f32, batch 64: the 13 S3D-G sites take 2.68-2.72 ms against the
//   generic instance's 4.82-4.84 and a 2.15 ms bound; the nine stride-1
//   sites about 1.0 ms (bound 0.76), the four strided ones 1.6 (1.39).
// - Backward, two launches. Composed W -> H -> T, the first-match rule sends
//   each output's cotangent to exactly one input: the lexicographically
//   first in-bounds cell, in (dw, dh, dt) order, that holds the window max
//   (the first W column holding it, in that column the first H row, in that
//   row the first T frame). One byte holds its offset dt*9 + dh*3 + dw.
//   1. Route: one thread per output element vector scans its window as the
//      forward does, keeping the first strict maximum in (dw, dh, dt) order,
//      and writes the offset to a uint8 [B, To, Ho, Wo, C] buffer.
//   2. Gather: one thread per input element vector visits its covering
//      windows in window-offset order and adds g where the route names its
//      own offset in that window. x is not read. The sum nests one
//      accumulator per axis, T outermost and W innermost, so it adds in the
//      order of the staged plain version (W stage, then H, then T); in bf16
//      the W and H sums are rounded to bf16 before going up a level, as the
//      plain version rounds each stage's cotangent. A trivial axis
//      (k = s = 1, p = 0) has no stage and no rounding. No atomics: the
//      result is deterministic and bit-equal to the plain version in f32
//      and bf16.
//   Bytes: x read, route written and read back, g read, dx written, about
//   the bound plus the route. What holds K2 above that on the H100 is the
//   window re-reads, not DRAM: at stride 1 each thread of either pass makes
//   27 loads, served by L1; a strided gather waits on its route loads. So
//   both passes map a block to a 2 x 2 x 4 pixel tile (neighbours share
//   L1), and are compiled with the window and strides as constants for the
//   four pool geometries of S3D-G (a generic instance takes the rest).
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
// K1: every call that pool_fwd_tile does not take.
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

// -- K1, tiled ---------------------------------------------------------------
// 16-byte (f32) or 8-byte (bf16) element vector copied to shared memory
// without passing through registers.
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest committed group
__device__ __forceinline__ void copy_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Output tile of one block: TH (template) x kFwdTW pixels x kFwdCV element
// vectors of 4 channels. Thread tid owns vector tid % kFwdCV of output
// column tid / kFwdCV % kFwdTW, and TH / 4 consecutive output rows from
// row tid / (kFwdCV * kFwdTW) * TH / 4.
constexpr int kFwdCV = 8, kFwdTW = 8;

// out[b, :, ht*TH .. +TH, wt*8 .. +8, 32 channels of chunk cc] for the
// block (blockIdx.x = wt * ncc + cc, blockIdx.y = ht, blockIdx.z = b):
// frames are walked in order from the first window's first frame (-pt) to
// the last window's last frame; a frame outside [0, T) is -inf and is not
// loaded. Output frame to is written once its last frame, to*st - pt +
// kt - 1, has been reduced.
template <typename T, int KT, int KH, int KW, int ST, int SH, int SW, int TH>
__global__ void __launch_bounds__(kThreads)
    pool_fwd_tile(const T* __restrict__ x, T* __restrict__ out, Geom g) {
  constexpr int V = 4, CV = kFwdCV, TW = kFwdTW;
  constexpr int RH = TH * TW * CV / kThreads;    // output rows of a thread
  static_assert(RH * kThreads == TH * TW * CV, "tile != block");
  constexpr int BH = (TH - 1) * SH + KH, BW = (TW - 1) * SW + KW;
  constexpr int CELLS = BH * BW * CV;            // box vectors of a frame
  constexpr int PER = (CELLS + kThreads - 1) / kThreads;
  constexpr int ROWS = (RH - 1) * SH + KH;       // box rows of a thread
  __shared__ __align__(16) T box[2][CELLS * V];

  const int tid = threadIdx.x;
  const int cv_n = g.C / V;
  const int ncc = (cv_n + CV - 1) / CV;
  const int wt = blockIdx.x / ncc, cc = blockIdx.x - wt * ncc;
  const int ht = blockIdx.y, b = blockIdx.z;
  const int h0 = ht * TH * SH - g.ph, w0 = wt * TW * SW - g.pw;
  const int c0 = cc * CV;

  // The box cells this thread copies, as element offsets in a frame (the
  // same in every frame); -1 for a cell it does not copy. A cell outside
  // the tensor holds -inf in both stages from the start.
  int src[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kThreads;
    src[j] = -1;
    if (i >= CELLS) continue;
    const int v = i % CV, px = i / CV;
    const int h = h0 + px / BW, w = w0 + px % BW;
    if (h >= 0 && h < g.H && w >= 0 && w < g.W) {
      if (c0 + v < cv_n) src[j] = (h * g.W + w) * g.C + (c0 + v) * V;
    } else {
      const float inf[V] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                            -CUDART_INF_F};
      storev<V>(&box[0][i * V], inf);
      storev<V>(&box[1][i * V], inf);
    }
  }

  const int frame = g.H * g.W * g.C;
  const T* clip = x + b * g.T * frame;
  auto load = [&](int t, int stage) {
    const T* f = clip + t * frame;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (src[j] >= 0) copy_async(&box[stage][(tid + j * kThreads) * V],
                                  f + src[j]);
  };

  const int v = tid % CV, col = tid / CV % TW, row0 = tid / (CV * TW) * RH;
  const int wo = wt * TW + col, ho0 = ht * TH + row0;
  const bool store = c0 + v < cv_n && wo < g.Wo;
  T* dst = out + (((b * g.To) * g.Ho + ho0) * g.Wo + wo) * g.C +
           (c0 + v) * V;
  const int oframe = g.Ho * g.Wo * g.C;

  // ring[d]: the H x W max of frame t - (KT - 1) + d, for this thread's rows
  float ring[KT][RH][V];
#pragma unroll
  for (int d = 0; d < KT; ++d)
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int l = 0; l < V; ++l) ring[d][r][l] = -CUDART_INF_F;

  const int t_first = -g.pt, t_last = (g.To - 1) * ST - g.pt + KT - 1;
  if (t_first >= 0) load(t_first, 0);
  copy_commit();
  for (int t = t_first; t <= t_last; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 <= t_last && t + 1 >= 0 && t + 1 < g.T) load(t + 1, stage ^ 1);
    copy_commit();
    copy_wait_prev();
    __syncthreads();
#pragma unroll
    for (int d = 0; d + 1 < KT; ++d)
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int l = 0; l < V; ++l) ring[d][r][l] = ring[d + 1][r][l];
    if (t >= 0 && t < g.T) {
      // W: the max of KW columns in each of the thread's box rows
      float rowm[ROWS][V];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const T* cell =
            &box[stage][(((row0 * SH + rr) * BW + col * SW) * CV + v) * V];
        loadv<V>(cell, rowm[rr]);
#pragma unroll
        for (int dw = 1; dw < KW; ++dw) {
          float c[V];
          loadv<V>(cell + dw * CV * V, c);
#pragma unroll
          for (int l = 0; l < V; ++l) rowm[rr][l] = max_nan(rowm[rr][l], c[l]);
        }
      }
      // H: the max of KH rows for each output row
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int l = 0; l < V; ++l) {
          float m = rowm[r * SH][l];
#pragma unroll
          for (int dh = 1; dh < KH; ++dh) m = max_nan(m, rowm[r * SH + dh][l]);
          ring[KT - 1][r][l] = m;
        }
    } else {
#pragma unroll
      for (int r = 0; r < RH; ++r)
#pragma unroll
        for (int l = 0; l < V; ++l) ring[KT - 1][r][l] = -CUDART_INF_F;
    }
    // T: output frame to ends with frame t
    const int j = t + g.pt - (KT - 1);
    if (store && j >= 0 && j % ST == 0) {
      const int to = j / ST;
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        if (ho0 + r >= g.Ho) continue;
        float m[V];
#pragma unroll
        for (int l = 0; l < V; ++l) {
          m[l] = ring[0][r][l];
#pragma unroll
          for (int d = 1; d < KT; ++d) m[l] = max_nan(m[l], ring[d][r][l]);
        }
        storev<V>(dst + to * oframe + r * g.Wo * g.C, m);
      }
    }
    __syncthreads();
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

// Thread -> element map of both K2 passes: each thread owns one element
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

// K2 pass 1. route[b, to, ho, wo, c..c+V) = dt*9 + dh*3 + dw of the first
// window cell, in (dw, dh, dt) order, that holds the window max, with the
// -inf padding counted as cells: the scan starts at offset 0 (kNoRouteByte
// when that cell is padding) and moves only to strictly greater values, so
// a window of -inf keeps its start. A lane whose window holds a NaN routes
// to kNoRouteByte: beside the scan it sums |v|, which is NaN exactly when a
// NaN was added (one full-rate add a cell; a NaN-propagating max beside
// the scan made K2 25% slower on the card). Capped at 32 registers (8
// blocks per SM): the window loads need threads in flight more than
// registers, and the cap measured faster on the card despite a few spilled
// words in the (3,3,3) and generic instances.
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

// K2 pass 2. dx[b, t, h, w, c..c+V) = the cotangents of the windows whose
// route names (t, h, w), summed T (outer) / H / W (inner) in window-offset
// order; a pooled W or H level is rounded to T before it is added up. Per
// T window that covers the element, the route words of its H x W covering
// windows are loaded together, then g where some lane's route hits.
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
// width (4 when C allows 16-byte / 8-byte vectors) and index width.
struct Plan {
  int dtype;     // 0 = f32, 1 = bf16
  bool vec4;
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

// The grid of pool_fwd_tile<..., TH> (V = 4); false when it passes the grid
// limits (B or the H tiles over 65535), or when the row offsets of a ragged
// last H tile (up to TH - 1 rows past Ho) would pass 32 bits.
template <int TH>
bool fwd_tile_grid(const Geom& g, dim3* grid) {
  const int64_t x = (int64_t)((g.C / 4 + kFwdCV - 1) / kFwdCV) *
                    ((g.Wo + kFwdTW - 1) / kFwdTW);
  const int64_t y = (g.Ho + TH - 1) / TH;
  const int64_t rows = (int64_t)g.B * g.To * g.Ho + TH;
  *grid = dim3((unsigned)x, (unsigned)y, (unsigned)g.B);
  return x < ((int64_t)1 << 31) && y <= 65535 && g.B <= 65535 &&
         rows * g.Wo * g.C < ((int64_t)1 << 31);
}

// Launches the tiled K1 for this geometry; false (launching nothing) when
// its grid does not fit.
template <typename T, int KT, int KH, int KW, int ST, int SH, int SW, int TH>
bool fwd_tile(const void* x, void* out, const Geom& g, cudaStream_t st) {
  dim3 grid;
  if (!fwd_tile_grid<TH>(g, &grid)) return false;
  pool_fwd_tile<T, KT, KH, KW, ST, SH, SW, TH><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g);
  return true;
}

// Compile-time instances of the tiled K1 for the pool geometries of S3D-G
// (V = 4, 32-bit plans, a grid that fits), by (kernel, stride), with the
// tile height TH; every other call takes the generic pool_fwd, and so does
// every call of a build with RSP_POOL_GENERIC defined (chip_smoke.py times
// the two).
template <typename T>
void fwd_dispatch(const Plan& pl, const void* x, void* out, const Geom& g,
                  cudaStream_t st) {
#ifndef RSP_POOL_GENERIC
  if (pl.vec4 && !pl.wide) {
    if (geometry_is(g, 1, 3, 3, 1, 2, 2) &&
        fwd_tile<T, 1, 3, 3, 1, 2, 2, 4>(x, out, g, st))
      return;
    if (geometry_is(g, 3, 3, 3, 1, 1, 1) &&
        fwd_tile<T, 3, 3, 3, 1, 1, 1, 8>(x, out, g, st))
      return;
    if (geometry_is(g, 3, 3, 3, 2, 2, 2) &&
        fwd_tile<T, 3, 3, 3, 2, 2, 2, 4>(x, out, g, st))
      return;
    if (geometry_is(g, 2, 2, 2, 2, 2, 2) &&
        fwd_tile<T, 2, 2, 2, 2, 2, 2, 4>(x, out, g, st))
      return;
  }
#endif
  if (pl.vec4) {
    if (pl.wide) fwd_t<T, 4, int64_t>(x, out, g, st);
    else fwd_t<T, 4, int32_t>(x, out, g, st);
  } else {
    if (pl.wide) fwd_t<T, 1, int64_t>(x, out, g, st);
    else fwd_t<T, 1, int32_t>(x, out, g, st);
  }
}

void fwd(const Plan& pl, const void* x, void* out, const Geom& g,
         cudaStream_t st) {
  if (pl.dtype == 0) fwd_dispatch<float>(pl, x, out, g, st);
  else fwd_dispatch<__nv_bfloat16>(pl, x, out, g, st);
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

// Compile-time instances for the pool geometries of S3D-G (V = 4, 32-bit
// plans); any other call takes the generic instance, and so does every call
// of a build with RSP_POOL_GENERIC defined (chip_smoke.py times the two).
template <typename T>
int bwd_dispatch(const Plan& pl, const void* x, const void* gout, void* dx,
                 void* route, const Geom& g, cudaStream_t st) {
#ifndef RSP_POOL_GENERIC
  if (pl.vec4 && !pl.wide) {
    if (geometry_is(g, 1, 3, 3, 1, 2, 2))
      return bwd_t<T, 4, int32_t, 1, 3, 3, 1, 2, 2>(x, gout, dx, route, g, st);
    if (geometry_is(g, 3, 3, 3, 1, 1, 1))
      return bwd_t<T, 4, int32_t, 3, 3, 3, 1, 1, 1>(x, gout, dx, route, g, st);
    if (geometry_is(g, 3, 3, 3, 2, 2, 2))
      return bwd_t<T, 4, int32_t, 3, 3, 3, 2, 2, 2>(x, gout, dx, route, g, st);
    if (geometry_is(g, 2, 2, 2, 2, 2, 2))
      return bwd_t<T, 4, int32_t, 2, 2, 2, 2, 2, 2>(x, gout, dx, route, g, st);
  }
#endif
  if (pl.vec4) {
    if (pl.wide)
      return bwd_t<T, 4, int64_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
    return bwd_t<T, 4, int32_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
  }
  if (pl.wide)
    return bwd_t<T, 1, int64_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
  return bwd_t<T, 1, int32_t, 0, 0, 0, 0, 0, 0>(x, gout, dx, route, g, st);
}

Plan make_plan(int dtype, const Geom& g) {
  Plan pl;
  pl.dtype = dtype;
  pl.vec4 = g.C % 4 == 0;
  // input or output (k = 2, p = 1 makes an axis one longer)
  const int64_t in = (int64_t)g.B * g.T * g.H * g.W * g.C;
  const int64_t out = (int64_t)g.B * g.To * g.Ho * g.Wo * g.C;
  pl.wide = (in > out ? in : out) >= ((int64_t)1 << 31);
  return pl;
}

}  // namespace

extern "C" {

// x, out: NDHWC contiguous. shape = {B, T, H, W, C};
// kspec = {kt, kh, kw, st, sh, sw, pt, ph, pw}; dtype 0 = f32, 1 = bf16.
int rsp_maxpool3d_fwd(const void* x, void* out, int dtype,
                      const int64_t* shape, const int* kspec, void* stream) {
  Geom g = make_geom(shape, kspec);
  fwd(make_plan(dtype, g), x, out, g, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// dx = d maxpool(x) / dx applied to g: two launches, route then gather.
// route is uint8 scratch of the output's shape [B, To, Ho, Wo, C]; x, g and
// dx are NDHWC contiguous in the dtype of x.
int rsp_maxpool3d_bwd(const void* x, const void* g, void* dx, void* route,
                      int dtype, const int64_t* shape, const int* kspec,
                      void* stream) {
  Geom geo = make_geom(shape, kspec);
  Plan pl = make_plan(dtype, geo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.dtype == 0) return bwd_dispatch<float>(pl, x, g, dx, route, geo, st);
  return bwd_dispatch<__nv_bfloat16>(pl, x, g, dx, route, geo, st);
}

}  // extern "C"
