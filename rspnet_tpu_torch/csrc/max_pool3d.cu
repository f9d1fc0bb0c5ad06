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
//
// - Forward: one thread per output pixel and 4 channels computes the max of
//   the whole k_t x k_h x k_w window directly (max is exact, so this equals
//   the separable per-axis form bit for bit). Channels are innermost, so a
//   warp reads 16-byte vectors of contiguous channels and the window
//   re-reads hit L1/L2.
// - Backward (gather form): recompute the stage inputs with the forward
//   kernel (T-pooled, then H-pooled), then one launch per pooled axis in
//   reverse order. Each thread owns one element vector of the stage input
//   and sums, in window-offset order, the cotangents whose window
//   first-matches it. No atomics, so the result is deterministic and equal
//   bit for bit to the plain version, which adds in the same order.
// - Index arithmetic is 32-bit whenever the tensors allow it (64-bit integer
//   division is a long software sequence on the card); the grid-stride
//   loop counter stays 64-bit so it cannot wrap.
//
// Plain C interface, loaded with ctypes. Each entry returns
// cudaGetLastError() after its launches.

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

// out[b, to, ho, wo, c..c+V) = max over the window; pad cells are skipped
// (they hold -inf in the reference and never win).
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
          for (int l = 0; l < V; ++l) m[l] = fmaxf(m[l], v[l]);
        }
      }
    }
    storev<V>(out + idx * V, m);
  }
}

// Gradient of a 1-axis pool over a tensor viewed as [outer, D, inner]:
// gin[o, i, j] = sum over windows `on` whose first max sits at i of
// gout[o, on, j], taken in window-offset order (off = 0 .. k-1). k <= 3.
template <typename T, int V, typename I>
__global__ void pool_axis_bwd(const T* __restrict__ vin,
                              const T* __restrict__ gout,
                              T* __restrict__ gin, I outer, int D, int n,
                              I inner, int k, int s, int p) {
  const I jv_n = inner / V;
  const I total = outer * D * jv_n;
  for (int64_t i64 = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i64 < total; i64 += (int64_t)gridDim.x * blockDim.x) {
    const I idx = (I)i64;
    I r = idx / jv_n;
    const I j = (idx - r * jv_n) * V;
    const int i = (int)(r % D);
    const I o = r / D;
    const T* col = vin + o * D * inner + j;
    float acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) acc[l] = 0.0f;
    for (int off = 0; off < k; ++off) {
      const int num = i + p - off;
      if (num < 0 || num % s != 0) continue;
      const int on = num / s;
      if (on >= n) continue;
      const int start = on * s - p;
      float val[3][V], m[V];
      bool valid[3];
#pragma unroll
      for (int l = 0; l < V; ++l) m[l] = -CUDART_INF_F;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int q = start + d;
        valid[d] = d < k && q >= 0 && q < D;
        if (valid[d]) {
          loadv<V>(col + (I)q * inner, val[d]);
#pragma unroll
          for (int l = 0; l < V; ++l) m[l] = fmaxf(m[l], val[d][l]);
        }
      }
      bool take[V];
      bool any = false;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        int first = -1;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (first < 0 && valid[d] && val[d][l] == m[l]) first = d;
        take[l] = first == off;
        any = any || take[l];
      }
      if (any) {
        float gv[V];
        loadv<V>(gout + (o * n + on) * inner + j, gv);
#pragma unroll
        for (int l = 0; l < V; ++l)
          if (take[l]) acc[l] += gv[l];
      }
    }
    storev<V>(gin + idx * V, acc);
  }
}

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  return blocks < 1 ? 1 : blocks;
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

template <typename T, int V, typename I>
void bwd_t(const void* vin, const void* gout, void* gin, int64_t outer,
           int D, int n, int64_t inner, int k, int s, int p,
           cudaStream_t st) {
  const int64_t work = outer * D * (inner / V);
  pool_axis_bwd<T, V, I><<<(unsigned)grid_for(work), kThreads, 0, st>>>(
      static_cast<const T*>(vin), static_cast<const T*>(gout),
      static_cast<T*>(gin), (I)outer, D, n, (I)inner, k, s, p);
}

template <typename T>
void fwd_dispatch(const Plan& pl, const void* x, void* out, const Geom& g,
                  cudaStream_t st) {
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

template <typename T>
void bwd_dispatch(const Plan& pl, const void* vin, const void* gout,
                  void* gin, int64_t outer, int D, int n, int64_t inner,
                  int k, int s, int p, cudaStream_t st) {
  if (pl.vec4) {
    if (pl.wide)
      bwd_t<T, 4, int64_t>(vin, gout, gin, outer, D, n, inner, k, s, p, st);
    else
      bwd_t<T, 4, int32_t>(vin, gout, gin, outer, D, n, inner, k, s, p, st);
  } else {
    if (pl.wide)
      bwd_t<T, 1, int64_t>(vin, gout, gin, outer, D, n, inner, k, s, p, st);
    else
      bwd_t<T, 1, int32_t>(vin, gout, gin, outer, D, n, inner, k, s, p, st);
  }
}

void bwd(const Plan& pl, const void* vin, const void* gout, void* gin,
         int64_t outer, int D, int n, int64_t inner, int k, int s, int p,
         cudaStream_t st) {
  if (pl.dtype == 0)
    bwd_dispatch<float>(pl, vin, gout, gin, outer, D, n, inner, k, s, p, st);
  else
    bwd_dispatch<__nv_bfloat16>(pl, vin, gout, gin, outer, D, n, inner, k,
                                s, p, st);
}

Plan make_plan(int dtype, const Geom& g) {
  Plan pl;
  pl.dtype = dtype;
  pl.vec4 = g.C % 4 == 0;
  // the input is the largest tensor of a call (stages are pooled from it)
  pl.wide = (int64_t)g.B * g.T * g.H * g.W * g.C >= ((int64_t)1 << 31);
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

// dx = d maxpool(x) / dx applied to g. stage1 and stage2 are scratch
// buffers for the T-pooled and TH-pooled stages (unused when the axis is
// trivial); gbuf1/gbuf2 hold the cotangents of the W and H stages. All
// NDHWC contiguous, dtype of x.
int rsp_maxpool3d_bwd(const void* x, const void* g, void* dx, void* stage1,
                      void* stage2, void* gbuf1, void* gbuf2, int dtype,
                      const int64_t* shape, const int* kspec, void* stream) {
  Geom geo = make_geom(shape, kspec);
  Plan pl = make_plan(dtype, geo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t B = geo.B, H = geo.H, W = geo.W, C = geo.C;
  const int T = geo.T, To = geo.To, Ho = geo.Ho, Wo = geo.Wo;
  const bool pool_t = !(geo.kt == 1 && geo.st == 1 && geo.pt == 0);
  const bool pool_h = !(geo.kh == 1 && geo.sh == 1 && geo.ph == 0);
  const bool pool_w = !(geo.kw == 1 && geo.sw == 1 && geo.pw == 0);

  // stage chain: s0 = x [T,H,W], s1 = T-pooled [To,H,W], s2 = [To,Ho,W]
  const void* s0 = x;
  const void* s1 = x;
  if (pool_t) {
    Geom gt = geo;
    gt.kh = gt.kw = 1; gt.sh = gt.sw = 1; gt.ph = gt.pw = 0;
    gt.Ho = geo.H; gt.Wo = geo.W;
    fwd(pl, x, stage1, gt, st);
    s1 = stage1;
  }
  const void* s2 = s1;
  if (pool_h) {
    Geom gh = geo;
    gh.T = To; gh.kt = 1; gh.st = 1; gh.pt = 0; gh.To = To;
    gh.kw = 1; gh.sw = 1; gh.pw = 0; gh.Wo = geo.W;
    fwd(pl, s1, stage2, gh, st);
    s2 = stage2;
  }

  // reverse walk: W, then H, then T. The last pooled axis writes dx.
  const bool last_is_w = !pool_h && !pool_t;
  const bool last_is_h = !pool_t;
  const void* gcur = g;
  if (pool_w) {
    void* dst = last_is_w ? dx : gbuf1;
    bwd(pl, s2, gcur, dst, B * To * Ho, (int)W, Wo, C, geo.kw, geo.sw,
        geo.pw, st);
    gcur = dst;
  }
  if (pool_h) {
    void* dst = last_is_h ? dx : gbuf2;
    bwd(pl, s1, gcur, dst, B * To, (int)H, Ho, W * C, geo.kh, geo.sh, geo.ph,
        st);
    gcur = dst;
  }
  if (pool_t) {
    bwd(pl, s0, gcur, dx, B, T, To, H * W * C, geo.kt, geo.st, geo.pt, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
