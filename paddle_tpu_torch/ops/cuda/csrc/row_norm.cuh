// Row-norm kernels for Hopper (sm_90a), shared by fused_residual_norm.cu
// (the fused residual + norm pairs) and norms.cu (the plain norms).
//
// One template covers the six TPU kernels of this family: a row pass
// over [rows, h] with an optional residual input, fp32 stats and an
// affine, and a backward with per-CTA dw (and db) partials.
//   forward   r = x (+ y, rounded to the input type BEFORE the stats);
//             RMS:   rstd = rsqrt(mean(r^2) + eps), out = r * rstd * w;
//             Layer: mean, var = mean((r - mean)^2) (two passes, as the
//                    TPU kernels), rstd = rsqrt(var + eps),
//                    out = (r - mean) * rstd * w + b;
//             all in fp32, cast once to the input type. w and b are
//             read in their own type (fp32 or bf16), which may differ
//             from the rows' (fp32 LayerNorm weights beside bf16 rows,
//             or bf16 weights cast for an O2 op).
//   backward  xhat = (x - mean) * rstd (RMS: x * rstd), wg = g * w,
//             c2 = mean(wg * xhat) and (Layer) c1 = mean(wg) over the
//             row;
//             RMS:   d = dres + rstd * (wg - xhat * c2);
//             Layer: d = dres + rstd * (wg - c1 - xhat * c2);
//             dres absent (null) is zero; dw = sum over rows of
//             g * xhat and (Layer) db = sum of g, in fp32, written in
//             w's type.
//
// What bounds it on an H100: bytes. Each element is read and written
// once with a few flops, so the design keeps a row's values in
// registers between its reductions and its use:
// * forward: one CTA of kThreads per row; each thread holds K chunks of
//   VEC columns (16-byte loads), and block reductions give the stats;
// * backward, both norms: ln_bwd_kernel, one launch on a persistent
//   grid, a row to a group of warps with every lane busy, dw (and db)
//   summed in a fixed order past a grid barrier (design notes there).
// No float atomics: a step is bitwise repeatable, like the TPU kernels'
// tile partials summed on the host.
// The TPU kernels pad rows to a block of 256; here a CTA masks its own
// ragged end, so nothing is padded.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum { kRms = 0, kLayer = 1 };

template <typename T>
__device__ inline float to_f(T x);
template <>
__device__ inline float to_f<float>(float x) { return x; }
template <>
__device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ inline T from_f(float x);
template <>
__device__ inline float from_f<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Sum of `v` over the CTA, returned to every thread. `buf` holds kWarps
// floats; consecutive calls alternate between two buffers, so one
// __syncthreads per call suffices.
__device__ inline float block_sum(float v, float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += buf[i];
  return s;
}

// ---------------------------------------------------------------- fwd --
// y and res are read and written only with RESID; b and mean only for
// the Layer norm.
template <int NORM, bool RESID, typename T, typename WT, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
row_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const WT* __restrict__ w, const WT* __restrict__ b,
                    T* __restrict__ res, T* __restrict__ out,
                    float* __restrict__ mean, float* __restrict__ rstd, int h,
                    float eps) {
  __shared__ float buf[2][kWarps];
  using P = Pack<T, VEC>;
  const long long base = (long long)blockIdx.x * h;
  const int nchunks = h / VEC;
  float r[K][VEC];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
      const P a = *reinterpret_cast<const P*>(x + base + c * VEC);
      if constexpr (RESID) {
        const P bb = *reinterpret_cast<const P*>(y + base + c * VEC);
        P o;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          // the residual add in the input type, as the blocks add
          o.v[v] = from_f<T>(__fadd_rn(to_f<T>(a.v[v]), to_f<T>(bb.v[v])));
          r[j][v] = to_f<T>(o.v[v]);
        }
        *reinterpret_cast<P*>(res + base + c * VEC) = o;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) r[j][v] = to_f<T>(a.v[v]);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        s += NORM == kRms ? r[j][v] * r[j][v] : r[j][v];
    }
  }
  s = block_sum(s, buf[0]);
  float mu = 0.f, rs;
  if constexpr (NORM == kRms) {
    rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(s, (float)h), eps));
  } else {
    mu = __fdiv_rn(s, (float)h);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (threadIdx.x + j * kThreads < nchunks) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float dv = __fsub_rn(r[j][v], mu);
          q += dv * dv;
        }
      }
    }
    q = block_sum(q, buf[1]);
    rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(q, (float)h), eps));
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
      P o;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int col = c * VEC + v;
        if constexpr (NORM == kRms) {
          o.v[v] = from_f<T>(
              __fmul_rn(__fmul_rn(r[j][v], rs), to_f<WT>(w[col])));
        } else {
          o.v[v] = from_f<T>(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(r[j][v], mu), rs),
                        to_f<WT>(w[col])),
              to_f<WT>(b[col])));
        }
      }
      *reinterpret_cast<P*>(out + base + c * VEC) = o;
    }
  }
  if (threadIdx.x == 0) {
    rstd[blockIdx.x] = rs;
    if constexpr (NORM == kLayer) mean[blockIdx.x] = mu;
  }
}

// ---------------------------------------------------------- launches --
// chunks per thread for a row of h columns in chunks of vec
inline int pick_k(int h, int vec) {
  const int per = (h / vec + kThreads - 1) / kThreads;
  for (int k = 1; k <= 8; k *= 2)
    if (per <= k) return k;
  return -1;
}

// The largest row width the kernels take for a dtype and load width.
inline int row_norm_max_h(int dtype, int vec) {
  const int v = vec ? (dtype == 0 ? 4 : 8) : 1;
  return 8 * kThreads * v;
}

template <int NORM, bool RESID, typename T, typename WT, int VEC>
int fwd_launch_t(const void* x, const void* y, const void* w, const void* b,
                 void* res, void* out, float* mean, float* rstd, int n, int h,
                 float eps, cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  const T* yy = static_cast<const T*>(y);
  const WT* ww = static_cast<const WT*>(w);
  const WT* bb = static_cast<const WT*>(b);
  T* rr = static_cast<T*>(res);
  T* oo = static_cast<T*>(out);
#define PDT_FWD(KK)                                                         \
  row_norm_fwd_kernel<NORM, RESID, T, WT, VEC, KK><<<n, kThreads, 0, st>>>( \
      xx, yy, ww, bb, rr, oo, mean, rstd, h, eps)
  switch (pick_k(h, VEC)) {
    case 1: PDT_FWD(1); break;
    case 2: PDT_FWD(2); break;
    case 4: PDT_FWD(4); break;
    case 8: PDT_FWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PDT_FWD
  return (int)cudaGetLastError();
}

// Calls F<T, WT, VEC>::run(args...) for the row type `dtype`, the weight
// type `wdtype` (each 0 float32, 1 bfloat16) and the load width (`vec`:
// 16 bytes, else one element); cudaErrorInvalidValue for another code.
template <template <typename, typename, int> class F, typename... A>
int dispatch_types(int dtype, int wdtype, int vec, A... args) {
#define PDT_VEC(T, WT, V)                              \
  return vec ? F<T, WT, V>::run(args...) : F<T, WT, 1>::run(args...)
  if (dtype == 0 && wdtype == 0) { PDT_VEC(float, float, 4); }
  if (dtype == 0 && wdtype == 1) { PDT_VEC(float, __nv_bfloat16, 4); }
  if (dtype == 1 && wdtype == 0) { PDT_VEC(__nv_bfloat16, float, 8); }
  if (dtype == 1 && wdtype == 1) { PDT_VEC(__nv_bfloat16, __nv_bfloat16, 8); }
#undef PDT_VEC
  return (int)cudaErrorInvalidValue;
}

template <int NORM, bool RESID>
struct FwdRun {
  template <typename T, typename WT, int VEC>
  struct F {
    static int run(const void* x, const void* y, const void* w, const void* b,
                   void* res, void* out, float* mean, float* rstd, int n,
                   int h, float eps, cudaStream_t st) {
      return fwd_launch_t<NORM, RESID, T, WT, VEC>(x, y, w, b, res, out, mean,
                                                   rstd, n, h, eps, st);
    }
  };
};

// dtype: 0 float32, 1 bfloat16 (x, y, res, out); wdtype the same for w
// and b; mean and rstd are fp32. `vec`: the caller checked 16-byte
// alignment and h a multiple of 16 bytes of the type.
template <bool RESID>
int row_norm_fwd(int norm, int dtype, int wdtype, const void* x,
                 const void* y, const void* w, const void* b, void* res,
                 void* out, float* mean, float* rstd, int n, int h, float eps,
                 int vec, cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  if (norm == kRms)
    return dispatch_types<FwdRun<kRms, RESID>::template F>(
        dtype, wdtype, vec, x, y, w, b, res, out, mean, rstd, n, h, eps, st);
  if (norm == kLayer)
    return dispatch_types<FwdRun<kLayer, RESID>::template F>(
        dtype, wdtype, vec, x, y, w, b, res, out, mean, rstd, n, h, eps, st);
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------- bwd --
// The backward of all four entries (rows 10 and 16, Layer; rows 12 and
// 14, RMS) in ONE launch, templated on the norm: RMS reads no mean,
// computes no c1 and keeps no db. What held the two-kernel designs back
// (one row at a time a CTA of 256 threads, 96 of them busy at h 768
// bf16; a CTA-wide sum, two __syncthreads, a row; dres loaded after the
// reduction; w read a scalar at a time every row, cast to fp32 on the
// host for the RMS pair; the partials summed by a second launch, at h
// 4096 one thread a column on 16 CTAs) and what this does instead:
// * a row to a group of G warps (ln_bwd_k: K chunks of VEC columns a
//   lane; at h 768 every lane holds 3 chunks, one warp a row in bf16,
//   two in fp32; at h 4096 eight warps, 2 chunks a lane in bf16, 4 in
//   fp32: norms.ln_bwd_group), so a row's sums are warp shuffles, and
//   across a group's G > 1 warps one named barrier a row
//   (double-buffered, as block_sum's);
// * x, g and dres of a row are loaded together before its sums (the
//   first row's before w is staged), and as many groups as the SMs hold
//   resident walk the rows (a persistent grid, gridDim.x * groups rows
//   apart), so other groups' loads are in flight while one group
//   reduces and stores;
// * w is read once a CTA, in its own type, into shared memory as fp32;
//   the rows are read with streaming loads (evict first: each byte is
//   read once);
// * each lane keeps dw (and db) of its columns in fp32 registers over
//   all of its group's rows; the CTA adds its groups' in group order and
//   writes one partial row; then, past a grid barrier (a cooperative
//   launch: every CTA is resident), each CTA adds its slice of the
//   columns over all the partial rows, whole 32-byte sectors a warp, and
//   writes dw (and db) in w's type. The same launch, and no one CTA
//   reads all the partial rows: a first design, in which the last CTA of
//   each set of ~sqrt(CTAs) and then the last set added them, spent ~9.5
//   us on an H100 at 8192 x 768 after the rows were done (PERF.md), one
//   L2 round trip after another.
// No float atomics: which rows a group takes, and every sum's order, are
// fixed by (n, h, the norm, the row type, the SM count and the CTAs an
// SM holds), so repeat runs on a card are bitwise equal.
struct LnBwdArgs {
  const void* x;        // [n, h] the forward's normed input (T)
  const void* w;        // [h] (WT)
  const float* mean;    // [n] (Layer; RMS reads none)
  const float* rstd;    // [n]
  const void* dres;     // [n, h] (T) or null: a zero residual cotangent
  const void* g;        // [n, h] the cotangent of the norm's output (T)
  void* d;              // [n, h] out (T)
  void* dwdb;           // [2, h] out: dw, then db (WT); RMS: [h], dw
  float* part;          // [gridDim.x, cols] fp32 scratch: partial rows
  int n, h;
  int G;                // warps a row: 1, 2, 4 or 8
  int cols;             // a partial row's floats: 2 h (RMS: h) up to 4
};

constexpr int kLnSumLoads = 16;  // partial rows a thread loads at once

// The chunks a lane takes (its template K) for a row of h columns read
// VEC at a time by G warps: the next of 1, 2, 3, 4, 6, 8; -1 past 8.
inline int ln_bwd_k(int h, int vec_elems, int G) {
  const int need = ((h + vec_elems - 1) / vec_elems + 32 * G - 1) / (32 * G);
  const int ks[] = {1, 2, 3, 4, 6, 8};
  for (int k : ks)
    if (need <= k) return k;
  return -1;
}

// Dynamic shared memory: w as fp32 (h rounded up to 4), then the groups'
// dw/db rows when a CTA has more than one group; at least a float a
// thread (the final sums reuse it).
inline int ln_bwd_smem(int h, int G, int cols) {
  const int groups = kWarps / G;
  const int f = (h + 3) / 4 * 4 + (groups > 1 ? groups * cols : 0);
  return (f > kThreads ? f : kThreads) * (int)sizeof(float);
}

// VEC elements of T (16 bytes, or one fp32 or bf16), read once: a
// streaming load (evict first).
template <typename P>
__device__ __forceinline__ P ld_stream(const P* p) {
  P out;
  if constexpr (sizeof(P) == 16)
    *reinterpret_cast<uint4*>(&out) = __ldcs(reinterpret_cast<const uint4*>(p));
  else if constexpr (sizeof(P) == 4)
    *reinterpret_cast<unsigned*>(&out) =
        __ldcs(reinterpret_cast<const unsigned*>(p));
  else
    *reinterpret_cast<unsigned short*>(&out) =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
  return out;
}

// Hides a packed row's registers from the compiler (no instruction), so
// that it cannot keep the values it converted from them earlier.
template <typename P>
__device__ __forceinline__ void opaque(P& p) {
  if constexpr (sizeof(P) % 4 == 0) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&p);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(P) / 4); ++i) asm volatile("" : "+r"(u[i]));
  } else {
    unsigned short* u = reinterpret_cast<unsigned short*>(&p);
    asm volatile("" : "+h"(u[0]));
  }
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// VEC fp32 values at s (16-byte aligned when VEC is a multiple of 4).
template <int VEC>
__device__ __forceinline__ void vec_load(const float* s, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z,
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = s[i];
  }
}

template <int VEC>
__device__ __forceinline__ void vec_store(float* s, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<float4*>(s)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = v[i];
  }
}

// The column sums of `rows` rows of src (stride cols), written to out
// (in OT) where below `limit`: CTA b takes the column ranges b, b +
// gridDim.x, ... of W columns (a power of two, 8 to 256: ~cols / CTAs),
// thread t column t % W of the range and rows t / W, t / W + 256 / W,
// ... (its loads in flight together, added in order), so that the lanes
// of a warp read whole 32-byte sectors of a row; then the lanes of a warp
// that share a column meet in a shuffle tree and the warps in warp order.
// The order is fixed by (rows, cols, gridDim.x).
template <typename OT>
__device__ inline void slice_sums(const float* src, int rows, int cols,
                                  int limit, OT* out, float* buf) {
  const int C = gridDim.x;
  int W = 8;
  while (W < kThreads && W * C < cols) W *= 2;
  const int step = kThreads / W, cl = threadIdx.x % W, r0 = threadIdx.x / W;
  const int lanes = W < 32 ? 32 / W : 1;  // a warp's threads on a column
  for (int c0 = blockIdx.x * W; c0 < cols; c0 += C * W) {
    const int col = c0 + cl;
    float s = 0.f;
    for (int rb = r0; col < cols && rb < rows; rb += kLnSumLoads * step) {
      float t[kLnSumLoads];
#pragma unroll
      for (int k = 0; k < kLnSumLoads; ++k) {
        const int r = rb + k * step;
        t[k] = r < rows ? __ldcg(src + (size_t)r * cols + col) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kLnSumLoads; ++k)
        if (rb + k * step < rows) s = __fadd_rn(s, t[k]);
    }
    for (int o = 16; o >= W; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    buf[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < W && col < limit) {
      float v = buf[threadIdx.x];
      for (int i = lanes; i < step; i += lanes)
        v = __fadd_rn(v, buf[i * W + threadIdx.x]);
      out[col] = from_f<OT>(v);
    }
    __syncthreads();
  }
}

template <int NORM, typename T, typename WT, int VEC, int K>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(const LnBwdArgs a) {
  constexpr bool kL = NORM == kLayer;
  constexpr int nv = kL ? 2 : 1;  // vectors summed over the rows: dw (db)
  extern __shared__ __align__(16) float lsm[];
  __shared__ float2 gsum[2][kWarps];
  using P = Pack<T, VEC>;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const T* __restrict__ dres = static_cast<const T*>(a.dres);
  T* __restrict__ d = static_cast<T*>(a.d);
  const WT* __restrict__ w = static_cast<const WT*>(a.w);
  const int h = a.h, G = a.G, groups = kWarps / G, glanes = 32 * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / G, gl = threadIdx.x - grp * glanes;
  const int nchunks = h / VEC;
  // a row's loads, all issued before its sums
  P xv[K], gv[K], rv[K];
  float rs = 0.f, mu = 0.f;
  auto load = [&](int row) {
    const size_t base = (size_t)row * h;
    rs = a.rstd[row];
    if constexpr (kL) mu = a.mean[row];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = gl + j * glanes;
      if (c < nchunks) {
        xv[j] = ld_stream(reinterpret_cast<const P*>(x + base + c * VEC));
        gv[j] = ld_stream(reinterpret_cast<const P*>(g + base + c * VEC));
        if (dres != nullptr)
          rv[j] = ld_stream(reinterpret_cast<const P*>(dres + base + c * VEC));
      }
    }
  };
  // xhat of one element: (x - mean) * rstd, RMS x * rstd
  auto xhat = [](float xf, float m, float r) {
    return kL ? __fmul_rn(__fsub_rn(xf, m), r) : __fmul_rn(xf, r);
  };
  const int stride = gridDim.x * groups;
  int row = blockIdx.x * groups + grp;
  if (row < a.n) load(row);  // in flight while w is staged
  for (int i = threadIdx.x; i < h; i += kThreads) lsm[i] = to_f<WT>(w[i]);
  __syncthreads();
  float dw[K][VEC], db[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < VEC; ++v) dw[j][v] = db[j][v] = 0.f;

  for (int it = 0; row < a.n; ++it) {
    const size_t base = (size_t)row * h;
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = gl + j * glanes;
      if (c < nchunks) {
        float wv[VEC];
        vec_load<VEC>(lsm + c * VEC, wv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gf = to_f<T>(gv[j].v[v]);
          const float xh = xhat(to_f<T>(xv[j].v[v]), mu, rs);
          const float wg = __fmul_rn(gf, wv[v]);
          if constexpr (kL) p1 += wg;
          p2 += wg * xh;
          dw[j][v] = __fadd_rn(dw[j][v], __fmul_rn(gf, xh));
          if constexpr (kL) db[j][v] = __fadd_rn(db[j][v], gf);
        }
      }
    }
    // first loads landed
    // c1, c2: the group's sums, by shuffles, then across its warps
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if constexpr (kL) p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      p2 += __shfl_xor_sync(0xffffffffu, p2, o);
    }
    if (G > 1) {
      if (lane == 0) gsum[it & 1][warp] = make_float2(p1, p2);
      group_sync(1 + grp, glanes);
      p1 = p2 = 0.f;
      for (int i = 0; i < G; ++i) {
        const float2 s = gsum[it & 1][grp * G + i];
        if constexpr (kL) p1 += s.x;
        p2 += s.y;
      }
    }
    const float c1 = __fdiv_rn(p1, (float)h), c2 = __fdiv_rn(p2, (float)h);
    // xhat and wg again from the row's packed values: the same bits, but
    // from copies the compiler cannot see are equal, so that it keeps the
    // packed row across the sums rather than the first pass's fp32
    // values (in bf16 half the registers: 128 a thread, not 164, and two
    // CTAs an SM at h 768)
    float m2 = mu, r2 = rs;
    asm volatile("" : "+f"(m2), "+f"(r2)::"memory");
#pragma unroll
    for (int j = 0; j < K; ++j) {
      opaque(xv[j]);
      opaque(gv[j]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = gl + j * glanes;
      if (c < nchunks) {
        float wv[VEC];
        vec_load<VEC>(lsm + c * VEC, wv);
        P o;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gf = to_f<T>(gv[j].v[v]);
          const float xh = xhat(to_f<T>(xv[j].v[v]), m2, r2);
          const float wg = __fmul_rn(gf, wv[v]);
          const float drv = dres != nullptr ? to_f<T>(rv[j].v[v]) : 0.f;
          const float t =
              kL ? __fsub_rn(__fsub_rn(wg, c1), __fmul_rn(xh, c2))
                 : __fsub_rn(wg, __fmul_rn(xh, c2));
          o.v[v] = from_f<T>(__fadd_rn(drv, __fmul_rn(r2, t)));
        }
        *reinterpret_cast<P*>(d + base + c * VEC) = o;
      }
    }
    row += stride;
    if (row < a.n) load(row);
  }

  // rows done: the CTA's partial row [dw | db | 0 pad], groups in order
  float* prow = a.part + (size_t)blockIdx.x * a.cols;
  if (groups == 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = gl + j * glanes;
      if (c < nchunks) {
        vec_store<VEC>(prow + c * VEC, dw[j]);
        if constexpr (kL) vec_store<VEC>(prow + h + c * VEC, db[j]);
      }
    }
    for (int i = nv * h + threadIdx.x; i < a.cols; i += kThreads)
      prow[i] = 0.f;
  } else {
    float* red = lsm + (h + 3) / 4 * 4 + (size_t)grp * a.cols;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = gl + j * glanes;
      if (c < nchunks) {
        vec_store<VEC>(red + c * VEC, dw[j]);
        if constexpr (kL) vec_store<VEC>(red + h + c * VEC, db[j]);
      }
    }
    for (int i = nv * h + gl; i < a.cols; i += glanes) red[i] = 0.f;
    __syncthreads();
    const float4* red4 = reinterpret_cast<const float4*>(lsm + (h + 3) / 4 * 4);
    for (int i = threadIdx.x; i < a.cols / 4; i += kThreads) {
      float4 s = red4[i];
      for (int q = 1; q < groups; ++q) {
        const float4 t = red4[(size_t)q * (a.cols / 4) + i];
        s.x = __fadd_rn(s.x, t.x);
        s.y = __fadd_rn(s.y, t.y);
        s.z = __fadd_rn(s.z, t.z);
        s.w = __fadd_rn(s.w, t.w);
      }
      reinterpret_cast<float4*>(prow)[i] = s;
    }
  }

  // partial row written: every CTA's is in past the grid barrier
  cg::this_grid().sync();
  // dw and db: this CTA's slice of the columns over every partial row
  slice_sums<WT>(a.part, gridDim.x, a.cols, nv * h, static_cast<WT*>(a.dwdb),
                 lsm);
  // dw and db written
}

template <int NORM>
struct LnBwdRun {
  template <typename T, typename WT, int VEC>
  struct F {
    template <int K>
    static int go(const LnBwdArgs* a, int ctas, int smem, int* occ,
                  cudaStream_t st) {
      auto kernel = ln_bwd_kernel<NORM, T, WT, VEC, K>;
      // the opt-in above 48 KB, once a device
      static int set_to[64];
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e != cudaSuccess) return (int)e;
      if (dev >= 64) return (int)cudaErrorInvalidDevice;
      if (smem > set_to[dev]) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        set_to[dev] = smem;
      }
      if (occ != nullptr)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            occ, kernel, kThreads, smem);
      void* args[] = {(void*)a};
      return (int)cudaLaunchCooperativeKernel((const void*)kernel, ctas,
                                              kThreads, args, smem, st);
    }
    // occ null: launch ctas CTAs; else store the CTAs an SM holds in *occ
    static int run(const LnBwdArgs* a, int ctas, int* occ, cudaStream_t st) {
      const int k = ln_bwd_k(a->h, VEC, a->G);
      const int smem = ln_bwd_smem(a->h, a->G, a->cols);
      switch (k) {
        case 1: return go<1>(a, ctas, smem, occ, st);
        case 2: return go<2>(a, ctas, smem, occ, st);
        case 3: return go<3>(a, ctas, smem, occ, st);
        case 4: return go<4>(a, ctas, smem, occ, st);
        case 6: return go<6>(a, ctas, smem, occ, st);
        case 8: return go<8>(a, ctas, smem, occ, st);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  };
};

// LnBwdRun<norm>::F<T, WT, VEC>::run(a, ctas, occ, st) for the types'
// codes (dispatch_types); cudaErrorInvalidValue for another norm.
inline int ln_bwd_run(int norm, int dtype, int wdtype, int vec,
                      const LnBwdArgs* a, int ctas, int* occ,
                      cudaStream_t st) {
  if (norm == kRms)
    return dispatch_types<LnBwdRun<kRms>::F>(dtype, wdtype, vec, a, ctas,
                                            occ, st);
  if (norm == kLayer)
    return dispatch_types<LnBwdRun<kLayer>::F>(dtype, wdtype, vec, a, ctas,
                                              occ, st);
  return (int)cudaErrorInvalidValue;
}

inline bool ln_bwd_groups_ok(int G) {
  return G == 1 || G == 2 || G == 4 || G == 8;
}

// A partial row's floats: dw and db (RMS: dw) of h columns, up to 4.
inline int ln_bwd_cols(int norm, int h) {
  return ((norm == kLayer ? 2 : 1) * h + 3) / 4 * 4;
}

// The CTAs an SM holds of the backward of `norm` for rows of h in
// `dtype` on groups of G warps: the fewer of its fp32-w and bf16-w
// kernels (so that w's type does not move the plan), or a negative
// cudaError_t.
inline int ln_bwd_ctas_per_sm(int norm, int dtype, int vec, int h, int G) {
  if (!ln_bwd_groups_ok(G) || h <= 0) return -(int)cudaErrorInvalidValue;
  LnBwdArgs a{};
  a.h = h;
  a.G = G;
  a.cols = ln_bwd_cols(norm, h);
  int most = 1 << 30;
  for (int wdtype = 0; wdtype < 2; ++wdtype) {
    int occ = 0;
    const int rc = ln_bwd_run(norm, dtype, wdtype, vec, &a, 0, &occ,
                              (cudaStream_t)0);
    if (rc != (int)cudaSuccess) return -rc;
    most = occ < most ? occ : most;
  }
  return most;
}

// The backward of `norm` (0 RMS, 1 Layer) on a plan (norms.ln_bwd_plan):
// `ctas` CTAs (at most those the SMs hold: a cooperative launch) of
// G-warp groups, partial rows of `cols` floats in `part` ([ctas, cols]).
// dtype, wdtype and vec as for the forward; dres may be null, and mean
// is read by the Layer norm alone.
inline int ln_bwd(int norm, int dtype, int wdtype, const void* x,
                  const void* w, const float* mean, const float* rstd,
                  const void* dres, const void* g, void* d, void* dwdb,
                  float* part, int n, int h, int vec, int G, int ctas,
                  int cols, cudaStream_t st) {
  if (n <= 0 || h <= 0 || !ln_bwd_groups_ok(G) || ctas <= 0 ||
      (norm != kRms && norm != kLayer) || cols != ln_bwd_cols(norm, h) ||
      (norm == kLayer && mean == nullptr))
    return (int)cudaErrorInvalidValue;
  const LnBwdArgs a{x, w, mean, rstd, dres, g, d, dwdb, part, n, h, G, cols};
  return ln_bwd_run(norm, dtype, wdtype, vec, &a, ctas, (int*)nullptr, st);
}

}  // namespace
