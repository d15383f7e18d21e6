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
//             c1 = mean(wg), c2 = mean(wg * xhat) over the row;
//             RMS:   d = dres + rstd * (wg - xhat * c2);
//             Layer: d = dres + rstd * (wg - c1 - xhat * c2);
//             dres absent (null) is zero; dw = sum over rows of
//             g * xhat and db = sum of g, in fp32, written in w's type.
//
// What bounds it on an H100: bytes. Each element is read and written
// once with a few flops, so the design keeps a row's values in
// registers between its reductions and its use:
// * forward: one CTA of kThreads per row; each thread holds K chunks of
//   VEC columns (16-byte loads), and block reductions give the stats;
// * backward: one CTA per block of rows, walking them in turn; each
//   thread holds its chunks' xhat and wg for the row and adds g * xhat
//   (and g) into fp32 partials for its columns, kept in registers across
//   the rows. The CTA writes its partial rows of dw (and db); a second,
//   small kernel sums them over the CTAs in a fixed order. No float
//   atomics: a step is bitwise repeatable, like the TPU kernels' tile
//   partials summed on the host.
// The TPU kernels pad rows to a block of 256; here a CTA masks its own
// ragged end, so nothing is padded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;          // the RMS pair's rows per backward CTA
constexpr int kMaxBlocks = 512;   // the other backwards' CTAs, at most
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

// Two sums at once (the Layer backward's c1 and c2), as block_sum.
__device__ inline float2 block_sum2(float a, float b, float2* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) buf[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    s.x += buf[i].x;
    s.y += buf[i].y;
  }
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

// ---------------------------------------------------------------- bwd --
// x is the forward's normed input (the residual sum for the fused
// pairs); dres may be null. The CTA's dw partial row goes to
// part[blockIdx.x], its db partial (Layer) to part[gridDim.x +
// blockIdx.x].
template <int NORM, typename T, typename WT, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
row_norm_bwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ dres,
                    const T* __restrict__ g, T* __restrict__ d,
                    float* __restrict__ part, int n, int h, int rows_per_cta) {
  __shared__ float buf[2][kWarps];
  __shared__ float2 buf2[2][kWarps];
  using P = Pack<T, VEC>;
  const int nchunks = h / VEC;
  float dw[K][VEC], db[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < VEC; ++v) dw[j][v] = db[j][v] = 0.f;
  const int row0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, n - row0);
  for (int i = 0; i < rows; ++i) {
    const long long base = (long long)(row0 + i) * h;
    const float rs = rstd[row0 + i];
    const float mu = NORM == kLayer ? mean[row0 + i] : 0.f;
    float xh[K][VEC], wg[K][VEC];
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < nchunks) {
        const P xv = *reinterpret_cast<const P*>(x + base + c * VEC);
        const P gv = *reinterpret_cast<const P*>(g + base + c * VEC);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gf = to_f<T>(gv.v[v]);
          const float xf = to_f<T>(xv.v[v]);
          xh[j][v] = NORM == kRms ? __fmul_rn(xf, rs)
                                  : __fmul_rn(__fsub_rn(xf, mu), rs);
          wg[j][v] = __fmul_rn(gf, to_f<WT>(w[c * VEC + v]));
          p2 += wg[j][v] * xh[j][v];
          dw[j][v] = __fadd_rn(dw[j][v], __fmul_rn(gf, xh[j][v]));
          if constexpr (NORM == kLayer) {
            p1 += wg[j][v];
            db[j][v] = __fadd_rn(db[j][v], gf);
          }
        }
      }
    }
    float c1 = 0.f, c2;
    if constexpr (NORM == kRms) {
      c2 = __fdiv_rn(block_sum(p2, buf[i & 1]), (float)h);
    } else {
      const float2 s = block_sum2(p1, p2, buf2[i & 1]);
      c1 = __fdiv_rn(s.x, (float)h);
      c2 = __fdiv_rn(s.y, (float)h);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < nchunks) {
        P dr;
        if (dres != nullptr) {
          dr = *reinterpret_cast<const P*>(dres + base + c * VEC);
        }
        P o;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float drv = dres != nullptr ? to_f<T>(dr.v[v]) : 0.f;
          const float t = NORM == kRms
                              ? __fsub_rn(wg[j][v], __fmul_rn(xh[j][v], c2))
                              : __fsub_rn(__fsub_rn(wg[j][v], c1),
                                          __fmul_rn(xh[j][v], c2));
          o.v[v] = from_f<T>(__fadd_rn(drv, __fmul_rn(rs, t)));
        }
        *reinterpret_cast<P*>(d + base + c * VEC) = o;
      }
    }
  }
  float* out = part + (long long)blockIdx.x * h;
  float* outb = part + (long long)(gridDim.x + blockIdx.x) * h;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        out[c * VEC + v] = dw[j][v];
        if constexpr (NORM == kLayer) outb[c * VEC + v] = db[j][v];
      }
    }
  }
}

// The RMS pair's dw: a thread per column sums the partials in CTA order.
__global__ void __launch_bounds__(kThreads)
dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
              int nblk, int h) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= h) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(long long)b * h + col];
  dw[col] = s;
}

// The other backwards' dw (y = 0) and db (y = 1): out[y][col] = the sum
// over the nblk partial rows part[y][.][col], in a fixed order, written
// in the weights' type OT. A CTA takes 32 columns; warp k sums rows k,
// k + kWarps, ... and warp 0 adds the kWarps sums in order: the many
// rows of a narrow h are read by kWarps times more threads than one per
// column.
template <typename OT>
__global__ void __launch_bounds__(kThreads)
partial_sum_kernel(const float* __restrict__ part, OT* __restrict__ out,
                   int nblk, int h) {
  __shared__ float acc[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const float* p = part + (long long)blockIdx.y * nblk * h;
  float s = 0.f;
  if (col < h)
    for (int b = warp; b < nblk; b += kWarps) s += p[(long long)b * h + col];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < h) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += acc[i][lane];
    out[(long long)blockIdx.y * h + col] = from_f<OT>(t);
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

// Rows per backward CTA for the kernels that are not the RMS pair: at
// least kRows, and at most kMaxBlocks CTAs (fewer partial rows to sum).
inline int bwd_rows_per_cta(int n) {
  const int r = (n + kMaxBlocks - 1) / kMaxBlocks;
  return r > kRows ? r : kRows;
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

template <int NORM, typename T, typename WT, int VEC>
int bwd_launch_t(const void* x, const void* w, const float* mean,
                 const float* rstd, const void* dres, const void* g, void* d,
                 float* part, int n, int h, int rows_per_cta, cudaStream_t st) {
  const int nblk = (n + rows_per_cta - 1) / rows_per_cta;
  const T* xx = static_cast<const T*>(x);
  const WT* ww = static_cast<const WT*>(w);
  const T* dr = static_cast<const T*>(dres);
  const T* gg = static_cast<const T*>(g);
  T* dd = static_cast<T*>(d);
#define PDT_BWD(KK)                                                      \
  row_norm_bwd_kernel<NORM, T, WT, VEC, KK><<<nblk, kThreads, 0, st>>>(  \
      xx, ww, mean, rstd, dr, gg, dd, part, n, h, rows_per_cta)
  switch (pick_k(h, VEC)) {
    case 1: PDT_BWD(1); break;
    case 2: PDT_BWD(2); break;
    case 4: PDT_BWD(4); break;
    case 8: PDT_BWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PDT_BWD
  return (int)cudaGetLastError();
}

template <int NORM>
struct BwdRun {
  template <typename T, typename WT, int VEC>
  struct F {
    static int run(const void* x, const void* w, const float* mean,
                   const float* rstd, const void* dres, const void* g,
                   void* d, float* part, int n, int h, int rows_per_cta,
                   cudaStream_t st) {
      return bwd_launch_t<NORM, T, WT, VEC>(x, w, mean, rstd, dres, g, d,
                                            part, n, h, rows_per_cta, st);
    }
  };
};

// The row kernel of the backward (dtype, wdtype and vec as for the
// forward): `part` holds the CTAs' fp32 partial rows ([ceil(n /
// rows_per_cta), h] for dw, then as many for db with the Layer norm).
// The caller sums them.
inline int row_norm_bwd_rows(int norm, int dtype, int wdtype, const void* x,
                             const void* w, const float* mean,
                             const float* rstd, const void* dres,
                             const void* g, void* d, float* part, int n, int h,
                             int vec, int rows_per_cta, cudaStream_t st) {
  if (norm == kRms)
    return dispatch_types<BwdRun<kRms>::template F>(
        dtype, wdtype, vec, x, w, mean, rstd, dres, g, d, part, n, h,
        rows_per_cta, st);
  if (norm == kLayer)
    return dispatch_types<BwdRun<kLayer>::template F>(
        dtype, wdtype, vec, x, w, mean, rstd, dres, g, d, part, n, h,
        rows_per_cta, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of every norm but the RMS pair: the row kernel, then
// partial_sum_kernel into `dwdb` ([h] dw, then [h] db for Layer), in
// the weights' type.
inline int row_norm_bwd(int norm, int dtype, int wdtype, const void* x,
                        const void* w, const float* mean, const float* rstd,
                        const void* dres, const void* g, void* d, float* part,
                        void* dwdb, int n, int h, int vec, cudaStream_t st) {
  if (n <= 0) return (int)cudaSuccess;
  if (wdtype != 0 && wdtype != 1) return (int)cudaErrorInvalidValue;
  const int rpc = bwd_rows_per_cta(n);
  const int rc = row_norm_bwd_rows(norm, dtype, wdtype, x, w, mean, rstd,
                                   dres, g, d, part, n, h, vec, rpc, st);
  if (rc != (int)cudaSuccess) return rc;
  const dim3 grid((h + 31) / 32, norm == kLayer ? 2 : 1);
  const int nblk = (n + rpc - 1) / rpc;
  if (wdtype == 0)
    partial_sum_kernel<float><<<grid, kThreads, 0, st>>>(
        part, static_cast<float*>(dwdb), nblk, h);
  else
    partial_sum_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dwdb), nblk, h);
  return (int)cudaGetLastError();
}

}  // namespace
