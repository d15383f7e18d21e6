// Fused residual add + RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `fused_residual_rms_norm_fwd` and
// `fused_residual_rms_norm_bwd` of
// paddle_tpu/ops/pallas/fused_residual_norm.py, with their block math
// (`_rrms_fwd_block`, `_rrms_bwd_block`):
//   forward   res = x + y, rounded to the input type BEFORE the stats;
//             rstd = rsqrt(mean(res^2) + eps) in fp32;
//             normed = res * rstd * w (fp32, cast to the input type);
//   backward  xhat = res * rstd, wg = dnormed * w,
//             c = mean(wg * xhat) over the row,
//             d = dres + rstd * (wg - xhat * c), the SHARED cotangent of
//             x and y (cast to the input type); dw = sum over rows of
//             dnormed * xhat in fp32. A missing dres (the residual output
//             unused, as LLaMA's final norm discards it) is zero.
//
// What bounds it on an H100: bytes. A row is read once and written once
// with a few flops per element; at the LLaMA-7B training shape (x, y
// [4096, 4096] bf16) the forward moves 67.1 MB in and 67.1 MB out
// (~0.04 ms at 3.35 TB/s), the backward 100.7 MB in and 33.6 MB out.
// The design keeps every row's values in registers between its
// reduction and its use, so each element crosses device memory once:
// * forward: one CTA per row; each thread holds K chunks of VEC columns
//   (16-byte loads), sums its squares, and a block reduction gives the
//   row's rstd;
// * backward: one CTA per block of kRows rows, walking its rows in turn;
//   each thread holds its chunks' xhat and wg for the row and adds
//   dnormed * xhat into fp32 dw partials for its columns, kept in
//   registers across the rows. The CTA writes its partial row of dw and
//   a second, small kernel sums the partials over the CTAs in a fixed
//   order. No float atomics: a step is bitwise repeatable, like the TPU
//   kernel's tile partials summed on the host.
// The TPU kernels pad rows to a block of 256; here a CTA masks its own
// ragged end, so nothing is padded.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_residual_norm.py checks shapes, types and contiguity, casts w to
// fp32 and allocates the outputs and the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;            // rows per CTA in the backward
constexpr int kWarps = kThreads / 32;

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
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
               const float* __restrict__ w, T* __restrict__ res,
               T* __restrict__ normed, float* __restrict__ rstd, int h,
               float eps) {
  __shared__ float buf[kWarps];
  using P = Pack<T, VEC>;
  const long long base = (long long)blockIdx.x * h;
  const int nchunks = h / VEC;
  float r[K][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
      const P a = *reinterpret_cast<const P*>(x + base + c * VEC);
      const P b = *reinterpret_cast<const P*>(y + base + c * VEC);
      P o;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        // the residual add in the input type, as the blocks add
        o.v[v] = from_f<T>(__fadd_rn(to_f<T>(a.v[v]), to_f<T>(b.v[v])));
        r[j][v] = to_f<T>(o.v[v]);
        ss += r[j][v] * r[j][v];
      }
      *reinterpret_cast<P*>(res + base + c * VEC) = o;
    }
  }
  ss = block_sum(ss, buf);
  const float rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)h), eps));
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
      P o;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        o.v[v] = from_f<T>(__fmul_rn(__fmul_rn(r[j][v], rs), w[c * VEC + v]));
      *reinterpret_cast<P*>(normed + base + c * VEC) = o;
    }
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = rs;
}

// ---------------------------------------------------------------- bwd --
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ res, const float* __restrict__ w,
               const float* __restrict__ rstd, const T* __restrict__ dres,
               const T* __restrict__ dnormed, T* __restrict__ d,
               float* __restrict__ dw_part, int n, int h) {
  __shared__ float buf[2][kWarps];
  using P = Pack<T, VEC>;
  const int nchunks = h / VEC;
  float dw[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < VEC; ++v) dw[j][v] = 0.f;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int i = 0; i < rows; ++i) {
    const long long base = (long long)(row0 + i) * h;
    const float rs = rstd[row0 + i];
    float xh[K][VEC], wg[K][VEC];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < nchunks) {
        const P r = *reinterpret_cast<const P*>(res + base + c * VEC);
        const P g = *reinterpret_cast<const P*>(dnormed + base + c * VEC);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float gv = to_f<T>(g.v[v]);
          xh[j][v] = __fmul_rn(to_f<T>(r.v[v]), rs);
          wg[j][v] = __fmul_rn(gv, w[c * VEC + v]);
          part += wg[j][v] * xh[j][v];
          dw[j][v] = __fadd_rn(dw[j][v], __fmul_rn(gv, xh[j][v]));
        }
      }
    }
    const float cm = __fdiv_rn(block_sum(part, buf[i & 1]), (float)h);
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
          o.v[v] = from_f<T>(__fadd_rn(
              drv, __fmul_rn(rs, __fsub_rn(wg[j][v], __fmul_rn(xh[j][v], cm)))));
        }
        *reinterpret_cast<P*>(d + base + c * VEC) = o;
      }
    }
  }
  float* out = dw_part + (long long)blockIdx.x * h;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < nchunks) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[c * VEC + v] = dw[j][v];
    }
  }
}

// dw[col] = sum over the backward's CTAs of their partials, in CTA order.
__global__ void __launch_bounds__(kThreads)
dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
              int nblk, int h) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= h) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(long long)b * h + col];
  dw[col] = s;
}

template <typename T, int VEC>
int fwd_launch(int k, const void* x, const void* y, const float* w, void* res,
               void* normed, float* rstd, int n, int h, float eps,
               cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  const T* yy = static_cast<const T*>(y);
  T* rr = static_cast<T*>(res);
  T* oo = static_cast<T*>(normed);
#define PDT_FWD(KK) \
  rms_fwd_kernel<T, VEC, KK><<<n, kThreads, 0, st>>>(xx, yy, w, rr, oo, rstd, h, eps)
  switch (k) {
    case 1: PDT_FWD(1); break;
    case 2: PDT_FWD(2); break;
    case 4: PDT_FWD(4); break;
    case 8: PDT_FWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PDT_FWD
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int bwd_launch(int k, const void* res, const float* w, const float* rstd,
               const void* dres, const void* dnormed, void* d, float* dw_part,
               float* dw, int n, int h, cudaStream_t st) {
  const int nblk = (n + kRows - 1) / kRows;
  const T* rr = static_cast<const T*>(res);
  const T* dr = static_cast<const T*>(dres);
  const T* gg = static_cast<const T*>(dnormed);
  T* dd = static_cast<T*>(d);
#define PDT_BWD(KK) \
  rms_bwd_kernel<T, VEC, KK><<<nblk, kThreads, 0, st>>>(rr, w, rstd, dr, gg, dd, dw_part, n, h)
  switch (k) {
    case 1: PDT_BWD(1); break;
    case 2: PDT_BWD(2); break;
    case 4: PDT_BWD(4); break;
    case 8: PDT_BWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PDT_BWD
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_sum_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0, st>>>(dw_part, dw,
                                                                     nblk, h);
  return (int)cudaGetLastError();
}

// chunks per thread for a row of h columns in chunks of vec
int pick_k(int h, int vec) {
  const int per = (h / vec + kThreads - 1) / kThreads;
  for (int k = 1; k <= 8; k *= 2)
    if (per <= k) return k;
  return -1;
}

}  // namespace

extern "C" {

// Rows of the backward's CTAs (the wrapper sizes the dw partials
// [ceil(n / rows), h] with it).
int pdt_rms_bwd_rows() { return kRows; }

// dtype: 0 float32, 1 bfloat16 (x, y, res, normed, d, dres, dnormed);
// w, rstd, dw and the partials are fp32. All row-major and contiguous.
// `vec`: the caller checked 16-byte alignment and h a multiple of
// 16 bytes of the type. Launch on `stream` (a cudaStream_t); return a
// cudaError_t as int.
int pdt_rms_fwd(int dtype, const void* x, const void* y, const float* w,
                void* res, void* normed, float* rstd, int n, int h, float eps,
                int vec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int v = vec ? 4 : 1, k = pick_k(h, v);
    return vec ? fwd_launch<float, 4>(k, x, y, w, res, normed, rstd, n, h, eps, st)
               : fwd_launch<float, 1>(k, x, y, w, res, normed, rstd, n, h, eps, st);
  }
  if (dtype == 1) {
    const int v = vec ? 8 : 1, k = pick_k(h, v);
    return vec ? fwd_launch<__nv_bfloat16, 8>(k, x, y, w, res, normed, rstd, n, h,
                                              eps, st)
               : fwd_launch<__nv_bfloat16, 1>(k, x, y, w, res, normed, rstd, n, h,
                                              eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dres may be null (a zero residual cotangent).
int pdt_rms_bwd(int dtype, const void* res, const float* w, const float* rstd,
                const void* dres, const void* dnormed, void* d, float* dw_part,
                float* dw, int n, int h, int vec, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int v = vec ? 4 : 1, k = pick_k(h, v);
    return vec ? bwd_launch<float, 4>(k, res, w, rstd, dres, dnormed, d, dw_part,
                                      dw, n, h, st)
               : bwd_launch<float, 1>(k, res, w, rstd, dres, dnormed, d, dw_part,
                                      dw, n, h, st);
  }
  if (dtype == 1) {
    const int v = vec ? 8 : 1, k = pick_k(h, v);
    return vec ? bwd_launch<__nv_bfloat16, 8>(k, res, w, rstd, dres, dnormed, d,
                                              dw_part, dw, n, h, st)
               : bwd_launch<__nv_bfloat16, 1>(k, res, w, rstd, dres, dnormed, d,
                                              dw_part, dw, n, h, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The largest row width the kernels take for a dtype and load width.
int pdt_rms_max_h(int dtype, int vec) {
  const int v = vec ? (dtype == 0 ? 4 : 8) : 1;
  return 8 * kThreads * v;
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
