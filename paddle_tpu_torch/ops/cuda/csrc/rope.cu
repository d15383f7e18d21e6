// Rotary position embedding (rope), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rope_call` (`_rope_kernel`) of
// paddle_tpu/ops/pallas/rope.py: out = x * cos + rot(x) * sin in fp32,
// cast to x's type, with the half ("neox": column i pairs with i + D/2,
// rot = [-x2, x1]) or the interleaved pairing (2i pairs with 2i + 1,
// rot[2i] = -x[2i+1], rot[2i+1] = x[2i]). The tables are fp32 [S, D]
// (one for every batch) or [B, S, D] (per-example positions). A rotation's
// transpose is the rotation by -theta, so the backward is this kernel
// with `neg_sin` set (sin read negated), as the TPU kernel's backward
// calls itself with -sin.
//
// What bounds it on an H100: bytes. Each element of x is read once and
// written once with a handful of flops; at the LLaMA-7B training shape
// (q or k [2, 2048, 32, 128] bf16, tables [2048, 128] fp32) one call
// reads 33.5 MB of x and 2.1 MB of tables and writes 33.5 MB, ~0.021 ms
// at 3.35 TB/s. The design follows:
// * the paddle layout [B, S, H, D] is read in place through its
//   (batch, seq, head) strides, so the TPU wrapper's swap to
//   [B, H, S, D] and back (two transposes of x) does not happen;
// * one CTA per (batch, position): it stages that position's cos and sin
//   rows in shared memory once and applies them to all H heads;
// * each thread moves 16 bytes per load and store: for the half pairing
//   a chunk of VEC columns from each half (the chunk's partner columns
//   sit D/2 further on), for the interleaved pairing VEC neighbouring
//   columns, which hold VEC/2 whole pairs.
// The arithmetic is the plain version's, op for op, with _rn intrinsics
// so that nvcc contracts no multiply-add: the result is the one the plain
// PyTorch version computes.
//
// Plain C interface (bound with ctypes); the wrapper in rope.py checks
// shapes, types, strides and alignment and allocates the output
// (contiguous [B, S, H, D]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 256;

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

// VEC elements of T through one load/store of VEC * sizeof(T) bytes
// (16 bytes when the wrapper found every row aligned, else one element).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Params {
  const void* x;
  void* out;
  const float* cos;
  const float* sin;
  int B, S, H, D;
  long long sb, ss, sh;   // element strides of x: batch, seq, head
  int batched;            // tables [B, S, D] rather than [S, D]
  int use_neox;           // half pairing rather than interleaved
  int neg_sin;            // rotate by -theta (the backward)
};

__device__ inline float rope1(float x, float c, float r, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) rope_kernel(Params p) {
  __shared__ float cs[kMaxD];
  __shared__ float sn[kMaxD];
  const int b = blockIdx.x / p.S;
  const int s = blockIdx.x - b * p.S;
  const int D = p.D;
  const long long tab = ((long long)(p.batched ? b : 0) * p.S + s) * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    cs[i] = p.cos[tab + i];
    const float si = p.sin[tab + i];
    sn[i] = p.neg_sin ? -si : si;
  }
  __syncthreads();

  const T* __restrict__ x = static_cast<const T*>(p.x);
  T* __restrict__ out = static_cast<T*>(p.out);
  const long long xrow = (long long)b * p.sb + (long long)s * p.ss;
  const long long orow = ((long long)b * p.S + s) * p.H * D;
  using P = Pack<T, VEC>;
  if (p.use_neox) {
    const int half = D / 2;
    const int per_head = half / VEC;
    for (int it = threadIdx.x; it < p.H * per_head; it += blockDim.x) {
      const int h = it / per_head;
      const int c = (it - h * per_head) * VEC;
      const T* xh = x + xrow + (long long)h * p.sh;
      T* oh = out + orow + (long long)h * D;
      const P a = *reinterpret_cast<const P*>(xh + c);
      const P z = *reinterpret_cast<const P*>(xh + c + half);
      P oa, oz;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x1 = to_f<T>(a.v[j]), x2 = to_f<T>(z.v[j]);
        oa.v[j] = from_f<T>(rope1(x1, cs[c + j], -x2, sn[c + j]));
        oz.v[j] = from_f<T>(rope1(x2, cs[c + half + j], x1, sn[c + half + j]));
      }
      *reinterpret_cast<P*>(oh + c) = oa;
      *reinterpret_cast<P*>(oh + c + half) = oz;
    }
  } else {
    const int per_head = D / VEC;
    for (int it = threadIdx.x; it < p.H * per_head; it += blockDim.x) {
      const int h = it / per_head;
      const int c = (it - h * per_head) * VEC;
      const T* xh = x + xrow + (long long)h * p.sh;
      T* oh = out + orow + (long long)h * D;
      if constexpr (VEC >= 2) {
        const P a = *reinterpret_cast<const P*>(xh + c);
        P o;
#pragma unroll
        for (int j = 0; j < VEC; j += 2) {
          const float xe = to_f<T>(a.v[j]), xo = to_f<T>(a.v[j + 1]);
          o.v[j] = from_f<T>(rope1(xe, cs[c + j], -xo, sn[c + j]));
          o.v[j + 1] = from_f<T>(rope1(xo, cs[c + j + 1], xe, sn[c + j + 1]));
        }
        *reinterpret_cast<P*>(oh + c) = o;
      } else {
        // one element per turn: its partner is the other column of its pair
        const float xv = to_f<T>(xh[c]);
        const int odd = c & 1;
        const float partner = to_f<T>(xh[odd ? c - 1 : c + 1]);
        oh[c] = from_f<T>(rope1(xv, cs[c], odd ? partner : -partner, sn[c]));
      }
    }
  }
}

template <typename T>
int launch(const Params& p, int vec, cudaStream_t st) {
  const dim3 grid((unsigned)(p.B * p.S));
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    rope_kernel<T, V><<<grid, kThreads, 0, st>>>(p);
  } else {
    rope_kernel<T, 1><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. x is [B, S, H, D] with the last dim
// contiguous and element strides (sb, ss, sh); out is contiguous
// [B, S, H, D]; cos and sin are contiguous fp32 [S, D] or (batched)
// [B, S, D]. `vec`: the caller checked that every row start of x and of
// out is 16-byte aligned and that D (half pairing: D/2) is a multiple of
// 16 bytes of the type. Launches on `stream` (a cudaStream_t); returns a
// cudaError_t as int.
int pdt_rope(int dtype, const void* x, void* out, const float* cos,
             const float* sin, int B, int S, int H, int D, long long sb,
             long long ss, long long sh, int batched, int use_neox,
             int neg_sin, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxD || (D & 1)) return (int)cudaErrorInvalidValue;
  Params p{x, out, cos, sin, B, S, H, D, sb, ss, sh, batched, use_neox,
           neg_sin};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, vec, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
