// Fused optimizer update (SGD / Momentum / Adam / AdamW) over one flat
// dtype bucket, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_call` of
// paddle_tpu/ops/pallas/fused_optimizer.py: in one pass over the bucket
// it applies the clip scale, the L2/L1 fold, the moment updates, the
// AdamW decoupled decay and the master-weight cast, and writes w, m, v
// and the master weights back in place (the TPU kernel's
// input_output_aliases).
//
// What bounds it on an H100: bytes. Each element is read and written
// once and no value is reused, so nothing is worth staging in shared
// memory and there is no product for the tensor cores: under O2 with
// AdamW it moves 30 B per parameter (bf16 w and g; fp32 m, v and master),
// ~3.7 GB for GPT-124M's bf16 bucket, ~1.1 ms at 3.35 TB/s. The design is
// a grid-stride loop, one element per thread per turn, so a warp reads
// and writes each array in whole contiguous lines. The four scalars (lr,
// clip scale, advanced beta powers) are read from a device array, so the
// host never waits for the device.
//
// The arithmetic is `_math`'s, op for op and in its order, with the
// _rn intrinsics so that nvcc contracts no multiply-add into an FMA: the
// result is the one the plain PyTorch version computes element-wise.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_optimizer.py checks lengths, types and contiguity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

struct Spec {
  int kind;         // 0 sgd, 1 momentum, 2 adam, 3 adamw
  int has_clip;
  int reg;          // 0 none, 1 l2, 2 l1 (only with a nonzero coefficient)
  int use_master;
  int nesterov;
  float beta1, beta2, one_minus_beta1, one_minus_beta2, eps;
  float momentum, rescale, decay, reg_coeff;
};

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

// scal = [lr, clip scale, new beta1 power, new beta2 power]
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(T* __restrict__ w, const T* __restrict__ g,
                    float* __restrict__ master, float* __restrict__ m,
                    float* __restrict__ v, const float* __restrict__ scal,
                    long long n, Spec s) {
  const float lr = scal[0], scale = scal[1], nb1 = scal[2], nb2 = scal[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float w32 = s.use_master ? master[i] : to_f<T>(w[i]);
    T gi = g[i];
    if (s.has_clip) gi = from_f<T>(__fmul_rn(to_f<T>(gi), scale));
    float g32 = to_f<T>(gi);
    if (s.reg == 1) {
      g32 = __fadd_rn(g32, __fmul_rn(s.reg_coeff, w32));
    } else if (s.reg == 2) {
      const float sgn = w32 > 0.f ? 1.f : (w32 < 0.f ? -1.f : 0.f);
      g32 = __fadd_rn(g32, __fmul_rn(s.reg_coeff, sgn));
    }
    float new32;
    if (s.kind == 0) {
      new32 = __fsub_rn(w32, __fmul_rn(lr, g32));
    } else if (s.kind == 1) {
      if (s.rescale != 1.f) g32 = __fmul_rn(g32, s.rescale);
      const float nm = __fadd_rn(__fmul_rn(s.momentum, m[i]), g32);
      m[i] = nm;
      new32 = s.nesterov
                  ? __fsub_rn(w32, __fmul_rn(lr, __fadd_rn(g32, __fmul_rn(s.momentum, nm))))
                  : __fsub_rn(w32, __fmul_rn(lr, nm));
    } else {
      if (s.kind == 3 && s.decay != 0.f)
        w32 = __fmul_rn(w32, __fsub_rn(1.f, __fmul_rn(lr, s.decay)));
      const float nm = __fadd_rn(__fmul_rn(s.beta1, m[i]), __fmul_rn(s.one_minus_beta1, g32));
      const float nv = __fadd_rn(__fmul_rn(s.beta2, v[i]),
                                 __fmul_rn(s.one_minus_beta2, __fmul_rn(g32, g32)));
      m[i] = nm;
      v[i] = nv;
      const float m_hat = __fdiv_rn(nm, __fsub_rn(1.f, nb1));
      const float v_hat = __fdiv_rn(nv, __fsub_rn(1.f, nb2));
      new32 = __fsub_rn(w32, __fdiv_rn(__fmul_rn(lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
    }
    w[i] = from_f<T>(new32);
    if (s.use_master) master[i] = new32;
  }
}

}  // namespace

extern "C" {

// dtype of w and g: 0 float32, 1 bfloat16. Absent state (m, v, master)
// is a null pointer. Launches on `stream` (a cudaStream_t); returns a
// cudaError_t as int.
int pdt_fused_update(int dtype, void* w, const void* g, float* master, float* m,
                     float* v, const float* scal, long long n, int kind,
                     int has_clip, int reg, int use_master, int nesterov,
                     float beta1, float beta2, float one_minus_beta1,
                     float one_minus_beta2, float eps, float momentum,
                     float rescale, float decay, float reg_coeff, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Spec s{kind, has_clip, reg, use_master, nesterov, beta1, beta2,
               one_minus_beta1, one_minus_beta2, eps, momentum, rescale,
               decay, reg_coeff};
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 CTAs per SM, grid-stride
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    fused_update_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<float*>(w), static_cast<const float*>(g), master, m, v, scal, n, s);
  } else if (dtype == 1) {
    fused_update_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(g), master, m,
        v, scal, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
