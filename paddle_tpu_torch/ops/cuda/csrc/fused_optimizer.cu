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
// AdamW it moves 28 B per parameter (g read and w written in bf16; m, v
// and the master weights read and written in fp32; w is never read, the
// master holds its value), 8.96 ms for a 1.07e9-parameter bucket at
// 3.35 TB/s. What held the first design (one element per thread a turn,
// 2- and 4-byte accesses) near 80% of that was the bytes a thread had in
// flight: ~14 B, ~28 KB an SM, no more than the card's latency asks for.
// This design gives each thread a run of 8 elements a turn: one 16-byte
// load of g (two for fp32), two of master, m and v each (and of w where
// there is no master), all issued before any arithmetic, and 16-byte
// stores; the grid is the CTAs that are resident at once, each walking
// the runs with a stride. Elements before the first run at which every
// array is 16-byte aligned, and after the last whole run, take the same
// update one at a time in the same kernel (the wrapper finds that first
// run; where the arrays share no alignment every element goes that way).
// Evict-first and L2-prefetch cache hints on the loads and stores were
// measured in turns on the card and took no time off (PERF.md), so the
// accesses are plain. The four scalars
// (lr, clip scale, advanced beta powers) are read from a device array,
// so the host never waits for the device.
//
// The arithmetic is `_math`'s, op for op and in its order, with the
// _rn intrinsics so that nvcc contracts no multiply-add into an FMA: the
// result is the one the plain PyTorch version computes element-wise.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_optimizer.py checks lengths, types and contiguity and plans the
// aligned runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// One element: w32 (the master or w), g as its bucket type gives it (a
// bf16 g is exact in fp32), m and v; returns the new fp32 weight, and the
// new m and v through mi and vi.
__device__ __forceinline__ float update1(const Spec& s, float lr, float scale,
                                         float nb1, float nb2, float w32, float g32,
                                         bool g_bf16, float& mi, float& vi) {
  if (s.has_clip) {
    g32 = __fmul_rn(g32, scale);
    if (g_bf16) g32 = __bfloat162float(__float2bfloat16_rn(g32));
  }
  if (s.reg == 1) {
    g32 = __fadd_rn(g32, __fmul_rn(s.reg_coeff, w32));
  } else if (s.reg == 2) {
    const float sgn = w32 > 0.f ? 1.f : (w32 < 0.f ? -1.f : 0.f);
    g32 = __fadd_rn(g32, __fmul_rn(s.reg_coeff, sgn));
  }
  if (s.kind == 0) return __fsub_rn(w32, __fmul_rn(lr, g32));
  if (s.kind == 1) {
    if (s.rescale != 1.f) g32 = __fmul_rn(g32, s.rescale);
    const float nm = __fadd_rn(__fmul_rn(s.momentum, mi), g32);
    mi = nm;
    return s.nesterov ? __fsub_rn(w32, __fmul_rn(lr, __fadd_rn(g32, __fmul_rn(s.momentum, nm))))
                      : __fsub_rn(w32, __fmul_rn(lr, nm));
  }
  if (s.kind == 3 && s.decay != 0.f) w32 = __fmul_rn(w32, __fsub_rn(1.f, __fmul_rn(lr, s.decay)));
  const float nm = __fadd_rn(__fmul_rn(s.beta1, mi), __fmul_rn(s.one_minus_beta1, g32));
  const float nv = __fadd_rn(__fmul_rn(s.beta2, vi),
                             __fmul_rn(s.one_minus_beta2, __fmul_rn(g32, g32)));
  mi = nm;
  vi = nv;
  const float m_hat = __fdiv_rn(nm, __fsub_rn(1.f, nb1));
  const float v_hat = __fdiv_rn(nv, __fsub_rn(1.f, nb2));
  return __fsub_rn(w32, __fdiv_rn(__fmul_rn(lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
}

// 8 floats from two 16-byte loads at p
__device__ __forceinline__ void ld8f(const float* p, float x[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void st8f(float* p, const float x[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// 8 elements of a T array as floats (a bf16 is exact in fp32), and back
template <typename T>
__device__ __forceinline__ void ld8(const T* p, float x[8]) {
  if constexpr (sizeof(T) == 4) {
    ld8f(reinterpret_cast<const float*>(p), x);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ void st8(T* p, const float x[8]) {
  if constexpr (sizeof(T) == 4) {
    st8f(reinterpret_cast<float*>(p), x);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// scal = [lr, clip scale, new beta1 power, new beta2 power]. Runs of 8
// elements from `head` (nvec of them, every array 16-byte aligned at
// each run), then the elements outside the runs one at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(T* __restrict__ w, const T* __restrict__ g,
                    float* __restrict__ master, float* __restrict__ m,
                    float* __restrict__ v, const float* __restrict__ scal,
                    long long n, long long head, long long nvec, Spec s) {
  const float lr = scal[0], scale = scal[1], nb1 = scal[2], nb2 = scal[3];
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool has_m = s.kind >= 1, has_v = s.kind >= 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long k = first; k < nvec; k += stride) {
    const long long i = head + 8 * k;
    float w32[8], g32[8], mi[8] = {}, vi[8] = {};
    ld8<T>(g + i, g32);
    if (s.use_master) {
      ld8f(master + i, w32);
    } else {
      ld8<T>(w + i, w32);
    }
    if (has_m) ld8f(m + i, mi);
    if (has_v) ld8f(v + i, vi);
    float nw[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      nw[e] = update1(s, lr, scale, nb1, nb2, w32[e], g32[e], kBf16, mi[e], vi[e]);
    st8<T>(w + i, nw);
    if (s.use_master) st8f(master + i, nw);
    if (has_m) st8f(m + i, mi);
    if (has_v) st8f(v + i, vi);
  }
  const long long tail0 = head + 8 * nvec;
  const long long nscalar = head + (n - tail0);
  for (long long j = first; j < nscalar; j += stride) {
    const long long i = j < head ? j : tail0 + (j - head);
    const float w32 = s.use_master ? master[i] : to_f<T>(w[i]);
    float mi = has_m ? m[i] : 0.f, vi = has_v ? v[i] : 0.f;
    const float nw = update1(s, lr, scale, nb1, nb2, w32, to_f<T>(g[i]), kBf16, mi, vi);
    w[i] = from_f<T>(nw);
    if (s.use_master) master[i] = nw;
    if (has_m) m[i] = mi;
    if (has_v) v[i] = vi;
  }
}

int g_sms[64];

template <typename T>
int launch(T* w, const T* g, float* master, float* m, float* v, const float* scal,
           long long n, long long head, long long nvec, const Spec& s, cudaStream_t st) {
  static int occ = 0;   // CTAs an SM, the same on every H100
  auto kernel = fused_update_kernel<T>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && occ <= 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  dev &= 63;
  if (err == cudaSuccess && g_sms[dev] <= 0)
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long nscalar = head + (n - head - 8 * nvec);
  const long long work = nvec > nscalar ? nvec : nscalar;
  long long blocks = (long long)g_sms[dev] * (occ > 0 ? occ : 1);
  const long long need = (work + kThreads - 1) / kThreads;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(w, g, master, m, v, scal, n, head, nvec, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of w and g: 0 float32, 1 bfloat16. Absent state (m, v, master)
// is a null pointer. Runs of 8 from element `head` (nvec of them) must
// find every array 16-byte aligned. Launches on `stream` (a
// cudaStream_t); returns a cudaError_t as int.
int pdt_fused_update(int dtype, void* w, const void* g, float* master, float* m,
                     float* v, const float* scal, long long n, long long head,
                     long long nvec, int kind, int has_clip, int reg,
                     int use_master, int nesterov, float beta1, float beta2,
                     float one_minus_beta1, float one_minus_beta2, float eps,
                     float momentum, float rescale, float decay, float reg_coeff,
                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (head < 0 || nvec < 0 || head + 8 * nvec > n) return (int)cudaErrorInvalidValue;
  const Spec s{kind, has_clip, reg, use_master, nesterov, beta1, beta2,
               one_minus_beta1, one_minus_beta2, eps, momentum, rescale,
               decay, reg_coeff};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(static_cast<float*>(w), static_cast<const float*>(g), master, m, v,
                         scal, n, head, nvec, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(static_cast<__nv_bfloat16*>(w),
                                 static_cast<const __nv_bfloat16*>(g), master, m, v, scal, n,
                                 head, nvec, s, st);
  return (int)cudaErrorInvalidValue;
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
