// Weight-only int8 matmul for Hopper (sm_90a), decode rows: y = (x @ q)
// * s [+ b] for an fp32 x of at most 16 rows.
//
// Replaces, with quant_matmul_sm90.cu (every other call: the tensor
// cores), the Pallas TPU kernel `_pallas_matmul` / `_kernel`
// (paddle_tpu/ops/pallas/quant_matmul.py): x [M, K] fp32 times an int8
// weight with one fp32 scale per output channel, accumulated in fp32, the
// scale applied once per output element after the K reduction (per-channel
// scales commute with the sum), then the bias. The weight arrives in the
// layout nn.Linear keeps, [N, K] (each output channel's K bytes
// contiguous); no float copy of it is ever written.
//
// What bounds it on an H100 at decode (M <= 16): the weight bytes. A
// step reads K * N int8 bytes once and does 2 M K N flops, far below the
// card's ratio of flops to bytes, so the kernel is a weight-streaming
// GEMV: a warp owns 4 output columns and reads their rows with 16-byte
// loads (16 int8 a lane), 8 of them in flight a lane; the activation
// rows sit in shared memory (staged in chunks of K, float4 slots
// XOR-swizzled so the 16 floats a lane reads for its 16 bytes hit
// distinct banks) and each float4 read feeds the 4 columns. Bytes become
// floats by a byte permute into the mantissa of 2^23 and one subtraction
// (exact), not by an integer-to-float conversion, whose rate on an SM is
// lower than the bytes arrive. It sums over k in order with fmaf and
// applies the scale after the sum, so a result is within fp32 rounding
// of the plain version. Shapes need not be multiples of anything: rows
// whose K is not a multiple of 16 take a path with byte loads.
//
// Plain C interface (bound with ctypes); the wrapper in quant_matmul.py
// checks shapes, types and contiguity and allocates the output. The
// launchers return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ shared ----

// Four signed bytes of `w` (byte i in the low bits first) as floats:
// flipping the sign bit makes byte b the unsigned b + 128, which a byte
// permute puts under the exponent of 2^23; subtracting 2^23 + 128 leaves
// exactly b.
__device__ __forceinline__ void bytes4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A weight load that is used once: stream it past L1.
__device__ __forceinline__ int4 ld_stream16(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// ------------------------------------------------------ decode: GEMV ----

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kCols = 4;     // output columns a warp owns
constexpr int kUnroll = 2;   // 16-byte chunks a column has in flight a lane

// float4 slot q of an activation row lives at slot swz(q): the slots
// 4c .. 4c+3 of the 16-byte chunk c that lane l reads (c = base + l) land
// in distinct banks across each group of 8 lanes.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 3); }

// Rows [0, M) of x [M, K], columns [k0, k0 + kc), into xs [MT][KC]
// (float4 slots swizzled), zero past kc up to the next multiple of 16
// and in rows M .. MT-1. Every CTA reads the same rows at once, so the
// loads are float4s (K % 4 == 0; x is 16-byte aligned), kStageLoads of
// them in flight a thread; a K that is not a multiple of 4 leaves rows
// unaligned and takes scalar loads.
constexpr int kStageLoads = 8;

template <int MT>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x, int M,
                                        int K, int k0, int kc, int KC) {
  const int q4n = ((kc + 15) & ~15) / 4;
  float4* xs4 = reinterpret_cast<float4*>(xs);
  if (K % 4 == 0) {
    const int total = MT * q4n, live = kc / 4;
    for (int base = threadIdx.x; base < total; base += kGemvThreads * kStageLoads) {
      float4 v[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int e = base + u * kGemvThreads;
        const int r = e / q4n, q4 = e - r * q4n;
        v[u] = (e < total && r < M && q4 < live)
                   ? __ldg(reinterpret_cast<const float4*>(x + (size_t)r * K + k0) + q4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int e = base + u * kGemvThreads;
        const int r = e / q4n, q4 = e - r * q4n;
        if (e < total) xs4[(size_t)r * (KC / 4) + swz(q4)] = v[u];
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < MT * q4n; e += kGemvThreads) {
    const int r = e / q4n, q4 = e - r * q4n;
    const int k = k0 + 4 * q4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < M) {
      const float* xr = x + (size_t)r * K;
      if (k < k0 + kc) v.x = __ldg(xr + k);
      if (k + 1 < k0 + kc) v.y = __ldg(xr + k + 1);
      if (k + 2 < k0 + kc) v.z = __ldg(xr + k + 2);
      if (k + 3 < k0 + kc) v.w = __ldg(xr + k + 3);
    }
    xs4[(size_t)r * (KC / 4) + swz(q4)] = v;
  }
}

// MT: rows computed (M <= MT); VEC: K % 16 == 0 (16-byte weight loads),
// else byte loads. Columns [g * 32, g * 32 + 32) for column groups g of
// this block; with one K chunk (KC >= K) the activations are staged once
// for all of them.
template <int MT, bool VEC>
__global__ void __launch_bounds__(kGemvThreads)
gemv_i8_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, const float* __restrict__ bias,
               float* __restrict__ y, int M, int K, int N, int KC) {
  extern __shared__ __align__(16) float xs[];  // [MT][KC]
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (N + kGemvWarps * kCols - 1) / (kGemvWarps * kCols);
  const bool one_chunk = KC >= K;
  {
    // the first column group's weight rows (its first K chunk) start
    // moving into L2 while the activations are staged
    const int r0 = blockIdx.x * kGemvWarps * kCols;
    const int nr = min(kGemvWarps * kCols, N - r0);
    const size_t lines = ((size_t)min(KC, K) + 127) / 128;
    for (size_t i = threadIdx.x; nr > 0 && i < (size_t)nr * lines; i += kGemvThreads) {
      const size_t row = i / lines, line = i - row * lines;
      const char* a = reinterpret_cast<const char*>(q + (size_t)(r0 + row) * K) + line * 128;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
    }
  }
  if (one_chunk) {
    stage_x<MT>(xs, x, M, K, 0, K, KC);
    __syncthreads();
  }
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int n0 = (g * kGemvWarps + warp) * kCols;
    const int8_t* rows[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) rows[j] = q + (size_t)min(n0 + j, N - 1) * K;
    float acc[MT][kCols];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      if (!one_chunk) {
        __syncthreads();  // the previous chunk's readers are done
        stage_x<MT>(xs, x, M, K, k0, kc, KC);
        __syncthreads();
      }
      if (VEC) {
        const int nch = kc / 16;  // K % 16 == 0, so every chunk is whole
        for (int c = lane; c < nch; c += 32 * kUnroll) {
          int4 w[kUnroll][kCols];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              w[u][j] = c + 32 * u < nch ? ld_stream16(rows[j] + k0 + 16 * (c + 32 * u))
                                         : make_int4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int cc = c + 32 * u;
            if (cc >= nch) break;
            float wf[kCols][16];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              bytes4_to_float((uint32_t)w[u][j].x, wf[j]);
              bytes4_to_float((uint32_t)w[u][j].y, wf[j] + 4);
              bytes4_to_float((uint32_t)w[u][j].z, wf[j] + 8);
              bytes4_to_float((uint32_t)w[u][j].w, wf[j] + 12);
            }
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              if (r >= M) break;
              const float4* xr = xs4 + (size_t)r * (KC / 4);
              const float4 a[4] = {xr[swz(4 * cc)], xr[swz(4 * cc + 1)],
                                   xr[swz(4 * cc + 2)], xr[swz(4 * cc + 3)]};
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                float t = acc[r][j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  t = fmaf(a[i].x, wf[j][4 * i], t);
                  t = fmaf(a[i].y, wf[j][4 * i + 1], t);
                  t = fmaf(a[i].z, wf[j][4 * i + 2], t);
                  t = fmaf(a[i].w, wf[j][4 * i + 3], t);
                }
                acc[r][j] = t;
              }
            }
          }
        }
      } else {
        // byte loads: lane takes k = lane, lane + 32, ... of the chunk
        for (int k = lane; k < kc; k += 32) {
          const int q4 = k >> 2, sub = k & 3;
          float wv[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) wv[j] = (float)__ldg(rows[j] + k0 + k);
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            if (r >= M) break;
            const float xv = xs[(size_t)r * KC + 4 * swz(q4) + sub];
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r >= M) break;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float t = warp_sum(acc[r][j]);
        const int n = n0 + j;
        if (lane == 0 && n < N) {
          float v = t * __ldg(s + n);
          if (bias != nullptr) v += __ldg(bias + n);
          y[(size_t)r * N + n] = v;
        }
      }
    }
  }
}

// Shared memory of the GEMV: MT rows of a K chunk. One chunk covers K
// when it fits in kGemvSmemMax; else chunks of the largest multiple of
// 512 floats that fits.
constexpr size_t kGemvSmemMax = 160 * 1024;

int gemv_rows(int M) { return M <= 4 ? 4 : (M <= 8 ? 8 : 16); }

int gemv_chunk(int MT, int K) {
  const int k16 = (K + 15) & ~15;
  if ((size_t)MT * k16 * sizeof(float) <= kGemvSmemMax) return k16;
  return (int)(kGemvSmemMax / (sizeof(float) * MT)) / 512 * 512;
}

template <int MT, bool VEC>
cudaError_t launch_gemv(const float* x, const int8_t* q, const float* s, const float* b,
                        float* y, int M, int K, int N, int num_sms, cudaStream_t st) {
  const int KC = gemv_chunk(MT, K);
  const size_t smem = (size_t)MT * KC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemv_i8_kernel<MT, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (N + kGemvWarps * kCols - 1) / (kGemvWarps * kCols);
  // one chunk: a block per SM (or as many as fit) walks column groups
  // with the activations staged once; several chunks: a block a group
  const int per_sm = smem <= 72 * 1024 ? 2 : 1;
  const int grid = KC >= K ? (groups < num_sms * per_sm ? groups : num_sms * per_sm)
                           : groups;
  gemv_i8_kernel<MT, VEC><<<grid, kGemvThreads, smem, st>>>(x, q, s, b, y, M, K, N, KC);
  return cudaGetLastError();
}

template <int MT>
cudaError_t dispatch_gemv(const float* x, const int8_t* q, const float* s, const float* b,
                          float* y, int M, int K, int N, int num_sms, cudaStream_t st) {
  if (K % 16 == 0) return launch_gemv<MT, true>(x, q, s, b, y, M, K, N, num_sms, st);
  return launch_gemv<MT, false>(x, q, s, b, y, M, K, N, num_sms, st);
}

}  // namespace

extern "C" {

// y [M, N] = (x [M, K] @ q^T) * s [+ b] for 1 <= M <= 16, q [N, K] int8
// rows, s [N] fp32, b [N] fp32 or null. x, q 16-byte aligned when K
// allows vector loads. Launch on `stream` (a cudaStream_t); returns a
// cudaError_t as int (cudaErrorInvalidValue for M > 16).
int pdt_quant_matmul_f32(const float* x, const int8_t* q, const float* s, const float* b,
                         float* y, int M, int K, int N, int num_sms, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (M > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (gemv_rows(M)) {
    case 4: return (int)dispatch_gemv<4>(x, q, s, b, y, M, K, N, num_sms, st);
    case 8: return (int)dispatch_gemv<8>(x, q, s, b, y, M, K, N, num_sms, st);
    default: return (int)dispatch_gemv<16>(x, q, s, b, y, M, K, N, num_sms, st);
  }
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
