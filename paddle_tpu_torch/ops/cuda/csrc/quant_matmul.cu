// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ q) * s [+ b].
//
// Replaces the Pallas TPU kernel `_pallas_matmul` / `_kernel`
// (paddle_tpu/ops/pallas/quant_matmul.py): x [M, K] fp32 times an int8
// weight with one fp32 scale per output channel, accumulated in fp32, the
// scale applied once per output element after the K reduction (per-channel
// scales commute with the sum), then the bias. The weight arrives in the
// layout nn.Linear keeps, [N, K] (each output channel's K bytes
// contiguous); no float copy of it is ever written.
//
// What bounds it on an H100 depends on M:
// * decode (M <= 16): the weight bytes. A step reads K * N int8 bytes
//   once and does 2 M K N flops, far below the card's ratio of flops to
//   bytes, so the kernel is a weight-streaming GEMV: a warp owns 4
//   output columns and reads their rows with 16-byte loads (16 int8 a
//   lane), 8 of them in flight a lane; the activation rows sit in shared
//   memory (staged in chunks of K, float4 slots XOR-swizzled so the 16
//   floats a lane reads for its 16 bytes hit distinct banks) and each
//   float4 read feeds the 4 columns. Bytes become floats by a byte
//   permute into the mantissa of 2^23 and one subtraction (exact), not by
//   an integer-to-float conversion, whose rate on an SM is lower than
//   the bytes arrive.
// * mixed prefill + decode (M up to the engine's token budget): the fp32
//   FMAs (2 M K N of them at 67 TFLOP/s; tensor cores are a later PR's
//   work, with their own tolerance). A plain SIMT GEMM: 64 x 64 output
//   tiles, 256 threads with 4 x 4 outputs each, K in steps of 32; the
//   int8 tile becomes fp32 as it is written to shared memory, the next
//   tile's global loads are in registers while the current one is
//   multiplied, and both shared tiles are stored transposed with a
//   float4-slot XOR swizzle so stores and float4 reads avoid bank
//   conflicts. Where the output tiles alone would leave SMs idle, K is
//   split over up to 4 CTAs a tile whose partial sums a second small
//   kernel adds in split order (deterministic, no atomics).
// Both regimes sum over k in order with fmaf and apply the scale after
// the sum, so a result is within fp32 rounding of the plain version.
// Shapes need not be multiples of anything: rows whose K is not a
// multiple of 16 (GEMV) or 8 (GEMM) take a path with byte loads.
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

// ------------------------------------------------------- mixed: GEMM ----

constexpr int BM = 64, BN = 64, BK = 32, kGemmThreads = 256;

// Tiles in shared memory are [BK][64] floats, k-major, with the float4
// slot of column c at row k stored at slot (c / 4) ^ tswz(k): the eight
// k rows a warp's tile stores touch, and its float4 reads, spread over
// the banks.
__device__ __forceinline__ int tswz(int k) { return (k & 7) ^ (((k >> 3) & 3) << 1); }

__device__ __forceinline__ int tidx(int k, int c) {
  return k * 64 + (((c >> 2) ^ tswz(k)) << 2) + (c & 3);
}

// Each thread loads 8 consecutive k of one row of the x tile (row
// tid / 4) and of one weight row (n = tid / 4): k = (tid % 4) * 8 + 0..7,
// zero at or past ke (the end of this CTA's K range).
template <bool VEC>
__device__ __forceinline__ void gemm_load(const float* __restrict__ x,
                                          const int8_t* __restrict__ q, int M, int K, int N,
                                          int m0, int n0, int k0, int ke, float (&xa)[8],
                                          float (&wa)[8]) {
  const int r = threadIdx.x / 4, kk = k0 + (threadIdx.x % 4) * 8;
  const int m = m0 + r, n = n0 + r;
  if (VEC) {  // K % 8 == 0 and ke % 8 == 0: a group of 8 is wholly in or out
    if (m < M && kk < ke) {
      const float4* p = reinterpret_cast<const float4*>(x + (size_t)m * K + kk);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      xa[0] = a.x; xa[1] = a.y; xa[2] = a.z; xa[3] = a.w;
      xa[4] = b.x; xa[5] = b.y; xa[6] = b.z; xa[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xa[i] = 0.f;
    }
    if (n < N && kk < ke) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(q + (size_t)n * K + kk));
      bytes4_to_float(w.x, wa);
      bytes4_to_float(w.y, wa + 4);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) wa[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ink = kk + i < ke;
      xa[i] = (m < M && ink) ? __ldg(x + (size_t)m * K + kk + i) : 0.f;
      wa[i] = (n < N && ink) ? (float)__ldg(q + (size_t)n * K + kk + i) : 0.f;
    }
  }
}

__device__ __forceinline__ void gemm_store(float* As, float* Bs, const float (&xa)[8],
                                           const float (&wa)[8]) {
  const int r = threadIdx.x / 4, kk = (threadIdx.x % 4) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    As[tidx(kk + i, r)] = xa[i];
    Bs[tidx(kk + i, r)] = wa[i];
  }
}

// A 64 x 64 output tile over K range [z k_per, (z + 1) k_per) for split
// z = blockIdx.z. With one split (ws null) the tile is scaled, biased and
// written to y; with several, the raw sums go to ws [splits, M, N] and
// gemm_reduce finishes them.
template <bool VEC>
__global__ void __launch_bounds__(kGemmThreads)
gemm_i8_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, const float* __restrict__ bias,
               float* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
               int k_per) {
  __shared__ __align__(16) float As[BK * 64];
  __shared__ __align__(16) float Bs[BK * 64];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_per, ke = min(K, kb + k_per);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float xa[8], wa[8];
  gemm_load<VEC>(x, q, M, K, N, m0, n0, kb, ke, xa, wa);
  gemm_store(As, Bs, xa, wa);
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += BK) {
    const bool more = k0 + BK < ke;
    if (more) gemm_load<VEC>(x, q, M, K, N, m0, n0, k0 + BK, ke, xa, wa);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + tidx(k, 4 * ty));
      const float4 b = *reinterpret_cast<const float4*>(Bs + tidx(k, 4 * tx));
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      gemm_store(As, Bs, xa, wa);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      if (ws != nullptr) {
        ws[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
        continue;
      }
      float v = acc[i][j] * __ldg(s + n);
      if (bias != nullptr) v += __ldg(bias + n);
      y[(size_t)m * N + n] = v;
    }
  }
}

// y = (sum over splits, in split order, of ws) * s [+ b]: deterministic.
__global__ void gemm_reduce(const float* __restrict__ ws, const float* __restrict__ s,
                            const float* __restrict__ bias, float* __restrict__ y, int M,
                            int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int n = (int)(i % N);
  float t = 0.f;
  for (int z = 0; z < splits; ++z) t += ws[(size_t)z * M * N + i];
  float v = t * __ldg(s + n);
  if (bias != nullptr) v += __ldg(bias + n);
  y[i] = v;
}

// K splits of the GEMM: enough CTAs for two per SM when the output tiles
// alone leave SMs idle (a mixed step's M of 128 on a 4096-wide output is
// 128 tiles for 132 SMs), at most 4, each split at least 8 K steps. One
// split means none.
int gemm_splits(int M, int K, int N, int num_sms, int* k_per) {
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int nk = (K + BK - 1) / BK;
  int splits = 2 * num_sms / tiles;
  if (splits > nk / 8) splits = nk / 8;
  if (splits > 4) splits = 4;
  if (splits < 2) {
    *k_per = nk * BK;
    return 1;
  }
  *k_per = (nk + splits - 1) / splits * BK;
  return (K + *k_per - 1) / *k_per;
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

// Largest M the GEMV regime takes.
int pdt_quant_matmul_gemv_max_rows() { return 16; }

// Floats of workspace pdt_quant_matmul_f32 needs for these shapes (0: none).
size_t pdt_quant_matmul_workspace_floats(int M, int K, int N, int num_sms) {
  if (M <= 16 || M <= 0 || N <= 0) return 0;
  int k_per;
  const int splits = gemm_splits(M, K, N, num_sms, &k_per);
  return splits > 1 ? (size_t)splits * M * N : 0;
}

// y [M, N] = (x [M, K] @ q^T) * s [+ b], q [N, K] int8 rows, s [N] fp32,
// b [N] fp32 or null. x, q 16-byte aligned when K allows vector loads;
// ws: pdt_quant_matmul_workspace_floats floats (or null when that is 0).
// Launch on `stream` (a cudaStream_t); returns a cudaError_t as int.
int pdt_quant_matmul_f32(const float* x, const int8_t* q, const float* s, const float* b,
                         float* y, int M, int K, int N, int num_sms, float* ws,
                         void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 16) {
    switch (gemv_rows(M)) {
      case 4: return (int)dispatch_gemv<4>(x, q, s, b, y, M, K, N, num_sms, st);
      case 8: return (int)dispatch_gemv<8>(x, q, s, b, y, M, K, N, num_sms, st);
      default: return (int)dispatch_gemv<16>(x, q, s, b, y, M, K, N, num_sms, st);
    }
  }
  int k_per;
  const int splits = gemm_splits(M, K, N, num_sms, &k_per);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  float* part = splits > 1 ? ws : nullptr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (K % 8 == 0)
    gemm_i8_kernel<true><<<grid, kGemmThreads, 0, st>>>(x, q, s, b, y, part, M, K, N, k_per);
  else
    gemm_i8_kernel<false><<<grid, kGemmThreads, 0, st>>>(x, q, s, b, y, part, M, K, N, k_per);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)M * N;
    gemm_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(ws, s, b, y, M, N, splits);
  }
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
