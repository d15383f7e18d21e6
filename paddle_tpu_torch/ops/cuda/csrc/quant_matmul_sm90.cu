// Weight-only int8 matmul on Hopper's tensor cores (sm_90a):
// y = (x @ q) * s [+ b] for fp32 or bf16 activations.
//
// Replaces, with quant_matmul.cu, the Pallas TPU kernel `_pallas_matmul`
// / `_kernel` (paddle_tpu/ops/pallas/quant_matmul.py): x [M, K] times an
// int8 weight with one fp32 scale per output channel, fp32 accumulation,
// the scale applied once per output element after the K reduction, the
// result cast to x's dtype, then the bias. quant_matmul.py sends here
// every bf16 call and every fp32 call with M > 16, K zero-padded to a
// multiple of 16 (what a TMA tensor map of the int8 weight takes); fp32
// calls with M <= 16 keep quant_matmul.cu's GEMV.
//
// What bounds it on an H100: at the serving engine's mixed step (M = 128
// tokens) the weight bytes (LLaMA-7B q/k/v/o: 16.8 MB, 5.0 us at 3.35
// TB/s, against 4.3 GFLOP = 4.3 us at 989 TFLOP/s bf16); from M ~ 200 up
// the bf16 tensor cores. So the products run on `wgmma`, and the weight
// is read from device memory once per token tile, as int8.
//
// The product is computed transposed, Y^T [N, M] = W [N, K] X^T [K, M]:
// 64 weight rows (output channels) are the wgmma's M, a tile of 64 tokens
// its N. The weight, stored [N, K] as WeightOnlyLinear keeps it, is the
// A operand from registers (the RS form): each consumer thread reads its
// fragment's bytes from the TMA-loaded, swizzled int8 tile and
// converts them in registers to bf16, which is exact (every int8 is a
// bf16: a byte permute puts the byte under the exponent of 2^23, one
// subtraction leaves the integer, whose upper 16 bits are its bf16). No
// float copy of the weight is written, in device or shared memory. The
// activations are the B operand, K-major like K in flash's S = Q K^T,
// from 128-byte-swizzled shared memory; rows past M arrive as zeros.
// A thread's fragment takes k = 2t, 2t+1, 2t+8, 2t+9 of each k16 step
// (t = lane % 4): two 32-bit shared loads a row, the wanted bytes picked
// by the permute that converts them, so x keeps its natural k order and
// goes from TMA straight to the tensor cores.
//
// Numbers. bf16 x: one product per k16 step into the fp32 accumulator.
// fp32 x is split into three bf16 planes, hi = bf16(x), mid = bf16(x -
// hi) and lo = bf16(x - hi - mid); q is exact in bf16, so only x - hi -
// mid - lo is lost, at most 2^-24 |x| a term: x keeps fp32's 24 bits.
// The tensor cores' fp32 accumulator does not round each addition to
// nearest as an FFMA does: measured on the card, a third plane
// interleaved with the others made the error larger, not smaller. So
// for an fp32 x each stage's products start a fresh accumulator, the
// smallest plane first (its sums stay small), and the stages are added
// in fp32 registers. Against two interleaved planes this took the error
// from 0.022-0.041 to 0.003-0.017 of quant_matmul.tolerance and the
// LLaMA-7B int8-KV serve's logit gap to its plain forward from 0.059 to
// 0.045; the third plane costs 8-13% at M = 128 (PERF.md). The split is a
// first small kernel of the same call
// (split_x_kernel: x read once, the planes written once), not a step of
// the product's CTAs: there every CTA of a token tile would repeat it,
// N / 64 times in all; moving it out made the fp32 route 18-26% faster
// at M = 128 on the card (PERF.md).
//
// Layout: one CTA per (64 tokens, 64 weight rows), token tiles fastest so
// the CTAs that share a weight tile run together and its second read
// hits L2. Nine warps: warp 8's first lane issues the TMA loads (the int8
// tile [64 rows][kKc k] and the x planes [64 tokens][kKc k]; kKc = 128
// for bf16 x, 64 for the three planes of an fp32 x) into a ring of
// stages with full/empty mbarriers; two consumer warpgroups take the
// stages in turn (stage slot s always by warpgroup s % 2, so a
// warpgroup never waits on a phase it could alias) and each keeps its
// own fp32 sum over half of K. The split is fixed, and so is the sum:
// warpgroup 0's half plus warpgroup 1's, then times the scale, so a call
// gives the same bits every time (no atomics, no split over CTAs). With
// two warpgroups the one's weight conversion overlaps the other's
// products. The epilogue goes through shared memory ([64 tokens][64
// channels]) so the rows of y [M, N] are stored coalesced; for bf16 the
// result is rounded to bf16 before the bias is added and rounded again,
// as `y.to(bf16) + bias.to(bf16)` does.
//
// Shared memory: fp32 x, 8 stages of 4 + 3 x 8 KB (225 KB); bf16 x, 8
// stages of 8 + 16 KB (193 KB). Measured on the card (PERF.md):
// 64-wide stages made the bf16 route ~20% slower; clusters of 2 or 4
// CTAs multicasting the x tile were slower, not faster, and a k order
// staggered by CTA changed nothing.
//
// Plain C interface (ctypes). The launcher encodes the three TMA tensor
// maps (cuTensorMapEncodeTiled, taken from the driver through the
// runtime: the library links no -lcuda) and returns a cudaError_t as
// int, or kEncodeFailed + the CUresult when a map cannot be encoded, or
// kNoEncoder.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 64;           // weight rows (output channels) a CTA
constexpr int kTok = 64;            // tokens a CTA: the wgmma's N
constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kThreads = kConsumers * kWG + 32;   // + the producer warp
constexpr int kPanel = kTok * 128;  // 64 tokens x 64 bf16 (128 bytes)
constexpr int kYPitch = kRows + 4;  // floats a token row of the y tile

constexpr int kF32Planes = 3;       // bf16 planes of an fp32 x
constexpr int kSmemMax = 227 * 1024;   // an H100 SM's shared memory a CTA

constexpr int kEncodeFailed = 100000;  // + the CUresult
constexpr int kNoEncoder = 99999;

// x arrives as P bf16 planes: kF32Planes for an fp32 x (hi, mid, lo),
// one for a bf16 x. A stage holds kKc of K: the int8 tile [64 rows][kKc]
// (128- or 64-byte swizzled rows) and each plane's kKc / 64 panels. The
// stage count is the largest even one that fits (see the header).
template <int P>
struct Cfg {
  static constexpr int kKc = P > 1 ? 64 : 128;
  static constexpr int kWTile = kRows * kKc;
  static constexpr int kPlane = kKc / 64 * kPanel;
  static constexpr int kStage = kWTile + P * kPlane;
  static constexpr int kStages = (kSmemMax - 2048) / kStage & ~1;
  static constexpr int kSmem = 1024 + kStages * kStage;
};

struct Args {
  const float* s;   // [N]
  const float* b;   // [N] or null; for bf16 x already rounded to bf16
  void* y;          // [M, N]: fp32 (P > 1) or bf16
  int M, N, n_k;
};

// Two bytes of `w` (bytes p, p + 1; `sel` = 0x7440 + p) as a bf16 pair,
// the lower byte in the low half. Exact: the byte, its sign bit flipped,
// lies under the exponent of 2^23; subtracting 2^23 + 128 leaves the
// integer, an fp32 whose low 16 bits are zero.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w,
                                                   uint32_t sel) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// fp32 x [n4 float4s] into its kF32Planes bf16 planes, planes[i] =
// bf16(x - planes[0] - ... - planes[i - 1]); every subtraction is exact,
// and each plane leaves at most 2^-8 of what it takes (three: 2^-24 |x|)
__global__ void __launch_bounds__(256)
    split_x_kernel(const float4* __restrict__ x, uint2* __restrict__ planes,
                   size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = __ldg(x + i);
#pragma unroll
    for (int p = 0; p < kF32Planes; ++p) {
      const uint2 t = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      planes[p * n4 + i] = t;
      v.x -= __uint_as_float(t.x << 16);
      v.y -= __uint_as_float(t.x & 0xFFFF0000u);
      v.z -= __uint_as_float(t.y << 16);
      v.w -= __uint_as_float(t.y & 0xFFFF0000u);
    }
  }
}

// tx[p]: the tensor map of x's plane p (the first P are read)
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_sm90_kernel(const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tx0,
                    const __grid_constant__ CUtensorMap tx1,
                    const __grid_constant__ CUtensorMap tx2, const Args a) {
  using C = Cfg<P>;
  static_assert(P >= 1 && P <= 3, "x planes: 1 to 3");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * C::kStages];   // full, empty
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // generic view of base
  auto sW = [&](int s) { return base + s * C::kStage; };
  // panel p of plane `plane` of stage s
  auto sX = [&](int s, int plane, int p) {
    return sW(s) + C::kWTile + plane * C::kPlane + p * kPanel;
  };
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[C::kStages + s]); };

  const int m0 = blockIdx.x * kTok, n0 = blockIdx.y * kRows;
  const int n_k = a.n_k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // lane 0 of each warp of the consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---------------------------------------------------- producer --
    if (lane == 0) {
      for (int j = 0; j < n_k; ++j) {
        const int s = j % C::kStages;
        if (j >= C::kStages) mbar_wait(empty(s), (j / C::kStages - 1) & 1);
        mbar_arrive_expect_tx(full(s), C::kStage);
        const int k0 = j * C::kKc;
        tma_load_2d(sW(s), &tw, full(s), k0, n0);
#pragma unroll
        for (int p = 0; p < C::kKc / 64; ++p) {
          tma_load_2d(sX(s, 0, p), &tx0, full(s), k0 + 64 * p, m0);
          if (P > 1) tma_load_2d(sX(s, 1, p), &tx1, full(s), k0 + 64 * p, m0);
          if (P > 2) tma_load_2d(sX(s, 2, p), &tx2, full(s), k0 + 64 * p, m0);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  const int c = warp / 4;                 // stages c, c + 2, ...
  const int tid = threadIdx.x % kWG;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * w + g;              // weight rows r0 and r0 + 8
  const uint32_t sel = 0x7440u + 2u * (t & 1);
  // chunk kk of row r sits at chunk kk ^ (r % 8) of a 128-byte row, kk ^
  // ((r / 2) % 4) of a 64-byte one (rows r0 and r0 + 8 share it), and
  // the thread's bytes 2t, 2t + 1 (and 8 on) in the word at 4 (t / 2)
  constexpr int kSteps = C::kKc / 16;     // k16 steps a stage
  const int phase = C::kKc == 128 ? g : (g >> 1) & 3;
  const uint8_t* const wrow = gbase + r0 * C::kKc + 4 * (t >> 1);

  // acc: the products; for an fp32 x (P > 1) only the current stage's,
  // and sum the stages before it, added in fp32 (round to nearest) as
  // each stage's products complete
  float acc[32], sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sum[i] = 0.f;
  uint32_t af[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) af[kk][e] = 0u;

  int pending = -1;   // the slot an in-flight product still reads
  for (int j = c; j < n_k; j += kConsumers) {
    const int s = j % C::kStages;
    mbar_wait(full(s), (j / C::kStages) & 1);
    wgmma_wait<0>();                      // this warpgroup's last products
    reg_fence(acc);
    reg_fence(af);
    if (pending >= 0) {                   // their x planes are read
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(pending));
      if (P > 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] += acc[i];
      }
    }
    // the weight fragments of the stage's k16 steps
    const uint8_t* wt = wrow + (sW(s) - base);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint8_t* p0 = wt + ((kk ^ phase) << 4);
      const uint8_t* p1 = p0 + 8 * C::kKc;
      af[kk][0] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p0), sel);
      af[kk][1] = i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p1), sel);
      af[kk][2] =
          i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p0 + 8), sel);
      af[kk][3] =
          i8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p1 + 8), sel);
    }
    reg_fence(acc);
    reg_fence(af);
    wgmma_fence();
    // the smallest plane first; with P > 1 the first product starts acc
    // afresh
#pragma unroll
    for (int p = P - 1; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_rs_n64<0>(acc, af[kk],
                        desc_sw128(sX(s, p, kk / 4) + (kk % 4) * 32),
                        P == 1 || p < P - 1 || kk > 0);
    wgmma_commit();
    pending = s;
  }
  wgmma_wait<0>();
  reg_fence(acc);
  if (pending >= 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[i] += acc[i];
  }

  // --------------------------------------------------------- epilogue --
  // y tile [kTok][kYPitch] fp32 over stage 0: warpgroup 1 leaves its half
  // there, warpgroup 0 adds its own, then scales
  constexpr int kAll = kConsumers * kWG;
  named_bar_sync(1, kAll);                // every stage is free
  float* yt = reinterpret_cast<float*>(gbase);
  if (c == 1) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* p = yt + (8 * jj + 2 * t + e) * kYPitch + r0;
        p[0] = sum[4 * jj + e];
        p[8] = sum[4 * jj + 2 + e];
      }
  }
  named_bar_sync(1, kAll);
  if (c == 0) {
    const int n = n0 + r0;
    const float s0 = n < a.N ? __ldg(a.s + n) : 0.f;
    const float s1 = n + 8 < a.N ? __ldg(a.s + n + 8) : 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* p = yt + (8 * jj + 2 * t + e) * kYPitch + r0;
        p[0] = (sum[4 * jj + e] + p[0]) * s0;
        p[8] = (sum[4 * jj + 2 + e] + p[8]) * s1;
      }
  }
  named_bar_sync(1, kAll);
  const bool vec = a.N % 4 == 0;
  for (int e = threadIdx.x; e < kTok * (kRows / 4); e += kAll) {
    const int tok = e / (kRows / 4), q4 = e % (kRows / 4);
    const int m = m0 + tok, n = n0 + 4 * q4;
    if (m >= a.M || n >= a.N) continue;
    const float4 v4 =
        *reinterpret_cast<const float4*>(yt + tok * kYPitch + 4 * q4);
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const int live = min(4, a.N - n);
    if (P > 1) {
      if (a.b != nullptr)
        for (int i = 0; i < live; ++i) v[i] += __ldg(a.b + n + i);
      float* yr = static_cast<float*>(a.y) + (size_t)m * a.N + n;
      if (vec) {
        *reinterpret_cast<float4*>(yr) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int i = 0; i < live; ++i) yr[i] = v[i];
      }
    } else {
      __nv_bfloat16 o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = __float2bfloat16_rn(v[i]);
        if (a.b != nullptr && i < live)
          o[i] = __float2bfloat16_rn(__bfloat162float(o[i]) +
                                     __ldg(a.b + n + i));
      }
      __nv_bfloat16* yr =
          static_cast<__nv_bfloat16*>(a.y) + (size_t)m * a.N + n;
      if (vec) {
        uint2 pk;
        pk.x = (uint32_t)__bfloat16_as_ushort(o[0]) |
               ((uint32_t)__bfloat16_as_ushort(o[1]) << 16);
        pk.y = (uint32_t)__bfloat16_as_ushort(o[2]) |
               ((uint32_t)__bfloat16_as_ushort(o[3]) << 16);
        *reinterpret_cast<uint2*>(yr) = pk;
      } else {
        for (int i = 0; i < live; ++i) yr[i] = o[i];
      }
    }
  }
}

// ------------------------------------------------------------- launch --
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 2-D map of a row-major [rows, cols] matrix (row pitch `pitch`
// bytes): boxes of `box_cols` x `box_rows`; rows and columns past the
// edge read as zeros
int encode(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
           int rows, int cols, long long pitch, int box_cols, int box_rows,
           CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = enc(map, dt, 2, const_cast<void*>(ptr), dims, strides,
                           box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

// the 2-D map of a bf16 x plane [M, K]: boxes of 64 k x 64 tokens
int encode_x(CUtensorMap* map, const void* ptr, int M, int K) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, M, K, 2LL * K,
                64, kTok, CU_TENSOR_MAP_SWIZZLE_128B);
}

// raises a kernel instance's dynamic shared memory limit once per device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, std::atomic<uint64_t>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (set.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set.fetch_or(bit);
  return err;
}

// x's P bf16 planes, each [M, K], one after another from `planes`
template <int P>
int launch(const void* q, const __nv_bfloat16* planes, int K, Args a,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr int kKc = Cfg<P>::kKc;
  CUtensorMap mw, mx[3];
  int rc = encode(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.N, K, K, kKc,
                  kRows, kKc == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B);
  for (int i = 0; i < P && rc == 0; ++i)
    rc = encode_x(&mx[i], planes + (size_t)i * a.M * K, a.M, K);
  if (rc != 0) return rc;
  for (int i = P; i < 3; ++i) mx[i] = mx[0];   // unread
  a.n_k = (K + kKc - 1) / kKc;
  const int smem = Cfg<P>::kSmem;
  cudaError_t err = allow_smem(qmm_sm90_kernel<P>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.M + kTok - 1) / kTok, (a.N + kRows - 1) / kRows);
  qmm_sm90_kernel<P><<<grid, kThreads, smem, stream>>>(mw, mx[0], mx[1],
                                                       mx[2], a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [M, N] (x's dtype) = (x [M, K] @ q^T) * s [+ b]: x fp32 (x_bf16 = 0)
// or bf16, q [N, K] int8 rows, s [N] fp32, b [N] fp32 or null (for bf16
// x: values already rounded to bf16); for fp32 x, ws:
// pdt_quant_matmul_sm90_f32_planes() x M K bf16 (x's planes), else null.
// K a multiple of 16 (the int8 weight's row pitch in a TMA map); x, q and
// ws contiguous and 16-byte aligned (the wrapper checks). Launches on `stream`: for fp32 x the split, then the
// product.
int pdt_quant_matmul_sm90(const void* x, int x_bf16, const int8_t* q,
                          const float* s, const float* b, void* y, void* ws,
                          int M, int K, int N, int num_sms, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16 != 0 || (!x_bf16 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!x_bf16) {
    const size_t n4 = (size_t)M * K / 4;
    const size_t blocks = (n4 + 255) / 256;
    const unsigned grid = (unsigned)(blocks < (size_t)num_sms * 8
                                         ? blocks : (size_t)num_sms * 8);
    split_x_kernel<<<grid, 256, 0, st>>>(static_cast<const float4*>(x),
                                         static_cast<uint2*>(ws), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  Args a;
  a.s = s;
  a.b = b;
  a.y = y;
  a.M = M;
  a.N = N;
  return x_bf16
             ? launch<1>(q, static_cast<const __nv_bfloat16*>(x), K, a, st)
             : launch<kF32Planes>(q, static_cast<const __nv_bfloat16*>(ws),
                                  K, a, st);
}

// bf16 planes an fp32 x is split into (the workspace is that many M K)
int pdt_quant_matmul_sm90_f32_planes() { return kF32Planes; }

const char* pdt_quant_matmul_sm90_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
