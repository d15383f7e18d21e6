// Weight-only int8 matmul for Hopper (sm_90a), decode rows: y = (x @ q)
// * s [+ b] for an fp32 x of at most 16 rows, on the tensor cores.
//
// Replaces, with quant_matmul_sm90.cu (every other call), the Pallas TPU
// kernel `_pallas_matmul` / `_kernel` (paddle_tpu/ops/pallas/
// quant_matmul.py): x [M, K] fp32 times an int8 weight with one fp32
// scale per output channel, accumulated in fp32, the scale applied once
// per output element after the K reduction, then the bias. The weight
// arrives in the layout nn.Linear keeps, [N, K] (each output channel's K
// bytes contiguous); no float copy of it is ever written.
//
// What bounds it on an H100 at decode (M <= 16): the weight bytes, K N
// int8 read once (LLaMA-7B: 16.8 to 131 MB a call, 5 to 39 us at 3.35
// TB/s). An SM must then take in ~14.5 bytes a clock. On the CUDA cores
// every weight byte costs M fp32 FMAs, its conversion and reads of x from
// shared memory, ~10 lane-ops a byte at M = 8: more than the SM can
// issue. So the products run on the tensor cores, which leave the SM
// about three lane-ops a byte (the conversion), and the weight stream
// sets the pace.
//
// The product is computed transposed, Y^T [N, M] = W [N, K] X^T [K, M],
// with mma.sync m16n8k16 (bf16 in, fp32 out): 16 output channels are the
// A operand's rows, x^T the B operand (M <= 8 one n8 tile, 9..16 two).
// int8 -> bf16 is exact (a byte permute puts the byte under the exponent
// of 2^23, a subtraction leaves the integer, whose upper 16 bits are its
// bf16). An fp32 x enters as three bf16 planes, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), which keep its 24 bits.
//
// The weight goes from device memory straight into registers, 16-byte
// loads that skip L1 (the bytes are used once), in a ring of two 128-k
// chunks a warp: 16 rows x 128 bytes a chunk, the next chunk's loads in
// flight while one is converted and multiplied (three chunks, or 256-k
// chunks, measured no faster on the card). x's first loads go out before
// the weight's: queued behind the ring's loads they came back late, and
// every product waits for x (an L2 prefetch of the weight further ahead,
// rolling, only while x is staged, line by line or in bulk, measured
// slower on the card). No shared-memory ring: a lane's bytes are its A
// fragments. Within a 64-k block the order of the K sum is free, so the
// block's k are permuted: lane (g, t) of a warp (g = lane / 4, t = lane %
// 4) loads the 16 contiguous bytes 16 t .. 16 t + 15 of the block from
// rows g and g + 8 of its 16 (a warp's load: 64 contiguous bytes of 8
// rows, whole 32-byte sectors), and the word i of those (k16 step i) holds the
// fragment's logical k 2t, 2t+1, 2t+8, 2t+9. x's B fragments follow the
// same order: lane (g, t) needs x row g at the same 16 k of each block,
// so the CTA converts its K-slice of x once into planes laid out
// fragment by fragment in shared memory (16 bytes a lane, 512 a warp
// read, no bank conflicts) and every warp reads them there.
//
// Numbers as quant_matmul_sm90.cu found them on the card: the tensor
// cores' fp32 accumulator does not round each addition to nearest, so
// every 64-k block's products start a fresh accumulator, the smallest
// plane first (lo, mid, hi), and the blocks are added in fp32 registers
// in k order; the scale comes after the whole sum, then the bias.
//
// Work: a CTA (16 warps, a warp 16 channels) owns 256 output channels
// and a K-slice. Where N / 256 row blocks do not fill the SMs, K is cut
// into `splits` slices of whole 64-k blocks (the wrapper's plan,
// quant_matmul.gemv_plan), one CTA each; every CTA writes its partial
// sums, and the last CTA of a row block to finish (a __threadfence, then
// an atomic ticket that it resets) adds the slices in slice order,
// scales, adds the bias and writes y. No atomics on y: two calls on the
// same inputs give the same bits. x is converted only for the CTA's own
// K-slice and rows (M / 256 of its weight work in conversions), in
// phases of at most kSmemBudget of shared memory, the next chunk's weight
// loads already in flight across each phase's barriers. K not a multiple of 16
// (rows not 16-byte aligned) takes byte loads; K and N need not be
// multiples of anything.
//
// Plain C interface (bound with ctypes); the wrapper in quant_matmul.py
// checks shapes, types and contiguity, plans the splits and allocates
// the output and the split scratch. The launcher returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // output channels a CTA
constexpr int kBlock = 64;           // k of a fresh accumulator; split unit
constexpr int kPB = 2;               // 64-k blocks of a chunk
constexpr int kChunk = kPB * kBlock; // k of a warp's 16-row load step
constexpr int kPlanes = 3;           // bf16 planes of an fp32 x
constexpr int kSmemBudget = 192 * 1024;
constexpr int kReduceBatch = 8;      // split partials a thread loads at once

struct Args {
  const float* x;     // [M, K]
  const int8_t* q;    // [N, K]
  const float* s;     // [N]
  const float* b;     // [N] or null
  float* y;           // [M, N]
  float* part;        // [splits, M, N] when splits > 1
  int* tickets;       // [row blocks], zero between launches
  int M, K, N, splits, kblocks, phase;   // phase: k staged at once
};

// A weight load that is used once: stream it past L1.
__device__ __forceinline__ int4 ld_stream16(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 weight bytes of `row` from k on (zeros past k1 or for a row past N).
// VEC: K % 16 == 0, so a piece lies wholly before k1 or past it.
template <bool VEC>
__device__ __forceinline__ int4 load_piece(const int8_t* row, int k, int k1, bool ok) {
  if (VEC) return ok && k < k1 ? ld_stream16(row + k) : make_int4(0, 0, 0, 0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (ok) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < k1) w[i / 4] |= (uint32_t)(uint8_t)__ldg(row + k + i) << (8 * (i % 4));
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// Bytes sel - 0x7440 and the next of u (= w ^ 0x80808080) as a bf16 pair,
// the lower byte in the low half: exact (see the header).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t u, uint32_t sel) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b: a the 16x16 bf16 A fragment, (b0, b1) the 16x8 B fragment.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte slot of x's planes that lane `lane` reads for chunk c (of
// the phase), its block h, plane p, n8 tile nt, step pair q (the block's
// steps 2q and 2q + 1): slots of one (c, h, p, nt, q) are a warp's 512
// bytes.
template <int NT>
__device__ __forceinline__ int slot(int c, int h, int p, int nt, int q, int lane) {
  return ((((c * kPB + h) * kPlanes + p) * NT + nt) * 2 + q) * 32 + lane;
}

// 8 consecutive k of x row m from k on (zeros from M or k1 on).
__device__ __forceinline__ void load8(float (&v)[8], const Args& a, int m, int k, int k1) {
  const float* xr = a.x + (size_t)m * a.K + k;
  if (m < a.M && a.K % 4 == 0 && k + 8 <= k1) {
    const float4 u0 = __ldg(reinterpret_cast<const float4*>(xr));
    const float4 u1 = __ldg(reinterpret_cast<const float4*>(xr) + 1);
    v[0] = u0.x, v[1] = u0.y, v[2] = u0.z, v[3] = u0.w;
    v[4] = u1.x, v[5] = u1.y, v[6] = u1.z, v[7] = u1.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = m < a.M && k + i < k1 ? __ldg(xr + i) : 0.f;
  }
}

// x rows [0, M), k [kb, kb + len) (zero from k1 on), into the
// fragment-ordered planes (rows M .. 8 NT - 1 are never read: their B
// fragments are zeros in registers): a thread takes 8 consecutive k of a
// row, one slot of each plane, kStageBatch such groups' loads in flight
// at once; with `have_first`, `first` holds the thread's first group,
// loaded already (stage_first).
constexpr int kStageBatch = 1;

__device__ __forceinline__ int stage_groups(int len) {
  return (len + kChunk - 1) / kChunk * (kChunk / 8);
}

__device__ __forceinline__ void stage_first(float (&v)[8], const Args& a, int kb, int len,
                                            int k1) {
  const int groups = stage_groups(len), e = threadIdx.x, m = e / groups;
  if (e < a.M * groups) load8(v, a, m, kb + 8 * (e - m * groups), k1);
}

template <int NT>
__device__ __forceinline__ void stage_x(uint4* xs, const Args& a, int kb, int len, int k1,
                                        const float (&first)[8], bool have_first) {
  const int groups = stage_groups(len);
  const int total = a.M * groups;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kStageBatch) {
    float v[kStageBatch][8];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads, m = e / groups;
      if (e >= total) break;
      if (u == 0 && have_first && e0 == threadIdx.x) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = first[i];
      } else {
        load8(v[u], a, m, kb + 8 * (e - m * groups), k1);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads, m = e / groups, kk = 8 * (e - m * groups);
      if (e >= total) break;
      const int c = kk / kChunk, r = kk % kChunk;
      const int h = r / kBlock, t = (r % kBlock) / 16, q = (r / 8) & 1;
      const int lane = (m % 8) * 4 + t;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = pack_bf16(v[u][2 * i], v[u][2 * i + 1]);
          v[u][2 * i] -= __uint_as_float(w[i] << 16);
          v[u][2 * i + 1] -= __uint_as_float(w[i] & 0xFFFF0000u);
        }
        xs[slot<NT>(c, h, p, m / 8, q, lane)] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// NT: n8 tiles of x rows (M <= 8 NT); VEC: K % 16 == 0; STAGES: 128-k
// chunks of the ring a warp keeps in registers.
template <int NT, bool VEC, int STAGES>
__global__ void __launch_bounds__(kThreads, 1) gemv_tc_kernel(const Args a) {
  extern __shared__ __align__(16) uint4 xs[];
  __shared__ int is_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int kb0 = (int)((long long)split * a.kblocks / a.splits);
  const int kb1 = (int)((long long)(split + 1) * a.kblocks / a.splits);
  const int k0 = kb0 * kBlock, k1 = min(kb1 * kBlock, a.K);
  const int nchunks = (k1 - k0 + kChunk - 1) / kChunk;
  const int rA = rb * kRows + warp * 16 + g, rB = rA + 8;
  const bool okA = rA < a.N, okB = rB < a.N;
  const int8_t* wA = a.q + (size_t)(okA ? rA : 0) * a.K + 16 * t;
  const int8_t* wB = a.q + (size_t)(okB ? rB : 0) * a.K + 16 * t;
  const int pc = a.phase / kChunk;   // chunks a phase

  // ring[s]: the lane's 16 bytes of each 64-k block of a chunk, row A's
  // blocks then row B's
  int4 ring[STAGES][2 * kPB];
  float x0[8];   // x's first group of this thread, asked for first
  stage_first(x0, a, k0, min(a.phase, k1 - k0), k1);
  auto load = [&](int4 (&r)[2 * kPB], int c) {
    const int k = k0 + c * kChunk;
    const bool live = c < nchunks;
#pragma unroll
    for (int h = 0; h < kPB; ++h) {
      r[h] = load_piece<VEC>(wA, k + h * kBlock, k1 - 16 * t, live && okA);
      r[kPB + h] = load_piece<VEC>(wB, k + h * kBlock, k1 - 16 * t, live && okB);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(ring[s], s);

  float sum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nt][e] = 0.f;

  for (int c0 = 0; c0 < nchunks; c0 += STAGES) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      const int c = c0 + s;
      if (c >= nchunks) break;
      if (c % pc == 0) {   // a new phase of x: every warp reaches it
        if (c > 0) __syncthreads();
        stage_x<NT>(xs, a, k0 + c * kChunk, min(a.phase, k1 - k0 - c * kChunk), k1, x0,
                    c == 0);
        __syncthreads();
      }
      load(ring[(s + STAGES - 1) % STAGES], c + STAGES - 1);
      const int cl = c % pc;
#pragma unroll
      for (int h = 0; h < kPB; ++h) {
        // the A fragments of block h's steps: word i of its pieces
        const int4 pa = ring[s][h], pb = ring[s][kPB + h];
        const uint32_t ua[4] = {(uint32_t)pa.x ^ 0x80808080u, (uint32_t)pa.y ^ 0x80808080u,
                                (uint32_t)pa.z ^ 0x80808080u, (uint32_t)pa.w ^ 0x80808080u};
        const uint32_t ub[4] = {(uint32_t)pb.x ^ 0x80808080u, (uint32_t)pb.y ^ 0x80808080u,
                                (uint32_t)pb.z ^ 0x80808080u, (uint32_t)pb.w ^ 0x80808080u};
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          af[i][0] = i8x2_to_bf16x2(ua[i], 0x7440u);
          af[i][1] = i8x2_to_bf16x2(ub[i], 0x7440u);
          af[i][2] = i8x2_to_bf16x2(ua[i], 0x7442u);
          af[i][3] = i8x2_to_bf16x2(ub[i], 0x7442u);
        }
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int p = kPlanes - 1; p >= 0; --p)   // lo, mid, hi
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const bool live = 8 * nt + g < a.M;   // x rows past M: zeros
            const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
            const uint4 u0 = live ? xs[slot<NT>(cl, h, p, nt, 0, lane)] : zero;
            const uint4 u1 = live ? xs[slot<NT>(cl, h, p, nt, 1, lane)] : zero;
            mma(acc[nt], af[0], u0.x, u0.y);
            mma(acc[nt], af[1], u0.z, u0.w);
            mma(acc[nt], af[2], u1.x, u1.y);
            mma(acc[nt], af[3], u1.z, u1.w);
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[nt][e] += acc[nt][e];
      }
    }
  }

  // sum[nt][e]: channel rA (e < 2) or rB, x row 8 nt + 2 t + e % 2
  const bool one = a.splits == 1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * nt + 2 * t + (e & 1), n = e < 2 ? rA : rB;
      if (m >= a.M || n >= a.N) continue;
      if (one) {
        float v = sum[nt][e] * __ldg(a.s + n);
        if (a.b != nullptr) v += __ldg(a.b + n);
        a.y[(size_t)m * a.N + n] = v;
      } else {
        a.part[((size_t)split * a.M + m) * a.N + n] = sum[nt][e];
      }
    }
  if (one) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.tickets + rb, 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  // the last CTA of the row block: the slices in order, the scale, the bias
  __threadfence();
  // (a float4 of channels a thread where N % 4 == 0; each batch's loads
  // in flight together, the adds in slice order)
  const int vw = a.N % 4 == 0 ? 4 : 1;
  const size_t step = (size_t)a.M * a.N;
  for (int e = threadIdx.x; e < a.M * kRows / vw; e += kThreads) {
    const int m = e / (kRows / vw), n = rb * kRows + vw * (e % (kRows / vw));
    if (n >= a.N) continue;
    const float* p = a.part + (size_t)m * a.N + n;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < a.splits; s0 += kReduceBatch) {
      float4 t[kReduceBatch];
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j) {
        const float* q = p + (s0 + j) * step;
        if (s0 + j >= a.splits) break;
        t[j] = vw == 4 ? __ldcg(reinterpret_cast<const float4*>(q))
                       : make_float4(__ldcg(q), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j) {
        if (s0 + j >= a.splits) break;
        v[0] += t[j].x, v[1] += t[j].y, v[2] += t[j].z, v[3] += t[j].w;
      }
    }
    for (int i = 0; i < vw; ++i) {
      float o = v[i] * __ldg(a.s + n + i);
      if (a.b != nullptr) o += __ldg(a.b + n + i);
      a.y[(size_t)m * a.N + n + i] = o;
    }
  }
  if (threadIdx.x == 0) a.tickets[rb] = 0;
}

template <int NT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int kStages = 2;
  auto kernel = gemv_tc_kernel<NT, VEC, kStages>;
  // the longest slice, in whole chunks, staged in phases of a.phase
  const int longest = (a.kblocks + a.splits - 1) / a.splits * kBlock;
  const int staged = min(a.phase, (longest + kChunk - 1) / kChunk * kChunk);
  const size_t smem = (size_t)staged * 8 * NT * kPlanes * 2;   // bf16 planes
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.N + kRows - 1) / kRows;
  kernel<<<blocks * a.splits, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Channels of one CTA and k of one split unit (quant_matmul.gemv_plan).
int pdt_quant_matmul_gemv_rows() { return kRows; }
int pdt_quant_matmul_gemv_block() { return kBlock; }

// y [M, N] = (x [M, K] @ q^T) * s [+ b] for 1 <= M <= 16, q [N, K] int8
// rows, s [N] fp32, b [N] fp32 or null, K cut into `splits` slices of
// whole 64-k blocks; part [splits, M, N] floats and tickets [ceil(N /
// 256)] ints (zero, and left zero) when splits > 1. x 16-byte aligned; q
// too when K % 16 == 0. Launch on `stream` (a cudaStream_t); returns a
// cudaError_t as int (cudaErrorInvalidValue for M > 16 or a bad split).
int pdt_quant_matmul_f32(const float* x, const int8_t* q, const float* s, const float* b,
                         float* y, float* part, int* tickets, int M, int K, int N,
                         int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int kblocks = (K + kBlock - 1) / kBlock;
  if (M > 16 || K <= 0 || splits < 1 || splits > kblocks) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const int nt = M <= 8 ? 1 : 2;
  // the k a phase stages: the most that fits kSmemBudget, whole chunks
  const int phase = kSmemBudget / (8 * nt * kPlanes * 2) / kChunk * kChunk;
  const Args a{x, q, s, b, y, part, tickets, M, K, N, splits, kblocks, phase};
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = K % 16 == 0;
  if (nt == 1) return (int)(vec ? launch<1, true>(a, st) : launch<1, false>(a, st));
  return (int)(vec ? launch<2, true>(a, st) : launch<2, false>(a, st));
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
