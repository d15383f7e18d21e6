// Fused decode egress for Hopper (sm_90a), three kernels:
//
// * fused_decode_mlp: the attention out-projection and its residual,
//   LayerNorm, fc1, tanh-GELU, fc2 and the second residual of one decode
//   layer, in one launch. Replaces `_mlp_block` (arch="gpt") run by
//   `_blocked_call` (paddle_tpu/ops/pallas/fused_decode_mlp.py):
//     y1 = x + (att @ wo + bo);  out = y1 + (gelu(norm(y1) @ w1 + b1) @ w2 + b2).
//   Its tensor-parallel partial mode replaces `_mlp_partial_block`
//   (fused_decode_mlp_partial, same file) for GPT: y1 given, no first
//   phase, no fc2 bias, no residual: the partial sum before the layer's
//   all-reduce.
// * swiglu_kernel: the same layer for arch="llama" (`_mlp_tail`'s SwiGLU
//   branch), LayerNorm or RMSNorm,
//     y1 = x + (att @ wo + bo);  h = norm(y1);
//     out = y1 + ((silu(h @ wg) * (h @ wu)) @ wd + b2),
//   and its partial mode (`_mlp_partial_block` for LLaMA): out =
//   (silu(h @ wg) * (h @ wu)) @ wd with a rank's slices, y1 given. One
//   weight stream with split K; its design is written above it.
// * fused_decode_epilogue: the final LayerNorm or RMSNorm, the LM head
//   and the guarded greedy pick, in one launch. Replaces
//   `_epilogue_block` (same file): logits = norm(x) @ w_lm^T (+ b_lm),
//   then with lg = logits + poison, bad = any non-finite lg in the row,
//   nxt = bad ? 0 : the FIRST index of the row's maximum
//   (generation.guarded_argmax).
//
// What bounds them on an H100: the weight bytes. At decode the batch is a
// few rows, so each product is a GEMV over a weight read once: 21.2 MB a
// layer for the MLP kernel at GPT-124M (~6.4 us at 3.35 TB/s) and the
// 154.5 MB tied embedding for the epilogue (~46 us). The TPU kernels walk
// row blocks of one grid with the weights resident in VMEM; one SM pulling
// those bytes would take hundreds of microseconds, so here the output
// columns of every product are spread over all SMs (decode_gemv.cuh: a
// warp per column or a few neighbouring ones, whole [out, in] weight rows
// with 16-byte loads after an L2 prefetch issued at kernel start,
// activation rows in shared memory).
//
// The MLP's three products depend on each other across columns (fc1 needs
// every column of y1, fc2 every column of f), so both MLP kernels are
// cooperative launches, their grid capped by the occupancy API so that
// all CTAs are resident, with a grid barrier (cooperative_groups
// this_grid().sync()) between the products; y1 [B, H] and f [B, I] pass
// through a global scratch that stays in L2. A refused cooperative launch
// returns its error and the wrapper raises: there is no fallback.
//
// The epilogue's argmax reduces across CTAs: each CTA writes its logits
// and, per row, the (max, first index, all-finite) of its columns; the
// last CTA to finish (a __threadfence, then an atomic ticket) reduces
// those partials, ties going to the lower index, and resets the ticket
// for the next launch. One launch, on one stream at a time per ticket.
//
// fp32 FMAs on the CUDA cores (at 8 rows they are not the limit). Plain C
// interface (bound with ctypes); the wrappers in
// fused_decode_mlp.py check shapes, types and contiguity and allocate the
// outputs and the scratch.

#include <cooperative_groups.h>

#include "decode_gemv.cuh"

namespace {

namespace cg = cooperative_groups;
using decode::kRowTile;
using decode::kThreads;
using decode::kWarps;

constexpr int kEpiColsPerCta = 64;   // vocab columns of one epilogue CTA
constexpr int kEpiGroup = 4;         // columns a warp dots at once

__device__ inline float gelu_tanh(float v) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (v + kKappa * (v * v * v));
  return 0.5f * v * (1.f + tanhf(inner));
}

struct MlpParams {
  const float* x;      // [B, H] residual stream
  const float* att;    // [B, A] attention output
  const float* wo;     // [H, A]
  const float* bo;     // [H] or null
  const float* nw;     // [H]
  const float* nb;     // [H] or null
  const float* w1;     // [I, H]
  const float* b1;     // [I] or null
  const float* w2;     // [H, I]
  const float* b2;     // [H] or null
  float* y1;           // [B, H] scratch
  float* f;            // [B, I] scratch
  float* out;          // [B, H]
  int B, H, A, I;
  float eps;
  int partial;         // y1 given: no phase 1, no fc2 bias, no residual
};

// One phase: for every output column n of this warp (grid-strided), every
// row b: dst[b, n] = epi(b, n, dot(s[b], w[n]) + bias[n]).
template <typename Epi>
__device__ inline void gemv_phase(const float* s, const float* __restrict__ w,
                                  const float* __restrict__ bias, int B, int K,
                                  int N, Epi epi) {
  const int lane = threadIdx.x % 32;
  const int gwarp = (int)blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = (int)gridDim.x * kWarps;
  for (int n = gwarp; n < N; n += nwarps) {
    const float bn = bias != nullptr ? __ldg(bias + n) : 0.f;
    for (int r0 = 0; r0 < B; r0 += kRowTile) {
      const int nr = min(kRowTile, B - r0);
      float acc[kRowTile];
      decode::warp_dot_rows(w + (size_t)n * K, s + (size_t)r0 * K, K, nr, acc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r < nr && lane == r) epi(r0 + r, n, bias != nullptr ? acc[r] + bn : acc[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_decode_mlp_kernel(MlpParams p) {
  extern __shared__ __align__(16) float s[];   // [B, max(A, H, I)]
  cg::grid_group grid = cg::this_grid();
  // ask the L2 now for every weight row this warp will read in the three
  // phases (21 MB at GPT-124M: they fit), so the barriers and the
  // activation loads overlap the fetch
  {
    const int gwarp = (int)blockIdx.x * kWarps + threadIdx.x / 32;
    const int nwarps = (int)gridDim.x * kWarps;
    for (int n = gwarp; n < p.H; n += nwarps) {
      if (!p.partial) decode::prefetch_row_l2(p.wo + (size_t)n * p.A, p.A);
      decode::prefetch_row_l2(p.w2 + (size_t)n * p.I, p.I);
    }
    for (int n = gwarp; n < p.I; n += nwarps)
      decode::prefetch_row_l2(p.w1 + (size_t)n * p.H, p.H);
  }

  // phase 1: y1 = x + (att @ wo^T + bo); the partial mode is given y1
  if (!p.partial) {
    decode::load_rows(s, p.att, p.B, p.A);
    __syncthreads();
    gemv_phase(s, p.wo, p.bo, p.B, p.A, p.H, [&](int b, int n, float v) {
      p.y1[(size_t)b * p.H + n] = p.x[(size_t)b * p.H + n] + v;
    });
    grid.sync();
  }

  // phase 2: f = gelu(norm(y1) @ w1^T + b1)
  decode::load_rows(s, p.y1, p.B, p.H);
  decode::layer_norm_rows(s, p.nw, p.nb, p.B, p.H, p.eps);
  gemv_phase(s, p.w1, p.b1, p.B, p.H, p.I, [&](int b, int n, float v) {
    p.f[(size_t)b * p.I + n] = gelu_tanh(v);
  });
  grid.sync();

  // phase 3: out = y1 + (f @ w2^T + b2); the partial mode: f @ w2^T
  decode::load_rows(s, p.f, p.B, p.I);
  __syncthreads();
  gemv_phase(s, p.w2, p.b2, p.B, p.I, p.H, [&](int b, int n, float v) {
    p.out[(size_t)b * p.H + n] = p.partial ? v : p.y1[(size_t)b * p.H + n] + v;
  });
}

struct EpiParams {
  const float* x;        // [B, H]
  const float* nw;       // [H]
  const float* nb;       // [H] or null
  const float* w;        // [V, H]
  const float* bias;     // [V] or null
  const float* poison;   // [B]
  float* logits;         // [B, V], pre-poison
  float* part_val;       // [grid, B] scratch
  int* part_idx;         // [grid, B]
  int* part_fin;         // [grid, B]
  unsigned* ticket;      // zero between launches
  long long* nxt;        // [B]
  unsigned char* bad;    // [B] (torch.bool)
  int B, H, V;
  float eps;
};

// (value, index, finite) merge: the larger value wins, a tie goes to the
// lower index; finite is the AND of both.
__device__ inline void merge(float& v, int& i, int& fin, float v2, int i2, int fin2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
  fin = fin && fin2;
}

template <bool kRms>
__global__ void __launch_bounds__(kThreads)
fused_decode_epilogue_kernel(EpiParams p) {
  extern __shared__ __align__(16) float hs[];   // [B, H], then partials
  float* wval = hs + (size_t)p.B * p.H;         // [kWarps, B]
  int* widx = reinterpret_cast<int*>(wval + kWarps * p.B);
  int* wfin = widx + kWarps * p.B;
  __shared__ int is_last;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (int)blockIdx.x * kEpiColsPerCta;
  const int n_end = min(p.V, n0 + kEpiColsPerCta);
  // the first row of each warp only: all resident CTAs' whole slabs
  // would overflow the L2 before they are read
  decode::prefetch_rows_l2(p.w, p.H, n0, min(n_end, n0 + kWarps));
  for (int e = threadIdx.x; e < kWarps * p.B; e += blockDim.x) {
    wval[e] = -INFINITY;
    widx[e] = 0x7fffffff;
    wfin[e] = 1;
  }
  decode::load_rows<1>(hs, p.x, p.B, p.H);
  if constexpr (kRms)
    decode::rms_norm_rows(hs, p.nw, p.nb, p.B, p.H, p.eps);
  else
    decode::layer_norm_rows(hs, p.nw, p.nb, p.B, p.H, p.eps);

  // this CTA's columns: logits out, and each warp's running (max, index,
  // finite) per row, kept by the lane that owns the row. A warp dots
  // kEpiGroup neighbouring columns at once (decode::warp_dot_multi), which
  // cuts the shared-memory reads per weight byte kEpiGroup-fold: at
  // LLaMA-7B's 8 rows of 4096 the CTA's 128 KB of rows leave one CTA an
  // SM, whose shared memory would otherwise bound it.
  for (int c0 = n0 + warp * kEpiGroup; c0 < n_end; c0 += kWarps * kEpiGroup) {
    const float* rows[kEpiGroup];
#pragma unroll
    for (int i = 0; i < kEpiGroup; ++i)
      rows[i] = p.w + (size_t)min(c0 + i, n_end - 1) * p.H;
    for (int r0 = 0; r0 < p.B; r0 += kRowTile) {
      const int nr = min(kRowTile, p.B - r0);
      float acc[kEpiGroup][kRowTile];
      decode::warp_dot_multi<kEpiGroup>(rows, hs + (size_t)r0 * p.H, p.H, nr, acc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r >= nr || lane != r) continue;
        const int b = r0 + r;
#pragma unroll
        for (int i = 0; i < kEpiGroup; ++i) {
          const int n = c0 + i;
          if (n >= n_end) break;
          const float lg0 = p.bias != nullptr ? acc[i][r] + __ldg(p.bias + n)
                                              : acc[i][r];
          p.logits[(size_t)b * p.V + n] = lg0;
          const float lg = lg0 + __ldg(p.poison + b);
          const int e = warp * p.B + b;
          merge(wval[e], widx[e], wfin[e], lg, n, isfinite(lg) ? 1 : 0);
        }
      }
    }
  }
  __syncthreads();

  // this CTA's partial per row, then the ticket
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) {
    float v = wval[b];
    int i = widx[b], fin = wfin[b];
    for (int w = 1; w < kWarps; ++w)
      merge(v, i, fin, wval[w * p.B + b], widx[w * p.B + b], wfin[w * p.B + b]);
    const size_t o = (size_t)blockIdx.x * p.B + b;
    p.part_val[o] = v;
    p.part_idx[o] = i;
    p.part_fin[o] = fin;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // the last CTA: reduce every CTA's partial, a warp per row
  __threadfence();
  for (int b = warp; b < p.B; b += kWarps) {
    float v = -INFINITY;
    int i = 0x7fffffff, fin = 1;
    for (int c = lane; c < (int)gridDim.x; c += 32) {
      const size_t o = (size_t)c * p.B + b;
      merge(v, i, fin, __ldcg(p.part_val + o), __ldcg(p.part_idx + o),
            __ldcg(p.part_fin + o));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
      const int f2 = __shfl_xor_sync(0xffffffffu, fin, off);
      merge(v, i, fin, v2, i2, f2);
    }
    if (lane == 0) {
      p.nxt[b] = fin ? (long long)i : 0;
      p.bad[b] = fin ? 0 : 1;
    }
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
}


// Cooperative launch of the GELU MLP kernel, full or partial; returns a
// cudaError_t.
cudaError_t launch_mlp(MlpParams p, size_t smem, cudaStream_t stream) {
  cudaError_t err = decode::allow_smem(fused_decode_mlp_kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_decode_mlp_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // enough warps for the widest phase, no more CTAs than can be resident
  const int widest = p.H > p.I ? p.H : p.I;
  int grid = (widest + kWarps - 1) / kWarps;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_decode_mlp_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one MLP CTA, in bytes.
size_t pdt_fused_decode_mlp_smem_bytes(int B, int H, int A, int I) {
  const int k = A > H ? (A > I ? A : I) : (H > I ? H : I);
  return (size_t)B * k * sizeof(float);
}

// Dynamic shared memory of one epilogue CTA, in bytes.
size_t pdt_fused_decode_epilogue_smem_bytes(int B, int H) {
  return ((size_t)B * H + 3 * (size_t)kWarps * B) * sizeof(float);
}

// CTAs of one epilogue launch (the length of its partial scratch).
int pdt_fused_decode_epilogue_grid(int V) {
  return (V + kEpiColsPerCta - 1) / kEpiColsPerCta;
}

// Cooperative launch on `stream`; returns a cudaError_t as int.
int pdt_fused_decode_mlp_f32(const float* x, const float* att, const float* wo,
                             const float* bo, const float* nw, const float* nb,
                             const float* w1, const float* b1, const float* w2,
                             const float* b2, float* y1, float* f, float* out, int B,
                             int H, int A, int I, float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  MlpParams p{x, att, wo, bo, nw, nb, w1, b1, w2, b2, y1, f, out, B, H, A, I, eps, 0};
  return (int)launch_mlp(p, pdt_fused_decode_mlp_smem_bytes(B, H, A, I),
                         (cudaStream_t)stream);
}

// The partial mode (fused_decode_mlp_partial): y1 [B, H] given, w1 [I, H]
// and w2 [H, I] a rank's slices; out = gelu(norm(y1) @ w1^T + b1) @ w2^T.
// Cooperative launch on `stream`; returns a cudaError_t as int.
int pdt_fused_decode_mlp_partial_f32(const float* y1, const float* nw, const float* nb,
                                     const float* w1, const float* b1, const float* w2,
                                     float* f, float* out, int B, int H, int I,
                                     float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  MlpParams p{nullptr, nullptr, nullptr, nullptr, nw, nb, w1, b1, w2, nullptr,
              const_cast<float*>(y1), f, out, B, H, 0, I, eps, 1};
  return (int)launch_mlp(p, pdt_fused_decode_mlp_smem_bytes(B, H, 0, I),
                         (cudaStream_t)stream);
}

// Launch on `stream`; returns a cudaError_t as int. `ticket` must be 0.
// `rms`: RMSNorm, else LayerNorm.
int pdt_fused_decode_epilogue_f32(const float* x, const float* nw, const float* nb,
                                  const float* w, const float* bias,
                                  const float* poison, float* logits, float* part_val,
                                  int* part_idx, int* part_fin, unsigned* ticket,
                                  long long* nxt, unsigned char* bad, int B, int H,
                                  int V, float eps, int rms, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  EpiParams p{x, nw, nb, w, bias, poison, logits, part_val, part_idx, part_fin,
              ticket, nxt, bad, B, H, V, eps};
  const size_t smem = pdt_fused_decode_epilogue_smem_bytes(B, H);
  auto kernel = rms ? fused_decode_epilogue_kernel<true>
                    : fused_decode_epilogue_kernel<false>;
  cudaError_t err = decode::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<pdt_fused_decode_epilogue_grid(V), kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

__device__ inline float silu(float v) { return v / (1.f + expf(-v)); }

// ---------------------------------------------------------------------------
// swiglu_kernel: the LLaMA egress (row 5), y1 = x + (att @ wo^T + bo);
// out = y1 + ((silu(h @ wg^T) * (h @ wu^T)) @ wd^T + b2) with h =
// norm(y1), and its tensor-parallel partial mode (row 6, y1 given, a
// rank's slices, out = the last product alone), as one unbroken weight
// stream. At LLaMA-7B a call reads 608 MB (row 5; 0.18 ms at 3.35 TB/s)
// or 270 MB (row 6 at TP=2; 81 us); fp32 FMAs on the CUDA cores are 2 a
// weight byte at 8 rows, far from the SM's rate, so the design is of the
// memory pipeline:
//
// * Fixed, even slices. Each product's K is cut into slices of at most
//   kSliceQ float4s (out projection: A / 512, gate/up: H / 512, down: I /
//   512), and the grid's CTAs into that many groups: CTA c takes slice c %
//   S of one block of about N / (grid / S) columns, so every CTA streams
//   the same bytes (+-1 column) and every warp the same number of items
//   (+-1). An item is two weight rows over the slice (a column's gate and
//   up rows; two neighbouring out-projection or down columns), kQ 16-byte
//   loads a row a lane, past L1.
// * No reloads. A CTA stages its activation slice in shared memory once
//   (for the gate/up product under an RMSNorm without bias, y1 * w: the
//   row's 1 / rms multiplies the finished sums, from the slices' sums of
//   squares; any other norm is applied on the way from full-row
//   statistics), its warps dot the items against it, RT rows at once in
//   registers, and a transposed butterfly leaves each lane one (row,
//   weight row) total. A slice's sums go to a global scratch; the S CTAs
//   of a column block count their arrivals and, once all are in (every
//   CTA is resident: a cooperative launch), each adds the slices in slice
//   order for its 1/S of the block's outputs (one round trip to L2, where
//   one CTA doing it all took several), so two calls give the same bits, and
//   finishes them there, once: y1 with x and bo, silu(g) * u, or out
//   (with b2 and y1 in row 5).
// * The stream does not wait. A warp keeps the next item's weights in
//   registers while it computes the current one: the next product's first
//   items are in flight before each grid barrier, and land while the sums
//   finish and the grid waits. The first activation row's loads go out
//   before the first weights' (behind them they came back late, and every
//   product waits for them). (An L2 prefetch of the items beyond,
//   rolling or only where the stream would idle, measured slower on the
//   card.)
//
// One cooperative launch, its grid every CTA the occupancy API lets be
// resident (two an SM at LLaMA-7B), capped by the work; a refused launch
// returns its error and the wrapper raises.

constexpr int kSwThreads = 256;
constexpr int kSwWarps = kSwThreads / 32;
constexpr int kSliceQ = 128;              // float4s of a K-slice, at most
constexpr int kQ = kSliceQ / 32;          // float4s of a weight row a lane loads
constexpr int kBuf = 2;                   // items a warp holds in registers
constexpr int kReduceBatch = 8;           // slice sums of an output loaded at once

struct SwigluParams {
  const float* x;      // [B, H] residual stream (row 5)
  const float* att;    // [B, A] attention output (row 5)
  const float* wo;     // [H, A] out projection (row 5)
  const float* bo;     // [H] or null
  const float* nw;     // [H]
  const float* nb;     // [H] or null
  const float* wg;     // [I, H] gate
  const float* wu;     // [I, H] up
  const float* wd;     // [H, I] down
  const float* b2;     // [H] or null (row 5)
  float* y1;           // [B, H]: written by the out projection (row 5), else given
  float* part0;        // [S0, B, H] out-projection slice sums (row 5)
  float* part_a;       // [SA, 2, B, I] gate and up slice sums
  float* part_b;       // [SB, B, H] down slice sums
  float* ss;           // [CA, SA, B] slice sums of squares (fast path)
  float* f;            // [B, I] silu(g) * u
  float* out;          // [B, H]
  unsigned* tickets;   // [C0 + CA + CB] arrival counts
  int B, H, A, I, S0, SA, SB, C0, CA, CB, rows;   // rows: B rounded up to RT
  int rms, fast;       // fast: RMSNorm without bias, 1 / rms factored out
  float eps;
};

// A weight float4 that is used once: stream it past L1.
__device__ __forceinline__ float4 ld_stream4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 w, float acc) {
  acc = fmaf(a.x, w.x, acc);
  acc = fmaf(a.y, w.y, acc);
  acc = fmaf(a.z, w.z, acc);
  return fmaf(a.w, w.w, acc);
}

// The warp's totals of V values (V a power of two, 2 to 32): each
// exchange halves the values a lane keeps, so lane l ends with the total
// of value l / (32 / V) after 5 + V - 1 - log2(V) shuffles (V = 8: 10,
// against 40 for a butterfly a value). A fixed order: the same bits on
// every call.
template <int V>
__device__ __forceinline__ float warp_sum_transposed(float (&v)[V]) {
  const int lane = threadIdx.x % 32;
  int m = 16;
#pragma unroll
  for (int n = V; n > 1; n >>= 1, m >>= 1) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  float r = v[0];
  for (; m >= 1; m >>= 1) r += __shfl_xor_sync(0xffffffffu, r, m);
  return r;
}

// Part s of n units cut into S parts (the first index of the part).
__device__ __forceinline__ int cut(int s, int n, int S) {
  return (int)((long long)s * n / S);
}

// A product's share of this CTA: K-slice s of its float4s [q0, q1) and
// columns [n0, n1) of column block cb (none where the CTA has no share).
struct Share {
  bool in;
  int s, cb, q0, q1, n0, n1;
};

__device__ __forceinline__ Share share_of(int K4, int N, int S, int C) {
  Share r{false, 0, 0, 0, 0, 0, 0};
  if (S == 0 || (int)blockIdx.x >= C * S) return r;
  r.in = true;
  r.s = blockIdx.x % S;
  r.cb = blockIdx.x / S;
  r.q0 = cut(r.s, K4, S);
  r.q1 = cut(r.s + 1, K4, S);
  r.n0 = cut(r.cb, N, C);
  r.n1 = cut(r.cb + 1, N, C);
  return r;
}

// FULL: row 5 (the out projection first), else row 6.
template <int RT, bool FULL>
__global__ void __launch_bounds__(kSwThreads, 2) swiglu_kernel(SwigluParams p) {
  extern __shared__ __align__(16) float4 xs[];   // [rows][kSliceQ], then stats
  float* stat = reinterpret_cast<float*>(xs + (size_t)p.rows * kSliceQ);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr bool full = FULL;
  // the three products' shares, read from shared memory where used (in
  // registers they spilled the hot loop's)
  __shared__ Share shares[3];
  if (threadIdx.x == 0) {
    shares[0] = FULL ? share_of(p.A / 4, p.H, p.S0, p.C0) : Share{false, 0, 0, 0, 0, 0, 0};
    shares[1] = share_of(p.H / 4, p.I, p.SA, p.CA);
    shares[2] = share_of(p.I / 4, p.H, p.SB, p.CB);
  }
  __syncthreads();
  const volatile Share& s0 = shares[0];
  const volatile Share& sa = shares[1];
  const volatile Share& sb = shares[2];
  const int tA = p.C0, tB = p.C0 + p.CA;   // the products' first counts
  // this warp's items: out-projection column pairs, gate/up columns, down
  // column pairs, warp + 8 i of each
  auto count = [&](int n) { return n > warp ? (n - warp + kSwWarps - 1) / kSwWarps : 0; };
  const int eA = FULL ? count((s0.n1 - s0.n0 + 1) / 2) : 0;   // the first gate/up item
  const int eB = eA + count(sa.n1 - sa.n0);        // the first down item
  const int nItems = eB + count((sb.n1 - sb.n0 + 1) / 2);

  // item i: its two weight rows from the slice start, the slice's length
  // in float4s and its (first) output column
  auto item = [&](int i, const float4*& r0, const float4*& r1, int& qlen, int& n) {
    if (i >= eA && i < eB) {
      n = sa.n0 + warp + kSwWarps * (i - eA);
      r0 = reinterpret_cast<const float4*>(p.wg + (size_t)n * p.H) + sa.q0;
      r1 = reinterpret_cast<const float4*>(p.wu + (size_t)n * p.H) + sa.q0;
      qlen = sa.q1 - sa.q0;
      return;
    }
    const bool out_proj = i < eA;
    const volatile Share& sh = out_proj ? s0 : sb;
    const float* w = out_proj ? p.wo : p.wd;
    const int K = out_proj ? p.A : p.I;
    n = sh.n0 + 2 * (warp + kSwWarps * (out_proj ? i : i - eB));
    const int n1 = min(n + 1, sh.n1 - 1);   // an odd block's last pair repeats
    r0 = reinterpret_cast<const float4*>(w + (size_t)n * K) + sh.q0;
    r1 = reinterpret_cast<const float4*>(w + (size_t)n1 * K) + sh.q0;
    qlen = sh.q1 - sh.q0;
  };
  auto load = [&](float4 (&w)[2][kQ], int i) {
    if (i >= nItems) return;
    const float4 *r0, *r1;
    int qlen, n;
    item(i, r0, r1, qlen, n);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int q = lane + 32 * j;
      w[0][j] = q < qlen ? ld_stream4(r0 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      w[1][j] = q < qlen ? ld_stream4(r1 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // the item's 2 RT sums a row tile: value r < RT is row b0 + r against
  // the first weight row, RT + r against the second
  auto compute = [&](const float4 (&w)[2][kQ], int i) {
    if (i >= nItems) return;
    const float4 *r0, *r1;
    int qlen, n;
    item(i, r0, r1, qlen, n);
    for (int b0 = 0; b0 < p.rows; b0 += RT) {
      float v[2 * RT];
#pragma unroll
      for (int r = 0; r < 2 * RT; ++r) v[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q < qlen) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 a = xs[(b0 + r) * kSliceQ + q];
            v[r] = dot4(a, w[0][j], v[r]);
            v[RT + r] = dot4(a, w[1][j], v[RT + r]);
          }
        }
      }
      const float t = warp_sum_transposed<2 * RT>(v);
      constexpr int kSpan = 32 / (2 * RT);
      const int idx = lane / kSpan, b = b0 + idx % RT, second = idx / RT;
      if (lane % kSpan != 0 || b >= p.B) continue;
      if (i >= eA && i < eB) {
        p.part_a[((size_t)(sa.s * 2 + second) * p.B + b) * p.I + n] = t;
      } else if (i < eA) {
        if (n + second < s0.n1) p.part0[((size_t)s0.s * p.B + b) * p.H + n + second] = t;
      } else if (n + second < sb.n1) {
        p.part_b[((size_t)sb.s * p.B + b) * p.H + n + second] = t;
      }
    }
  };

  // The first activation row of each warp, and w for the gate/up product,
  // asked for before any weight: att's slice (row 5) or y1's (row 6).
  float4 pre[kQ], prew[kQ];
  const bool pre_att = full && s0.in, pre_y1 = !full && sa.in;
  if ((pre_att || pre_y1) && warp < p.B) {
    const float4* src = pre_att
        ? reinterpret_cast<const float4*>(p.att + (size_t)warp * p.A) + s0.q0
        : reinterpret_cast<const float4*>(p.y1 + (size_t)warp * p.H) + sa.q0;
    const int qlen = pre_att ? s0.q1 - s0.q0 : sa.q1 - sa.q0;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int q = lane + 32 * j;
      if (q < qlen) {
        pre[j] = __ldcg(src + q);
        if (pre_y1) prew[j] = __ldg(reinterpret_cast<const float4*>(p.nw) + sa.q0 + q);
      }
    }
  }

  // att's slice for the out projection, rows B .. rows - 1 zeros
  auto stage_0 = [&]() {
    const int qlen = s0.q1 - s0.q0;
    for (int r = warp; r < p.rows; r += kSwWarps) {
      const float4* src = reinterpret_cast<const float4*>(p.att + (size_t)r * p.A) + s0.q0;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q >= qlen) break;
        xs[r * kSliceQ + q] = r >= p.B   ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : r == warp ? pre[j]
                                          : __ldcg(src + q);
      }
    }
    __syncthreads();
  };

  // y1's slice for the gate/up product: y1 * w (and each row's sum of
  // squares over the slice) on the fast path, else normalised from
  // full-row statistics; rows B .. rows - 1 are zeros. A warp a row. y1
  // is read from L2: row 5 wrote it in this launch.
  auto stage_a = [&]() {
    const bool rms = p.rms != 0;
    if (!p.fast) decode::row_norm_stats(stat, p.y1, p.B, p.H, rms, p.eps);
    const int qlen = sa.q1 - sa.q0;
    const float4* w4 = reinterpret_cast<const float4*>(p.nw) + sa.q0;
    for (int r = warp; r < p.rows; r += kSwWarps) {
      const float4* y4 = reinterpret_cast<const float4*>(p.y1 + (size_t)r * p.H) + sa.q0;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q >= qlen) break;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < p.B) {
          const bool first = pre_y1 && r == warp;
          v = first ? pre[j] : __ldcg(y4 + q);
          const float4 w = first ? prew[j] : __ldg(w4 + q);
          if (p.fast) {
            sq = dot4(v, v, sq);
            v = make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
          } else {
            const float mean = stat[2 * r], rstd = stat[2 * r + 1];
            const int k = 4 * (sa.q0 + q);
            v.x = decode::norm_one(v.x, mean, rstd, rms, w.x, p.nb, k);
            v.y = decode::norm_one(v.y, mean, rstd, rms, w.y, p.nb, k + 1);
            v.z = decode::norm_one(v.z, mean, rstd, rms, w.z, p.nb, k + 2);
            v.w = decode::norm_one(v.w, mean, rstd, rms, w.w, p.nb, k + 3);
          }
        }
        xs[r * kSliceQ + q] = v;
      }
      if (p.fast && r < p.B) {
        sq = decode::warp_sum(sq);
        if (lane == 0) p.ss[((size_t)sa.cb * p.SA + sa.s) * p.B + r] = sq;
      }
    }
    __syncthreads();
  };

  // f's slice for the down product (written in this launch: read from L2)
  auto stage_b = [&]() {
    const int qlen = sb.q1 - sb.q0;
    for (int e = threadIdx.x; e < p.rows * qlen; e += kSwThreads) {
      const int r = e / qlen, q = e - r * qlen;
      xs[r * kSliceQ + q] =
          r < p.B ? __ldcg(reinterpret_cast<const float4*>(p.f + (size_t)r * p.I) + sb.q0 + q)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  };

  // after a product's items: publish this CTA's slice sums, then wait
  // until the S CTAs of its column block all have (every CTA is resident:
  // a cooperative launch), so that each adds the slices, in slice order,
  // of its own share of the block's outputs; a product's counts go back
  // to 0 after the next grid barrier, the last product's before the first
  auto arrive_all = [&](int t, int S) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(p.tickets + t, 1u);
      while (*reinterpret_cast<volatile unsigned*>(p.tickets + t) < (unsigned)S)
        __nanosleep(32);
    }
    __syncthreads();
    __threadfence();
  };
  // the sum in slice order of S slice sums `step` floats apart from src
  auto slice_sum = [&](const float* src, size_t step, int S) {
    float o = 0.f;
    for (int s0_ = 0; s0_ < S; s0_ += kReduceBatch) {
      float t[kReduceBatch];
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j)
        if (s0_ + j < S) t[j] = __ldcg(src + (s0_ + j) * step);
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j)
        if (s0_ + j < S) o += t[j];
    }
    return o;
  };
  auto reset = [&](int t0, int n) {
    if (threadIdx.x == 0 && (int)blockIdx.x < n) p.tickets[t0 + blockIdx.x] = 0u;
  };

  // after the out projection (row 5): y1 = x + (att @ wo^T + bo)
  auto boundary_0 = [&]() {
    if (s0.in) {
      arrive_all(s0.cb, p.S0);
      const int cols = s0.n1 - s0.n0, total = p.B * cols;
      for (int e = cut(s0.s, total, p.S0) + threadIdx.x; e < cut(s0.s + 1, total, p.S0);
           e += kSwThreads) {
        const int b = e / cols, n = s0.n0 + e % cols;
        float t = slice_sum(p.part0 + (size_t)b * p.H + n, (size_t)p.B * p.H, p.S0);
        if (p.bo != nullptr) t += __ldg(p.bo + n);
        p.y1[(size_t)b * p.H + n] = __ldg(p.x + (size_t)b * p.H + n) + t;
      }
    }
    reset(tB, p.CB);
    grid.sync();
    reset(0, p.C0);
    if (sa.in) stage_a();
  };

  // after the gate/up product: silu(g) * u
  auto boundary_a = [&]() {
    if (sa.in) {
      arrive_all(tA + sa.cb, p.SA);
      if (p.fast) {   // each row's 1 / rms from its slices' sums of squares
        for (int b = threadIdx.x; b < p.B; b += kSwThreads) {
          const float sq = slice_sum(p.ss + (size_t)sa.cb * p.SA * p.B + b, p.B, p.SA);
          stat[b] = rsqrtf(sq / p.H + p.eps);
        }
        __syncthreads();
      }
      const int cols = sa.n1 - sa.n0, total = p.B * cols;
      for (int e = cut(sa.s, total, p.SA) + threadIdx.x; e < cut(sa.s + 1, total, p.SA);
           e += kSwThreads) {
        const int b = e / cols, n = sa.n0 + e % cols;
        const float* pg = p.part_a + (size_t)b * p.I + n;
        const size_t step = (size_t)p.B * p.I;   // a gate (or up) slice's sums
        const float r = p.fast ? stat[b] : 1.f;
        const float g = slice_sum(pg, 2 * step, p.SA) * r;
        const float u = slice_sum(pg + step, 2 * step, p.SA) * r;
        p.f[(size_t)b * p.I + n] = silu(g) * u;
      }
    }
    if (!full) reset(tB, p.CB);
    grid.sync();
    reset(tA, p.CA);
    if (sb.in) stage_b();
  };

  // the products end to end, the next kBuf - 1 items' loads in flight
  // during each
  float4 wb[kBuf][2][kQ];
#pragma unroll
  for (int u = 0; u < kBuf - 1; ++u) load(wb[u], u);
  if (full) {
    if (s0.in) stage_0();
  } else if (sa.in) {
    stage_a();
  }
  const int steps = nItems > eB ? nItems : eB + 1;   // the boundaries run once
  for (int i = 0; i < steps; i += kBuf) {
#pragma unroll
    for (int u = 0; u < kBuf; ++u) {
      if (i + u >= steps) break;
      load(wb[(u + kBuf - 1) % kBuf], i + u + kBuf - 1);
      if (full && i + u == eA) boundary_0();
      if (i + u == eB) boundary_a();
      compute(wb[u], i + u);
    }
  }

  // after the down product: out = the slices' sum (row 6), y1 + (that +
  // b2) (row 5)
  if (sb.in) {
    arrive_all(tB + sb.cb, p.SB);
    const int cols = sb.n1 - sb.n0, total = p.B * cols;
    for (int e = cut(sb.s, total, p.SB) + threadIdx.x; e < cut(sb.s + 1, total, p.SB);
         e += kSwThreads) {
      const size_t o = (size_t)(e / cols) * p.H + sb.n0 + e % cols;
      float t = slice_sum(p.part_b + o, (size_t)p.B * p.H, p.SB);
      if (full) {
        if (p.b2 != nullptr) t += __ldg(p.b2 + sb.n0 + e % cols);
        t = __ldcg(p.y1 + o) + t;
      }
      p.out[o] = t;
    }
  }
}

// Rows the SwiGLU kernel's registers hold at once for B rows: B itself
// up to 2, else 4 (more rows in tiles of 4: 8 spilled at 128 registers).
int swiglu_row_tile(int B) { return B <= 2 ? B : 4; }

template <int RT>
cudaError_t swiglu_plan_rt(int B, int H, int A, int I, int* plan) {
  auto kernel = A > 0 ? swiglu_kernel<RT, true> : swiglu_kernel<RT, false>;
  const int rows = (B + RT - 1) / RT * RT;
  const size_t smem = (size_t)rows * kSliceQ * sizeof(float4) + 2 * (size_t)B * sizeof(float);
  cudaError_t err = decode::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSwThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int most = per_sm * sms;
  auto slices = [](int K) { return (K / 4 + kSliceQ - 1) / kSliceQ; };
  const int S0 = A > 0 ? slices(A) : 0, SA = slices(H), SB = slices(I);
  if (S0 > most || SA > most || SB > most) return cudaErrorInvalidValue;
  const int C0 = S0 > 0 ? min(most / S0, (H + 1) / 2) : 0;
  const int CA = min(most / SA, I), CB = min(most / SB, (H + 1) / 2);
  const int grid = max(C0 * S0, max(CA * SA, CB * SB));
  const int vals[10] = {grid, S0, SA, SB, C0, CA, CB, rows, (int)smem, most};
  for (int i = 0; i < 10; ++i) plan[i] = vals[i];
  return cudaSuccess;
}

template <bool FULL>
const void* swiglu_kernel_for(int B) {
  switch (swiglu_row_tile(B)) {
    case 1: return (const void*)swiglu_kernel<1, FULL>;
    case 2: return (const void*)swiglu_kernel<2, FULL>;
    default: return (const void*)swiglu_kernel<4, FULL>;
  }
}

}  // namespace

extern "C" {

// The plan of one SwiGLU launch at these widths on the current card (A =
// 0: the partial mode, no out projection), into plan[10]: grid; S0, SA,
// SB (K-slices of the out-projection, gate/up and down products); C0,
// CA, CB (their column blocks); rows (B rounded up to the row tile);
// shared memory bytes; the CTAs that can be resident
// (fused_decode_mlp.swiglu_plan_for is the same rule). Its scratch, in
// floats: part0 S0 B H, part_a SA 2 B I, part_b SB B H, ss CA SA B, f B
// I, and y1 B H (row 5); counts: C0 + CA + CB ints, zero at first.
// Returns a cudaError_t as int.
int pdt_fused_decode_swiglu_plan(int B, int H, int A, int I, int* plan) {
  if (B <= 0 || H % 4 || A % 4 || I % 4) return (int)cudaErrorInvalidValue;
  switch (swiglu_row_tile(B)) {
    case 1: return (int)swiglu_plan_rt<1>(B, H, A, I, plan);
    case 2: return (int)swiglu_plan_rt<2>(B, H, A, I, plan);
    default: return (int)swiglu_plan_rt<4>(B, H, A, I, plan);
  }
}

// The SwiGLU egress (row 5: x, att, wo, bo, b2 given, y1 written) or its
// partial mode (row 6, fused_decode_mlp_partial: A = 0, y1 given, x, att,
// wo, bo and b2 null): wg and wu [I, H], wd [H, I], by the plan[10] of
// pdt_fused_decode_swiglu_plan for these widths on this card, over the
// scratch it sizes. Cooperative launch on `stream`; returns a cudaError_t
// as int. `rms`: RMSNorm, else LayerNorm.
int pdt_fused_decode_swiglu_f32(const float* x, const float* att, const float* wo,
                                const float* bo, const float* nw, const float* nb,
                                const float* wg, const float* wu, const float* wd,
                                const float* b2, float* y1, float* scratch,
                                unsigned* tickets, float* out, int B, int H, int A, int I,
                                int rms, float eps, const int* plan, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int S0 = plan[1], SA = plan[2], SB = plan[3], CA = plan[5];
  float* part0 = scratch;
  float* part_a = part0 + (size_t)S0 * B * H;
  float* part_b = part_a + (size_t)SA * 2 * B * I;
  float* ss = part_b + (size_t)SB * B * H;
  float* f = ss + (size_t)CA * SA * B;
  SwigluParams p{x,      att,    wo,     bo,      nw,     nb,      wg,      wu,      wd,
                 b2,     y1,     part0,  part_a,  part_b, ss,      f,       out,     tickets,
                 B,      H,      A,      I,       S0,     SA,      SB,      plan[4], CA,
                 plan[6], plan[7], rms,  rms != 0 && nb == nullptr,       eps};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(A > 0 ? swiglu_kernel_for<true>(B)
                                                      : swiglu_kernel_for<false>(B),
                                                dim3(plan[0]),
                                                dim3(kSwThreads), args, (size_t)plan[8],
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
