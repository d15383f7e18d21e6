// Fused decode egress for Hopper (sm_90a), three kernels:
//
// * fused_decode_mlp: the attention out-projection and its residual,
//   LayerNorm, fc1, tanh-GELU, fc2 and the second residual of one decode
//   layer, in one launch. Replaces `_mlp_block` (arch="gpt") run by
//   `_blocked_call` (paddle_tpu/ops/pallas/fused_decode_mlp.py):
//     y1 = x + (att @ wo + bo);  out = y1 + (gelu(norm(y1) @ w1 + b1) @ w2 + b2).
// * fused_decode_swiglu: the same layer for arch="llama" (`_mlp_tail`'s
//   SwiGLU branch), LayerNorm or RMSNorm, with the activation rows
//   streamed through shared memory in K-chunks (its design is written
//   above it):
//     y1 = x + (att @ wo + bo);  h = norm(y1);
//     out = y1 + ((silu(h @ wg) * (h @ wu)) @ wd + b2).
// * Their tensor-parallel partial mode replaces `_mlp_partial_block`
//   (fused_decode_mlp_partial, same file): y1 is given, so the first
//   phase and its grid barrier are skipped, and the last product has no
//   bias and no residual: out = mlp(norm(y1)) with a rank's slices of
//   the MLP weights, the partial sum before the layer's all-reduce.
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
// every column of y1, fc2 every column of f), so the kernel is a
// cooperative launch, its grid capped by the occupancy API so that all
// CTAs are resident, with a grid barrier (cooperative_groups
// this_grid().sync()) between the phases; y1 [B, H] and f [B, I] pass
// through a global scratch that stays in L2. A refused cooperative launch
// returns its error and the wrapper raises: there is no fallback.
//
// The epilogue's argmax reduces across CTAs: each CTA writes its logits
// and, per row, the (max, first index, all-finite) of its columns; the
// last CTA to finish (a __threadfence, then an atomic ticket) reduces
// those partials, ties going to the lower index, and resets the ticket
// for the next launch. One launch, on one stream at a time per ticket.
//
// fp32 FMAs on the CUDA cores; tensor cores, TMA and split-K are later
// work. Plain C interface (bound with ctypes); the wrappers in
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


// ---------------------------------------------------------------------------
// fused_decode_swiglu_kernel. Same plan as fused_decode_mlp_kernel (a
// cooperative launch, all output columns of each product spread over every
// warp of the grid, a grid barrier between the three products, y1 and the
// activations passing through a global scratch that stays in L2), with three
// changes for LLaMA-7B's width:
//
// * The activation rows stream through shared memory in K-chunks
//   (decode::load_chunk): 8 rows of the down projection's 11008 floats are
//   352 KB, above the 227 KB a CTA may have. A chunk is at most 64 KB
//   (2048 columns at 8 rows); two CTAs then share an SM (registers, 125 a
//   thread, allow no third). Each warp keeps its columns' partial sums in
//   the phase's output buffer, only it touching them, and the last chunk
//   finishes the column. The norm of y1 is applied as each chunk loads,
//   from per-row statistics every CTA computes once (row_norm_stats).
// * A warp dots two weight rows against each activation float4 it reads
//   from shared memory (decode::warp_dot_multi): two neighbouring columns
//   of the out and down projections, a column's gate and up rows. That
//   halves the shared-memory traffic; four rows at once measured slower
//   on the H100 (fewer column groups than warps in the out and down
//   projections, and spills).
// * The L2 prefetch is bounded: one layer's weights are 608 MB at
//   LLaMA-7B, twelve times the 50 MB L2, so a prefetch of all of them
//   (the GPT kernel's) would evict itself. Before each grid barrier every
//   warp asks only for the first chunk of the first row of its first
//   column group of the next product, so the fetch overlaps the barrier's
//   wait. At 8 rows (8 KB chunks, 264 CTAs) that is 16.8 MB before the
//   out projection, 69.2 MB of gate and up rows before the second phase
//   (more than the L2 holds) and 16.8 MB before the down projection; at
//   one row (whole-row chunks) 33.6, 138.4 and 90.2 MB.
//
// The grid is every CTA that can be resident (the occupancy API), capped at
// one warp per column group of the widest product; the phases stride their
// column groups over whatever grid runs, so every column is covered at any
// grid size, and a refused launch returns its error. What bounds it: the weight
// bytes (608 MB a layer at LLaMA-7B, 0.18 ms at 3.35 TB/s).

constexpr size_t kSwigluChunkBytes = 64 * 1024;

struct SwigluParams {
  const float* x;      // [B, H] residual stream
  const float* att;    // [B, A] attention output
  const float* wo;     // [H, A]
  const float* bo;     // [H] or null
  const float* nw;     // [H]
  const float* nb;     // [H] or null
  const float* wg;     // [I, H] gate
  const float* wu;     // [I, H] up
  const float* wd;     // [H, I] down
  const float* b2;     // [H] or null
  float* y1;           // [B, H] scratch
  float* g;            // [B, I] scratch: gate partials, then silu(g) * u
  float* u;            // [B, I] scratch: up partials
  float* out;          // [B, H]
  int B, H, A, I, kc, rms;
  float eps;
  int partial;         // y1 given: no phase 1, no down bias, no residual
};

__device__ inline float silu(float v) { return v / (1.f + expf(-v)); }

// Weight rows a warp dots at once: two neighbouring columns of the out
// or down projection, or one column's gate and up rows.
constexpr int kGroup = 2;

// One product over K-chunks of src [B, K] (normalised on load where `stat`
// is given): for every output column n (each warp takes groups of
// kGroup / kW neighbouring columns, grid-strided), every row b and every
// chunk, part(b, n, dots, first, last) with dots[i] this chunk's dot of
// row b with w[i]'s row n, called by one lane. A group's kGroup weight
// rows go through one decode::warp_dot_multi.
template <int kW, typename Part>
__device__ inline void chunked_phase(float* s, const float* src, int B, int K, int kc,
                                     const float* stat, bool rms, const float* nw,
                                     const float* nb, const float* const (&w)[kW],
                                     int N, Part part) {
  static_assert(kGroup % kW == 0, "a group holds whole columns");
  constexpr int kCols = kGroup / kW;
  constexpr int kN = kGroup;
  const int lane = threadIdx.x % 32;
  const int gwarp = (int)blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = (int)gridDim.x * kWarps;
  const int groups = (N + kCols - 1) / kCols;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int len = min(kc, K - k0);
    __syncthreads();   // the previous chunk's readers are done
    decode::load_chunk(s, src, B, K, k0, len, stat, rms, nw, nb);
    __syncthreads();
    for (int g = gwarp; g < groups; g += nwarps) {
      const float* rows[kN];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int n = min(g * kCols + j, N - 1);   // a tail column repeats
#pragma unroll
        for (int i = 0; i < kW; ++i) rows[j * kW + i] = w[i] + (size_t)n * K + k0;
      }
      for (int r0 = 0; r0 < B; r0 += kRowTile) {
        const int nr = min(kRowTile, B - r0);
        float acc[kN][kRowTile];
        decode::warp_dot_multi<kN>(rows, s + (size_t)r0 * len, len, nr, acc);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (r >= nr || lane != r) continue;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int n = g * kCols + j;
            if (n >= N) break;
            float dots[kW];
#pragma unroll
            for (int i = 0; i < kW; ++i) dots[i] = acc[j * kW + i][r];
            part(r0 + r, n, dots, k0 == 0, k0 + len >= K);
          }
        }
      }
    }
  }
}

// Ask the L2 for the first chunk of the first row of this warp's first
// column group of w [N, K] (groups of `cols` columns).
__device__ inline void prefetch_first_chunk(const float* w, int N, int K, int kc,
                                            int cols) {
  const int gwarp = (int)blockIdx.x * kWarps + threadIdx.x / 32;
  if (gwarp * cols < N)
    decode::prefetch_row_l2(w + (size_t)gwarp * cols * K, min(kc, K));
}

__global__ void __launch_bounds__(kThreads)
fused_decode_swiglu_kernel(SwigluParams p) {
  extern __shared__ __align__(16) float s[];   // [B, kc] chunk, then [B, 2] stats
  float* stat = s + (size_t)p.B * p.kc;
  cg::grid_group grid = cg::this_grid();
  const bool rms = p.rms != 0;

  // phase 1: y1 = x + (att @ wo^T + bo); the partial mode is given y1
  if (!p.partial) {
    prefetch_first_chunk(p.wo, p.H, p.A, p.kc, kGroup);
    const float* w[1] = {p.wo};
    chunked_phase<1>(s, p.att, p.B, p.A, p.kc, nullptr, rms, nullptr, nullptr, w,
                     p.H, [&](int b, int n, const float* d, bool first, bool last) {
      float* y = p.y1 + (size_t)b * p.H + n;
      float t = first ? d[0] : *y + d[0];
      if (last) {
        if (p.bo != nullptr) t += __ldg(p.bo + n);
        t = p.x[(size_t)b * p.H + n] + t;
      }
      *y = t;
    });
  }
  prefetch_first_chunk(p.wg, p.I, p.H, p.kc, kGroup / 2);
  prefetch_first_chunk(p.wu, p.I, p.H, p.kc, kGroup / 2);
  if (!p.partial) grid.sync();

  // phase 2: f = silu(norm(y1) @ wg^T) * (norm(y1) @ wu^T)
  decode::row_norm_stats(stat, p.y1, p.B, p.H, rms, p.eps);
  {
    const float* w[2] = {p.wg, p.wu};
    chunked_phase<2>(s, p.y1, p.B, p.H, p.kc, stat, rms, p.nw, p.nb, w, p.I,
                     [&](int b, int n, const float* d, bool first, bool last) {
      float* g = p.g + (size_t)b * p.I + n;
      float* u = p.u + (size_t)b * p.I + n;
      const float gv = first ? d[0] : *g + d[0];
      const float uv = first ? d[1] : *u + d[1];
      if (last) {
        *g = silu(gv) * uv;
      } else {
        *g = gv;
        *u = uv;
      }
    });
  }
  prefetch_first_chunk(p.wd, p.H, p.I, p.kc, kGroup);
  grid.sync();

  // phase 3: out = y1 + (f @ wd^T + b2); the partial mode: f @ wd^T
  {
    const float* w[1] = {p.wd};
    chunked_phase<1>(s, p.g, p.B, p.I, p.kc, nullptr, rms, nullptr, nullptr, w, p.H,
                     [&](int b, int n, const float* d, bool first, bool last) {
      float* o = p.out + (size_t)b * p.H + n;
      float t = first ? d[0] : *o + d[0];
      if (last) {
        if (p.b2 != nullptr) t += __ldg(p.b2 + n);
        if (!p.partial) t = p.y1[(size_t)b * p.H + n] + t;
      }
      *o = t;
    });
  }
}

// K-chunk of the SwiGLU kernel: the widest product's K where it fits in
// kSwigluChunkBytes, else a multiple of 128 (of 4 for very many rows;
// 0: too many rows).
int swiglu_chunk(int B, int H, int A, int I) {
  const int widest = A > H ? (A > I ? A : I) : (H > I ? H : I);
  long long kc = (long long)(kSwigluChunkBytes / sizeof(float)) / B;
  if (kc >= widest) return widest;
  kc = kc >= 128 ? kc & ~127LL : kc & ~3LL;
  return kc >= 4 ? (int)kc : 0;
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

// Dynamic shared memory of one SwiGLU CTA, in bytes (0: B rows do not fit).
size_t pdt_fused_decode_swiglu_smem_bytes(int B, int H, int A, int I) {
  const int kc = swiglu_chunk(B, H, A, I);
  return kc == 0 ? 0 : ((size_t)B * kc + 2 * (size_t)B) * sizeof(float);
}

// CTAs of one SwiGLU launch into *grid: every CTA that can be resident
// (set the kernel's shared-memory limit first), at most one warp per
// column group of the widest product. Returns a cudaError_t as int.
int pdt_fused_decode_swiglu_grid(int B, int H, int A, int I, int* grid) {
  const size_t smem = pdt_fused_decode_swiglu_smem_bytes(B, H, A, I);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = decode::allow_smem(fused_decode_swiglu_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_decode_swiglu_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int g13 = (H + kGroup - 1) / kGroup;               // phases 1 and 3
  const int g2 = (I + kGroup / 2 - 1) / (kGroup / 2);      // gate and up
  const int widest = g13 > g2 ? g13 : g2;
  *grid = (widest + kWarps - 1) / kWarps;
  if (*grid > per_sm * sms) *grid = per_sm * sms;
  return (int)cudaSuccess;
}

}  // extern "C"

namespace {

// Cooperative launch of the SwiGLU kernel, full or partial, over the grid
// pdt_fused_decode_swiglu_grid picks; returns a cudaError_t as int.
int launch_swiglu(SwigluParams p, void* stream) {
  const size_t smem = pdt_fused_decode_swiglu_smem_bytes(p.B, p.H, p.A, p.I);
  int grid = 0;
  cudaError_t err = (cudaError_t)pdt_fused_decode_swiglu_grid(p.B, p.H, p.A, p.I, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_decode_swiglu_kernel,
                                    dim3(grid), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Cooperative launch of the SwiGLU egress on `stream`; returns a
// cudaError_t as int. `rms`: RMSNorm, else LayerNorm.
int pdt_fused_decode_swiglu_f32(const float* x, const float* att, const float* wo,
                                const float* bo, const float* nw, const float* nb,
                                const float* wg, const float* wu, const float* wd,
                                const float* b2, float* y1, float* g, float* u,
                                float* out, int B, int H, int A, int I, int rms,
                                float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int kc = swiglu_chunk(B, H, A, I);
  if (kc == 0) return (int)cudaErrorInvalidValue;
  return launch_swiglu({x, att, wo, bo, nw, nb, wg, wu, wd, b2, y1, g, u, out,
                        B, H, A, I, kc, rms, eps, 0}, stream);
}

// The partial mode (fused_decode_mlp_partial, arch="llama"): y1 [B, H]
// given, wg and wu [I, H] and wd [H, I] a rank's slices; out =
// (silu(norm(y1) @ wg^T) * (norm(y1) @ wu^T)) @ wd^T. Cooperative launch
// on `stream`; returns a cudaError_t as int.
int pdt_fused_decode_swiglu_partial_f32(const float* y1, const float* nw,
                                        const float* nb, const float* wg,
                                        const float* wu, const float* wd, float* g,
                                        float* u, float* out, int B, int H, int I,
                                        int rms, float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int kc = swiglu_chunk(B, H, 0, I);
  if (kc == 0) return (int)cudaErrorInvalidValue;
  return launch_swiglu({nullptr, nullptr, nullptr, nullptr, nw, nb, wg, wu, wd,
                        nullptr, const_cast<float*>(y1), g, u, out, B, H, 0, I, kc,
                        rms, eps, 1},
                       stream);
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
