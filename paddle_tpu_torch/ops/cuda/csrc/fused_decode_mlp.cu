// Fused decode egress for Hopper (sm_90a), two kernels:
//
// * fused_decode_mlp: the attention out-projection and its residual,
//   LayerNorm, fc1, tanh-GELU, fc2 and the second residual of one decode
//   layer, in one launch. Replaces `_mlp_block` (arch="gpt") run by
//   `_blocked_call` (paddle_tpu/ops/pallas/fused_decode_mlp.py):
//     y1 = x + (att @ wo + bo);  out = y1 + (gelu(norm(y1) @ w1 + b1) @ w2 + b2).
// * fused_decode_epilogue: the final LayerNorm, the LM head and the
//   guarded greedy pick, in one launch. Replaces `_epilogue_block` (same
//   file): logits = norm(x) @ w_lm^T (+ b_lm), then with lg = logits +
//   poison, bad = any non-finite lg in the row, nxt = bad ? 0 : the FIRST
//   index of the row's maximum (generation.guarded_argmax).
//
// What bounds them on an H100: the weight bytes. At decode the batch is a
// few rows, so each product is a GEMV over a weight read once: 21.2 MB a
// layer for the MLP kernel at GPT-124M (~6.4 us at 3.35 TB/s) and the
// 154.5 MB tied embedding for the epilogue (~46 us). The TPU kernels walk
// row blocks of one grid with the weights resident in VMEM; one SM pulling
// those bytes would take hundreds of microseconds, so here the output
// columns of every product are spread over all SMs (decode_gemv.cuh: a
// warp per column, whole [out, in] weight rows with 16-byte loads after
// an L2 prefetch issued at kernel start, activation rows in shared
// memory).
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
      decode::prefetch_row_l2(p.wo + (size_t)n * p.A, p.A);
      decode::prefetch_row_l2(p.w2 + (size_t)n * p.I, p.I);
    }
    for (int n = gwarp; n < p.I; n += nwarps)
      decode::prefetch_row_l2(p.w1 + (size_t)n * p.H, p.H);
  }

  // phase 1: y1 = x + (att @ wo^T + bo)
  decode::load_rows(s, p.att, p.B, p.A);
  __syncthreads();
  gemv_phase(s, p.wo, p.bo, p.B, p.A, p.H, [&](int b, int n, float v) {
    p.y1[(size_t)b * p.H + n] = p.x[(size_t)b * p.H + n] + v;
  });
  grid.sync();

  // phase 2: f = gelu(norm(y1) @ w1^T + b1)
  decode::load_rows(s, p.y1, p.B, p.H);
  decode::layer_norm_rows(s, p.nw, p.nb, p.B, p.H, p.eps);
  gemv_phase(s, p.w1, p.b1, p.B, p.H, p.I, [&](int b, int n, float v) {
    p.f[(size_t)b * p.I + n] = gelu_tanh(v);
  });
  grid.sync();

  // phase 3: out = y1 + (f @ w2^T + b2)
  decode::load_rows(s, p.f, p.B, p.I);
  __syncthreads();
  gemv_phase(s, p.w2, p.b2, p.B, p.I, p.H, [&](int b, int n, float v) {
    p.out[(size_t)b * p.H + n] = p.y1[(size_t)b * p.H + n] + v;
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
  decode::layer_norm_rows(hs, p.nw, p.nb, p.B, p.H, p.eps);

  // this CTA's columns: logits out, and each warp's running (max, index,
  // finite) per row, kept by the lane that owns the row
  for (int n = n0 + warp; n < n_end; n += kWarps) {
    const float bn = p.bias != nullptr ? __ldg(p.bias + n) : 0.f;
    for (int r0 = 0; r0 < p.B; r0 += kRowTile) {
      const int nr = min(kRowTile, p.B - r0);
      float acc[kRowTile];
      decode::warp_dot_rows(p.w + (size_t)n * p.H, hs + (size_t)r0 * p.H, p.H, nr,
                            acc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r >= nr || lane != r) continue;
        const int b = r0 + r;
        const float lg0 = p.bias != nullptr ? acc[r] + bn : acc[r];
        p.logits[(size_t)b * p.V + n] = lg0;
        const float lg = lg0 + __ldg(p.poison + b);
        const int e = warp * p.B + b;
        merge(wval[e], widx[e], wfin[e], lg, n, isfinite(lg) ? 1 : 0);
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
  MlpParams p{x, att, wo, bo, nw, nb, w1, b1, w2, b2, y1, f, out, B, H, A, I, eps};
  const size_t smem = pdt_fused_decode_mlp_smem_bytes(B, H, A, I);
  cudaError_t err = decode::allow_smem(fused_decode_mlp_kernel, smem);
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
           &per_sm, fused_decode_mlp_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // enough warps for the widest phase, no more CTAs than can be resident
  const int widest = H > I ? H : I;
  int grid = (widest + kWarps - 1) / kWarps;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_decode_mlp_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns a cudaError_t as int. `ticket` must be 0.
int pdt_fused_decode_epilogue_f32(const float* x, const float* nw, const float* nb,
                                  const float* w, const float* bias,
                                  const float* poison, float* logits, float* part_val,
                                  int* part_idx, int* part_fin, unsigned* ticket,
                                  long long* nxt, unsigned char* bad, int B, int H,
                                  int V, float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  EpiParams p{x, nw, nb, w, bias, poison, logits, part_val, part_idx, part_fin,
              ticket, nxt, bad, B, H, V, eps};
  const size_t smem = pdt_fused_decode_epilogue_smem_bytes(B, H);
  cudaError_t err = decode::allow_smem(fused_decode_epilogue_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_decode_epilogue_kernel<<<pdt_fused_decode_epilogue_grid(V), kThreads, smem,
                                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
