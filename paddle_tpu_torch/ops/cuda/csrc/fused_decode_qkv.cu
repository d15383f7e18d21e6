// Fused decode ingress for Hopper (sm_90a): LayerNorm, the fused QKV
// projection with its bias, and the paged-KV append of one decode step,
// in one launch.
//
// Replaces the Pallas TPU kernel `_qkv_kernel` of `fused_decode_qkv`
// (paddle_tpu/ops/pallas/fused_decode_qkv.py) for the GPT branch:
// norm="layer", one fused [3, heads, head_dim]-column weight and bias, no
// rope, fp32 page pools. Each row b writes its K and V at
// (page, slot) = (bt[b, min(pos / page_size, NP - 1)], pos % page_size),
// the JAX `_page_slot` lookup.
//
// What bounds it on an H100: the weight bytes. At decode the batch is a
// few rows (8 at GPT-124M's serving geometry), so the projection is a
// GEMV that reads W [3 H, H] once: 7.1 MB at GPT-124M, ~2.1 us at
// 3.35 TB/s, against ~0.4 us of fp32 FMAs. The TPU kernel walks the row
// blocks of one grid on one core with W resident in VMEM; here the output
// columns are tiled over ~290 CTAs so that every SM streams its share of
// W. Each CTA recomputes the rows' LayerNorm from x (a few KB, hot in L2)
// into shared memory, then each warp dots whole weight rows ([out, in]
// layout, 16-byte loads) against the normalised rows. The CTA that owns a
// K or V column stores it straight into its pool: there is no dependency
// between CTAs, so this is an ordinary launch. fp32 FMAs on the CUDA
// cores; tensor cores, TMA and split-K are later work.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_decode_qkv.py checks shapes, types and contiguity and allocates q.

#include "decode_gemv.cuh"

namespace {

using decode::kRowTile;
using decode::kThreads;
using decode::kWarps;

constexpr int kColsPerCta = 8;   // output columns of one CTA (1 per warp)

struct Params {
  const float* x;             // [B, H]
  const float* norm_w;        // [H]
  const float* norm_b;        // [H] or null
  const float* w;             // [N, H], N = (nh + 2 hk) hd
  const float* bias;          // [N] or null
  const long long* pos;       // [B]
  const int* block_tables;    // [B, NP]
  float* q;                   // [B, nh * hd]
  float* k_pages;             // [hk, P, page_size, hd]
  float* v_pages;             // [hk, P, page_size, hd]
  int B, H, nq, nk, hd, P, page_size, NP;
  float eps;
};

__global__ void __launch_bounds__(kThreads)
fused_decode_qkv_kernel(Params p) {
  extern __shared__ __align__(16) float hs[];   // [B, H] normalised rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int N = p.nq + 2 * p.nk;
  const int n0 = (int)blockIdx.x * kColsPerCta;
  const int n_end = min(N, n0 + kColsPerCta);
  decode::prefetch_rows_l2(p.w, p.H, n0, n_end);
  decode::load_rows(hs, p.x, p.B, p.H);
  decode::layer_norm_rows(hs, p.norm_w, p.norm_b, p.B, p.H, p.eps);

  for (int n = n0 + warp; n < n_end; n += kWarps) {
    const float bias = p.bias != nullptr ? __ldg(p.bias + n) : 0.f;
    for (int r0 = 0; r0 < p.B; r0 += kRowTile) {
      const int nr = min(kRowTile, p.B - r0);
      float acc[kRowTile];
      decode::warp_dot_rows(p.w + (size_t)n * p.H, hs + (size_t)r0 * p.H, p.H,
                            nr, acc);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r >= nr || lane != r) continue;
        const int b = r0 + r;
        const float v = p.bias != nullptr ? acc[r] + bias : acc[r];
        if (n < p.nq) {
          p.q[(size_t)b * p.nq + n] = v;
          continue;
        }
        const bool is_k = n < p.nq + p.nk;
        const int j = is_k ? n - p.nq : n - p.nq - p.nk;
        const int head = j / p.hd, d = j - head * p.hd;
        const long long pos = p.pos[b];
        const long long last = p.NP - 1;
        const long long pi = pos / p.page_size < last ? pos / p.page_size : last;
        const long long page = p.block_tables[(size_t)b * p.NP + pi];
        const long long slot = pos % p.page_size;
        float* pool = is_k ? p.k_pages : p.v_pages;
        pool[((head * (long long)p.P + page) * p.page_size + slot) * p.hd + d] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t pdt_fused_decode_qkv_smem_bytes(int B, int H) {
  return (size_t)B * H * sizeof(float);
}

// Launch on `stream` (a cudaStream_t); returns a cudaError_t as int.
int pdt_fused_decode_qkv_f32(const float* x, const float* norm_w, const float* norm_b,
                             const float* w, const float* bias, const long long* pos,
                             const int* block_tables, float* q, float* k_pages,
                             float* v_pages, int B, int H, int n_heads, int n_kv_heads,
                             int head_dim, int P, int page_size, int NP, float eps,
                             void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  Params p{x, norm_w, norm_b, w, bias, pos, block_tables, q, k_pages, v_pages,
           B, H, n_heads * head_dim, n_kv_heads * head_dim, head_dim, P,
           page_size, NP, eps};
  const size_t smem = pdt_fused_decode_qkv_smem_bytes(B, H);
  cudaError_t err = decode::allow_smem(fused_decode_qkv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int N = p.nq + 2 * p.nk;
  const int grid = (N + kColsPerCta - 1) / kColsPerCta;
  fused_decode_qkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
