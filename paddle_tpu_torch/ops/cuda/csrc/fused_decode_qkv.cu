// Fused decode ingress for Hopper (sm_90a): the norm, the QKV
// projection, rope and the paged-KV append of one decode step, in one
// launch. Two kernels replace the Pallas TPU kernel `_qkv_kernel` of
// `fused_decode_qkv` (paddle_tpu/ops/pallas/fused_decode_qkv.py):
//
// * fused_decode_qkv_kernel, the GPT branch with fp32 pools: norm="layer",
//   one fused [3, heads, head_dim]-column weight and bias, no rope;
// * fused_decode_qkv_heads_kernel, every other branch (`_qkv_block` and
//   `_quantize_or_cast`): LayerNorm or RMSNorm, one fused weight or three
//   (wq, wk, wv), biases or none, GQA, rotate-half rope at each row's
//   position, and fp32 pools or int8 pools quantized on write into fp32
//   scale pools (`kv_quantize`). Its design is written above it.
//
// Each row b writes its K and V at (page, slot) = (bt[b, min(pos /
// page_size, NP - 1)], pos % page_size), the JAX `_page_slot` lookup.
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


// ---------------------------------------------------------------------------
// fused_decode_qkv_heads_kernel: one CTA per head of output columns (the
// nh q heads, then the hk k heads, then the hk v heads), because rope
// pairs column i with i +- hd/2 and the int8 quantize-on-write needs the
// absmax of the whole head vector. The CTA's 16 warps stream the head's
// hd weight rows ([out, in], 16-byte loads) against the normalised rows,
// which come through shared memory in K-chunks (the whole H at LLaMA-7B's
// 8 rows: 128 KB, one CTA per SM; the 96 CTAs of LLaMA-7B's 32 + 2 x 32
// heads then stream 2 MB of weights each), each warp dotting four
// neighbouring columns at once (decode::warp_dot_multi); the head's
// [B, hd] outputs gather in shared memory. After a block barrier the CTA adds the bias,
// applies rope with the caller's fp32 cos/sin tables [B, hd] (one home of
// the angles: the wrapper makes them as the unfused path does) and writes
// q, or the K/V vectors: fp32, or quantized as `kv_quantize` does it
// (symmetric absmax per head vector, sc = amax / 127, 1 for an all-zero
// vector, q = clamp(rint(x / sc), -127, 127) with IEEE division and ties
// to even) with the scale beside them. A row whose (page, slot) a later
// row also writes is skipped, so the later row's value stays (the JAX
// kernel's row-by-row write order, `_append` of the plain version).
// What bounds it: the weight bytes (201 MB at LLaMA-7B, 0.060 ms at
// 3.35 TB/s); fp32 FMAs on the CUDA cores.

constexpr int kHeadThreads = 512;
constexpr int kHeadCols = 4;   // neighbouring columns one warp dots at once
constexpr size_t kHeadSmemCap = 220 * 1024;   // dynamic shared memory cap

struct HeadParams {
  const float* x;             // [B, H]
  const float* norm_w;        // [H]
  const float* norm_b;        // [H] or null
  const float* w[3];          // q, k, v weight rows [nh|hk * hd, H]
  const float* bias[3];       // [nh|hk * hd] each, or null
  const float* cos;           // [B, hd] or null (no rope)
  const float* sin;           // [B, hd]
  const long long* pos;       // [B]
  const int* block_tables;    // [B, NP]
  float* q;                   // [B, nh * hd]
  void* k_pages;              // fp32 or int8 [hk, P, page_size, hd]
  void* v_pages;
  float* k_scales;            // [hk, P, page_size], null for fp32 pools
  float* v_scales;
  int B, H, nh, hk, hd, P, page_size, NP, kc, rms;
  float eps;
};

__device__ inline long long slot_key(const HeadParams& p, int b) {
  const long long pos = p.pos[b];
  const long long last = p.NP - 1;
  const long long pi = pos / p.page_size < last ? pos / p.page_size : last;
  const long long page = p.block_tables[(size_t)b * p.NP + pi];
  return page * p.page_size + pos % p.page_size;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kHeadThreads)
fused_decode_qkv_heads_kernel(HeadParams p) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                                   // [B, kc] normalised chunk
  float* os = xs + (size_t)p.B * p.kc;              // [B, hd] the head's outputs
  float* stat = os + (size_t)p.B * p.hd;            // [B, 2]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int head = blockIdx.x;
  const int which = head < p.nh ? 0 : head < p.nh + p.hk ? 1 : 2;
  const int j = which == 0 ? head : which == 1 ? head - p.nh : head - p.nh - p.hk;
  const float* w = p.w[which] + (size_t)j * p.hd * p.H;
  const float* bias = p.bias[which] != nullptr ? p.bias[which] + (size_t)j * p.hd
                                               : nullptr;
  // each warp's first weight row (the first chunk's loads find it in L2)
  const int groups = (p.hd + kHeadCols - 1) / kHeadCols;
  if (warp < groups)
    decode::prefetch_row_l2(w + (size_t)warp * kHeadCols * p.H, p.kc);
  decode::row_norm_stats(stat, p.x, p.B, p.H, p.rms != 0, p.eps);

  for (int k0 = 0; k0 < p.H; k0 += p.kc) {
    const int len = min(p.kc, p.H - k0);
    decode::load_chunk(xs, p.x, p.B, p.H, k0, len, stat, p.rms != 0, p.norm_w,
                       p.norm_b);
    __syncthreads();
    // each warp takes groups of kHeadCols neighbouring columns
    for (int g = warp; g < groups; g += nwarps) {
      const float* rows[kHeadCols];
#pragma unroll
      for (int i = 0; i < kHeadCols; ++i) {
        const int c = min(g * kHeadCols + i, p.hd - 1);   // a tail column repeats
        rows[i] = w + (size_t)c * p.H + k0;
      }
      for (int r0 = 0; r0 < p.B; r0 += kRowTile) {
        const int nr = min(kRowTile, p.B - r0);
        float acc[kHeadCols][kRowTile];
        decode::warp_dot_multi<kHeadCols>(rows, xs + (size_t)r0 * len, len, nr, acc);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (r >= nr || lane != r) continue;
#pragma unroll
          for (int i = 0; i < kHeadCols; ++i) {
            const int c = g * kHeadCols + i;
            if (c >= p.hd) break;
            float* o = os + (size_t)(r0 + r) * p.hd + c;
            *o = k0 == 0 ? acc[i][r] : *o + acc[i][r];
          }
        }
      }
    }
    __syncthreads();
  }

  // bias, then rope on q and k: x * cos + [-x2, x1] * sin, one thread per
  // (row, column pair)
  const int half = p.hd / 2;
  const bool roped = p.cos != nullptr && which < 2;
  for (int i = threadIdx.x; i < p.B * half; i += blockDim.x) {
    const int b = i / half, c = i - b * half;
    float* o = os + (size_t)b * p.hd;
    float lo = o[c], hi = o[c + half];
    if (bias != nullptr) {
      lo += __ldg(bias + c);
      hi += __ldg(bias + c + half);
    }
    if (roped) {
      const float* cs = p.cos + (size_t)b * p.hd;
      const float* sn = p.sin + (size_t)b * p.hd;
      const float rlo = lo * __ldg(cs + c) + (-hi) * __ldg(sn + c);
      const float rhi = hi * __ldg(cs + c + half) + lo * __ldg(sn + c + half);
      lo = rlo;
      hi = rhi;
    }
    o[c] = lo;
    o[c + half] = hi;
  }
  __syncthreads();

  if (which == 0) {
    const int nq = p.nh * p.hd;
    for (int i = threadIdx.x; i < p.B * p.hd; i += blockDim.x) {
      const int b = i / p.hd, c = i - b * p.hd;
      p.q[(size_t)b * nq + (size_t)j * p.hd + c] = os[i];
    }
    return;
  }
  // K or V: a warp per row
  void* pool = which == 1 ? p.k_pages : p.v_pages;
  float* scales = which == 1 ? p.k_scales : p.v_scales;
  for (int b = warp; b < p.B; b += nwarps) {
    const long long key = slot_key(p, b);
    bool later = false;
    for (int b2 = b + 1; b2 < p.B; ++b2) later = later || slot_key(p, b2) == key;
    if (later) continue;
    const long long page = key / p.page_size, slot = key - page * p.page_size;
    const size_t at = ((size_t)j * p.P + page) * p.page_size + slot;
    const float* o = os + (size_t)b * p.hd;
    if (scales == nullptr) {
      float* dst = static_cast<float*>(pool) + at * p.hd;
      for (int c = lane; c < p.hd; c += 32) dst[c] = o[c];
      continue;
    }
    float amax = 0.f;
    for (int c = lane; c < p.hd; c += 32) amax = fmaxf(amax, fabsf(o[c]));
    amax = warp_max(amax);
    const float sc = amax > 0.f ? amax / 127.f : 1.f;
    signed char* dst = static_cast<signed char*>(pool) + at * p.hd;
    for (int c = lane; c < p.hd; c += 32) {
      const float qv = fminf(fmaxf(rintf(o[c] / sc), -127.f), 127.f);
      dst[c] = (signed char)qv;
    }
    if (lane == 0) scales[at] = sc;
  }
}

// K-chunk of the heads kernel: the whole row where the cap allows, else
// the widest multiple of 4 that fits (0: too many rows).
int heads_chunk(int B, int H, int hd) {
  const long long room = (long long)(kHeadSmemCap / sizeof(float)) -
                         (long long)B * hd - 2LL * B;
  long long kc = room / B;
  if (kc >= H) return H;
  kc &= ~3LL;
  return kc >= 4 ? (int)kc : 0;
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

// Dynamic shared memory of one heads-kernel CTA, in bytes (0: B rows do
// not fit).
size_t pdt_fused_decode_qkv_heads_smem_bytes(int B, int H, int hd) {
  const int kc = heads_chunk(B, H, hd);
  if (kc == 0) return 0;
  return ((size_t)B * kc + (size_t)B * hd + 2 * (size_t)B) * sizeof(float);
}

// Launch the heads kernel on `stream`; returns a cudaError_t as int.
// int8 pools when k_scales is not null, else fp32 pools.
int pdt_fused_decode_qkv_heads(const float* x, const float* norm_w,
                               const float* norm_b, const float* wq, const float* wk,
                               const float* wv, const float* bq, const float* bk,
                               const float* bv, const float* cos, const float* sin,
                               const long long* pos, const int* block_tables, float* q,
                               void* k_pages, void* v_pages, float* k_scales,
                               float* v_scales, int B, int H, int n_heads,
                               int n_kv_heads, int head_dim, int P, int page_size,
                               int NP, int rms, float eps, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int kc = heads_chunk(B, H, head_dim);
  if (kc == 0 || head_dim % 2) return (int)cudaErrorInvalidValue;
  HeadParams p{x, norm_w, norm_b, {wq, wk, wv}, {bq, bk, bv}, cos, sin, pos,
               block_tables, q, k_pages, v_pages, k_scales, v_scales, B, H,
               n_heads, n_kv_heads, head_dim, P, page_size, NP, kc, rms, eps};
  const size_t smem = pdt_fused_decode_qkv_heads_smem_bytes(B, H, head_dim);
  cudaError_t err = decode::allow_smem(fused_decode_qkv_heads_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_decode_qkv_heads_kernel<<<n_heads + 2 * n_kv_heads, kHeadThreads, smem,
                                  (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
