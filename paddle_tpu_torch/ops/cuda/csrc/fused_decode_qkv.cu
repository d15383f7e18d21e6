// Fused decode ingress for Hopper (sm_90a): the norm, the QKV
// projection, rope and the paged-KV append of one decode step, in one
// launch. Two kernels replace the Pallas TPU kernel `_qkv_kernel` of
// `fused_decode_qkv` (paddle_tpu/ops/pallas/fused_decode_qkv.py), both
// `_qkv_block` and `_quantize_or_cast`: LayerNorm or RMSNorm, one fused
// weight or three (wq, wk, wv), biases or none, GQA, fp32 pools or int8
// pools quantized on write into fp32 scale pools (`kv_quantize`):
//
// * qkv_split_kernel, every call without rope (GPT's): a split-K weight
//   stream, its design written above it;
// * fused_decode_qkv_heads_kernel, every call with rotate-half rope at
//   each row's position (LLaMA's): one CTA a head.
//
// Each row b writes its K and V at (page, slot) = (bt[b, min(pos /
// page_size, NP - 1)], pos % page_size), the JAX `_page_slot` lookup. A
// row whose (page, slot) a later row also writes is skipped, so the later
// row's value stays (the JAX kernel's row-by-row write order, `_append`
// of the plain version).
//
// What bounds them on an H100: the weight bytes. At decode the batch is a
// few rows (8 at the serving geometry), so the projection is a GEMV that
// reads its weights once: 7.1 MB at GPT-124M (~2.1 us at 3.35 TB/s), 201
// MB at LLaMA-7B (~60 us), and fp32 FMAs on the CUDA cores are 2 a weight
// byte at 8 rows, far from the SM's rate. The TPU kernel walks the row
// blocks of one grid on one core with W resident in VMEM; here every SM
// streams a share of W.
//
// Plain C interface (bound with ctypes); the wrapper in
// fused_decode_qkv.py checks shapes, types and contiguity, allocates q and
// the split kernel's scratch, and plans its K-slices.

#include "decode_gemv.cuh"

namespace {

using decode::kRowTile;

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row b's table entry for position pos, and its (page, slot) as one key
// (page * page_size + slot).
template <typename Prm>
__device__ inline const int* table_entry(const Prm& p, int b, long long pos) {
  const long long last = p.NP - 1;
  const long long pi = pos / p.page_size < last ? pos / p.page_size : last;
  return p.block_tables + (size_t)b * p.NP + pi;
}

template <typename Prm>
__device__ inline long long slot_key(const Prm& p, int b, long long pos) {
  return (long long)*table_entry(p, b, pos) * p.page_size + pos % p.page_size;
}

// Each row's (page, slot) key into keys [B] (shared memory), a thread a
// row.
template <typename Prm>
__device__ inline void row_keys(const Prm& p, long long* keys) {
  for (int b = threadIdx.x; b < p.B; b += blockDim.x) keys[b] = slot_key(p, b, p.pos[b]);
}

// A finished head: os [B, hd] (shared memory, after a block barrier) of
// q head j (which 0) into q, or of kv head j (which 1: K, 2: V) into its
// pool at each row's (page, slot) (keys, row_keys'), a warp a row: fp32,
// or quantized as
// `kv_quantize` does it (symmetric absmax per head vector, sc = amax /
// 127, 1 for an all-zero vector, q = clamp(rint(x / sc), -127, 127) with
// IEEE division and ties to even) with the scale beside it. A row whose
// (page, slot) a later row also writes is skipped: the later row's value
// stays.
template <typename Prm>
__device__ inline void write_head(const Prm& p, const float* os, const long long* keys,
                                  int which, int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  if (which == 0) {
    const int nq = p.nh * p.hd;
    for (int i = threadIdx.x; i < p.B * p.hd; i += blockDim.x) {
      const int b = i / p.hd, c = i - b * p.hd;
      p.q[(size_t)b * nq + (size_t)j * p.hd + c] = os[i];
    }
    return;
  }
  void* pool = which == 1 ? p.k_pages : p.v_pages;
  float* scales = which == 1 ? p.k_scales : p.v_scales;
  for (int b = warp; b < p.B; b += nwarps) {
    const long long key = keys[b];
    bool later = false;
    for (int b2 = b + 1; b2 < p.B; ++b2) later = later || keys[b2] == key;
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

// ---------------------------------------------------------------------------
// qkv_split_kernel: the ingress without rope (GPT's) as a split-K weight
// stream. One CTA a (head, K-slice), the head's S slices neighbouring
// CTAs; S is the caller's (fused_decode_qkv.split_plan): the fewest
// slices none longer than kSplitQ float4s (GPT-124M: 36 heads x 3
// slices of 256 floats on one card, 18 x 3 on a TP=2 rank, where one CTA
// a head, the per-head kernel's design, streamed each head's 196 KB
// alone; more slices, to fill all 132 SMs, measured no faster). Every
// CTA streams the same bytes: its head's hd weight rows over its slice.
//
// * x first. The norm needs full-row statistics, so every CTA copies x's
//   rows whole into shared memory (cp.async: no registers held; hot in L2
//   after the first CTAs), with the norm's slices, before it asks for any
//   weight, then stages only its slice, normalised.
// * A column pair a lane group. kPairLanes lanes share the two weight rows
//   of two neighbouring columns over the slice, each lane holding up to
//   kPairJ float4s of each row in registers (the whole slice: at most
//   kSplitQ float4s), so each x float4 read from shared memory feeds two
//   columns; RT rows at once, the group's sums by a butterfly in a fixed
//   order.
// * The slices' sums in slice order. Each CTA writes its [B, hd] sums to a
//   global scratch and counts its head's arrivals (a __threadfence, then an
//   atomic ticket); the head's last CTA adds the S slices in slice order
//   (two calls give the same bits), adds the bias, writes q or the K/V
//   rows (write_head) and puts the ticket back to 0 for the next launch.
//   An ordinary launch: no CTA waits for another.

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kPairLanes = 8;                       // lanes of one column pair
constexpr int kPairJ = 8;                           // float4s of a row a lane holds
constexpr int kSplitQ = kPairLanes * kPairJ;        // float4s of a K-slice, at most
constexpr int kPairsPerPass = kSplitThreads / kPairLanes;

struct SplitParams {
  const float* x;             // [B, H]
  const float* norm_w;        // [H]
  const float* norm_b;        // [H] or null
  const float* w[3];          // q, k, v weight rows [nh|hk * hd, H]
  const float* bias[3];       // [nh|hk * hd] each, or null
  const long long* pos;       // [B]
  const int* block_tables;    // [B, NP]
  float* q;                   // [B, nh * hd]
  void* k_pages;              // fp32 or int8 [hk, P, page_size, hd]
  void* v_pages;
  float* k_scales;            // [hk, P, page_size], null for fp32 pools
  float* v_scales;
  float* part;                // [S, B, (nh + 2 hk) hd] slice sums
  unsigned* tickets;          // [nh + 2 hk] arrivals, 0 between launches
  int B, H, nh, hk, hd, P, page_size, NP, S, rows, rms;   // rows: B rounded up to RT
  float eps;
};

template <int RT>
__global__ void __launch_bounds__(kSplitThreads, 2) qkv_split_kernel(SplitParams p) {
  extern __shared__ __align__(16) float4 xs[];   // [rows][kSplitQ] the slice
  float4* nsl = xs + (size_t)p.rows * kSplitQ;    // [2][kSplitQ] the norm's slices
  long long* keys = reinterpret_cast<long long*>(nsl + 2 * kSplitQ);   // [B]
  float* xrows = reinterpret_cast<float*>(nsl + 2 * kSplitQ + (p.B + 1) / 2);   // [B, H]
  float* os = xrows + (size_t)p.B * p.H;          // [B, hd] the head's outputs
  float* stat = os + (size_t)p.B * p.hd;          // [B, 2]
  __shared__ int is_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = blockIdx.x / p.S, s = blockIdx.x - head * p.S;
  const int which = head < p.nh ? 0 : head < p.nh + p.hk ? 1 : 2;
  const int j = which == 0 ? head : which == 1 ? head - p.nh : head - p.nh - p.hk;
  const float* w = p.w[which] + (size_t)j * p.hd * p.H;
  const size_t N = (size_t)(p.nh + 2 * p.hk) * p.hd;
  const int K4 = p.H / 4;
  const int q0 = decode::cut(s, K4, p.S), qlen = decode::cut(s + 1, K4, p.S) - q0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // x's rows and the norm's slices, asked for before any weight; of the
  // caches, the head's bias, which its last CTA reads
  decode::copy_async(xrows, p.x, p.B * p.H);
  decode::copy_async(reinterpret_cast<float*>(nsl), p.norm_w + 4 * q0, 4 * qlen);
  if (p.norm_b != nullptr)
    decode::copy_async(reinterpret_cast<float*>(nsl + kSplitQ), p.norm_b + 4 * q0, 4 * qlen);
  if (p.bias[which] != nullptr)
    decode::prefetch_rows_l2(p.bias[which] + (size_t)j * p.hd, p.hd, 0, 1);
  const bool key_lane = (int)threadIdx.x < p.B;   // a row's position, early
  const long long my_pos = key_lane ? p.pos[threadIdx.x] : 0;

  // this thread's column pair: lane u8 of the pair's kPairLanes, its
  // float4s u8 + kPairLanes jj of both rows over the slice
  const int pairs = (p.hd + 1) / 2;
  const int u8 = threadIdx.x % kPairLanes;
  float4 wr[2][kPairJ];
  auto load_pair = [&](int pp) {
    const bool ok = pp < pairs;
    const int c0 = ok ? 2 * pp : 0, c1 = min(c0 + 1, p.hd - 1);   // an odd hd repeats
    const float4* r0 = reinterpret_cast<const float4*>(w + (size_t)c0 * p.H) + q0;
    const float4* r1 = reinterpret_cast<const float4*>(w + (size_t)c1 * p.H) + q0;
#pragma unroll
    for (int jj = 0; jj < kPairJ; ++jj) {
      const int q = u8 + kPairLanes * jj;
      const bool in = ok && q < qlen;
      wr[0][jj] = in ? decode::ld_stream4(r0 + q) : zero;
      wr[1][jj] = in ? decode::ld_stream4(r1 + q) : zero;
    }
  };
  const int pp0 = threadIdx.x / kPairLanes;
  load_pair(pp0);
  if (key_lane)   // the row's table entry, of the L2, behind the weights
    asm volatile("prefetch.global.L2 [%0];" ::"l"(table_entry(p, threadIdx.x, my_pos)));

  // each row's statistics over the whole row, then the slice, normalised
  // as `_norm_block` does, into xs; rows B .. rows - 1 are zeros
  const bool rms = p.rms != 0;
  decode::cp_async_wait_all();
  __syncthreads();
  decode::row_norm_stats(stat, xrows, p.B, p.H, rms, p.eps);
  const float4* x4 = reinterpret_cast<const float4*>(xrows);
  for (int e = threadIdx.x; e < p.rows * qlen; e += kSplitThreads) {
    const int r = e / qlen, q = e - r * qlen;
    float4 v = zero;
    if (r < p.B) {
      v = decode::norm4(x4[(size_t)r * K4 + q0 + q], stat[2 * r], stat[2 * r + 1], rms,
                        nsl[q], p.norm_b != nullptr ? &nsl[kSplitQ + q] : nullptr);
    }
    xs[r * kSplitQ + q] = v;
  }
  __syncthreads();

  // the pairs' slice sums: a warp's lane groups take its pairs, then those
  // kPairsPerPass further on (passes uniform across the warp)
  constexpr int kGroups = 32 / kPairLanes;
  for (int pass = 0; kPairsPerPass * pass + kGroups * warp < pairs; ++pass) {
    const int pp = pp0 + kPairsPerPass * pass;
    if (pass > 0) load_pair(pp);
    for (int b0 = 0; b0 < p.rows; b0 += RT) {
      float v[2 * RT];
#pragma unroll
      for (int e = 0; e < 2 * RT; ++e) v[e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kPairJ; ++jj) {
        const int q = u8 + kPairLanes * jj;
        if (q < qlen) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 a = xs[(b0 + r) * kSplitQ + q];
            v[r] = decode::dot4(a, wr[0][jj], v[r]);
            v[RT + r] = decode::dot4(a, wr[1][jj], v[RT + r]);
          }
        }
      }
      // the group's totals, on each of its lanes, in a fixed order
#pragma unroll
      for (int e = 0; e < 2 * RT; ++e)
#pragma unroll
        for (int m = kPairLanes / 2; m >= 1; m >>= 1)
          v[e] += __shfl_xor_sync(0xffffffffu, v[e], m);
#pragma unroll
      for (int e = 0; e < 2 * RT; ++e) {
        const int c = 2 * pp + e / RT, b = b0 + e % RT;
        if (e % kPairLanes == u8 && pp < pairs && c < p.hd && b < p.B)
          p.part[((size_t)s * p.B + b) * N + (size_t)head * p.hd + c] = v[e];
      }
    }
  }

  // publish, then count the head's arrivals: its last CTA finishes it
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.tickets + head, 1u) == (unsigned)(p.S - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) p.tickets[head] = 0u;
  if (key_lane) keys[threadIdx.x] = slot_key(p, threadIdx.x, my_pos);
  const float* bias = p.bias[which] != nullptr ? p.bias[which] + (size_t)j * p.hd : nullptr;
  for (int i = threadIdx.x; i < p.B * p.hd; i += kSplitThreads) {
    const int b = i / p.hd, c = i - b * p.hd;
    float v = decode::slice_sum(p.part + (size_t)b * N + (size_t)head * p.hd + c,
                                (size_t)p.B * N, p.S);
    if (bias != nullptr) v += __ldg(bias + c);
    os[i] = v;
  }
  __syncthreads();
  write_head(p, os, keys, which, j);
}

// Rows the split kernel's registers hold at once for B rows: B rounded up
// to a power of two, at most 8.
int split_row_tile(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

const void* split_kernel_for(int B) {
  switch (split_row_tile(B)) {
    case 1: return (const void*)qkv_split_kernel<1>;
    case 2: return (const void*)qkv_split_kernel<2>;
    case 4: return (const void*)qkv_split_kernel<4>;
    default: return (const void*)qkv_split_kernel<8>;
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
// to even) with the scale beside them (write_head).
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

__global__ void __launch_bounds__(kHeadThreads)
fused_decode_qkv_heads_kernel(HeadParams p) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                                   // [B, kc] normalised chunk
  float* os = xs + (size_t)p.B * p.kc;              // [B, hd] the head's outputs
  float* stat = os + (size_t)p.B * p.hd;            // [B, 2]
  long long* keys = reinterpret_cast<long long*>(stat + 2 * p.B);   // [B]
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
  // (row, column pair); the rows' (page, slot) beside
  row_keys(p, keys);
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

  write_head(p, os, keys, which, j);
}

// K-chunk of the heads kernel: the whole row where the cap allows, else
// the widest multiple of 4 that fits (0: too many rows).
int heads_chunk(int B, int H, int hd) {
  const long long room = (long long)(kHeadSmemCap / sizeof(float)) -
                         (long long)B * hd - 4LL * B;
  long long kc = room / B;
  if (kc >= H) return H;
  kc &= ~3LL;
  return kc >= 4 ? (int)kc : 0;
}


}  // namespace

extern "C" {

// Float4s of one of the split kernel's K-slices, at most
// (fused_decode_qkv.SPLIT_Q).
int pdt_fused_decode_qkv_split_q() { return kSplitQ; }

// Dynamic shared memory of one split-kernel CTA, in bytes.
size_t pdt_fused_decode_qkv_split_smem_bytes(int B, int H, int hd) {
  const int RT = split_row_tile(B);
  const size_t rows = (size_t)(B + RT - 1) / RT * RT;
  return ((size_t)rows + 2) * kSplitQ * sizeof(float4) + (size_t)(B + 1) / 2 * sizeof(float4) +
         ((size_t)B * H + (size_t)B * hd + 2 * (size_t)B) * sizeof(float);
}

// Launch the split kernel on `stream` with S K-slices a head
// (fused_decode_qkv.split_plan), over `part` (S B (nh + 2 hk) hd floats)
// and `tickets` (nh + 2 hk zeros, left at 0); returns a cudaError_t as
// int. int8 pools when k_scales is not null, else fp32 pools. `rms`:
// RMSNorm, else LayerNorm.
int pdt_fused_decode_qkv_split(const float* x, const float* norm_w, const float* norm_b,
                               const float* wq, const float* wk, const float* wv,
                               const float* bq, const float* bk, const float* bv,
                               const long long* pos, const int* block_tables, float* q,
                               void* k_pages, void* v_pages, float* k_scales,
                               float* v_scales, float* part, unsigned* tickets, int B, int H,
                               int n_heads, int n_kv_heads, int head_dim, int P,
                               int page_size, int NP, int S, int rms, float eps,
                               void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (H % 4 || B > kSplitThreads || S < 1 || S > H / 4 || (H / 4 + S - 1) / S > kSplitQ)
    return (int)cudaErrorInvalidValue;
  const int RT = split_row_tile(B);
  SplitParams p{x,         norm_w,       norm_b,  {wq, wk, wv}, {bq, bk, bv},
                pos,       block_tables, q,       k_pages,      v_pages,
                k_scales,  v_scales,     part,    tickets,      B,
                H,         n_heads,      n_kv_heads, head_dim,  P,
                page_size, NP,           S,       (B + RT - 1) / RT * RT,
                rms,       eps};
  const size_t smem = pdt_fused_decode_qkv_split_smem_bytes(B, H, head_dim);
  const void* kernel = split_kernel_for(B);
  cudaError_t err = decode::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((n_heads + 2 * n_kv_heads) * S), dim3(kSplitThreads),
                         args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one heads-kernel CTA, in bytes (0: B rows do
// not fit).
size_t pdt_fused_decode_qkv_heads_smem_bytes(int B, int H, int hd) {
  const int kc = heads_chunk(B, H, hd);
  if (kc == 0) return 0;
  return ((size_t)B * kc + (size_t)B * hd + 4 * (size_t)B) * sizeof(float);
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
