// Ragged paged attention over fp32 or int8 KV page pools, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (paddle_tpu/ops/pallas/paged_attention.py), both of its variants: fp32
// pools, and int8 pools with f32 scale side-pools [Hk, P, page_size] (one
// absmax scale per kv head and token slot, quantization.kv_quantize). Packed query
// tokens of many sequences (decode rows with q_len 1 and prefill chunks
// in one call) attend a paged KV pool through per-sequence block tables,
// with positional causality kv_pos <= kv_len - q_len + i, GQA, and an
// online softmax in fp32.
//
// What bounds it on an H100: the KV bytes. Every q block must read each
// KV token it attends once (4 B x D x 2 per token and kv head), and at
// decode and small prefill chunks that is hundreds of bytes per FLOP.
// The design spends nothing else on device memory: one CTA per (kv head,
// q block) stages the q block's rows of all `rep` query heads of its kv
// head once, walks the sequence's pages only up to the causal bound of
// its q block (never a token at or past kv_len), and keeps scores,
// softmax state and the output accumulator in shared memory. K and V
// move in 64-token chunks with 16-byte cp.async copies into two
// shared-memory buffers, so the next chunk's bytes are in flight while
// the current one is scored: the loop waits on memory once per chunk,
// not once per load.
//
// The int8 variant moves a quarter of the bytes: each chunk stages the
// int8 K and V rows (16-byte copies) and their 64 scales (4-byte copies)
// and dequantizes in registers, the int8 value times its token's scale,
// right before each product, as the TPU kernel dequantizes its VMEM
// block before the dots. The TPU kernel zeroes the rows of a fetched
// block that lie at or past kv_len (garbage times a zero weight would
// still poison the sum); here no such row is ever staged or read, so
// there is nothing to zero. The grid comes from static shapes only (kv heads x
// q blocks of the padded token budget): the CTA finds its sequence from
// q_lens itself, so the host never reads a device length. No tensor
// cores, no TMA, no split-KV yet: those are later work.
//
// Plain C interface (bound with ctypes); the wrapper in
// paged_attention.py checks shapes, types and contiguity and allocates
// the output. The launcher returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // kv tokens staged in shared memory per step

struct Params {
  const float* q;             // [T, Hq, D]
  const void* k_pages;        // [Hk, P, page_size, D] fp32 or int8
  const void* v_pages;        // [Hk, P, page_size, D] fp32 or int8
  const float* k_scales;      // [Hk, P, page_size] (int8 pools only)
  const float* v_scales;      // [Hk, P, page_size] (int8 pools only)
  const int* block_tables;    // [B, NP]
  const int* kv_lens;         // [B]
  const int* q_lens;          // [B]
  float* out;                 // [T, Hq, D]
  int T, Hq, Hk, D, P, page_size, B, NP, q_block, rep;
  float scale;
};

// floats of one K+V chunk buffer. fp32: K rows padded by 4 floats, then
// V rows. int8: K rows of D + 16 bytes, V rows of D bytes, then the K and
// V scales of the chunk's tokens (a multiple of 16 bytes for D % 16 == 0).
template <bool Q8>
__host__ __device__ inline size_t chunk_floats(int d) {
  if (Q8) return ((size_t)kChunk * (d + 16) + (size_t)kChunk * d) / 4 + 2 * kChunk;
  return (size_t)kChunk * (d + 4) + (size_t)kChunk * d;
}

// shared-memory floats for R = q_block * rep rows of width D
template <bool Q8>
__host__ __device__ inline size_t smem_floats(int rows, int d) {
  return (size_t)rows * d            // q rows, pre-scaled
         + 2 * chunk_floats<Q8>(d)   // two K/V chunk buffers
         + (size_t)rows * kChunk     // scores, then probabilities
         + (size_t)rows * d          // output accumulator
         + 3 * (size_t)rows;         // running max, running sum, rescale
}

// 16-byte global -> shared copy that does not wait for the data
__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// 4-byte global -> shared copy (a token's scale)
__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Start copying K/V of tokens [c0, c0 + n) of one sequence's kv head into
// a chunk buffer `cb` (fp32: K rows at stride D + 4 floats, then V rows at
// stride D; int8: K rows at stride D + 16 bytes, V rows at stride D, then
// the n K scales and the n V scales at kChunk floats apart); all tokens
// are below kv_len, so never stale or unwritten pool memory.
template <bool Q8>
__device__ inline void stage_chunk(const Params& p, const int* bt, int kvh,
                                   int c0, int n, float* cb) {
  const int D = p.D;
  if (Q8) {
    const int D16 = D >> 4, KS8 = D + 16;
    signed char* ks = reinterpret_cast<signed char*>(cb);
    signed char* vs = ks + kChunk * KS8;
    float* kss = reinterpret_cast<float*>(vs + kChunk * D);
    const signed char* kp = static_cast<const signed char*>(p.k_pages);
    const signed char* vp = static_cast<const signed char*>(p.v_pages);
    for (int e = threadIdx.x; e < n * D16; e += kThreads) {
      const int j = e / D16, d16 = e - j * D16;
      const int pos = c0 + j;
      const int page = __ldg(bt + pos / p.page_size);
      const size_t off =
          (((size_t)kvh * p.P + page) * p.page_size + pos % p.page_size) * D + 16 * d16;
      cp_async16(ks + j * KS8 + 16 * d16, kp + off);
      cp_async16(vs + j * D + 16 * d16, vp + off);
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int pos = c0 + j;
      const int page = __ldg(bt + pos / p.page_size);
      const size_t off = ((size_t)kvh * p.P + page) * p.page_size + pos % p.page_size;
      cp_async4(kss + j, p.k_scales + off);
      cp_async4(kss + kChunk + j, p.v_scales + off);
    }
  } else {
    const int D4 = D >> 2, KS = D + 4;
    float* ks = cb;
    float* vs = cb + kChunk * KS;
    const float* kp = static_cast<const float*>(p.k_pages);
    const float* vp = static_cast<const float*>(p.v_pages);
    for (int e = threadIdx.x; e < n * D4; e += kThreads) {
      const int j = e / D4, d4 = e - j * D4;
      const int pos = c0 + j;
      const int page = __ldg(bt + pos / p.page_size);
      const size_t off =
          (((size_t)kvh * p.P + page) * p.page_size + pos % p.page_size) * D + 4 * d4;
      cp_async16(ks + j * KS + 4 * d4, kp + off);
      cp_async16(vs + j * D + 4 * d4, vp + off);
    }
  }
  cp_async_commit();
}

// q row qr (pre-scaled, D floats) dotted with chunk token j's K row.
template <bool Q8>
__device__ inline float score(const float* qr, const float* cb, int j, int D) {
  float s = 0.f;
  if (Q8) {
    const int KS8 = D + 16;
    const signed char* kr = reinterpret_cast<const signed char*>(cb) + (size_t)j * KS8;
    const float ksc = reinterpret_cast<const float*>(
        reinterpret_cast<const signed char*>(cb) + (size_t)kChunk * (KS8 + D))[j];
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int d16 = 0; d16 < (D >> 4); ++d16) {
      const int4 w = reinterpret_cast<const int4*>(kr)[d16];
      const signed char* b = reinterpret_cast<const signed char*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = q4[4 * d16 + i];
        s = fmaf(a.x, (float)b[4 * i] * ksc, s);
        s = fmaf(a.y, (float)b[4 * i + 1] * ksc, s);
        s = fmaf(a.z, (float)b[4 * i + 2] * ksc, s);
        s = fmaf(a.w, (float)b[4 * i + 3] * ksc, s);
      }
    }
  } else {
    const float4* qv = reinterpret_cast<const float4*>(qr);
    const float4* kj = reinterpret_cast<const float4*>(cb + (size_t)j * (D + 4));
    for (int d4 = 0; d4 < (D >> 2); ++d4) {
      const float4 a = qv[d4], c = kj[d4];
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
  }
  return s;
}

// Chunk token j's V values at columns 4 d4 .. 4 d4 + 3.
template <bool Q8>
__device__ inline float4 v_row4(const float* cb, int j, int d4, int D) {
  if (Q8) {
    const signed char* base = reinterpret_cast<const signed char*>(cb);
    const signed char* vr = base + (size_t)kChunk * (D + 16) + (size_t)j * D;
    const float vsc = reinterpret_cast<const float*>(
        base + (size_t)kChunk * (2 * D + 16))[kChunk + j];
    const char4 v = reinterpret_cast<const char4*>(vr)[d4];
    return make_float4((float)v.x * vsc, (float)v.y * vsc, (float)v.z * vsc,
                       (float)v.w * vsc);
  }
  return reinterpret_cast<const float4*>(cb + (size_t)kChunk * (D + 4) + (size_t)j * D)[d4];
}

template <bool Q8>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int D4 = D >> 2;
  const int R = p.q_block * p.rep;
  const size_t CB = chunk_floats<Q8>(D);
  float* qs = smem;                       // [R][D]
  float* buf = qs + (size_t)R * D;        // 2 chunk buffers of CB floats
  float* sc = buf + 2 * CB;               // [R][kChunk]
  float* acc = sc + (size_t)R * kChunk;   // [R][D]
  float* m_s = acc + (size_t)R * D;       // [R]
  float* l_s = m_s + R;                   // [R]
  float* a_s = l_s + R;                   // [R]

  const int qbg = blockIdx.x;  // global q block
  const int kvh = blockIdx.y;  // kv head
  const int tid = threadIdx.x;
  const int tok0 = qbg * p.q_block;

  // Which sequence owns this q block: segment b starts at q block
  // sum(ceil(q_lens[:b] / q_block)). B is at most the engine's slot count.
  int b = -1, qb = 0, cum = 0;
  for (int i = 0; i < p.B; ++i) {
    const int n = (max(p.q_lens[i], 0) + p.q_block - 1) / p.q_block;
    if (qbg < cum + n) {
      b = i;
      qb = qbg - cum;
      break;
    }
    cum += n;
  }

  if (b < 0) {  // padding q block past the live total: zero rows, exit
    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int tok = tok0 + r / p.rep;
      if (tok < p.T)
        p.out[((size_t)tok * p.Hq + kvh * p.rep + r % p.rep) * D + d] = 0.f;
    }
    return;
  }

  const int kv_len = p.kv_lens[b];
  const int base = kv_len - p.q_lens[b] + qb * p.q_block;  // q_pos of row token 0
  const int kv_need = min(kv_len, base + p.q_block);       // causal truncation
  const int* bt = p.block_tables + (size_t)b * p.NP;
  // the first chunk's copies fly while the q rows are staged
  if (kv_need > 0) stage_chunk<Q8>(p, bt, kvh, 0, min(kChunk, kv_need), buf);

  // Row r is token r / rep of the q block, query head kvh * rep + r % rep.
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int tok = tok0 + r / p.rep;
    const int h = kvh * p.rep + r % p.rep;
    qs[e] = tok < p.T ? p.q[((size_t)tok * p.Hq + h) * D + d] * p.scale : 0.f;
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int c0 = 0, it = 0; c0 < kv_need; c0 += kChunk, ++it) {
    const int n = min(kChunk, kv_need - c0);
    const float* cb = buf + (it & 1) * CB;

    // 1. start the next chunk's copies into the other buffer (its last
    //    reader finished before the barrier that ended the previous
    //    iteration), then wait for this chunk's
    const int c1 = c0 + kChunk;
    if (c1 < kv_need) {
      stage_chunk<Q8>(p, bt, kvh, c1, min(kChunk, kv_need - c1), buf + ((it + 1) & 1) * CB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. scores, masked by kv_pos <= q_pos
    for (int e = tid; e < R * n; e += kThreads) {
      const int r = e / n, j = e - r * n;
      const float s = score<Q8>(qs + (size_t)r * D, cb, j, D);
      sc[r * kChunk + j] = (c0 + j <= base + r / p.rep) ? s : -INFINITY;
    }
    __syncthreads();

    // 3. online softmax, one warp per row; a masked entry gets weight 0
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = sc + r * kChunk;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = m_new == -INFINITY ? 0.f : expf(sr[j] - m_new);
        sr[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V, four columns per thread
    for (int e = tid; e < R * D4; e += kThreads) {
      const int r = e / D4, d4 = e - r * D4;
      const float* pr = sc + r * kChunk;
      float4* a4 = reinterpret_cast<float4*>(acc + (size_t)r * D) + d4;
      const float alpha = a_s[r];
      float4 a = *a4;
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = pr[j];
        const float4 v = v_row4<Q8>(cb, j, d4, D);
        a.x = fmaf(pj, v.x, a.x);
        a.y = fmaf(pj, v.y, a.y);
        a.z = fmaf(pj, v.z, a.z);
        a.w = fmaf(pj, v.w, a.w);
      }
      *a4 = a;
    }
    __syncthreads();
  }

  // 5. normalise; a row that attended nothing (l == 0) writes 0
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int tok = tok0 + r / p.rep;
    if (tok >= p.T) continue;
    const float l = l_s[r];
    p.out[((size_t)tok * p.Hq + kvh * p.rep + r % p.rep) * D + d] =
        l == 0.f ? 0.f : acc[e] / l;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes (int8 pools: q8 != 0).
size_t pdt_ragged_paged_attention_smem_bytes(int q_block, int rep, int d, int q8) {
  return (q8 ? smem_floats<true>(q_block * rep, d) : smem_floats<false>(q_block * rep, d)) *
         sizeof(float);
}

}  // extern "C"

namespace {

template <bool Q8>
int launch(const Params& p, void* stream) {
  if (p.T <= 0 || p.Hk <= 0) return (int)cudaSuccess;
  const size_t smem = pdt_ragged_paged_attention_smem_bytes(p.q_block, p.rep, p.D, Q8);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel<Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.T + p.q_block - 1) / p.q_block, p.Hk);
  ragged_paged_attention_kernel<Q8><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); returns a cudaError_t as int.
int pdt_ragged_paged_attention_f32(const float* q, const float* k_pages,
                                   const float* v_pages, const int* block_tables,
                                   const int* kv_lens, const int* q_lens, float* out,
                                   int T, int Hq, int Hk, int D, int P, int page_size,
                                   int B, int NP, int q_block, float scale,
                                   void* stream) {
  if (Hk <= 0) return (int)cudaSuccess;
  Params p{q, k_pages, v_pages, nullptr, nullptr, block_tables, kv_lens, q_lens, out,
           T, Hq, Hk, D, P, page_size, B, NP, q_block, Hq / Hk, scale};
  return launch<false>(p, stream);
}

// int8 pools [Hk, P, page_size, D] with f32 scales [Hk, P, page_size];
// D % 16 == 0.
int pdt_ragged_paged_attention_i8(const float* q, const signed char* k_pages,
                                  const signed char* v_pages, const float* k_scales,
                                  const float* v_scales, const int* block_tables,
                                  const int* kv_lens, const int* q_lens, float* out,
                                  int T, int Hq, int Hk, int D, int P, int page_size,
                                  int B, int NP, int q_block, float scale,
                                  void* stream) {
  if (Hk <= 0) return (int)cudaSuccess;
  Params p{q, k_pages, v_pages, k_scales, v_scales, block_tables, kv_lens, q_lens, out,
           T, Hq, Hk, D, P, page_size, B, NP, q_block, Hq / Hk, scale};
  return launch<true>(p, stream);
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
