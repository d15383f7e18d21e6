// Ragged paged attention over fp32 KV page pools, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (paddle_tpu/ops/pallas/paged_attention.py) for fp32 pools: packed query
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
// not once per load. The grid comes from static shapes only (kv heads x
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
  const float* k_pages;       // [Hk, P, page_size, D]
  const float* v_pages;       // [Hk, P, page_size, D]
  const int* block_tables;    // [B, NP]
  const int* kv_lens;         // [B]
  const int* q_lens;          // [B]
  float* out;                 // [T, Hq, D]
  int T, Hq, Hk, D, P, page_size, B, NP, q_block, rep;
  float scale;
};

// floats of one K+V chunk buffer (K rows padded by 4 floats)
__host__ __device__ inline size_t chunk_floats(int d) {
  return (size_t)kChunk * (d + 4) + (size_t)kChunk * d;
}

// shared-memory floats for R = q_block * rep rows of width D
__host__ __device__ inline size_t smem_floats(int rows, int d) {
  return (size_t)rows * d            // q rows, pre-scaled
         + 2 * chunk_floats(d)       // two K/V chunk buffers
         + (size_t)rows * kChunk     // scores, then probabilities
         + (size_t)rows * d          // output accumulator
         + 3 * (size_t)rows;         // running max, running sum, rescale
}

// 16-byte global -> shared copy that does not wait for the data
__device__ inline void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
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
// a chunk buffer (K rows at stride D + 4, V rows at stride D); all tokens
// are below kv_len, so never stale or unwritten pool memory.
__device__ inline void stage_chunk(const Params& p, const int* bt, int kvh,
                                   int c0, int n, float* ks, float* vs) {
  const int D = p.D, D4 = D >> 2, KS = D + 4;
  for (int e = threadIdx.x; e < n * D4; e += kThreads) {
    const int j = e / D4, d4 = e - j * D4;
    const int pos = c0 + j;
    const int page = __ldg(bt + pos / p.page_size);
    const size_t off =
        (((size_t)kvh * p.P + page) * p.page_size + pos % p.page_size) * D + 4 * d4;
    cp_async16(ks + j * KS + 4 * d4, p.k_pages + off);
    cp_async16(vs + j * D + 4 * d4, p.v_pages + off);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int D4 = D >> 2;
  const int KS = D + 4;  // K row stride: keeps float4 alignment, spreads banks
  const int R = p.q_block * p.rep;
  float* qs = smem;                       // [R][D]
  float* buf = qs + (size_t)R * D;        // 2 x ([kChunk][KS] K, [kChunk][D] V)
  float* sc = buf + 2 * chunk_floats(D);  // [R][kChunk]
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
  if (kv_need > 0) stage_chunk(p, bt, kvh, 0, min(kChunk, kv_need), buf, buf + kChunk * KS);

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
    float* ks = buf + (it & 1) * chunk_floats(D);
    float* vs = ks + kChunk * KS;

    // 1. start the next chunk's copies into the other buffer (its last
    //    reader finished before the barrier that ended the previous
    //    iteration), then wait for this chunk's
    const int c1 = c0 + kChunk;
    if (c1 < kv_need) {
      float* ks1 = buf + ((it + 1) & 1) * chunk_floats(D);
      stage_chunk(p, bt, kvh, c1, min(kChunk, kv_need - c1), ks1, ks1 + kChunk * KS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. scores, masked by kv_pos <= q_pos
    for (int e = tid; e < R * n; e += kThreads) {
      const int r = e / n, j = e - r * n;
      const float4* qr = reinterpret_cast<const float4*>(qs + (size_t)r * D);
      const float4* kj = reinterpret_cast<const float4*>(ks + j * KS);
      float s = 0.f;
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 a = qr[d4], c = kj[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
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
      const float4* v4 = reinterpret_cast<const float4*>(vs) + d4;
      float4* a4 = reinterpret_cast<float4*>(acc + (size_t)r * D) + d4;
      const float alpha = a_s[r];
      float4 a = *a4;
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = pr[j];
        const float4 v = v4[j * D4];
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

// Dynamic shared memory one CTA needs, in bytes.
size_t pdt_ragged_paged_attention_smem_bytes(int q_block, int rep, int d) {
  return smem_floats(q_block * rep, d) * sizeof(float);
}

// Launch on `stream` (a cudaStream_t); returns a cudaError_t as int.
int pdt_ragged_paged_attention_f32(const float* q, const float* k_pages,
                                   const float* v_pages, const int* block_tables,
                                   const int* kv_lens, const int* q_lens, float* out,
                                   int T, int Hq, int Hk, int D, int P, int page_size,
                                   int B, int NP, int q_block, float scale,
                                   void* stream) {
  if (T <= 0 || Hk <= 0) return (int)cudaSuccess;
  Params p{q, k_pages, v_pages, block_tables, kv_lens, q_lens, out,
           T, Hq, Hk, D, P, page_size, B, NP, q_block, Hq / Hk, scale};
  const size_t smem = pdt_ragged_paged_attention_smem_bytes(q_block, Hq / Hk, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((T + q_block - 1) / q_block, Hk);
  ragged_paged_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
