// Building blocks of the fused decode kernels (fused_decode_qkv.cu,
// fused_decode_mlp.cu): a decode step multiplies a handful of rows (one
// token per serving slot) by weight matrices kept in the nn.Linear
// layout [out, in]. Each output column is then one contiguous weight row
// dotted with every activation row: a weight-streaming GEMV whose cost
// is the weight bytes, read once. Warps read weight rows with 16-byte
// loads, several in flight per lane; the activation rows sit in shared
// memory, normalised there first where the layer asks for a norm. Rows
// too wide for shared memory stream through it in K-chunks (load_chunk),
// or a CTA takes one K-slice of them; either is normalised on the way
// from per-row statistics (row_norm_stats). Split-K partial sums are
// added in slice order (slice_sum), so two calls give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;   // activation rows one warp carries per pass

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The norm's statistics of rows x [B, K] (device or shared memory), for
// rows that stream through shared memory in K-chunks (load_chunk) or by
// K-slices: stat[2 r] = the row's mean (0 for rms), stat[2 r + 1] = its
// rsqrt(var + eps) (layer: var = E[x^2] - mean^2) or rsqrt(E[x^2] + eps)
// (rms). 16-byte loads, kStatLoads in flight a lane (one round trip for a
// row of up to 32 kStatLoads float4s: GPT-124M's 768 floats); plain
// loads, never through the read-only path (x may have been written
// earlier in the same launch). One warp per row; x 16-byte aligned, K % 4
// == 0.
// Ends with a block barrier.
constexpr int kStatLoads = 8;

__device__ inline void row_norm_stats(float* stat, const float* x, int B, int K,
                                      bool rms, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K4 = K / 4;
  for (int r = warp; r < B; r += blockDim.x / 32) {
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)r * K);
    float sum = 0.f, sq = 0.f;
    for (int base = lane; base < K4; base += 32 * kStatLoads) {
      float4 v[kStatLoads];
#pragma unroll
      for (int u = 0; u < kStatLoads; ++u)
        v[u] = base + 32 * u < K4 ? row[base + 32 * u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kStatLoads; ++u) {
        sum += (v[u].x + v[u].y) + (v[u].z + v[u].w);
        sq = fmaf(v[u].x, v[u].x, sq);
        sq = fmaf(v[u].y, v[u].y, sq);
        sq = fmaf(v[u].z, v[u].z, sq);
        sq = fmaf(v[u].w, v[u].w, sq);
      }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if (lane == 0) {
      const float mean = rms ? 0.f : sum / K;
      const float var = rms ? sq / K : sq / K - mean * mean;
      stat[2 * r] = mean;
      stat[2 * r + 1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
}

// One element through the norm of row_norm_stats' statistics, in
// `_norm_block`'s order: ((v - mean) * rstd) * w (layer) or (v * rstd) * w
// (rms), then + b only where b is given.
__device__ inline float norm_one(float v, float mean, float rstd, bool rms,
                                 float w, const float* b, int k) {
  v = (rms ? v * rstd : (v - mean) * rstd) * w;
  return b != nullptr ? v + __ldg(b + k) : v;
}

// A float4 through the norm of row_norm_stats' statistics, as norm_one:
// ((v - mean) * rstd) * w (layer) or (v * rstd) * w (rms), then + b only
// where b is given (b and w the float4s of the same columns).
__device__ inline float4 norm4(float4 v, float mean, float rstd, bool rms, float4 w,
                               const float4* b) {
  v.x = (rms ? v.x * rstd : (v.x - mean) * rstd) * w.x;
  v.y = (rms ? v.y * rstd : (v.y - mean) * rstd) * w.y;
  v.z = (rms ? v.z * rstd : (v.z - mean) * rstd) * w.z;
  v.w = (rms ? v.w * rstd : (v.w - mean) * rstd) * w.w;
  if (b != nullptr) {
    const float4 c = *b;
    v.x += c.x;
    v.y += c.y;
    v.z += c.z;
    v.w += c.w;
  }
  return v;
}

// Stream K-chunks of activation rows through shared memory: copy columns
// [k0, k0 + kc) of rows src [B, ld] into s [B, kc] (rows kc floats apart),
// every thread of the block taking part, kLoads 16-byte loads in flight
// per thread. With `stat` (row_norm_stats), each element is normalised on
// the way with weight w [ld] and bias b [ld] or null. A row too wide for
// shared memory (LLaMA-7B's MLP: 8 rows of 11008 floats are 352 KB) then
// takes several chunks, the caller carrying each output's partial sum
// from one chunk to the next. Plain loads, as row_norm_stats. ld, k0, kc %
// 4 == 0.
template <int kLoads = 4>
__device__ inline void load_chunk(float* s, const float* src, int B, int ld,
                                  int k0, int kc, const float* stat, bool rms,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b) {
  const int c4 = kc / 4, n4 = B * c4, step = blockDim.x;
  float4* d4 = reinterpret_cast<float4*>(s);
  for (int base = threadIdx.x; base < n4; base += kLoads * step) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * step;
      if (i < n4) {
        const int r = i / c4, c = i - r * c4;
        v[u] = reinterpret_cast<const float4*>(src + (size_t)r * ld + k0)[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * step;
      if (i >= n4) continue;
      if (stat != nullptr) {
        const int r = i / c4, k = k0 + 4 * (i - r * c4);
        const float mean = stat[2 * r], rstd = stat[2 * r + 1];
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k));
        v[u].x = norm_one(v[u].x, mean, rstd, rms, wv.x, b, k);
        v[u].y = norm_one(v[u].y, mean, rstd, rms, wv.y, b, k + 1);
        v[u].z = norm_one(v[u].z, mean, rstd, rms, wv.z, b, k + 2);
        v[u].w = norm_one(v[u].w, mean, rstd, rms, wv.w, b, k + 3);
      }
      d4[i] = v[u];
    }
  }
}

// Ask the L2 for rows [n0, n1) of a weight matrix [N, K] (fp32, rows
// contiguous), every thread of the block taking 128-byte lines in turn.
// The loads that follow then find the bytes in L2: issued at kernel start,
// the fetch overlaps the activations' LayerNorm prologue.
__device__ inline void prefetch_rows_l2(const float* w, int K, int n0, int n1) {
  if (n1 <= n0) return;
  const char* base = reinterpret_cast<const char*>(w + (size_t)n0 * K);
  const size_t lines = ((size_t)(n1 - n0) * K * sizeof(float) + 127) / 128;
  for (size_t i = threadIdx.x; i < lines; i += blockDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + i * 128));
}

// The same for one row, by the lanes of one warp.
__device__ inline void prefetch_row_l2(const float* w_row, int K) {
  const char* base = reinterpret_cast<const char*>(w_row);
  const int lines = (K * (int)sizeof(float) + 127) / 128;
  for (int i = threadIdx.x % 32; i < lines; i += 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + (size_t)i * 128));
}

constexpr int kBatch = 8;   // 16-byte weight loads in flight per lane

// acc[i][r] = dot(a[r, :K], w[i][:K]) for i < kN weight rows and r < nr
// (nr <= kRowTile), summed across the warp: every lane returns the totals.
// `a` is shared memory with rows K floats apart; each w[i] is a weight row
// in device memory, 16-byte aligned, K % 4 == 0. Each activation float4
// read from shared memory feeds kN weight float4s, so shared-memory
// traffic per weight byte falls kN-fold (at 8 rows, one weight row at a
// time reads 8 bytes of shared memory per weight byte, which bounds the
// SM before its share of HBM does at LLaMA-7B's widths). kBatch / kN
// 16-byte loads per weight row and lane are issued before any is used,
// kBatch in all. Every lane adds its k = lane + 32 j terms in ascending j
// whatever kN is.
template <int kN>
__device__ inline void warp_dot_multi(const float* const (&w)[kN], const float* a,
                                      int K, int nr, float (&acc)[kN][kRowTile]) {
  constexpr int kB = kBatch / kN;
  static_assert(kB >= 1 && kB * kN == kBatch, "kN must divide kBatch");
  const int lane = threadIdx.x % 32;
  const int K4 = K / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) acc[i][r] = 0.f;
  for (int base = lane; base < K4; base += 32 * kB) {
    float4 wv[kN][kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int k = base + 32 * u;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        wv[i][u] = k < K4 ? __ldg(reinterpret_cast<const float4*>(w[i]) + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int k = base + 32 * u;
      if (k >= K4) break;
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r < nr) {
          const float4 av = a4[(size_t)r * K4 + k];
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            acc[i][r] = fmaf(av.x, wv[i][u].x, acc[i][r]);
            acc[i][r] = fmaf(av.y, wv[i][u].y, acc[i][r]);
            acc[i][r] = fmaf(av.z, wv[i][u].z, acc[i][r]);
            acc[i][r] = fmaf(av.w, wv[i][u].w, acc[i][r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) acc[i][r] = warp_sum(acc[i][r]);
}

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

// Part s of n units cut into S parts (the first index of the part).
__device__ __forceinline__ int cut(int s, int n, int S) {
  return (int)((long long)s * n / S);
}

constexpr int kReduceBatch = 8;   // slice sums of an output loaded at once

// The sum in slice order of S split-K partial sums `step` floats apart
// from src, written earlier in this launch by other CTAs (read from L2):
// a fixed order, so the same bits on every call.
__device__ inline float slice_sum(const float* src, size_t step, int S) {
  float o = 0.f;
  for (int s0 = 0; s0 < S; s0 += kReduceBatch) {
    float t[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      if (s0 + j < S) t[j] = __ldcg(src + (s0 + j) * step);
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      if (s0 + j < S) o += t[j];
  }
  return o;
}

// Copy n floats from device memory into shared memory without holding
// them in registers (cp.async, 16 bytes at a time, every thread of the
// block taking part; both 16-byte aligned, n % 4 == 0), through the L2
// (data written earlier in this launch by other CTAs reads right). The
// copies land by cp_async_wait_all() and a block barrier.
__device__ inline void copy_async(float* smem, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src + 4 * i));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Set the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace decode
