// Building blocks of the fused decode kernels (fused_decode_qkv.cu,
// fused_decode_mlp.cu): a decode step multiplies a handful of rows (one
// token per serving slot) by weight matrices kept in the nn.Linear
// layout [out, in]. Each output column is then one contiguous weight row
// dotted with every activation row: a weight-streaming GEMV whose cost
// is the weight bytes, read once. A warp owns a column and reads its row
// with 16-byte loads, up to eight in flight per lane, after the block
// asked the L2 for all of its rows; the activation rows sit in shared
// memory, normalised there first where the layer asks for a norm.

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

// Copy rows [B, K] from global memory into shared memory `s` (every
// thread of the block takes part), kLoads 16-byte loads per thread in
// flight before they are stored (more loads in flight, more registers:
// the epilogue, whose occupancy they would cut, takes one). `src` may
// have been written earlier in the same launch by other blocks (after a
// grid barrier), so it is read with plain loads, never through the
// read-only path. K % 4 == 0.
template <int kLoads = 8>
__device__ inline void load_rows(float* s, const float* src, int B, int K) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(s);
  const int n4 = B * K / 4, step = blockDim.x;
  for (int base = threadIdx.x; base < n4; base += kLoads * step) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * step < n4) v[u] = s4[base + u * step];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * step < n4) d4[base + u * step] = v[u];
  }
}

// LayerNorm of every row of s [B, H] in place, as the JAX package's
// `_norm_block` with norm="layer": var = E[x^2] - mean^2,
// ((x - mean) * rsqrt(var + eps)) * w, then + b only where b is given.
// One warp per row. Ends with a block barrier.
__device__ inline void layer_norm_rows(float* s, const float* __restrict__ w,
                                       const float* __restrict__ b, int B, int H,
                                       float eps) {
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += blockDim.x / 32) {
    float* row = s + (size_t)r * H;
    float sum = 0.f, sq = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float v = row[k];
      sum += v;
      sq = fmaf(v, v, sq);
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / H;
    const float var = sq / H - mean * mean;
    const float rstd = rsqrtf(var + eps);
    for (int k = lane; k < H; k += 32) {
      float v = ((row[k] - mean) * rstd) * __ldg(w + k);
      if (b != nullptr) v += __ldg(b + k);
      row[k] = v;
    }
  }
  __syncthreads();
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

// acc[r] = dot(a[r, :K], w_row[:K]) for r < nr (nr <= kRowTile), summed
// across the warp: every lane returns the totals. `a` is shared memory
// with rows K floats apart; w_row is a weight row in device memory, 16-byte
// aligned, K % 4 == 0. Up to kBatch 16-byte weight loads per lane are
// issued before any is used (a 768-wide row is one batch).
__device__ inline void warp_dot_rows(const float* __restrict__ w_row, const float* a,
                                     int K, int nr, float (&acc)[kRowTile]) {
  const int lane = threadIdx.x % 32;
  const int K4 = K / 4;
  const float4* w4 = reinterpret_cast<const float4*>(w_row);
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
  for (int base = lane; base < K4; base += 32 * kBatch) {
    float4 wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + 32 * u;
      wv[u] = k < K4 ? __ldg(w4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + 32 * u;
      if (k >= K4) break;
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r < nr) {
          const float4 av = a4[(size_t)r * K4 + k];
          acc[r] = fmaf(av.x, wv[u].x, acc[r]);
          acc[r] = fmaf(av.y, wv[u].y, acc[r]);
          acc[r] = fmaf(av.z, wv[u].z, acc[r]);
          acc[r] = fmaf(av.w, wv[u].w, acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = warp_sum(acc[r]);
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
