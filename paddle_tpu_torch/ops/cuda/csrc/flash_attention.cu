// Flash attention forward and backward (causal, GQA, Sq != Sk), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd` (`_fwd_kernel`) and `_bwd`
// (`_bwd_fused_kernel`) of paddle_tpu/ops/pallas/flash_attention.py, with
// their arithmetic: q scaled once on load, scores and softmax state in
// fp32, masked scores at NEG_INF = -1e30 (never -inf, so no exp() gives
// NaN), causal alignment at the bottom-right corner (q row i attends key
// j <= i + Sk - Sq), logsumexp saved by the forward, probabilities
// recomputed from it in the backward, dq/dk/dv accumulated in fp32 and
// cast to the input type. Rows that attend nothing give o = 0,
// lse = -1e30 and zero gradients.
//
// Which inputs it serves: flash_attention.py's route rule (tc_route)
// sends bf16 inputs with head_dim 64 or 128 and 16-byte aligned base
// pointers and strides to the tensor-core kernels of
// flash_attention_sm90.cu (the training paths' calls); these kernels take
// every other call: fp32 inputs (the fp32 parity steps, held to 1e-4
// against the CPU), other head dims up to 128, and unaligned views.
//
// What bounds it on an H100: arithmetic. This is the port's first,
// simple design: the products run as fp32 FMAs on the CUDA cores (fp32
// and bf16 inputs alike are widened to fp32 in shared memory), so it is
// bound by the fp32 FMA rate and shared-memory reads, far above the
// tensor-core bound.
//
// Layout: q [B, Sq, Hq, D], k and v [B, Sk, Hk, D] with the last dim
// contiguous and any (batch, seq, head) strides, so the unbound views of
// a fused qkv projection go in without a copy. o, dq [B, Sq, Hq, D] and
// dk, dv [B, Sk, Hk, D] are written contiguous; lse and delta are
// [B, Hq, Sq] fp32.
//
// Forward: one CTA per (q tile of 64 rows, q head, batch). The TPU's
// sequential k grid becomes a loop inside the CTA, which stops at the
// causal diagonal. 128 threads: a warp holds 16 rows x 64 columns of the
// score tile, each thread 4 rows x 8 columns, so a row's max and sum are
// three shuffles among 8 lanes.
//
// Backward, design (a), deterministic: the TPU kernel carries dq in a
// scratch buffer across its sequential (k block, q block) grid, and CUDA
// blocks run in no order. So two kernels: one CTA per (k tile, kv head,
// batch) recomputes p and ds for every q tile of every q head of its GQA
// group and accumulates dk and dv in registers (the group sum happens in
// place); one CTA per (q tile, q head, batch) recomputes them again for
// its row and accumulates dq. That is 7 tile products per (q, k) tile
// pair instead of the fused kernel's 5, with no atomics.
// delta = rowsum(dO * O) comes from the wrapper, as JAX computes it
// outside the kernel.
//
// Plain C interface (bound with ctypes); the wrapper in
// flash_attention.py checks shapes, types and strides and allocates the
// outputs. Each launcher returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // q rows and k columns of a tile
constexpr int kLdP = kTile + 1;    // padded row of a score tile in smem
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ inline float to_f(T x);
template <>
__device__ inline float to_f<float>(float x) { return x; }
template <>
__device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ inline T from_f(float x);
template <>
__device__ inline float from_f<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward only
  void* o;              // forward output
  float* lse;           // [B, Hq, Sq]
  const float* delta;   // [B, Hq, Sq], backward only
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hk, Sq, Sk, D;
  long long qsb, qss, qsh;   // element strides of q (batch, seq, head)
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long dsb, dss, dsh;   // of dout
  float scale;
  int causal;
  int vec;          // every row 16-byte aligned, D a multiple of 16 B of T
};

// 16 bytes of T widened to fp32
__device__ inline void unpack16(const uint4& u, float* x, float) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ inline void unpack16(const uint4& u, float* x, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// rows [r0, r0 + 64) of one (batch, head) slice -> smem [64][DP + 1] fp32,
// times `mul`; rows past `rows` and columns past D are zero. With `vec`
// (16-byte aligned rows, D a multiple of 16 bytes of T) each thread
// moves 16 bytes per load, and the loads of a tile are issued together,
// so the tile costs one memory latency, not one per element.
template <typename T, int DP>
__device__ inline void load_tile(float* sm, const T* base, long long ss,
                                 int r0, int rows, int D, float mul, int vec) {
  constexpr int LD = DP + 1;
  if (vec) {
    constexpr int V = 16 / sizeof(T);   // elements per 16-byte chunk
    constexpr int CPR = DP / V;         // chunks per padded row
#pragma unroll 4
    for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
      const int r = i / CPR, c0 = (i % CPR) * V;
      float x[V];
      if (r0 + r < rows && c0 < D) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            base + (long long)(r0 + r) * ss + c0);
        unpack16(u, x, T());
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sm[r * LD + c0 + j] = x[j] * mul;
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r0 + r < rows && c < D) x = to_f<T>(base[(long long)(r0 + r) * ss + c]) * mul;
    sm[r * LD + c] = x;
  }
}

__device__ inline float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ inline float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// number of k tiles the q tile starting at q0 needs (causal: up to the
// diagonal of its last row; may be 0 when no row attends anything)
__device__ inline int k_tiles(int q0, int Sq, int Sk, int causal) {
  const int nk = (Sk + kTile - 1) / kTile;
  if (!causal) return nk;
  const int lim = q0 + kTile + (Sk - Sq) + kTile - 1;
  return lim <= 0 ? 0 : min(nk, lim / kTile);
}

template <int DP>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  return 3 * (size_t)kTile * (DP + 1) + (size_t)kTile * kLdP;
}
template <int DP>
__host__ __device__ constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)kTile * (DP + 1) + 2 * (size_t)kTile * kLdP + 2 * kTile;
}
template <int DP>
__host__ __device__ constexpr size_t dq_smem_floats() {
  return 4 * (size_t)kTile * (DP + 1) + (size_t)kTile * kLdP + 2 * kTile;
}

// ------------------------------------------------------------ forward --
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = DP + 1;
  constexpr int DC = DP / 8;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;                              // column lane
  const int ty = (threadIdx.x >> 5) * 4 + (lane >> 3);  // row group 0..15
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  load_tile<T, DP>(Qs, qb, p.qss, q0, p.Sq, p.D, p.scale, p.vec);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int hi = k_tiles(q0, p.Sq, p.Sk, p.causal);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kTile;
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile<T, DP>(Ks, kb, p.kss, k0, p.Sk, p.D, 1.f, p.vec);
    load_tile<T, DP>(Vs, vb, p.vss, k0, p.Sk, p.D, 1.f, p.vec);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[(tx + 8 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + tx + 8 * c;
        const bool good = col < p.Sk && (!p.causal || row + offset >= col);
        ok |= (unsigned)good << c;
        if (!good) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e = ((ok >> c) & 1u) ? expf(s[i][c] - m_new) : 0.f;
        s[i][c] = e;
        rs += e;
      }
      rs = group8_sum(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 8; ++c) Ps[(ty + 16 * i) * kLdP + tx + 8 * c] = s[i][c];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.D) orow[d] = from_f<T>(acc[i][c] / ls);
    }
    if (tx == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------ backward: dk and dv --
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = DP + 1;
  constexpr int DC = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Pt = dOs + kTile * LD;     // p transposed: [k][q]
  float* dSt = Pt + kTile * kLdP;   // ds transposed
  float* Ls = dSt + kTile * kLdP;   // lse of the q tile's rows
  float* Dl = Ls + kTile;           // delta of the q tile's rows

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.Hq / p.Hk;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;                              // q-column lane
  const int ty = (threadIdx.x >> 5) * 4 + (lane >> 3);  // k-row group
  const int offset = p.Sk - p.Sq;

  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  load_tile<T, DP>(Ks, kb, p.kss, k0, p.Sk, p.D, 1.f, p.vec);
  load_tile<T, DP>(Vs, vb, p.vss, k0, p.Sk, p.D, 1.f, p.vec);

  float dK[4][DC], dV[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dK[i][c] = dV[i][c] = 0.f;

  const int nq = (p.Sq + kTile - 1) / kTile;
  const int lo = p.causal ? max(0, (k0 - offset) / kTile) : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
    const T* db = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;
    const long long stat = ((long long)b * p.Hq + h) * p.Sq;
    for (int iq = lo; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();   // the previous q tile is consumed
      load_tile<T, DP>(Qs, qb, p.qss, q0, p.Sq, p.D, p.scale, p.vec);
      load_tile<T, DP>(dOs, db, p.dss, q0, p.Sq, p.D, 1.f, p.vec);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < p.Sq;
        Ls[r] = in ? p.lse[stat + q0 + r] : 0.f;
        Dl[r] = in ? p.delta[stat + q0 + r] : 0.f;
      }
      __syncthreads();

      float st[4][8], dpt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; ++d) {
        float kv[4], vv[4], qv[8], ov[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          qv[c] = Qs[(tx + 8 * c) * LD + d];
          ov[c] = dOs[(tx + 8 * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], ov[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kcol = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int qr = tx + 8 * c;
          const int qrow = q0 + qr;
          const bool good = kcol < p.Sk && qrow < p.Sq &&
                            (!p.causal || qrow + offset >= kcol);
          const float pr = good ? expf(st[i][c] - Ls[qr]) : 0.f;
          Pt[(ty + 16 * i) * kLdP + qr] = pr;
          dSt[(ty + 16 * i) * kLdP + qr] = pr * (dpt[i][c] - Dl[qr]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], sv[4], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty + 16 * i) * kLdP + qq];
          sv[i] = dSt[(ty + 16 * i) * kLdP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dOs[qq * LD + tx + 8 * c];
          qv[c] = Qs[qq * LD + tx + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dV[i][c] = fmaf(pv[i], dov[c], dV[i][c]);
            dK[i][c] = fmaf(sv[i], qv[c], dK[i][c]);
          }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + ty + 16 * i;
    if (krow >= p.Sk) continue;
    const long long base = (((long long)b * p.Sk + krow) * p.Hk + hk) * p.D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.D) {
        dk[base + d] = from_f<T>(dK[i][c]);
        dv[base + d] = from_f<T>(dV[i][c]);
      }
    }
  }
}

// ------------------------------------------------------ backward: dq --
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = DP + 1;
  constexpr int DC = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;     // ds: [q][k]
  float* Ls = dSs + kTile * kLdP;
  float* Dl = Ls + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;                              // k-column lane
  const int ty = (threadIdx.x >> 5) * 4 + (lane >> 3);  // q-row group
  const int offset = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* db = static_cast<const T*>(p.dout) + b * p.dsb + h * p.dsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;
  const long long stat = ((long long)b * p.Hq + h) * p.Sq;
  load_tile<T, DP>(Qs, qb, p.qss, q0, p.Sq, p.D, p.scale, p.vec);
  load_tile<T, DP>(dOs, db, p.dss, q0, p.Sq, p.D, 1.f, p.vec);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < p.Sq;
    Ls[r] = in ? p.lse[stat + q0 + r] : 0.f;
    Dl[r] = in ? p.delta[stat + q0 + r] : 0.f;
  }

  float dQ[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dQ[i][c] = 0.f;

  const int hi = k_tiles(q0, p.Sq, p.Sk, p.causal);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<T, DP>(Ks, kb, p.kss, k0, p.Sk, p.D, 1.f, p.vec);
    load_tile<T, DP>(Vs, vb, p.vss, k0, p.Sk, p.D, 1.f, p.vec);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        ov[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        kv[c] = Ks[(tx + 8 * c) * LD + d];
        vv[c] = Vs[(tx + 8 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
      const int qrow = q0 + qr;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = k0 + tx + 8 * c;
        const bool good = col < p.Sk && qrow < p.Sq &&
                          (!p.causal || qrow + offset >= col);
        const float pr = good ? expf(s[i][c] - Ls[qr]) : 0.f;
        dSs[qr * kLdP + tx + 8 * c] = pr * (dp[i][c] - Dl[qr]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dQ[i][c] = fmaf(sv[i], kv[c], dQ[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    T* drow = dq + (((long long)b * p.Sq + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.D) drow[d] = from_f<T>(dQ[i][c] * p.scale);
    }
  }
}

// ------------------------------------------------------------ launch --
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DP>
int launch_fwd(const Params& p, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  cudaError_t err = set_smem(flash_fwd_kernel<T, DP>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.Hq, p.B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_bwd(const Params& p, cudaStream_t stream) {
  const size_t smem_kv = dkv_smem_floats<DP>() * sizeof(float);
  const size_t smem_q = dq_smem_floats<DP>() * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, DP>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = set_smem(flash_bwd_dq_kernel<T, DP>, smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((p.Sk + kTile - 1) / kTile, p.Hk, p.B);
  flash_bwd_dkv_kernel<T, DP><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((p.Sq + kTile - 1) / kTile, p.Hq, p.B);
  flash_bwd_dq_kernel<T, DP><<<grid_q, kThreads, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

// head_dim padded to 32, 64 or 128 (the wrapper refuses D > 128)
template <typename T>
int dispatch(const Params& p, cudaStream_t stream, bool fwd) {
  if (p.D <= 32) return fwd ? launch_fwd<T, 32>(p, stream) : launch_bwd<T, 32>(p, stream);
  if (p.D <= 64) return fwd ? launch_fwd<T, 64>(p, stream) : launch_bwd<T, 64>(p, stream);
  return fwd ? launch_fwd<T, 128>(p, stream) : launch_bwd<T, 128>(p, stream);
}

int run(const Params& p, int dtype, void* stream, bool fwd) {
  if (p.B <= 0 || p.Hq <= 0 || p.Sq <= 0 || p.Sk <= 0) return (int)cudaSuccess;
  if (p.D <= 0 || p.D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(p, s, fwd);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s, fwd);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements. `vec`: the
// caller checked that every row start is 16-byte aligned and D is a
// multiple of 16 bytes of the type. Launches on `stream` (a
// cudaStream_t); returns a cudaError_t as int.
int pdt_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int Hq, int Hk, int Sq,
                            int Sk, int D, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss,
                            long long vsh, float scale, int causal, int vec,
                            void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.scale = scale; p.causal = causal; p.vec = vec;
  return run(p, dtype, stream, true);
}

int pdt_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, void* dk, void* dv, int B, int Hq, int Hk,
                            int Sq, int Sk, int D, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss,
                            long long vsh, long long dsb, long long dss,
                            long long dsh, float scale, int causal, int vec,
                            void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = const_cast<float*>(lse);
  p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Hq = Hq; p.Hk = Hk; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.qsb = qsb; p.qss = qss; p.qsh = qsh;
  p.ksb = ksb; p.kss = kss; p.ksh = ksh;
  p.vsb = vsb; p.vss = vss; p.vsh = vsh;
  p.dsb = dsb; p.dss = dss; p.dsh = dsh;
  p.scale = scale; p.causal = causal; p.vec = vec;
  return run(p, dtype, stream, false);
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
