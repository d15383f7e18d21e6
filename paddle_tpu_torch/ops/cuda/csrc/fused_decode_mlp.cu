// Fused decode egress for Hopper (sm_90a), two kernels:
//
// * egress_kernel: the attention out-projection and its residual, the
//   norm, the MLP and the second residual of one decode layer, in one
//   launch. Replaces `_mlp_block` run by `_blocked_call`
//   (paddle_tpu/ops/pallas/fused_decode_mlp.py), both of `_mlp_tail`'s
//   branches:
//     y1 = x + (att @ wo + bo);  h = norm(y1);
//     GELU (arch="gpt"):     out = y1 + (gelu_tanh(h @ w1 + b1) @ w2 + b2)
//     SwiGLU (arch="llama"): out = y1 + ((silu(h @ wg) * (h @ wu)) @ wd + b2)
//   Its partial mode replaces `_mlp_partial_block` (fused_decode_mlp_partial,
//   same file), tensor parallelism's shard-local MLP: y1 given, a rank's
//   slices, no out projection, no fc2 bias, no residual: the partial sum
//   before the layer's all-reduce. One weight stream with split K; its
//   design is written above it.
// * fused_decode_epilogue: the final LayerNorm or RMSNorm, the LM head
//   and the guarded greedy pick, in one launch. Replaces
//   `_epilogue_block` (same file): logits = norm(x) @ w_lm^T (+ b_lm),
//   then with lg = logits + poison, bad = any non-finite lg in the row,
//   nxt = bad ? 0 : the FIRST index of the row's maximum
//   (generation.guarded_argmax). One persistent wave of CTAs streaming
//   the head through rings in shared memory, for any number of rows; its
//   design is written above it.
//
// What bounds them on an H100: the weight bytes. At decode the batch is a
// few rows, so each product is a GEMV over a weight read once: 21.2 MB a
// layer for the egress at GPT-124M (~6.4 us at 3.35 TB/s), 608 MB at
// LLaMA-7B (~0.18 ms), and the 154.5 MB tied embedding for the GPT
// epilogue (~46 us). The TPU kernels walk row blocks of one grid with the
// weights resident in VMEM; one SM pulling those bytes would take hundreds
// of microseconds, so here the work of every product is spread over all
// SMs.
//
// The egress's products depend on each other across columns (fc1 needs
// every column of y1, fc2 every column of the activation), so it is a
// cooperative launch, its grid capped by the occupancy API so that all
// CTAs are resident, with a grid barrier (cooperative_groups
// this_grid().sync()) between the products; y1 [B, H] and the activation
// [B, I] pass through a global scratch that stays in L2. A refused
// cooperative launch returns its error and the wrapper raises: there is
// no fallback.
//
// fp32 FMAs on the CUDA cores (at 8 rows they are not the limit). Plain C
// interface (bound with ctypes); the wrappers in fused_decode_mlp.py check
// shapes, types and contiguity and allocate the outputs and the scratch.

#include <cooperative_groups.h>

#include "decode_gemv.cuh"

namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// egress_kernel: row 5, y1 = x + (att @ wo^T + bo), then out = y1 +
// (act(h) @ w2^T + b2) with h = norm(y1) and act(h) = gelu_tanh(h @ w1^T +
// b1) (GELU) or silu(h @ wg^T) * (h @ wu^T) (SwiGLU), and its tensor-
// parallel partial mode (row 6: y1 given, a rank's slices, out =
// act(h) @ w2^T alone), as one unbroken weight stream. A call reads 608 MB
// at LLaMA-7B (row 5; 0.18 ms at 3.35 TB/s), 270 MB at its TP=2 (row 6;
// 81 us), 21.2 MB at GPT-124M (6.4 us) and 9.4 MB at its TP=2 (2.8 us);
// fp32 FMAs on the CUDA cores are 2 a weight byte at 8 rows, far from the
// SM's rate, so the design is of the memory pipeline:
//
// * Fixed, even slices. Each product's K is cut into slices of at most
//   kSliceQ float4s (the out projection: A / 512, the first MLP product:
//   H / 512, the second: I / 512; GPT-124M 2, 2 and 6, LLaMA-7B 8, 8 and
//   22), and the grid's CTAs into that many groups: CTA c takes slice
//   c % S of one block of about N / (grid / S) columns, so every CTA
//   streams the same bytes (+-1 column) and every warp the same number of
//   items (+-1). An item is two weight rows over the slice (SwiGLU's gate
//   and up rows of one column; else two neighbouring columns: of the out
//   projection, fc1, fc2 or the down projection), kQ 16-byte loads a row a
//   lane, past L1.
// * No reloads. A CTA stages its activation slice in shared memory once
//   (for the first MLP product under an RMSNorm without bias, y1 * w: the
//   row's 1 / rms multiplies the finished sums, from the slices' sums of
//   squares; any other norm, GPT's LayerNorm with its bias among them, is
//   applied on the way from full-row statistics), its warps dot the items
//   against it, RT rows at once in registers, and a transposed butterfly
//   leaves each lane one (row, weight row) total. A slice's sums go to a
//   global scratch; the S CTAs of a column block count their arrivals
//   and the slices are added in slice order, so two calls give the same
//   bits: SwiGLU, once all are in (every CTA is resident: a cooperative
//   launch), by each CTA for its 1/S of the block's outputs (one round
//   trip to L2, where one CTA doing all of LLaMA-7B's took several); GELU,
//   GPT's thin blocks, by the last CTA to arrive for all of them (one
//   round trip, and no CTA waits for another). The sums are finished
//   there, once: y1 with x and bo; gelu_tanh(sum + b1), or silu(g) * u;
//   out (with b2 and y1 in row 5).
// * The stream does not wait. A warp keeps the next item's weights in
//   registers while it computes the current one: the next product's first
//   items are in flight before each grid barrier, and land while the sums
//   finish and the grid waits. The first activation row's loads go out
//   before the first weights' (behind them they came back late, and every
//   product waits for them). (An L2 prefetch of the items beyond,
//   rolling or only where the stream would idle, measured slower on the
//   card for LLaMA-7B, and for GPT-124M all of a CTA's later items at
//   its start, 21 MB in all, too.)
//
// One cooperative launch, its grid every CTA the occupancy API lets be
// resident (two an SM), capped by the work; a refused launch returns its
// error and the wrapper raises.

__device__ inline float gelu_tanh(float v) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (v + kKappa * (v * v * v));
  return 0.5f * v * (1.f + tanhf(inner));
}

__device__ inline float silu(float v) { return v / (1.f + expf(-v)); }

constexpr int kEgThreads = 256;
constexpr int kEgWarps = kEgThreads / 32;
constexpr int kSliceQ = 128;              // float4s of a K-slice, at most
constexpr int kQ = kSliceQ / 32;          // float4s of a weight row a lane loads
constexpr int kBuf = 2;                   // items a warp holds in registers

using decode::cut;
using decode::dot4;
using decode::ld_stream4;
using decode::slice_sum;

struct EgressParams {
  const float* x;      // [B, H] residual stream (row 5)
  const float* att;    // [B, A] attention output (row 5)
  const float* wo;     // [H, A] out projection (row 5)
  const float* bo;     // [H] or null
  const float* nw;     // [H]
  const float* nb;     // [H] or null
  const float* w1;     // [I, H] fc1 (GELU) or the gate (SwiGLU)
  const float* b1;     // [I] or null (GELU)
  const float* wu;     // [I, H] the up projection (SwiGLU)
  const float* w2;     // [H, I] fc2 or the down projection
  const float* b2;     // [H] or null (row 5)
  float* y1;           // [B, H]: written by the out projection (row 5), else given
  float* part0;        // [S0, B, H] out-projection slice sums (row 5)
  float* part_a;       // fc1 slice sums [SA, B, I] (GELU); gate, up [SA, 2, B, I]
  float* part_b;       // [SB, B, H] second-product slice sums
  float* ss;           // [CA, SA, B] slice sums of squares (fast path)
  float* f;            // [B, I] the activation
  float* out;          // [B, H]
  unsigned* tickets;   // [C0 + CA + CB] arrival counts
  int B, H, A, I, S0, SA, SB, C0, CA, CB, rows;   // rows: B rounded up to RT
  int rms, fast;       // fast: RMSNorm without bias, 1 / rms factored out
  float eps;
};

// The warp's totals of V values (V a power of two, 2 to 32): each
// exchange halves the values a lane keeps, so lane l ends with the total
// of value l / (32 / V) after 5 + V - 1 - log2(V) shuffles (V = 8: 10,
// against 40 for a butterfly a value). A fixed order: the same bits on
// every call.
template <int V>
__device__ __forceinline__ float warp_sum_transposed(float (&v)[V]) {
  const int lane = threadIdx.x % 32;
  int m = 16;
#pragma unroll
  for (int n = V; n > 1; n >>= 1, m >>= 1) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  float r = v[0];
  for (; m >= 1; m >>= 1) r += __shfl_xor_sync(0xffffffffu, r, m);
  return r;
}

// A product's share of this CTA: K-slice s of its float4s [q0, q1) and
// columns [n0, n1) of column block cb (none where the CTA has no share).
struct Share {
  bool in;
  int s, cb, q0, q1, n0, n1;
};

__device__ __forceinline__ Share share_of(int K4, int N, int S, int C) {
  Share r{false, 0, 0, 0, 0, 0, 0};
  if (S == 0 || (int)blockIdx.x >= C * S) return r;
  r.in = true;
  r.s = blockIdx.x % S;
  r.cb = blockIdx.x / S;
  r.q0 = cut(r.s, K4, S);
  r.q1 = cut(r.s + 1, K4, S);
  r.n0 = cut(r.cb, N, C);
  r.n1 = cut(r.cb + 1, N, C);
  return r;
}

// FULL: row 5 (the out projection first), else row 6. GELU: fc1 and
// gelu_tanh, else SwiGLU.
template <int RT, bool FULL, bool GELU>
__global__ void __launch_bounds__(kEgThreads, 2) egress_kernel(EgressParams p) {
  // [rows][kSliceQ] the activation slice; where the norm needs full-row
  // statistics (not fast), the norm's slices [2][kSliceQ] and y1 [B, H];
  // then the statistics
  extern __shared__ __align__(16) float4 xs[];
  float4* nsl = xs + (size_t)p.rows * kSliceQ;
  float* ys = reinterpret_cast<float*>(nsl + (p.fast ? 0 : 2 * kSliceQ));
  float* stat = ys + (p.fast ? 0 : (size_t)p.B * p.H);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr bool full = FULL;
  // the three products' shares, read from shared memory where used (in
  // registers they spilled the hot loop's)
  __shared__ Share shares[3];
  if (threadIdx.x == 0) {
    shares[0] = FULL ? share_of(p.A / 4, p.H, p.S0, p.C0) : Share{false, 0, 0, 0, 0, 0, 0};
    shares[1] = share_of(p.H / 4, p.I, p.SA, p.CA);
    shares[2] = share_of(p.I / 4, p.H, p.SB, p.CB);
  }
  __syncthreads();
  const volatile Share& s0 = shares[0];
  const volatile Share& sa = shares[1];
  const volatile Share& sb = shares[2];
  const int tA = p.C0, tB = p.C0 + p.CA;   // the products' first counts
  // this warp's items: column pairs of the out projection, gate/up columns
  // (SwiGLU) or fc1 column pairs (GELU), column pairs of the second
  // product, warp + 8 i of each
  auto count = [&](int n) { return n > warp ? (n - warp + kEgWarps - 1) / kEgWarps : 0; };
  const int eA = FULL ? count((s0.n1 - s0.n0 + 1) / 2) : 0;   // the first MLP item
  const int eB = eA + count(GELU ? (sa.n1 - sa.n0 + 1) / 2 : sa.n1 - sa.n0);
  const int nItems = eB + count((sb.n1 - sb.n0 + 1) / 2);

  // item i: its two weight rows from the slice start, the slice's length
  // in float4s and its (first) output column
  auto item = [&](int i, const float4*& r0, const float4*& r1, int& qlen, int& n) {
    if (!GELU && i >= eA && i < eB) {
      n = sa.n0 + warp + kEgWarps * (i - eA);
      r0 = reinterpret_cast<const float4*>(p.w1 + (size_t)n * p.H) + sa.q0;
      r1 = reinterpret_cast<const float4*>(p.wu + (size_t)n * p.H) + sa.q0;
      qlen = sa.q1 - sa.q0;
      return;
    }
    const int prod = i < eA ? 0 : i < eB ? 1 : 2;
    const volatile Share& sh = prod == 0 ? s0 : prod == 1 ? sa : sb;
    const float* w = prod == 0 ? p.wo : prod == 1 ? p.w1 : p.w2;
    const int K = prod == 0 ? p.A : prod == 1 ? p.H : p.I;
    n = sh.n0 + 2 * (warp + kEgWarps * (i - (prod == 0 ? 0 : prod == 1 ? eA : eB)));
    const int n1 = min(n + 1, sh.n1 - 1);   // an odd block's last pair repeats
    r0 = reinterpret_cast<const float4*>(w + (size_t)n * K) + sh.q0;
    r1 = reinterpret_cast<const float4*>(w + (size_t)n1 * K) + sh.q0;
    qlen = sh.q1 - sh.q0;
  };
  auto load = [&](float4 (&w)[2][kQ], int i) {
    if (i >= nItems) return;
    const float4 *r0, *r1;
    int qlen, n;
    item(i, r0, r1, qlen, n);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int q = lane + 32 * j;
      w[0][j] = q < qlen ? ld_stream4(r0 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      w[1][j] = q < qlen ? ld_stream4(r1 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // the item's 2 RT sums a row tile: value r < RT is row b0 + r against
  // the first weight row, RT + r against the second
  auto compute = [&](const float4 (&w)[2][kQ], int i) {
    if (i >= nItems) return;
    const float4 *r0, *r1;
    int qlen, n;
    item(i, r0, r1, qlen, n);
    for (int b0 = 0; b0 < p.rows; b0 += RT) {
      float v[2 * RT];
#pragma unroll
      for (int r = 0; r < 2 * RT; ++r) v[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q < qlen) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 a = xs[(b0 + r) * kSliceQ + q];
            v[r] = dot4(a, w[0][j], v[r]);
            v[RT + r] = dot4(a, w[1][j], v[RT + r]);
          }
        }
      }
      const float t = warp_sum_transposed<2 * RT>(v);
      constexpr int kSpan = 32 / (2 * RT);
      const int idx = lane / kSpan, b = b0 + idx % RT, second = idx / RT;
      if (lane % kSpan != 0 || b >= p.B) continue;
      if (i >= eA && i < eB) {
        if (!GELU)
          p.part_a[((size_t)(sa.s * 2 + second) * p.B + b) * p.I + n] = t;
        else if (n + second < sa.n1)
          p.part_a[((size_t)sa.s * p.B + b) * p.I + n + second] = t;
      } else if (i < eA) {
        if (n + second < s0.n1) p.part0[((size_t)s0.s * p.B + b) * p.H + n + second] = t;
      } else if (n + second < sb.n1) {
        p.part_b[((size_t)sb.s * p.B + b) * p.H + n + second] = t;
      }
    }
  };

  // The first activation row of each warp, and w for the first MLP
  // product, asked for before any weight: att's slice (row 5) or y1's
  // (row 6).
  float4 pre[kQ], prew[kQ];
  const bool pre_att = full && s0.in, pre_y1 = !full && sa.in && p.fast;
  if ((pre_att || pre_y1) && warp < p.B) {
    const float4* src = pre_att
        ? reinterpret_cast<const float4*>(p.att + (size_t)warp * p.A) + s0.q0
        : reinterpret_cast<const float4*>(p.y1 + (size_t)warp * p.H) + sa.q0;
    const int qlen = pre_att ? s0.q1 - s0.q0 : sa.q1 - sa.q0;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int q = lane + 32 * j;
      if (q < qlen) {
        pre[j] = __ldcg(src + q);
        if (pre_y1) prew[j] = __ldg(reinterpret_cast<const float4*>(p.nw) + sa.q0 + q);
      }
    }
  }
  // Where the norm is applied from full-row statistics (GPT's LayerNorm),
  // the first MLP product's staging waits on more loads: copy the norm's
  // slices (and in row 6 y1's rows) into shared memory before any weight
  // too.
  if (!p.fast && sa.in) {
    const int n = 4 * (sa.q1 - sa.q0);
    decode::copy_async(reinterpret_cast<float*>(nsl), p.nw + 4 * sa.q0, n);
    if (p.nb != nullptr)
      decode::copy_async(reinterpret_cast<float*>(nsl + kSliceQ), p.nb + 4 * sa.q0, n);
    if (!full) decode::copy_async(ys, p.y1, p.B * p.H);
  }

  // att's slice for the out projection, rows B .. rows - 1 zeros
  auto stage_0 = [&]() {
    const int qlen = s0.q1 - s0.q0;
    for (int r = warp; r < p.rows; r += kEgWarps) {
      const float4* src = reinterpret_cast<const float4*>(p.att + (size_t)r * p.A) + s0.q0;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q >= qlen) break;
        xs[r * kSliceQ + q] = r >= p.B   ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : r == warp ? pre[j]
                                          : __ldcg(src + q);
      }
    }
    __syncthreads();
  };

  // y1's slice for the first MLP product: y1 * w (and each row's sum of
  // squares over the slice) on the fast path, a warp a row, else
  // normalised from full-row statistics of y1's rows in shared memory
  // (row 5: copied now, from L2: it wrote them in this launch); rows
  // B .. rows - 1 are zeros.
  auto stage_a = [&]() {
    const bool rms = p.rms != 0;
    const int qlen = sa.q1 - sa.q0;
    if (!p.fast) {
      if (full) decode::copy_async(ys, p.y1, p.B * p.H);
      decode::cp_async_wait_all();
      __syncthreads();
      decode::row_norm_stats(stat, ys, p.B, p.H, rms, p.eps);
      const float4* y4 = reinterpret_cast<const float4*>(ys);
      for (int e = threadIdx.x; e < p.rows * qlen; e += kEgThreads) {
        const int r = e / qlen, q = e - r * qlen;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < p.B)
          v = decode::norm4(y4[(size_t)r * (p.H / 4) + sa.q0 + q], stat[2 * r],
                            stat[2 * r + 1], rms, nsl[q],
                            p.nb != nullptr ? &nsl[kSliceQ + q] : nullptr);
        xs[r * kSliceQ + q] = v;
      }
      __syncthreads();
      return;
    }
    const float4* w4 = reinterpret_cast<const float4*>(p.nw) + sa.q0;
    for (int r = warp; r < p.rows; r += kEgWarps) {
      const float4* y4 = reinterpret_cast<const float4*>(p.y1 + (size_t)r * p.H) + sa.q0;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int q = lane + 32 * j;
        if (q >= qlen) break;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < p.B) {
          const bool first = pre_y1 && r == warp;
          v = first ? pre[j] : __ldcg(y4 + q);
          const float4 w = first ? prew[j] : __ldg(w4 + q);
          sq = dot4(v, v, sq);
          v = make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
        }
        xs[r * kSliceQ + q] = v;
      }
      if (r < p.B) {
        sq = decode::warp_sum(sq);
        if (lane == 0) p.ss[((size_t)sa.cb * p.SA + sa.s) * p.B + r] = sq;
      }
    }
    __syncthreads();
  };

  // the activation's slice for the second product (written in this
  // launch: read from L2)
  auto stage_b = [&]() {
    const int qlen = sb.q1 - sb.q0;
    for (int e = threadIdx.x; e < p.rows * qlen; e += kEgThreads) {
      const int r = e / qlen, q = e - r * qlen;
      xs[r * kSliceQ + q] =
          r < p.B ? __ldcg(reinterpret_cast<const float4*>(p.f + (size_t)r * p.I) + sb.q0 + q)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  };

  // after a product's items: publish this CTA's slice sums and count the
  // arrivals of its column block's S CTAs; [e0, e1) of the block's total
  // outputs are then this CTA's to finish, adding their slices in slice
  // order. SwiGLU: each CTA waits until all S have arrived (every CTA is
  // resident: a cooperative launch) and takes its 1/S of the outputs
  // (LLaMA-7B's blocks took one CTA several round trips). GELU: GPT's
  // blocks are thin (at most a few hundred outputs), so the last CTA to
  // arrive takes them all in one round trip and the others wait for
  // nothing. A product's counts go back to 0 after the next grid barrier,
  // the last product's before the first.
  __shared__ int arrived_last;
  auto arrive = [&](int t, int S, int s, int total, int& e0, int& e1) {
    __threadfence();
    __syncthreads();
    if (GELU) {
      if (threadIdx.x == 0) arrived_last = atomicAdd(p.tickets + t, 1u) == (unsigned)S - 1u;
      __syncthreads();
      e0 = 0;
      e1 = arrived_last ? total : 0;
    } else {
      if (threadIdx.x == 0) {
        atomicAdd(p.tickets + t, 1u);
        while (*reinterpret_cast<volatile unsigned*>(p.tickets + t) < (unsigned)S)
          __nanosleep(32);
      }
      __syncthreads();
      e0 = cut(s, total, S);
      e1 = cut(s + 1, total, S);
    }
    __threadfence();
  };
  auto reset = [&](int t0, int n) {
    if (threadIdx.x == 0 && (int)blockIdx.x < n) p.tickets[t0 + blockIdx.x] = 0u;
  };

  // after the out projection (row 5): y1 = x + (att @ wo^T + bo)
  auto boundary_0 = [&]() {
    if (s0.in) {
      const int cols = s0.n1 - s0.n0;
      int e0, e1;
      arrive(s0.cb, p.S0, s0.s, p.B * cols, e0, e1);
      for (int e = e0 + threadIdx.x; e < e1; e += kEgThreads) {
        const int b = e / cols, n = s0.n0 + e % cols;
        float t = slice_sum(p.part0 + (size_t)b * p.H + n, (size_t)p.B * p.H, p.S0);
        if (p.bo != nullptr) t += __ldg(p.bo + n);
        p.y1[(size_t)b * p.H + n] = __ldg(p.x + (size_t)b * p.H + n) + t;
      }
    }
    reset(tB, p.CB);
    grid.sync();
    reset(0, p.C0);
    if (sa.in) stage_a();
  };

  // after the first MLP product: gelu_tanh(sum + b1), or silu(g) * u
  auto boundary_a = [&]() {
    if (sa.in) {
      const int cols = sa.n1 - sa.n0;
      int e0, e1;
      arrive(tA + sa.cb, p.SA, sa.s, p.B * cols, e0, e1);
      if (p.fast && e0 < e1) {   // each row's 1 / rms from its slices' sums of squares
        for (int b = threadIdx.x; b < p.B; b += kEgThreads) {
          const float sq = slice_sum(p.ss + (size_t)sa.cb * p.SA * p.B + b, p.B, p.SA);
          stat[b] = rsqrtf(sq / p.H + p.eps);
        }
        __syncthreads();
      }
      for (int e = e0 + threadIdx.x; e < e1; e += kEgThreads) {
        const int b = e / cols, n = sa.n0 + e % cols;
        const float* pa = p.part_a + (size_t)b * p.I + n;
        const size_t step = (size_t)p.B * p.I;   // a slice's sums (of one kind)
        const float r = p.fast ? stat[b] : 1.f;
        float a;
        if (GELU) {
          a = slice_sum(pa, step, p.SA) * r;
          if (p.b1 != nullptr) a += __ldg(p.b1 + n);
          a = gelu_tanh(a);
        } else {
          const float g = slice_sum(pa, 2 * step, p.SA) * r;
          const float u = slice_sum(pa + step, 2 * step, p.SA) * r;
          a = silu(g) * u;
        }
        p.f[(size_t)b * p.I + n] = a;
      }
    }
    if (!full) reset(tB, p.CB);
    grid.sync();
    reset(tA, p.CA);
    if (sb.in) stage_b();
  };

  // the products end to end, the next kBuf - 1 items' loads in flight
  // during each
  float4 wb[kBuf][2][kQ];
#pragma unroll
  for (int u = 0; u < kBuf - 1; ++u) load(wb[u], u);
  if (full) {
    if (s0.in) stage_0();
  } else if (sa.in) {
    stage_a();
  }
  const int steps = nItems > eB ? nItems : eB + 1;   // the boundaries run once
  for (int i = 0; i < steps; i += kBuf) {
#pragma unroll
    for (int u = 0; u < kBuf; ++u) {
      if (i + u >= steps) break;
      load(wb[(u + kBuf - 1) % kBuf], i + u + kBuf - 1);
      if (full && i + u == eA) boundary_0();
      if (i + u == eB) boundary_a();
      compute(wb[u], i + u);
    }
  }

  // after the second product: out = the slices' sum (row 6), y1 + (that +
  // b2) (row 5)
  if (sb.in) {
    const int cols = sb.n1 - sb.n0;
    int e0, e1;
    arrive(tB + sb.cb, p.SB, sb.s, p.B * cols, e0, e1);
    for (int e = e0 + threadIdx.x; e < e1; e += kEgThreads) {
      const size_t o = (size_t)(e / cols) * p.H + sb.n0 + e % cols;
      float t = slice_sum(p.part_b + o, (size_t)p.B * p.H, p.SB);
      if (full) {
        if (p.b2 != nullptr) t += __ldg(p.b2 + sb.n0 + e % cols);
        t = __ldcg(p.y1 + o) + t;
      }
      p.out[o] = t;
    }
  }
}

// Rows the egress kernel's registers hold at once for B rows: B itself up
// to 2, else 4 (more rows in tiles of 4: 8 spilled at 128 registers, and
// at one CTA an SM, which takes 255, GPT-124M's egress ran 25-30% slower).
int egress_row_tile(int B) { return B <= 2 ? B : 4; }

template <bool FULL, bool GELU>
const void* egress_kernel_for(int B) {
  switch (egress_row_tile(B)) {
    case 1: return (const void*)egress_kernel<1, FULL, GELU>;
    case 2: return (const void*)egress_kernel<2, FULL, GELU>;
    default: return (const void*)egress_kernel<4, FULL, GELU>;
  }
}

const void* egress_kernel_for(int B, bool full, bool gelu) {
  if (gelu) return full ? egress_kernel_for<true, true>(B) : egress_kernel_for<false, true>(B);
  return full ? egress_kernel_for<true, false>(B) : egress_kernel_for<false, false>(B);
}

// RMSNorm without bias factors 1 / rms out of the first product's sums
// (the fast path); every other norm is applied on the way from full-row
// statistics, its rows and slices kept in shared memory.
bool egress_fast(int rms, bool has_nb) { return rms && !has_nb; }

// Dynamic shared memory of one egress CTA: the activation slice of `rows`
// rows, then (not fast) the norm's slices and y1's rows, then the
// statistics.
size_t egress_smem(int B, int H, int rows, bool fast) {
  return ((size_t)rows * kSliceQ + (fast ? 0 : 2 * kSliceQ)) * sizeof(float4) +
         ((fast ? 0 : (size_t)B * H) + 2 * (size_t)B) * sizeof(float);
}

cudaError_t egress_plan(int B, int H, int A, int I, int gelu, int rms, int has_nb, int* plan) {
  const void* kernel = egress_kernel_for(B, A > 0, gelu != 0);
  const int RT = egress_row_tile(B);
  const int rows = (B + RT - 1) / RT * RT;
  const size_t smem = egress_smem(B, H, rows, egress_fast(rms, has_nb != 0));
  cudaError_t err = decode::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kEgThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int most = per_sm * sms;
  auto slices = [](int K) { return (K / 4 + kSliceQ - 1) / kSliceQ; };
  const int S0 = A > 0 ? slices(A) : 0, SA = slices(H), SB = slices(I);
  if (S0 > most || SA > most || SB > most) return cudaErrorInvalidValue;
  const int C0 = S0 > 0 ? min(most / S0, (H + 1) / 2) : 0;
  const int CA = min(most / SA, gelu ? (I + 1) / 2 : I), CB = min(most / SB, (H + 1) / 2);
  const int grid = max(C0 * S0, max(CA * SA, CB * SB));
  const int vals[10] = {grid, S0, SA, SB, C0, CA, CB, rows, (int)smem, most};
  for (int i = 0; i < 10; ++i) plan[i] = vals[i];
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// fused_decode_epilogue_kernel: row 7, logits = norm(x) @ w^T (+ bias), then
// the guarded greedy pick of each row. A call reads the head once: 524.3 MB
// at LLaMA-7B (0.157 ms at 3.35 TB/s), 154.5 MB for GPT-124M's tied
// embedding (46 us); at 8 rows the fp32 FMAs are 2 a weight byte, ~20% of
// the CUDA cores' rate. So the design is of the memory pipeline:
//
// * One persistent wave. The grid is every CTA the occupancy API lets be
//   resident (capped by the work); CTA c takes vocab columns [c V / grid,
//   (c + 1) V / grid), the same bytes +-1 column, and normalises x once for
//   all of them (the earlier design ran 500-786 CTAs of 64 columns, each
//   normalising all rows again: 3.79 waves at LLaMA-7B). Warp w takes a
//   range of the CTA's columns, kG neighbouring ones at a time (a unit).
// * The weight stream starts before the norm and never waits for it. Each
//   warp streams its units through a ring of kEpiStages stages in shared
//   memory filled by 16-byte cp.async copies (a stage: 128 floats of each
//   of the unit's weight rows, lane l copying and later reading float4 l
//   of each, so no lane waits for another). The first kEpiStages - 1
//   stages go out right after x's copy, before the statistics, and each
//   stage consumed puts the next one in flight, across units, K-chunks and
//   row groups alike.
// * Any number of rows. Rows go in groups of RT (at most kEpiRowsMost,
//   whose sums a lane holds in registers); x's rows of a group sit in
//   shared memory, normalised there from full-row statistics
//   (decode::row_norm_stats). Where RT rows of H do not fit beside the
//   rings, x goes by K-chunks of `kc` floats, each staged once a CTA; the
//   CTA's columns' sums wait in shared memory for the next chunk and are
//   added in chunk order (LLaMA-7B at 16 rows: two chunks of 2048). More
//   rows than RT take more row groups, each streaming the head again. No
//   shared-memory ceiling on B.
// * Fixed orders. A lane adds its stages in order, a warp its lanes by a
//   fixed transposed butterfly (warp_sum_transposed), the chunks in order:
//   every logit has the same bits on every call. The pick (max, first
//   index, all finite) of each row is a lexicographic maximum, the same in
//   any order of merges: per unit by shuffles, per warp in registers, per
//   CTA over its warps, then by the last CTA (a __threadfence, then an
//   atomic ticket, reset for the next launch) over every CTA's partial,
//   ties to the lower index.
//
// A refused launch returns its error and the wrapper raises.

constexpr int kEpiThreads = 256;
constexpr int kEpiWarps = kEpiThreads / 32;
constexpr int kEpiGroup = 8;       // columns a warp dots at once (at most)
constexpr int kEpiStages = 2;      // stages of a warp's ring
constexpr int kEpiStageQ = 32;     // float4s of a weight row a stage, one a lane
constexpr int kEpiRowsMost = 16;   // rows a group holds (RT, at most)
constexpr int kEpiNormQ = 4;       // float4 columns a thread normalises at once

// Columns a warp dots at once with RT rows: kEpiGroup, fewer where a
// lane's sums (columns x RT) would pass 64.
__host__ __device__ constexpr int epi_group(int RT) {
  return kEpiGroup * RT > 64 ? 64 / RT : kEpiGroup;
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
  int B, H, V, kc;       // kc: floats of x's K-chunk (H: x held whole)
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

__device__ inline void merge_xor(float& v, int& i, int& fin, int m) {
  merge(v, i, fin, __shfl_xor_sync(0xffffffffu, v, m), __shfl_xor_sync(0xffffffffu, i, m),
        __shfl_xor_sync(0xffffffffu, fin, m));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int RT, bool kRms>
__global__ void __launch_bounds__(kEpiThreads) fused_decode_epilogue_kernel(EpiParams p) {
  constexpr int kG = epi_group(RT);
  constexpr int kV = kG * RT;                        // sums a lane holds
  constexpr int kTotals = kV > 32 ? kV / 32 : 1;     // totals a lane ends with
  constexpr int kSpan = kV < 32 ? 32 / kV : 1;       // lanes sharing a total
  static_assert(kV <= 32 || kV % 32 == 0, "a lane's sums: 1-32, or 32 a total");
  // ring [warp][stage][column][kEpiStageQ] float4s, x's chunk [rows][kc],
  // the chunks' running sums [columns][RT] (several chunks only), the
  // statistics [RT][2], the warps' picks [3][warp][RT]
  extern __shared__ __align__(16) float4 ring[];
  float* xs = reinterpret_cast<float*>(ring + kEpiWarps * kEpiStages * kG * kEpiStageQ);
  const int G = gridDim.x, cta = blockIdx.x;
  const int NC = (p.H + p.kc - 1) / p.kc, NG = (p.B + RT - 1) / RT;
  float* psum = xs + (size_t)min(p.B, RT) * p.kc;
  float* stat = psum + (NC > 1 ? (size_t)((p.V + G - 1) / G) * RT : 0);
  float* wval = stat + 2 * RT;
  int* widx = reinterpret_cast<int*>(wval + kEpiWarps * RT);
  int* wfin = widx + kEpiWarps * RT;
  __shared__ int is_last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // CTA c takes vocab columns [n0, n1), warp w the range [wn0, wn1) of
  // them, kG at a time: NR units, each through every K-chunk of every row
  // group (a phase: row group g, chunk c)
  const int n0 = decode::cut(cta, p.V, G), n1 = decode::cut(cta + 1, p.V, G);
  const int wn0 = n0 + decode::cut(warp, n1 - n0, kEpiWarps);
  const int wn1 = n0 + decode::cut(warp + 1, n1 - n0, kEpiWarps);
  const int NR = (wn1 - wn0 + kG - 1) / kG;
  auto chunk_len = [&](int c) { return min(p.kc, p.H - c * p.kc); };
  auto stages = [&](int c) { return (chunk_len(c) + 4 * kEpiStageQ - 1) / (4 * kEpiStageQ); };
  auto rows_of = [&](int g) { return min(RT, p.B - g * RT); };

  // the producer: the next stage to put in flight, stage ps of unit pj of
  // phase pph, into ring slot `slot`: float4 `lane` of each of the unit's
  // rows' stage, one 16-byte copy each, a group a stage (empty past the end)
  int pph = 0, pj = 0, ps = 0;
  auto produce = [&](int slot) {
    if (pph < NG * NC && NR > 0) {
      const int c = pph % NC, col0 = wn0 + pj * kG, q = ps * kEpiStageQ + lane;
      float4* dst = ring + ((size_t)(warp * kEpiStages + slot) * kG) * kEpiStageQ + lane;
      const float* src = p.w + (size_t)col0 * p.H + (size_t)c * p.kc + 4 * q;
#pragma unroll
      for (int i = 0; i < kG; ++i)
        if (col0 + i < wn1 && 4 * q < chunk_len(c))
          cp_async16(dst + i * kEpiStageQ, src + (size_t)i * p.H);
      if (++ps == stages(c)) {
        ps = 0;
        if (++pj == NR) {
          pj = 0;
          ++pph;
        }
      }
    }
    cp_async_commit();
  };
  // the chunk of nr rows in xs [nr][kc4] float4s, normalised in place;
  // k4: its first float4 column
  auto normalise = [&](int nr, int kc4, int k4) {
    float4* x4 = reinterpret_cast<float4*>(xs);
    const float4* w4 = reinterpret_cast<const float4*>(p.nw) + k4;
    const float4* b4 = reinterpret_cast<const float4*>(p.nb) + k4;
    for (int q0 = threadIdx.x; q0 < kc4; q0 += kEpiThreads * kEpiNormQ) {
      float4 wv[kEpiNormQ], bv[kEpiNormQ];
#pragma unroll
      for (int e = 0; e < kEpiNormQ; ++e) {
        const int q = q0 + e * kEpiThreads;
        if (q < kc4) {
          wv[e] = __ldg(w4 + q);
          bv[e] = p.nb != nullptr ? __ldg(b4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int e = 0; e < kEpiNormQ; ++e) {
        const int q = q0 + e * kEpiThreads;
        if (q >= kc4) break;
        for (int r = 0; r < nr; ++r)
          x4[(size_t)r * kc4 + q] = decode::norm4(x4[(size_t)r * kc4 + q], stat[2 * r],
                                                  stat[2 * r + 1], kRms, wv[e],
                                                  p.nb != nullptr ? &bv[e] : nullptr);
      }
    }
  };

  // x's first chunk goes out first, then the first weight stages; the
  // statistics come from the rows in shared memory (x whole) or from x
  // while both land (K-chunks), and the chunk is normalised in place
  for (int r = 0; r < rows_of(0); ++r)
    decode::copy_async(xs + (size_t)r * chunk_len(0), p.x + (size_t)r * p.H, chunk_len(0));
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < kEpiStages - 1; ++k) produce(k);
  if (NC > 1) decode::row_norm_stats(stat, p.x, rows_of(0), p.H, kRms, p.eps);
  cp_async_wait<kEpiStages - 1>();
  __syncthreads();
  if (NC == 1) decode::row_norm_stats(stat, xs, rows_of(0), p.H, kRms, p.eps);
  normalise(rows_of(0), chunk_len(0) / 4, 0);
  __syncthreads();

  float acc[kG][RT];
  // this lane's running pick of row (lane / kSpan) % RT of the group
  float pv = -INFINITY;
  int pi = 0x7fffffff, pfin = 1;
  int t = 0;   // stages consumed
  for (int ph = 0; ph < NG * NC; ++ph) {
    const int g = ph / NC, c = ph % NC, nr = rows_of(g), kc4 = chunk_len(c) / 4;
    if (ph > 0) {   // a later chunk or row group
      if (c == 0)
        decode::row_norm_stats(stat, p.x + (size_t)g * RT * p.H, nr, p.H, kRms, p.eps);
      __syncthreads();
      decode::load_chunk<8>(xs, p.x + (size_t)g * RT * p.H, nr, p.H, c * p.kc, 4 * kc4, stat,
                            kRms, p.nw, p.nb);
      __syncthreads();
    }
    if (c == 0) {   // a row group begins
      pv = -INFINITY;
      pi = 0x7fffffff;
      pfin = 1;
    }
    for (int j = 0; j < NR; ++j) {
      const int col0 = wn0 + j * kG;
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[i][r] = 0.f;
      for (int s = 0; s < stages(c); ++s, ++t) {
        produce((t + kEpiStages - 1) % kEpiStages);
        cp_async_wait<kEpiStages - 1>();
        const int q = s * kEpiStageQ + lane;
        if (q >= kc4) continue;
        const float4* ws =
            ring + ((size_t)(warp * kEpiStages + t % kEpiStages) * kG) * kEpiStageQ + lane;
        float4 wv[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) wv[i] = ws[i * kEpiStageQ];
        const float4* x4 = reinterpret_cast<const float4*>(xs) + q;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nr) {
            const float4 a = x4[(size_t)r * kc4];
#pragma unroll
            for (int i = 0; i < kG; ++i) acc[i][r] = decode::dot4(a, wv[i], acc[i][r]);
          }
        }
      }

      // the unit's sums over this chunk
      float tot[kTotals];
#pragma unroll
      for (int h = 0; h < kTotals; ++h) {
        float v[kV / kTotals];
#pragma unroll
        for (int e = 0; e < kV / kTotals; ++e) {
          const int k = h * (kV / kTotals) + e;
          v[e] = acc[k / RT][k % RT];
        }
        tot[h] = warp_sum_transposed<kV / kTotals>(v);
      }
      // total h of this lane: column i, row r of the group
      float cv = -INFINITY;
      int ci = 0x7fffffff, cfin = 1;
#pragma unroll
      for (int h = 0; h < kTotals; ++h) {
        const int k = h * 32 + lane / kSpan, i = k / RT, r = k % RT, n = col0 + i;
        if (n >= wn1 || r >= nr) continue;
        float sum = tot[h];
        if (NC > 1) {   // the chunks' running sums, added in chunk order
          float* run = psum + (size_t)(n - n0) * RT + r;
          if (c > 0) sum = *run + sum;
          if (c < NC - 1) {
            if (lane % kSpan == 0) *run = sum;
            continue;
          }
        }
        const int b = g * RT + r;
        const float lg0 = p.bias != nullptr ? sum + __ldg(p.bias + n) : sum;
        if (lane % kSpan == 0) p.logits[(size_t)b * p.V + n] = lg0;
        const float lg = lg0 + __ldg(p.poison + b);
        merge(cv, ci, cfin, lg, n, isfinite(lg) ? 1 : 0);
      }
      // the unit's columns of each row, then the running pick
      for (int m = max(RT, 32 / kG); m < 32; m <<= 1) merge_xor(cv, ci, cfin, m);
      merge(pv, pi, pfin, cv, ci, cfin);
    }

    if (c == NC - 1) {   // each warp's picks, then the CTA's, in warp order
      const int r = (lane / kSpan) % RT;
      if (lane == r * kSpan) {
        wval[warp * RT + r] = pv;
        widx[warp * RT + r] = pi;
        wfin[warp * RT + r] = pfin;
      }
      __syncthreads();
      for (int r2 = threadIdx.x; r2 < nr; r2 += kEpiThreads) {
        float v = wval[r2];
        int i = widx[r2], fin = wfin[r2];
        for (int w2 = 1; w2 < kEpiWarps; ++w2)
          merge(v, i, fin, wval[w2 * RT + r2], widx[w2 * RT + r2], wfin[w2 * RT + r2]);
        const size_t o = (size_t)cta * p.B + g * RT + r2;
        p.part_val[o] = v;
        p.part_idx[o] = i;
        p.part_fin[o] = fin;
      }
    }
  }
  cp_async_wait<0>();

  // the ticket: the last CTA reduces every CTA's partial, a warp a row,
  // and puts the ticket back to 0
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int b = warp; b < p.B; b += kEpiWarps) {
    float v = -INFINITY;
    int i = 0x7fffffff, fin = 1;
    for (int c = lane; c < G; c += 32) {
      const size_t o = (size_t)c * p.B + b;
      merge(v, i, fin, __ldcg(p.part_val + o), __ldcg(p.part_idx + o), __ldcg(p.part_fin + o));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) merge_xor(v, i, fin, off);
    if (lane == 0) {
      p.nxt[b] = fin ? (long long)i : 0;
      p.bad[b] = fin ? 0 : 1;
    }
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
}

// Rows of one group for B rows: B rounded up to a power of two, at most
// kEpiRowsMost.
int epilogue_row_tile(int B) {
  int rt = 1;
  while (rt < B && rt < kEpiRowsMost) rt *= 2;
  return rt;
}

template <int RT>
const void* epilogue_kernel_for(int rms) {
  return rms ? (const void*)fused_decode_epilogue_kernel<RT, true>
             : (const void*)fused_decode_epilogue_kernel<RT, false>;
}

const void* epilogue_kernel_for(int RT, int rms) {
  switch (RT) {
    case 1: return epilogue_kernel_for<1>(rms);
    case 2: return epilogue_kernel_for<2>(rms);
    case 4: return epilogue_kernel_for<4>(rms);
    case 8: return epilogue_kernel_for<8>(rms);
    default: return epilogue_kernel_for<16>(rms);
  }
}

// Dynamic shared memory of one epilogue CTA: the rings, x's chunk of
// min(B, RT) rows, the chunks' running sums of `cols` columns (several
// chunks only), the statistics and the warps' picks.
size_t epilogue_smem(int B, int H, int RT, int kc, int cols) {
  const size_t sums = kc < H ? (size_t)cols * RT : 0;
  return (size_t)kEpiWarps * kEpiStages * epi_group(RT) * kEpiStageQ * sizeof(float4) +
         ((size_t)min(B, RT) * kc + sums + 2 * (size_t)RT + 3 * (size_t)kEpiWarps * RT) *
             sizeof(float);
}

cudaError_t epilogue_plan(int B, int H, int V, int rms, int* plan) {
  const int RT = epilogue_row_tile(B);
  const void* kernel = epilogue_kernel_for(RT, rms);
  int dev = 0, sms = 0, most = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
  most -= (int)fa.sharedSizeBytes;   // the dynamic shared memory a CTA may have
  const int groups = (V + kEpiWarps * epi_group(RT) - 1) / (kEpiWarps * epi_group(RT));
  int kc = H, grid = 0;
  size_t smem = epilogue_smem(B, H, RT, H, 0);
  const long long rows_bytes = (long long)sizeof(float) * min(B, RT);
  if (smem > (size_t)most) {
    // K-chunks, one CTA an SM: the fewest chunks of whole stages that fit
    grid = min(sms, groups);
    const int cols = (V + grid - 1) / grid;
    const long long room = (long long)most - (long long)epilogue_smem(B, H, RT, 0, 0) -
                           (long long)cols * RT * (long long)sizeof(float);
    const int step = 4 * kEpiStageQ;
    const long long kc_most = room / rows_bytes / step * step;
    if (kc_most < step) return cudaErrorInvalidValue;
    const int chunks = (int)((H + kc_most - 1) / kc_most);
    kc = ((H + chunks - 1) / chunks + step - 1) / step * step;
    smem = epilogue_smem(B, H, RT, kc, cols);
  }
  // the card's most, not this plan's: plans of other B share the kernel
  // (one RT), and a later plan's smaller limit would refuse this one's
  // launches
  if ((err = decode::allow_smem(kernel, most)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kEpiThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (grid == 0) grid = min(per_sm * sms, groups);
  const int vals[6] = {grid, RT, kc, (int)smem, per_sm, (H + kc - 1) / kc};
  for (int i = 0; i < 6; ++i) plan[i] = vals[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of one egress launch at these widths on the current card (A =
// 0: the partial mode, no out projection; gelu: the GELU MLP, else
// SwiGLU; rms: RMSNorm, else LayerNorm; has_nb: the norm has a bias),
// into plan[10]: grid; S0, SA, SB (K-slices of the out-projection, first
// and second MLP products); C0, CA, CB (their column blocks); rows (B
// rounded up to the row tile); shared memory bytes; the CTAs the plan may
// use (every resident one) (fused_decode_mlp.egress_plan_for is the same
// rule). Its scratch, in
// floats: part0 S0 B H, part_a SA (1 GELU, 2 SwiGLU) B I, part_b SB B H,
// f B I, ss CA SA B, and y1 B H (row 5); counts: C0 + CA + CB ints, zero
// at first. Returns a cudaError_t as int.
int pdt_fused_decode_egress_plan(int B, int H, int A, int I, int gelu, int rms, int has_nb,
                                 int* plan) {
  if (B <= 0 || H % 4 || A % 4 || I % 4) return (int)cudaErrorInvalidValue;
  return (int)egress_plan(B, H, A, I, gelu, rms, has_nb, plan);
}

// The egress (row 5: x, att, wo, bo, b2 given, y1 written) or its partial
// mode (row 6, fused_decode_mlp_partial: A = 0, y1 given, x, att, wo, bo
// and b2 null): w1 [I, H] (fc1 or the gate), b1 [I] or null (GELU), wu
// [I, H] (SwiGLU's up projection; null for GELU), w2 [H, I], by the
// plan[10] of pdt_fused_decode_egress_plan for these widths and this
// activation and norm on this card, over the scratch it sizes. Cooperative
// launch on `stream`; returns a cudaError_t as int. `rms`: RMSNorm, else
// LayerNorm; a plan made for another norm is refused.
int pdt_fused_decode_egress_f32(const float* x, const float* att, const float* wo,
                                const float* bo, const float* nw, const float* nb,
                                const float* w1, const float* b1, const float* wu,
                                const float* w2, const float* b2, float* y1,
                                float* scratch, unsigned* tickets, float* out, int B, int H,
                                int A, int I, int gelu, int rms, float eps, const int* plan,
                                void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool fast = egress_fast(rms, nb != nullptr);
  if ((size_t)plan[8] != egress_smem(B, H, plan[7], fast)) return (int)cudaErrorInvalidValue;
  const int S0 = plan[1], SA = plan[2], SB = plan[3], CA = plan[5];
  float* part0 = scratch;
  float* part_a = part0 + (size_t)S0 * B * H;
  float* part_b = part_a + (size_t)SA * (gelu ? 1 : 2) * B * I;
  float* f = part_b + (size_t)SB * B * H;   // 16-byte aligned: read as float4s
  float* ss = f + (size_t)B * I;
  EgressParams p{x,      att,     wo,      bo,      nw,     nb,      w1,  b1,      wu,
                 w2,     b2,      y1,      part0,   part_a, part_b,  ss,  f,       out,
                 tickets, B,      H,       A,       I,      S0,      SA,  SB,      plan[4],
                 CA,     plan[6], plan[7], rms,     fast,    eps};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(egress_kernel_for(B, A > 0, gelu != 0),
                                                dim3(plan[0]), dim3(kEgThreads), args,
                                                (size_t)plan[8], (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of one epilogue launch for B rows of H over a vocab of V on the
// current card (rms: RMSNorm, else LayerNorm), into plan[6]: grid (every
// resident CTA, at most one a column group of the warps; with K-chunks one
// CTA an SM); RT (rows of a group); kc (floats of x's K-chunk, H where x's
// rows fit whole beside the ring); shared memory bytes; resident CTAs an
// SM; chunks (fused_decode_mlp.epilogue_plan_for is the same rule). Its
// scratch: part_val, part_idx, part_fin [grid, B]; the ticket, zero at
// first. Returns a cudaError_t as int.
int pdt_fused_decode_epilogue_plan(int B, int H, int V, int rms, int* plan) {
  if (B <= 0 || H <= 0 || V <= 0 || H % 4) return (int)cudaErrorInvalidValue;
  return (int)epilogue_plan(B, H, V, rms, plan);
}

// Launch by the plan[6] of pdt_fused_decode_epilogue_plan for these widths
// and this norm on this card, on `stream`; returns a cudaError_t as int.
// `ticket` must be 0. `rms`: RMSNorm, else LayerNorm.
int pdt_fused_decode_epilogue_f32(const float* x, const float* nw, const float* nb,
                                  const float* w, const float* bias,
                                  const float* poison, float* logits, float* part_val,
                                  int* part_idx, int* part_fin, unsigned* ticket,
                                  long long* nxt, unsigned char* bad, int B, int H,
                                  int V, float eps, int rms, const int* plan, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int grid = plan[0], RT = plan[1], kc = plan[2];
  if (RT != epilogue_row_tile(B) || kc <= 0 ||
      (size_t)plan[3] != epilogue_smem(B, H, RT, kc, (V + grid - 1) / grid))
    return (int)cudaErrorInvalidValue;
  EpiParams p{x, nw, nb, w, bias, poison, logits, part_val, part_idx, part_fin,
              ticket, nxt, bad, B, H, V, kc, eps};
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(epilogue_kernel_for(RT, rms), dim3(grid),
                                     dim3(kEpiThreads), args, (size_t)plan[3],
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
