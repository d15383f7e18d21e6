// Flash attention forward and backward on Hopper's tensor cores (bf16,
// head_dim 64 or 128), for sm_90a.
//
// Replaces, with flash_attention.cu, the Pallas TPU kernels `_fwd`
// (`_fwd_kernel`) and `_bwd` (`_bwd_fused_kernel`) of
// paddle_tpu/ops/pallas/flash_attention.py. flash_attention.py sends a
// call here when its inputs are bf16, head_dim is 64 or 128 and every base
// pointer and (batch, seq, head) stride is a multiple of 16 bytes (what a
// TMA tensor map needs); every other call goes to flash_attention.cu.
// Same contract: scores and softmax state in fp32, masked scores never
// attended (NEG_INF = -1e30 semantics: probability 0), causal alignment at
// the bottom-right corner (q row i attends key j <= i + Sk - Sq), lse
// [B, Hq, Sq] fp32 the natural log of the scaled scores' sum, GQA with dk
// and dv summed over the group, o = 0, lse = -1e30 and zero gradients for
// rows that attend nothing.
//
// What bounds it on an H100: the bf16 tensor cores (989 TFLOP/s) at the
// training shapes (LLaMA-7B [2, 2048, 32, 128] causal: 6.9e10 flops
// forward, 1.7e11 backward, against ~0.1 GB of traffic). So every product
// is a `wgmma` fed by TMA (csrc/sm90.cuh), and the softmax runs in fp32
// registers between them.
//
// Numbers: Q, K, V and dO are bf16, so their products are exact in the
// fp32 accumulators. P (and in the backward dS) is rounded to bf16 before
// it enters a product, as the JAX package's unfused `_sdpa_xla` rounds its
// probabilities to the input dtype. The tolerance against the plain fp32
// version follows from that rounding, element by element
// (flash_attention.tc_tolerances): for o_ij, 2^-8 (sum_k p_ik |v_kj|) /
// l_i; for dv, dk and dq the same term from |P| or |dS| against the
// other operand; each plus one bf16 rounding of the element's reference
// value and 1e-4 for the fp32 summation order. dq is
// summed over the key tiles with fp32 atomics, in no fixed order: it is
// not bitwise reproducible from run to run.
//
// Forward: one CTA per (128 query rows, q head, batch), the heavy causal
// tiles (the last rows) launched first. Three warpgroups: warpgroup 0's
// first thread issues the TMA loads (Q once, then K and V tiles of 128
// keys into a 2-stage ring with full/empty mbarriers); warpgroups 1 and 2
// each own 64 query rows: S = Q K^T (`wgmma` m64n128k16, both operands
// K-major in shared memory), scale, mask (on the causal diagonal and the
// ragged key edge only), online softmax in fp32 registers with log2(e)
// folded into the scale, P converted to bf16 in registers and fed as the
// A operand of O += P V (RS form, V MN-major with the transpose flag).
// The epilogue divides by l and writes o (bf16) and lse (fp32, natural
// log). Shared memory: Q 16 KB a 64-column panel, two stages of K and V;
// 160 KB at head_dim 128.
//
// Backward (FA3's layout, dQ by reduction): one CTA per (128 keys, kv
// head, batch). It holds K and V in shared memory and dK, dV in fp32
// registers (each consumer warpgroup 64 keys) across a loop over the q
// heads of its GQA group and the q tiles of 64 rows that reach its keys
// (from the causal diagonal on), Q, dO, lse and delta arriving by TMA in
// a 2-stage ring. Per q tile, keys as the `wgmma` rows:
//   1. S^T = K Q^T and 4. dP^T = V dO^T (SS, K-major),
//   2. P^T = exp2(scale log2(e) S^T - lse log2(e)), masked,
//   5. dS^T = P^T o (dP^T - delta),
//   3. dV += P^T dO and 6. dK += dS^T Q (RS, dO and Q MN-major),
//   7. dS^T goes to shared memory as bf16 and comes back as the
//      transposed A of dQ_tile = dS K (SS, both MN-major), which is added
//      into a zeroed [B, Sq, Hq, D] fp32 scratch with vector atomics; the
//      wrapper scales it and casts it to q's dtype. The two warpgroups'
//      dS^T halves form one [128 keys][64 q] tile (two buffers,
//      alternating), so each tile pair adds its dQ tile once: at
//      head_dim 128 each warpgroup takes 64 of its columns, at 64 the
//      warpgroups take the whole tile on alternate iterations.
// Five products per tile pair. delta = rowsum(dO o O) comes from the
// wrapper (as JAX computes it outside its kernel), with lse, both padded
// to whole tiles of kBwdRows rows (pdt_flash_sm90_bwd_rows) so they
// arrive by bulk copy.
//
// Plain C interface (ctypes). The launchers encode the TMA tensor maps
// from the strides they are given (cuTensorMapEncodeTiled, taken from the
// driver through the runtime: the library links no -lcuda) and return a
// cudaError_t as int, or kEncodeFailed + the CUresult when a map cannot
// be encoded, or kNoEncoder.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWG = 128;               // threads of a warpgroup
constexpr int kThreads = 3 * kWG;      // producer + two consumers
constexpr int kFwdRows = 128;          // q rows of a forward CTA
constexpr int kFwdKeys = 128;          // keys of a forward K/V tile
constexpr int kBwdKeys = 128;          // keys of a backward CTA
constexpr int kBwdRows = 64;           // q rows of a backward tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;      // lse of a row that attends nothing

constexpr int kEncodeFailed = 100000;  // + the CUresult
constexpr int kNoEncoder = 99999;

// ------------------------------------------------------------ forward --
struct FwdArgs {
  __nv_bfloat16* o;   // [B, Sq, Hq, D], contiguous
  float* lse;         // [B, Hq, Sq]
  int Hq, Hk, Sq, Sk, n_qt;
  float scale_log2;   // scale * log2(e)
  int causal;
};

// P: 64-column panels of head_dim (1 or 2)
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdArgs a) {
  constexpr uint32_t kPanel = kFwdRows * 128;   // bytes of a 128-row panel
  constexpr uint32_t kTile = P * kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];     // q, full[2], empty[2]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + (1 + s) * kTile; };
  auto sV = [&](int s) { return base + (3 + s) * kTile; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[3 + s]); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (a.n_qt - 1 - (int)blockIdx.z) * kFwdRows;
  const int hk = h / (a.Hq / a.Hk);
  const int offset = a.Sk - a.Sq;
  int n_k = (a.Sk + kFwdKeys - 1) / kFwdKeys;
  if (a.causal) {
    const int last = min(q0 + kFwdRows - 1, a.Sq - 1) + offset;
    n_k = last < 0 ? 0 : min(n_k, last / kFwdKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // ------------------------------------------------ producer --
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_k > 0) {
      mbar_arrive_expect_tx(bar_q, kTile);
#pragma unroll
      for (int p = 0; p < P; ++p)
        tma_load_4d(sQ + p * kPanel, &tq, bar_q, 64 * p, h, q0, b);
      for (int j = 0; j < n_k; ++j) {
        const int s = j & 1;
        if (j >= 2) mbar_wait(empty(s), ((j >> 1) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * kTile);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load_4d(sK(s) + p * kPanel, &tk, full(s), 64 * p, hk,
                      j * kFwdKeys, b);
          tma_load_4d(sV(s) + p * kPanel, &tv, full(s), 64 * p, hk,
                      j * kFwdKeys, b);
        }
      }
    }
  } else {
    // ------------------------------------------------ consumers --
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;                    // rows q0 + 64 w ..
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int r = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * w + 16 * warp + r;   // and row0 + 8

    float o_acc[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[p][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (n_k > 0) mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int s = j & 1;
      mbar_wait(full(s), (j >> 1) & 1);

      // S = Q K^T over head_dim, k16 steps along the panels' rows
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * P; ++kk) {
        const uint32_t col = (kk / 4) * kPanel + (kk % 4) * 32;
        wgmma_ss_n128<0, 0>(sc, desc_sw128(sQ + col + 64 * w * 128),
                            desc_sw128(sK(s) + col), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      const int k0 = j * kFwdKeys;
      const bool edge = k0 + kFwdKeys > a.Sk ||
                        (a.causal && k0 + kFwdKeys - 1 > q0 + 64 * w + offset);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] *= a.scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = row0 + 8 * ((i / 2) & 1);
          if (col >= a.Sk || (a.causal && col > row + offset))
            sc[i] = -INFINITY;
        }
      }

      // online softmax of rows row0 (entries 4 j + 0, 1) and row0 + 8
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hf], sc[4 * jj + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[hf] - m_use);
        m[hf] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = exp2f(sc[4 * jj + 2 * hf + e] - m_use);
            sc[4 * jj + 2 * hf + e] = pv;
            rs += pv;
          }
        l[hf] = l[hf] * alpha + rs;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            o_acc[p][4 * jj + 2 * hf] *= alpha;
            o_acc[p][4 * jj + 2 * hf + 1] *= alpha;
          }
      }

      // P as bf16 A fragments, one per k16 slice of the 128 keys
      uint32_t pf[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pf[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      // O += P V, one n64 product a panel of head_dim
#pragma unroll
      for (int p = 0; p < P; ++p) reg_fence(o_acc[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_rs_n64<1>(o_acc[p], pf[kk],
                          desc_sw128(sV(s) + p * kPanel + kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) reg_fence(o_acc[p]);
      reg_fence(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: o = O / l, lse = ln(sum of exp) of the scaled scores
    constexpr int D = 64 * P;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row0 + 8 * hf;
      if (row >= a.Sq) continue;
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      __nv_bfloat16* orow =
          a.o + (((long long)b * a.Sq + row) * a.Hq + h) * D + 2 * t;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(orow + 64 * p + 8 * jj) =
              pack_bf16(o_acc[p][4 * jj + 2 * hf] * inv,
                        o_acc[p][4 * jj + 2 * hf + 1] * inv);
      if (t == 0)
        a.lse[((long long)b * a.Hq + h) * a.Sq + row] =
            lt > 0.f ? (m[hf] + log2f(lt)) * kLn2 : kNegInf;
    }
  }
}

// ------------------------------------------------------------ backward --
struct BwdArgs {
  const float* lse;     // [B, Hq, Sq_pad]
  const float* delta;   // [B, Hq, Sq_pad]: rowsum(dO o O)
  float* dq;            // [B, Sq, Hq, D] fp32, zeroed: sum of dS K
  __nv_bfloat16* dk;    // [B, Sk, Hk, D], contiguous
  __nv_bfloat16* dv;
  int Hq, Hk, Sq, Sk, Sq_pad, n_qt;
  float scale, scale_log2;
  int causal;
};

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwdArgs a) {
  constexpr uint32_t kKPanel = kBwdKeys * 128;  // a 128-row panel: 16 KB
  constexpr uint32_t kQPanel = kBwdRows * 128;  // a 64-row panel: 8 KB
  constexpr uint32_t kKV = P * kKPanel;
  constexpr uint32_t kQ = P * kQPanel;
  constexpr uint32_t kStats = kBwdRows * 4;     // lse or delta of a tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];     // kv, full[2], empty[2]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + kKV;
  auto sQ = [&](int s) { return base + 2 * kKV + s * kQ; };
  auto sdO = [&](int s) { return base + 2 * kKV + (2 + s) * kQ; };
  // dS^T, two buffers (iterations alternate) of [128 keys][64 q]
  auto sdS = [&](int i) { return base + 2 * kKV + 4 * kQ + i * kKPanel; };
  const uint32_t stats_off = 2 * kKV + 4 * kQ + 2 * kKPanel;
  auto lse_at = [&](int s) { return stats_off + s * 2 * kStats; };
  auto delta_at = [&](int s) { return stats_off + s * 2 * kStats + kStats; };
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[3 + s]); };

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBwdKeys;
  const int rep = a.Hq / a.Hk;
  const int offset = a.Sk - a.Sq;
  // the first q tile whose rows reach key k0
  const int lo = a.causal ? max(0, (k0 - offset) / kBwdRows) : 0;
  const int n_it = rep * max(0, a.n_qt - lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // ------------------------------------------------ producer --
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * kKV);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tma_load_4d(sK + p * kKPanel, &tk, bar_kv, 64 * p, hk, k0, b);
        tma_load_4d(sV + p * kKPanel, &tv, bar_kv, 64 * p, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it & 1;
        const int h = hk * rep + it / (a.n_qt - lo);
        const int q0 = (lo + it % (a.n_qt - lo)) * kBwdRows;
        if (it >= 2) mbar_wait(empty(s), ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * kQ + 2 * kStats);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load_4d(sQ(s) + p * kQPanel, &tq, full(s), 64 * p, h, q0, b);
          tma_load_4d(sdO(s) + p * kQPanel, &tdo, full(s), 64 * p, h, q0, b);
        }
        const long long st = ((long long)b * a.Hq + h) * a.Sq_pad + q0;
        bulk_load(base + lse_at(s), a.lse + st, kStats, full(s));
        bulk_load(base + delta_at(s), a.delta + st, kStats, full(s));
      }
    }
  } else {
    // ------------------------------------------------ consumers --
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;                      // keys k0 + 64 w ..
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32, lane = tid % 32;
    const int r = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * w;
    const int key0 = kw0 + 16 * warp + r;      // and key0 + 8
    const uint32_t kRows = 64 * w * 128;       // this warpgroup's K/V rows

    float dk_acc[P][32], dv_acc[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

    if (n_it > 0) mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it & 1;
      const int h = hk * rep + it / (a.n_qt - lo);
      const int q0 = (lo + it % (a.n_qt - lo)) * kBwdRows;
      mbar_wait(full(s), (it >> 1) & 1);

      // 1. S^T = K Q^T, 4. dP^T = V dO^T
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * P; ++kk) {
        const uint32_t kc = (kk / 4) * kKPanel + (kk % 4) * 32 + kRows;
        const uint32_t qc = (kk / 4) * kQPanel + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(st, desc_sw128(sK + kc), desc_sw128(sQ(s) + qc),
                           kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * P; ++kk) {
        const uint32_t kc = (kk / 4) * kKPanel + (kk % 4) * 32 + kRows;
        const uint32_t qc = (kk / 4) * kQPanel + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dpt, desc_sw128(sV + kc), desc_sw128(sdO(s) + qc),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // 2. P^T, 5. dS^T (keys are rows, q rows are columns)
      const float* lse_s = reinterpret_cast<const float*>(gbase + lse_at(s));
      const float* del_s = reinterpret_cast<const float*>(gbase + delta_at(s));
      const bool edge = kw0 + 64 > a.Sk || q0 + kBwdRows > a.Sq ||
                        (a.causal && kw0 + 63 > q0 + offset);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int qc = 8 * jj + 2 * t;
        float2 L = *reinterpret_cast<const float2*>(lse_s + qc);
        L.x *= kLog2e;
        L.y *= kLog2e;
        const float2 Dl = *reinterpret_cast<const float2*>(del_s + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          float pv = exp2f(st[i] * a.scale_log2 - ((e & 1) ? L.y : L.x));
          if (edge) {
            const int q = q0 + qc + (e & 1);
            const int key = key0 + 8 * (e >> 1);
            if (q >= a.Sq || key >= a.Sk || (a.causal && q + offset < key))
              pv = 0.f;
          }
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - ((e & 1) ? Dl.y : Dl.x));
        }
      }
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pf[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          df[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }

      // 3. dV += P^T dO, 6. dK += dS^T Q (dO and Q MN-major)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        reg_fence(dv_acc[p]);
        reg_fence(dk_acc[p]);
      }
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64<1>(dv_acc[p], pf[kk],
                          desc_sw128(sdO(s) + p * kQPanel + kk * 2048), 1);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64<1>(dk_acc[p], df[kk],
                          desc_sw128(sQ(s) + p * kQPanel + kk * 2048), 1);
      wgmma_commit();

      // 7. dS^T to shared memory as bf16, swizzled like a TMA panel, while
      // the products run: this warpgroup's 64 rows (keys) of the
      // iteration's [128 keys][64 q] buffer; chunk jj of a row holds q
      // columns 8 jj .. 8 jj + 7
      const uint32_t ds = sdS(it & 1);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 64 * w + 16 * warp + r + 8 * hf;
          const uint32_t addr =
              ds + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(df[jj / 2][2 * (jj % 2) + hf])
                       : "memory");
        }
      fence_proxy_async();
      // the dQ product reads both halves of dS^T (all 128 keys). Two
      // buffers: a warpgroup rewrites this one two iterations on, after
      // the other has passed the next barrier and so finished its dQ
      // product here.
      named_bar_sync(1, 2 * kWG);

      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        reg_fence(dv_acc[p]);
        reg_fence(dk_acc[p]);
      }
      reg_fence(pf);
      reg_fence(df);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // Q, dO, lse, delta consumed

      // dQ_tile = dS K over the CTA's 128 keys (dS^T and K MN-major): at
      // head_dim 128 each warpgroup takes one 64-column panel every
      // iteration, at 64 the two take the whole tile on alternate ones
      if (P == 2 || (it & 1) == w) {
        const int panel = P == 2 ? w : 0;
        float dq_acc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n64<1, 1>(dq_acc, desc_sw128(ds + kk * 2048),
                             desc_sw128(sK + panel * kKPanel + kk * 2048),
                             kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq_acc);

        constexpr int D = 64 * P;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int q = q0 + 16 * warp + r + 8 * hf;
          if (q >= a.Sq) continue;
          float* dst = a.dq + (((long long)b * a.Sq + q) * a.Hq + h) * D +
                       64 * panel + 2 * t;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * jj),
                      make_float2(dq_acc[4 * jj + 2 * hf],
                                  dq_acc[4 * jj + 2 * hf + 1]));
        }
      }
    }

    // epilogue: dk (times the scale) and dv as bf16
    constexpr int D = 64 * P;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf;
      if (key >= a.Sk) continue;
      const long long row = (((long long)b * a.Sk + key) * a.Hk + hk) * D + 2 * t;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 64 * p + 8 * jj;
          *reinterpret_cast<uint32_t*>(a.dk + row + c) =
              pack_bf16(dk_acc[p][4 * jj + 2 * hf] * a.scale,
                        dk_acc[p][4 * jj + 2 * hf + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(a.dv + row + c) =
              pack_bf16(dv_acc[p][4 * jj + 2 * hf],
                        dv_acc[p][4 * jj + 2 * hf + 1]);
        }
    }
  }
}

// ------------------------------------------------------------- launch --
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D map (head_dim, head, seq, batch) of a bf16 [B, S, H, D] view
// with element strides (sb, ss, sh, 1): boxes of 64 columns x `rows` rows
// of one (head, batch), 128-byte swizzled; rows past S read as zeros
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
           long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           const_cast<void*>(ptr), dims, strides, box, estr,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

// raises a kernel instance's dynamic shared memory limit once per device
// (bit `dev` of `set`, the instance's own)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, std::atomic<uint64_t>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (set.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set.fetch_or(bit);
  return err;
}

template <int P>
constexpr int fwd_smem() { return 5 * P * kFwdRows * 128 + 1024; }
template <int P>
constexpr int bwd_smem() {
  return 2 * P * kBwdKeys * 128 + 4 * P * kBwdRows * 128 +
         2 * kBwdKeys * 128 + 4 * kBwdRows * 4 + 1024;
}

template <int P>
int launch_fwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const FwdArgs& a, int B,
               cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const int smem = fwd_smem<P>();
  cudaError_t err = allow_smem(flash_fwd_sm90_kernel<P>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, B, a.n_qt);
  flash_fwd_sm90_kernel<P><<<grid, kThreads, smem, stream>>>(mq, mk, mv,
                                                             a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bwd(const CUtensorMap& mq, const CUtensorMap& mk,
               const CUtensorMap& mv, const CUtensorMap& mdo,
               const BwdArgs& a, int B, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const int smem = bwd_smem<P>();
  cudaError_t err = allow_smem(flash_bwd_sm90_kernel<P>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hk, B, (a.Sk + kBwdKeys - 1) / kBwdKeys);
  flash_bwd_sm90_kernel<P><<<grid, kThreads, smem, stream>>>(mq, mk, mv,
                                                             mdo, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, Sq, Hq, D], k and v [B, Sk, Hk, D] with element strides
// (batch, seq, head) and a contiguous last dim, D 64 or 128, every base
// pointer and stride a multiple of 16 bytes (the wrapper checks). Writes
// o [B, Sq, Hq, D] (contiguous) and lse [B, Hq, Sq]. Launches on `stream`.
int pdt_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Hq, int Hk, int Sq, int Sk, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaSuccess;
  if ((D != 64 && D != 128) || Sk <= 0 || Hk <= 0 || Hq % Hk != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc = encode(&mq, q, B, Sq, Hq, D, qsb, qss, qsh, kFwdRows);
  if (rc == 0) rc = encode(&mk, k, B, Sk, Hk, D, ksb, kss, ksh, kFwdKeys);
  if (rc == 0) rc = encode(&mv, v, B, Sk, Hk, D, vsb, vss, vsh, kFwdKeys);
  if (rc != 0) return rc;
  FwdArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.Hq = Hq; a.Hk = Hk; a.Sq = Sq; a.Sk = Sk;
  a.n_qt = (Sq + kFwdRows - 1) / kFwdRows;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_fwd<1>(mq, mk, mv, a, B, s)
                 : launch_fwd<2>(mq, mk, mv, a, B, s);
}

// The backward over the same views plus do [B, Sq, Hq, D]. lse and delta
// are [B, Hq, Sq_pad] fp32, Sq_pad a multiple of pdt_flash_sm90_bwd_rows()
// (the rows past Sq are read and not used): the forward's lse and
// rowsum(dO o O). dq_acc [B, Sq, Hq, D] fp32 must be zeroed: it receives
// sum dS K (unscaled). Writes dk, dv [B, Sk, Hk, D] bf16 (contiguous).
int pdt_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int B, int Hq, int Hk, int Sq, int Sk, int D, int Sq_pad, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, float scale, int causal, void* stream) {
  if (B <= 0 || Hk <= 0 || Sk <= 0) return (int)cudaSuccess;
  if ((D != 64 && D != 128) || Sq <= 0 || Hq % Hk != 0 ||
      Sq_pad % kBwdRows != 0 || Sq_pad < Sq)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int rc = encode(&mq, q, B, Sq, Hq, D, qsb, qss, qsh, kBwdRows);
  if (rc == 0) rc = encode(&mk, k, B, Sk, Hk, D, ksb, kss, ksh, kBwdKeys);
  if (rc == 0) rc = encode(&mv, v, B, Sk, Hk, D, vsb, vss, vsh, kBwdKeys);
  if (rc == 0) rc = encode(&mdo, dout, B, Sq, Hq, D, dsb, dss, dsh, kBwdRows);
  if (rc != 0) return rc;
  BwdArgs a;
  a.lse = lse; a.delta = delta; a.dq = dq_acc;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Hq = Hq; a.Hk = Hk; a.Sq = Sq; a.Sk = Sk; a.Sq_pad = Sq_pad;
  a.n_qt = (Sq + kBwdRows - 1) / kBwdRows;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_bwd<1>(mq, mk, mv, mdo, a, B, s)
                 : launch_bwd<2>(mq, mk, mv, mdo, a, B, s);
}

// the backward's q rows a tile: its lse and delta rows are padded to it
int pdt_flash_sm90_bwd_rows() { return kBwdRows; }

const char* pdt_flash_sm90_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
