// Ragged paged attention over fp32 or int8 KV page pools, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_kernel` / `_ragged_call`
// (paddle_tpu/ops/pallas/paged_attention.py), both of its variants: fp32
// pools, and int8 pools with f32 scale side-pools [Hk, P, page_size] (one
// absmax scale per kv head and token slot, quantization.kv_quantize).
// Packed query tokens of many sequences (decode rows with q_len 1 and
// prefill chunks in one call) attend a paged KV pool through
// per-sequence block tables, with positional causality
// kv_pos <= kv_len - q_len + i, GQA, and an online softmax in fp32.
//
// What bounds it on an H100: the KV bytes. Every query row must see each
// KV token it attends (4 B x D x 2 per token and kv head with fp32 pools,
// D + 4 B x 2 with int8 ones); at every serving shape that is far more
// time at 3.35 TB/s than the products take. So the design reads each
// needed K/V token of a kv head once per tile of up to 64 query rows,
// keeps enough bytes in flight to fill the card, and keeps every
// intermediate on chip.
//
// Work is planned as the TPU kernel plans it (`_plan_items`): flat
// (sequence segment, q tile, kv split) units, walked by persistent CTAs
// (grid = resident CTAs, from static shapes only; every CTA walks the
// same plan from q_lens and kv_lens on the device, so the host reads no
// device length). A unit's kv range stops at the causal bound of its
// last row; a long range is split along KV (flash-decoding) so that a
// few long sequences still fill 132 SMs. Each split writes (m, l, acc)
// to scratch; the CTA that finishes a unit's last split (an atomic count
// per unit, put back to 0 by that CTA) combines the partials in split
// order, so the result does not depend on which CTA ran what.
//
// Two routes, chosen by the wrapper from static shapes (route()):
//
// * mixed (q_block > 1, or GQA groups other than 1, 2 or 4): a tile is up
//   to 64 rows (token x q head of the group) of one segment, and its
//   splits are sized so that the call makes about one unit every two
//   resident CTAs (kCtasPerUnit). K/V pages move in 64-token chunks with
//   16-byte cp.async copies into a raw buffer; all threads convert a chunk
//   once into bf16 planes in shared memory (int8 exactly, one plane; fp32
//   as hi + mid + lo = x exactly), and the next chunk's copies fly while
//   the warps use the planes. Q.K^T and P.V run on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 out; B fragments by ldmatrix, V's
//   through ldmatrix.trans), in registers as FA2 keeps them: each warp
//   owns 16 rows (or, for tiles of 32 rows or fewer, 16 or 32 rows and a
//   quarter or half of each chunk's tokens; the warps' states are merged
//   in order at the end), the score fragments become the A operand of
//   P.V without leaving registers. Padding rows of a segment ride in the
//   same tiles and cost nothing extra. q is split into three bf16 planes
//   too (int8 pools: once a unit, in shared memory); int8 K/V's per-token
//   scales factor out (K's scales a score column, V's folded into P
//   before P is split). fp32 pools take the six products of order <= 2
//   (q_i k_j, i + j <= 2), int8 pools the three of q or P; each k step's
//   products go smallest first into a fresh accumulator that is then
//   added in fp32 registers: the tensor cores' accumulator does not round
//   each addition to nearest, so no long sum runs in it. Measured on the
//   card (PERF.md), this route is held by latency, not by bytes: the
//   plan, each unit's wait for its page ids and first chunk, and a
//   chunk's conversion and products at two CTAs an SM.
// * decode (q_block == 1 and a GQA group of 1, 2 or 4 heads): a unit is
//   one token's group rows, one kv head and a split of its kv tokens. The
//   products are dots of 1-4 rows: the CUDA cores, one 16-byte load of K
//   and of V per lane and token (a token's row spread over D x size / 16
//   lanes, so a warp reads 1-8 tokens at once), eight tokens a group in
//   flight (four with GQA groups of 2 or 4), an online softmax per group;
//   the groups merge in order in shared memory.
//
// Plain C interface (bound with ctypes); the wrapper in
// paged_attention.py checks shapes, types and contiguity, picks the
// route and allocates the output and the split scratch. The launcher
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;     // kv tokens a mixed CTA stages at a time
constexpr int kTileRows = 64;  // query rows of one mixed tile
constexpr int kCtasPerUnit = 2;  // resident CTAs a mixed unit (sizes its splits)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;           // [T, Hq, D]
  const void* k_pages;      // [Hk, P, page_size, D] fp32 or int8
  const void* v_pages;      // [Hk, P, page_size, D] fp32 or int8
  const float* k_scales;    // [Hk, P, page_size] (int8 pools only)
  const float* v_scales;    // [Hk, P, page_size] (int8 pools only)
  const int* block_tables;  // [B, NP]
  const int* kv_lens;       // [B]
  const int* q_lens;        // [B]
  float* out;               // [T, Hq, D]
  float* part_acc;          // [max_splits, T * Hq, D] unnormalised sums
  float* part_ml;           // [max_splits, T * Hq, 2] running max, sum
  int* counters;            // one per unit, 0 between launches
  int T, Hq, Hk, D, P, page_size, B, NP, q_block, rep;
  int split_tokens;         // kv tokens a decode split takes
  int max_splits;
  int page_shift;           // log2(page_size), or -1 if not a power of 2
  float scale;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// smallest y >= x with y % mod == res (res < mod)
__host__ __device__ constexpr int at_residue(int x, int mod, int res) {
  return x <= res ? res : res + cdiv(x - res, mod) * mod;
}

// A unit's splits of `kv` tokens: `base` tokens each, or, past
// `max_splits` of them, max_splits splits of a multiple of 16 tokens.
__device__ inline void split_geom(int kv, int base, int max_splits, int& ns,
                                  int& len) {
  len = base;
  ns = kv <= 0 ? 1 : cdiv(kv, len);
  if (ns > max_splits) {
    len = cdiv(cdiv(kv, max_splits), 16) * 16;
    ns = cdiv(kv, len);
  }
}

// A kv position's table slot and its slot in the page (a shift and a
// mask where page_size is a power of 2, as the engine's always is)
__device__ __forceinline__ int page_of(const Params& p, int pos) {
  return p.page_shift >= 0 ? pos >> p.page_shift : pos / p.page_size;
}
__device__ __forceinline__ int in_page(const Params& p, int pos) {
  return p.page_shift >= 0 ? pos & (p.page_size - 1) : pos % p.page_size;
}

// Page ids a unit's kv range can span: a sequence's table, at most.
__host__ __device__ inline int max_unit_pages(const Params& p) { return p.NP + 1; }

// What every CTA reads of the call's plan, in shared memory: q_lens
// (clamped at 0) and kv_lens, loaded once by all threads together (a
// walk over them in device memory would wait on each length in turn),
// then the page ids of the unit at hand.
struct Plan {
  int* q;      // [B]
  int* kv;     // [B]
  int* pages;  // [max pages] the unit's page ids, from table slot page0
  int page0;
};

__device__ Plan load_plan(const Params& p, int* mem) {
  Plan pl{mem, mem + p.B, mem + 2 * p.B, 0};
  for (int b = threadIdx.x; b < p.B; b += kThreads) {
    pl.q[b] = max(p.q_lens[b], 0);
    pl.kv[b] = p.kv_lens[b];
  }
  __syncthreads();
  return pl;
}

// The page ids of kv positions [lo, hi) of sequence b into pl.pages
// (all threads; a barrier comes before they are read).
__device__ void load_pages(const Params& p, Plan& pl, int b, int lo, int hi, int max_pages) {
  pl.page0 = page_of(p, lo);
  const int n = hi > lo ? min(max_pages, page_of(p, hi - 1) - pl.page0 + 1) : 0;
  const int* bt = p.block_tables + (size_t)b * p.NP + pl.page0;
  for (int i = threadIdx.x; i < n; i += kThreads) pl.pages[i] = __ldg(bt + i);
}

// Packed tokens of segment b: q_len rounded up to q_block (0 sits out).
__device__ inline int seg_tokens(const Params& p, const Plan& pl, int b) {
  return cdiv(pl.q[b], p.q_block) * p.q_block;
}

// Rows of tokens past the live segments hold 0: every CTA zeroes a
// stride of them.
__device__ void zero_dead_rows(const Params& p, const Plan& pl) {
  int live = 0;
  for (int b = 0; b < p.B; ++b) live += seg_tokens(p, pl, b);
  live = min(live, p.T);
  const size_t n = (size_t)(p.T - live) * p.Hq * p.D;
  float* o = p.out + (size_t)live * p.Hq * p.D;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads)
    o[e] = 0.f;
}

// After a unit's split wrote its partial (all threads call this): count
// the split in; the CTA that counts the last one combines every split's
// (m, l, acc) in split order and writes the unit's rows, `row(k)` for k
// in [0, nrows) (query rows tok * Hq + head), then puts the count back.
// The combine works on all rows at once (a row at a time would wait on
// its loads in turn): the rows' (m, l) into shared memory `sm` (`cap`
// floats, free by now), each row's weights and sum, then each thread's
// (row, 4 columns) summed over the splits in order, a split's loads for
// all of a thread's columns in flight together.
template <typename RowFn>
__device__ void finish_split(const Params& p, int ns, int cidx, int nrows, RowFn row,
                             int* s_last, float* sm, int cap) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(p.counters + cidx, 1) == ns - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  constexpr int kPer = kTileRows * 32 / kThreads;  // (row, 4 columns) a thread: D <= 128
  const int tid = threadIdx.x, D4 = p.D / 4;
  const size_t TH = (size_t)p.T * p.Hq;
  const int per_row = 3 * ns + 2;  // m, l, weight a split; the sum; the row
  const int batch = max(1, min(nrows, min(kTileRows, cap / per_row)));
  for (int r0 = 0; r0 < nrows; r0 += batch) {
    const int nb = min(batch, nrows - r0);
    for (int k = tid; k < nb; k += kThreads)
      reinterpret_cast<int*>(sm)[k * per_row + 3 * ns + 1] = (int)row(r0 + k);
    __syncthreads();
    for (int e = tid; e < nb * ns; e += kThreads) {
      const int k = e / ns, s = e - k * ns;
      const int r = reinterpret_cast<const int*>(sm)[k * per_row + 3 * ns + 1];
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(p.part_ml) + s * TH + r);
      sm[k * per_row + s] = ml.x;
      sm[k * per_row + ns + s] = ml.y;
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kThreads) {
      float* r = sm + k * per_row;
      float M = -INFINITY;
      for (int s = 0; s < ns; ++s) M = fmaxf(M, r[s]);
      float L = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float w = r[s] == -INFINITY ? 0.f : expf(r[s] - M);
        r[2 * ns + s] = w;
        L += r[ns + s] * w;
      }
      r[3 * ns] = L;
    }
    __syncthreads();
    float4 a[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads, k = e / D4;
        if (k < nb) {
          const float w = sm[k * per_row + 2 * ns + s];
          const int r = reinterpret_cast<const int*>(sm)[k * per_row + 3 * ns + 1];
          const float4 x = __ldcg(reinterpret_cast<const float4*>(
                                      p.part_acc + (s * TH + r) * p.D) + (e - k * D4));
          a[i].x += w * x.x;
          a[i].y += w * x.y;
          a[i].z += w * x.z;
          a[i].w += w * x.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, k = e / D4;
      if (k < nb) {
        const float L = sm[k * per_row + 3 * ns];
        const int r = reinterpret_cast<const int*>(sm)[k * per_row + 3 * ns + 1];
        reinterpret_cast<float4*>(p.out + (size_t)r * p.D)[e - k * D4] =
            L == 0.f ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : make_float4(a[i].x / L, a[i].y / L, a[i].z / L, a[i].w / L);
      }
    }
    __syncthreads();  // the next batch takes the shared memory
  }
  if (threadIdx.x == 0) p.counters[cidx] = 0;
}

// ------------------------------------------------------------ copies --
__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ inline void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------- tensor cores --
// c += a b: a 16x16 bf16 A fragment, b (b0, b1) a 16x8 bf16 B fragment.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as three bf16 pairs hi + mid + lo, x0 in the low halves. Every
// subtraction is exact and each plane leaves at most 2^-8 of what it
// takes, so the three hold all 24 bits of each value.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// Two bytes of `w` (bytes p, p + 1; `sel` = 0x7440 + p) as a bf16 pair,
// the lower byte in the low half. Exact: the byte, its sign bit flipped,
// lies under the exponent of 2^23; subtracting 2^23 + 128 leaves the
// integer, an fp32 whose low 16 bits are zero.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// 16 int8 (a uint4) as fp32, exactly: each byte, its sign bit flipped,
// under the exponent of 2^23, less 2^23 + 128 (a byte permute and an add;
// the int8-to-float conversion instruction runs at a quarter of that rate)
__device__ __forceinline__ void i8x16_to_f32(uint4 w, float f[16]) {
  const uint32_t ws[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                          w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = __uint_as_float(__byte_perm(ws[i], 0x4B000000u, 0x7440 + b)) - 8388736.f;
}

// ---------------------------------------------------------- mixed route --
template <bool Q8, int D>
struct MixCfg {
  static constexpr int kEsize = Q8 ? 1 : 4;
  static constexpr int kPlanes = Q8 ? 1 : 3;   // bf16 planes of K and V
  static constexpr int kDP = D < 16 ? 16 : D;  // D padded to the k16 step
  static constexpr int kRow = D * kEsize;      // bytes of a pool row
  // the raw chunk: K rows, V rows, then (int8) the K and V scales
  static constexpr int kRawBytes = kChunk * 2 * kRow + (Q8 ? 2 * kChunk * 4 : 0);
  // bf16 planes [token][kDP + 8]: a row pitch of an odd number of 16-byte
  // units, so ldmatrix's eight row reads hit distinct banks
  static constexpr int kPP = kDP + 8;
  static constexpr int kPlaneBytes = kChunk * kPP * 2;
  // q rows (fp32, split when read) at a pitch of 8 mod 32 floats: a warp's
  // 8-byte reads of rows g, columns 2t hit distinct banks
  static constexpr int kQS = at_residue(kDP, 32, 8);
  // int8 pools: q as three bf16 planes [row][kPP], split once a unit in
  // place (raw rows read out first) and read by ldmatrix; fp32 pools keep
  // q in fp32 and split it at each k step (their planes take the room)
  static constexpr bool kQPlanes = Q8;
  static constexpr int kQBytes = kQPlanes && 3 * kPP * 2 > kQS * 4 ? 3 * kTileRows * kPP * 2
                                                                  : kTileRows * kQS * 4;
  static constexpr int kKSteps = kDP / 16;
  static constexpr int kNd = D / 8;  // n8 tiles of a P.V row
  static constexpr int kBodyBytes = kRawBytes + 2 * kPlanes * kPlaneBytes + 2 * kChunk * 4;
  static constexpr int kRedBytes = 3 * 16 * (D + 2) * 4;  // the warps' merge
  static constexpr int kBufBytes = kBodyBytes > kRedBytes ? kBodyBytes : kRedBytes;
  static constexpr int kSmem = kQBytes + kBufBytes;
  // CTAs an SM's shared memory holds (at most 3): registers are sized so
  // that as many fit
  static constexpr int kPerSm = 232448 / (kSmem + 1024) > 3 ? 3 : 232448 / (kSmem + 1024);
  static constexpr int kMinBlocks = kPerSm < 1 ? 1 : kPerSm;
};

// One mixed unit: the tile's rows, its kv range and where it writes.
struct Tile {
  int b, tok0, r0, rows, ql, kv_len, kv_need, ns, len, id;
};

// A mixed tile's splits: `work` chunk-weights a unit (a chunk of a tile of
// more than 32 rows weighs 2: its four warps each take the whole chunk),
// whole 64-token chunks each; never more than max_splits splits.
__device__ inline void tile_splits(int kv_need, int rows, int work, int max_splits, int& ns,
                                   int& len) {
  const int chunks = cdiv(max(kv_need, 1), kChunk);
  const int units = max(1, cdiv(chunks * (rows > 32 ? 2 : 1), work));
  len = cdiv(chunks, units) * kChunk;
  if (cdiv(kv_need, len) > max_splits) len = cdiv(cdiv(kv_need, max_splits), 16) * 16;
  ns = kv_need <= 0 ? 1 : cdiv(kv_need, len);
}

// Most mixed tiles a call can have: its rows in tiles of 64, and one
// partial tile a segment.
__host__ __device__ inline int max_tiles(const Params& p) {
  return cdiv(p.T * p.rep, kTileRows) + p.B;
}

// The mixed route's plan, made once a CTA by its first thread into
// shared memory `tab` (max_tiles x 11 ints): segments in order, each cut
// into tiles of up to 64 rows (row r of a segment: its token r / rep, q
// head r % rep of the group), each tile into its kv splits, sized for
// about one unit every kCtasPerUnit CTAs (each kv head's units share
// gridDim.x / (kCtasPerUnit Hk) of them, at least two chunk-weights a unit
// to carry a unit's fixed costs): a split costs its partial's round trip
// and a combine at the end of its unit, and on the card one unit every
// two CTAs beat one, four and eight (`chip_ab.py groups . attn_units`,
// PERF.md). Returns the number of tile-split units (one kv head's).
__device__ int mixed_plan(const Params& p, const Plan& pl, int* tab) {
  __shared__ int s_n, s_work, s_units;
  if (threadIdx.x == 0) {  // the tiles' geometry (a running sum: one thread)
    int tok0 = 0, n = 0, weight = 0;
    for (int b = 0; b < p.B && tok0 < p.T; ++b) {
      const int ql = pl.q[b];
      const int seg = seg_tokens(p, pl, b);
      if (seg == 0) continue;
      const int seg_rows = min(seg, p.T - tok0) * p.rep;
      const int kv_len = pl.kv[b];
      for (int r0 = 0; r0 < seg_rows; r0 += kTileRows, ++n) {
        const int rows = min(kTileRows, seg_rows - r0);
        const int lr = r0 + rows - 1;  // the tile's last row and its token
        const int last = p.rep == 1 ? lr : lr / p.rep;
        const int kv_need = max(0, min(kv_len, kv_len - ql + last + 1));
        int* t = tab + 11 * n;
        t[0] = b, t[1] = tok0, t[2] = r0, t[3] = rows, t[4] = ql, t[5] = kv_len;
        t[6] = kv_need, t[9] = n;
        weight += cdiv(max(kv_need, 1), kChunk) * (rows > 32 ? 2 : 1);
      }
      tok0 += seg;
    }
    s_n = n;
    s_work = max(2, cdiv(weight, max(1, (int)gridDim.x / (kCtasPerUnit * p.Hk))));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_n; i += kThreads) {  // each tile's splits
    int* t = tab + 11 * i;
    tile_splits(t[6], t[3], s_work, p.max_splits, t[7], t[8]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the units' offsets
    int units = 0;
    for (int i = 0; i < s_n; ++i) {
      tab[11 * i + 10] = units;
      units += tab[11 * i + 7];
    }
    s_units = units;
    tab[11 * max_tiles(p)] = s_n;
  }
  __syncthreads();
  return s_units;
}

// Tile-split unit ts of the plan: its tile and split.
__device__ inline void plan_unit(const Params& p, const int* tab, int ts, Tile& tl, int& split) {
  const int n = tab[11 * max_tiles(p)];
  int i = 0;
  while (i + 1 < n && tab[11 * (i + 1) + 10] <= ts) ++i;
  const int* t = tab + 11 * i;
  tl = Tile{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9]};
  split = ts - t[10];
}

// Start copying K/V of tokens [c0, c0 + n) of kv head kvh into the raw
// chunk (K rows, V rows, then for int8 the K and V scales). Every copied
// token is below kv_len, so never stale or unwritten pool memory.
template <bool Q8, int D>
__device__ void stage(const Params& p, const Plan& pl, int kvh, int c0, int n,
                      unsigned char* raw) {
  using C = MixCfg<Q8, D>;
  constexpr int kRow16 = C::kRow / 16;  // 16-byte pieces of a row
  unsigned char* ks = raw;
  unsigned char* vs = raw + kChunk * C::kRow;
  const unsigned char* kp = static_cast<const unsigned char*>(p.k_pages);
  const unsigned char* vp = static_cast<const unsigned char*>(p.v_pages);
  for (int e = threadIdx.x; e < n * kRow16; e += kThreads) {
    const int j = e / kRow16, c = e - j * kRow16;
    const int pos = c0 + j;
    const size_t slot =
        ((size_t)kvh * p.P + pl.pages[page_of(p, pos) - pl.page0]) * p.page_size +
        in_page(p, pos);
    cp_async16(ks + j * C::kRow + 16 * c, kp + slot * C::kRow + 16 * c);
    cp_async16(vs + j * C::kRow + 16 * c, vp + slot * C::kRow + 16 * c);
  }
  if constexpr (Q8) {
    float* ksc = reinterpret_cast<float*>(vs + kChunk * C::kRow);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int pos = c0 + j;
      const size_t slot =
          ((size_t)kvh * p.P + pl.pages[page_of(p, pos) - pl.page0]) * p.page_size +
          in_page(p, pos);
      cp_async4(ksc + j, p.k_scales + slot);
      cp_async4(ksc + kChunk + j, p.v_scales + slot);
    }
  }
  cp_async_commit();
}

// The raw chunk (its first n tokens) into bf16 planes, all threads:
// int8 K/V exactly (one plane each), fp32 as hi, mid, lo; rows past n and
// the columns D .. kDP are 0 (zero V rows and scales keep P.V finite where
// P is 0). The scales go to their own arrays, so the raw chunk can take
// the next chunk's copies while this one is used.
template <bool Q8, int D>
__device__ void convert(const unsigned char* raw, int n, __nv_bfloat16* kpl,
                        __nv_bfloat16* vpl, float* scl) {
  using C = MixCfg<Q8, D>;
  constexpr int kVals = Q8 ? 16 : 4;         // values in 16 raw bytes
  constexpr int kPieces = C::kDP / kVals;    // pieces of a padded row
  for (int e = threadIdx.x; e < 2 * kChunk * kPieces; e += kThreads) {
    const int kv = e / (kChunk * kPieces);   // 0 K, 1 V
    const int j = (e / kPieces) % kChunk, c = e % kPieces;
    const bool live = j < n && c * kVals < D;
    const unsigned char* src = raw + kv * kChunk * C::kRow + j * C::kRow + 16 * c;
    __nv_bfloat16* dst = (kv ? vpl : kpl) + j * C::kPP + c * kVals;
    if constexpr (Q8) {
      const uint4 w = live ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = i8x2_to_bf16x2(ws[i], 0x7440);
        o[2 * i + 1] = i8x2_to_bf16x2(ws[i], 0x7442);
      }
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
      const float4 x = live ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
      uint32_t h0, m0, l0, h1, m1, l1;
      split3(x.x, x.y, h0, m0, l0);
      split3(x.z, x.w, h1, m1, l1);
      constexpr int kPlane = kChunk * C::kPP;  // elements between planes
      *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(dst + kPlane) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(dst + 2 * kPlane) = make_uint2(l0, l1);
    }
  }
  if constexpr (Q8) {
    const float* rsc = reinterpret_cast<const float*>(raw + 2 * kChunk * C::kRow);
    for (int j = threadIdx.x; j < 2 * kChunk; j += kThreads)
      scl[j] = (j % kChunk) < n ? rsc[j] : 0.f;
  }
}

// ldmatrix: four 8x8 bf16 matrices, row addresses from lanes 8i .. 8i + 7
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm2t(uint32_t r[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

template <bool Q8, int D>
__device__ void mixed_unit(const Params& p, Plan& pl, int max_pages, const Tile& tl, int h,
                           int split, float* qs, unsigned char* buf, int* s_last) {
  using C = MixCfg<Q8, D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lo = split * tl.len, hi = min(lo + tl.len, tl.kv_need);
  // 16-row m tiles; a tile of 32 rows or fewer gives each m tile 2 or 4
  // warps, each on its share of every chunk's tokens
  const int MT = cdiv(tl.rows, 16);
  const int MTp = MT == 1 ? 1 : (MT == 2 ? 2 : 4);
  const int KG = 4 / MTp;
  const int mt = warp % MTp, kg = warp / MTp;
  const bool active = mt < MT;
  const int NT = kChunk / KG / 8;  // n8 tiles of this warp's tokens: 8, 4 or 2
  const int j0 = kg * NT * 8;      // its first token in a chunk
  unsigned char* raw = buf;
  __nv_bfloat16* kpl = reinterpret_cast<__nv_bfloat16*>(buf + C::kRawBytes);
  __nv_bfloat16* vpl = kpl + C::kPlanes * kChunk * C::kPP;
  float* scl = reinterpret_cast<float*>(vpl + C::kPlanes * kChunk * C::kPP);  // K, V scales

  __syncthreads();  // the previous unit is done with shared memory
  // the tile's q rows (scaled when they are split); rows past the tile
  // are 0. Their copies fly while the page ids are read.
  constexpr int kD4 = D / 4;
  for (int e = tid; e < MTp * 16 * kD4; e += kThreads) {
    const int r = e / kD4, d4 = e - r * kD4;
    float* dst = qs + r * C::kQS + 4 * d4;
    if (r < tl.rows) {
      const int sr = tl.r0 + r;
      const size_t row = (size_t)(tl.tok0 + sr / p.rep) * p.Hq + h * p.rep + sr % p.rep;
      cp_async16(dst, p.q + row * D + 4 * d4);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_commit();
  load_pages(p, pl, tl.b, lo, hi, max_pages);
  __syncthreads();  // the page ids
  if (lo < hi) stage<Q8, D>(p, pl, h, lo, min(kChunk, hi - lo), raw);

  // this thread's rows g and g + 8 of its m tile and their kv bounds: a
  // row's token i attends positions <= kv_len - q_len + i; rows past the
  // tile attend nothing
  const int ra = mt * 16 + g, rb = ra + 8;
  const int pos_a = ra < tl.rows ? tl.kv_len - tl.ql + (tl.r0 + ra) / p.rep : -1;
  const int pos_b = rb < tl.rows ? tl.kv_len - tl.ql + (tl.r0 + rb) / p.rep : -1;
  // ldmatrix row addresses: lane l reads row l & 7 of matrix l >> 3
  const int lr = lane & 7, lm = lane >> 3;

  float acc[C::kNd][4];
#pragma unroll
  for (int nd = 0; nd < C::kNd; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    cp_async_wait<0>();
    __syncthreads();  // this chunk's bytes (and the q rows) have landed
    if constexpr (C::kQPlanes) {
      if (c0 == lo) {  // q rows into three bf16 planes, in place: read, then write
        constexpr int kPer = kTileRows * kD4 / kThreads;
        float4 x[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = tid + i * kThreads, r = e / kD4, d4 = e - r * kD4;
          x[i] = r < MTp * 16 ? *reinterpret_cast<const float4*>(qs + r * C::kQS + 4 * d4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
        __nv_bfloat16* qp = reinterpret_cast<__nv_bfloat16*>(qs);
        const float sc = p.scale;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = tid + i * kThreads, r = e / kD4, d4 = e - r * kD4;
          uint32_t h0, m0, l0, h1, m1, l1;
          split3(x[i].x * sc, x[i].y * sc, h0, m0, l0);
          split3(x[i].z * sc, x[i].w * sc, h1, m1, l1);
          __nv_bfloat16* dst = qp + r * C::kPP + 4 * d4;
          *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(dst + kTileRows * C::kPP) = make_uint2(m0, m1);
          *reinterpret_cast<uint2*>(dst + 2 * kTileRows * C::kPP) = make_uint2(l0, l1);
        }
      }
    }
    convert<Q8, D>(raw, n, kpl, vpl, scl);
    __syncthreads();  // the planes are written; the raw chunk is free
    if (c0 + kChunk < hi)  // the next chunk's copies fly while this one is used
      stage<Q8, D>(p, pl, h, c0 + kChunk, min(kChunk, hi - c0 - kChunk), raw);

    if (active) {
      // S = (q scale) K^T over this warp's tokens, a k step at a time into
      // fresh accumulators, added in fp32
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        // A: q rows g and g + 8, columns 2t, 2t+1 and 2t+8, 2t+9, scaled
        // and split into three bf16 planes (int8 pools: read as such,
        // matrices rows +0 / +8, columns +0 / +8)
        uint32_t ah[4], am[4], al[4];
        if constexpr (C::kQPlanes) {
          const __nv_bfloat16* qp = reinterpret_cast<const __nv_bfloat16*>(qs) +
                                    (mt * 16 + (lm & 1) * 8 + lr) * C::kPP + 16 * kk +
                                    (lm >> 1) * 8;
          ldsm4(ah, qp);
          ldsm4(am, qp + kTileRows * C::kPP);
          ldsm4(al, qp + 2 * kTileRows * C::kPP);
        } else {
          const int d0 = 16 * kk + 2 * t, d1 = d0 + 8;
          const float2 z = make_float2(0.f, 0.f);
          const float2 xa0 = *reinterpret_cast<const float2*>(qs + ra * C::kQS + d0);
          const float2 xb0 = *reinterpret_cast<const float2*>(qs + rb * C::kQS + d0);
          const float2 xa1 =
              (D >= 16 || d1 < D) ? *reinterpret_cast<const float2*>(qs + ra * C::kQS + d1) : z;
          const float2 xb1 =
              (D >= 16 || d1 < D) ? *reinterpret_cast<const float2*>(qs + rb * C::kQS + d1) : z;
          const float sc = p.scale;
          split3(xa0.x * sc, xa0.y * sc, ah[0], am[0], al[0]);
          split3(xb0.x * sc, xb0.y * sc, ah[1], am[1], al[1]);
          split3(xa1.x * sc, xa1.y * sc, ah[2], am[2], al[2]);
          split3(xb1.x * sc, xb1.y * sc, ah[3], am[3], al[3]);
        }
        // two n tiles an ldmatrix.x4 (matrices: tokens +0 / +8, columns
        // +0 / +8), four n tiles at a time, the products term by term
        // across them (independent chains)
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += 4) {
          if (n0 < NT) {
            float c[4][4];
#pragma unroll
            for (int x = 0; x < 4; ++x) c[x][0] = c[x][1] = c[x][2] = c[x][3] = 0.f;
            uint32_t b[C::kPlanes][4][2];
#pragma unroll
            for (int pl2 = 0; pl2 < C::kPlanes; ++pl2) {
#pragma unroll
              for (int x = 0; x < 4; x += 2) {
                uint32_t r[4];
                const int tok = j0 + (n0 + x) * 8 + (lm >> 1) * 8 + lr;
                ldsm4(r, kpl + pl2 * kChunk * C::kPP + tok * C::kPP + 16 * kk + (lm & 1) * 8);
                b[pl2][x][0] = r[0];
                b[pl2][x][1] = r[1];
                b[pl2][x + 1][0] = r[2];
                b[pl2][x + 1][1] = r[3];
              }
            }
            if constexpr (Q8) {
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], al, b[0][x][0], b[0][x][1]);
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], am, b[0][x][0], b[0][x][1]);
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], ah, b[0][x][0], b[0][x][1]);
            } else {
              constexpr int H = 0, M = C::kPlanes > 1 ? 1 : 0, L = C::kPlanes > 2 ? 2 : 0;
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], al, b[H][x][0], b[H][x][1]);  // q lo  k hi
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], am, b[M][x][0], b[M][x][1]);  // q mid k mid
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], ah, b[L][x][0], b[L][x][1]);  // q hi  k lo
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], am, b[H][x][0], b[H][x][1]);  // q mid k hi
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], ah, b[M][x][0], b[M][x][1]);  // q hi  k mid
#pragma unroll
              for (int x = 0; x < 4; ++x) mma(c[x], ah, b[H][x][0], b[H][x][1]);  // q hi  k hi
            }
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              s[n0 + x][0] += c[x][0];
              s[n0 + x][1] += c[x][1];
              s[n0 + x][2] += c[x][2];
              s[n0 + x][3] += c[x][3];
            }
          }
        }
      }

      // K scales (int8) and the mask: columns 2t, 2t+1 of n tile nt are
      // chunk tokens j0 + 8 nt + 2t, + 1
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < NT) {
          const int jc = j0 + nt * 8 + 2 * t;
          const int pos = c0 + jc;
          float k0 = 1.f, k1 = 1.f;
          if constexpr (Q8) {
            k0 = scl[jc];
            k1 = scl[jc + 1];
          }
          s[nt][0] = (jc < n && pos <= pos_a) ? s[nt][0] * k0 : -INFINITY;
          s[nt][1] = (jc + 1 < n && pos + 1 <= pos_a) ? s[nt][1] * k1 : -INFINITY;
          s[nt][2] = (jc < n && pos <= pos_b) ? s[nt][2] * k0 : -INFINITY;
          s[nt][3] = (jc + 1 < n && pos + 1 <= pos_b) ? s[nt][3] * k1 : -INFINITY;
          mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
        }
      }
      // online softmax: a row lives on the four lanes of a quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = mn_a == -INFINITY ? 1.f : expf(m_a - mn_a);
      const float al_b = mn_b == -INFINITY ? 1.f : expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int nd = 0; nd < C::kNd; ++nd) {
        acc[nd][0] *= al_a;
        acc[nd][1] *= al_a;
        acc[nd][2] *= al_b;
        acc[nd][3] *= al_b;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < NT) {
          s[nt][0] = mn_a == -INFINITY ? 0.f : expf(s[nt][0] - mn_a);
          s[nt][1] = mn_a == -INFINITY ? 0.f : expf(s[nt][1] - mn_a);
          s[nt][2] = mn_b == -INFINITY ? 0.f : expf(s[nt][2] - mn_b);
          s[nt][3] = mn_b == -INFINITY ? 0.f : expf(s[nt][3] - mn_b);
          l_a += s[nt][0] + s[nt][1];
          l_b += s[nt][2] + s[nt][3];
        }
      }

      // acc += P V, 16 tokens a k step: score tiles 2jj and 2jj + 1 are
      // the A fragment (FA2's register reuse); B comes from the V planes
      // through ldmatrix.trans (matrices: tokens +0 / +8, columns +0 / +8)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (2 * jj < NT) {
          const int jt = j0 + 16 * jj + 2 * t;  // tokens jt, jt+1, jt+8, jt+9
          float pa0 = s[2 * jj][0], pa1 = s[2 * jj][1], pb0 = s[2 * jj][2], pb1 = s[2 * jj][3];
          float pc0 = s[2 * jj + 1][0], pc1 = s[2 * jj + 1][1];
          float pd0 = s[2 * jj + 1][2], pd1 = s[2 * jj + 1][3];
          if constexpr (Q8) {  // V's scales fold into P
            const float* vsc = scl + kChunk;
            const float v0 = vsc[jt], v1 = vsc[jt + 1], v8 = vsc[jt + 8], v9 = vsc[jt + 9];
            pa0 *= v0;
            pa1 *= v1;
            pb0 *= v0;
            pb1 *= v1;
            pc0 *= v8;
            pc1 *= v9;
            pd0 *= v8;
            pd1 *= v9;
          }
          uint32_t ph[4], pm[4], pl3[4];
          split3(pa0, pa1, ph[0], pm[0], pl3[0]);
          split3(pb0, pb1, ph[1], pm[1], pl3[1]);
          split3(pc0, pc1, ph[2], pm[2], pl3[2]);
          split3(pd0, pd1, ph[3], pm[3], pl3[3]);
          const int vtok = j0 + 16 * jj + (lm & 1) * 8 + lr;
#pragma unroll
          for (int n0 = 0; n0 < C::kNd; n0 += 4) {
            constexpr int kG = C::kNd < 4 ? C::kNd : 4;
            float c[kG][4];
#pragma unroll
            for (int x = 0; x < kG; ++x) c[x][0] = c[x][1] = c[x][2] = c[x][3] = 0.f;
            uint32_t b[C::kPlanes][kG][2];
#pragma unroll
            for (int pl2 = 0; pl2 < C::kPlanes; ++pl2) {
              const __nv_bfloat16* vb = vpl + pl2 * kChunk * C::kPP + vtok * C::kPP;
              if constexpr (kG == 1) {
                uint32_t r[2];
                ldsm2t(r, vb + 8 * n0);
                b[pl2][0][0] = r[0];
                b[pl2][0][1] = r[1];
              } else {
#pragma unroll
                for (int x = 0; x < kG; x += 2) {
                  uint32_t r[4];
                  ldsm4t(r, vb + 8 * (n0 + x) + (lm >> 1) * 8);
                  b[pl2][x][0] = r[0];
                  b[pl2][x][1] = r[1];
                  b[pl2][x + 1][0] = r[2];
                  b[pl2][x + 1][1] = r[3];
                }
              }
            }
            if constexpr (Q8) {
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], pl3, b[0][x][0], b[0][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], pm, b[0][x][0], b[0][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], ph, b[0][x][0], b[0][x][1]);
            } else {
              constexpr int H = 0, M = C::kPlanes > 1 ? 1 : 0, L = C::kPlanes > 2 ? 2 : 0;
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], pl3, b[H][x][0], b[H][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], pm, b[M][x][0], b[M][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], ph, b[L][x][0], b[L][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], pm, b[H][x][0], b[H][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], ph, b[M][x][0], b[M][x][1]);
#pragma unroll
              for (int x = 0; x < kG; ++x) mma(c[x], ph, b[H][x][0], b[H][x][1]);
            }
#pragma unroll
            for (int x = 0; x < kG; ++x) {
              acc[n0 + x][0] += c[x][0];
              acc[n0 + x][1] += c[x][1];
              acc[n0 + x][2] += c[x][2];
              acc[n0 + x][3] += c[x][3];
            }
          }
        }
      }
    }
    __syncthreads();  // the planes are converted anew next turn
  }
  cp_async_wait<0>();  // the q copies, where the unit had no kv to read
  // a row's sum is spread over its quad
  l_a += __shfl_xor_sync(kFull, l_a, 1);
  l_a += __shfl_xor_sync(kFull, l_a, 2);
  l_b += __shfl_xor_sync(kFull, l_b, 1);
  l_b += __shfl_xor_sync(kFull, l_b, 2);

  // merge the warps that shared an m tile, in kv order
  if (KG > 1) {
    __syncthreads();
    float* red = reinterpret_cast<float*>(buf);  // [KG - 1][MTp * 16][D + 2]
    constexpr int RW = D + 2;
    if (active && kg > 0) {
      float* rr = red + (size_t)(kg - 1) * MTp * 16 * RW;
#pragma unroll
      for (int nd = 0; nd < C::kNd; ++nd) {
        rr[ra * RW + 8 * nd + 2 * t] = acc[nd][0];
        rr[ra * RW + 8 * nd + 2 * t + 1] = acc[nd][1];
        rr[rb * RW + 8 * nd + 2 * t] = acc[nd][2];
        rr[rb * RW + 8 * nd + 2 * t + 1] = acc[nd][3];
      }
      if (t == 0) {
        rr[ra * RW + D] = m_a;
        rr[ra * RW + D + 1] = l_a;
        rr[rb * RW + D] = m_b;
        rr[rb * RW + D + 1] = l_b;
      }
    }
    __syncthreads();
    if (active && kg == 0) {
      for (int k = 1; k < KG; ++k) {
        const float* rr = red + (size_t)(k - 1) * MTp * 16 * RW;
        const float m2a = rr[ra * RW + D], m2b = rr[rb * RW + D];
        const float Ma = fmaxf(m_a, m2a), Mb = fmaxf(m_b, m2b);
        const float wa = m_a == -INFINITY ? 0.f : expf(m_a - Ma);
        const float va = m2a == -INFINITY ? 0.f : expf(m2a - Ma);
        const float wb = m_b == -INFINITY ? 0.f : expf(m_b - Mb);
        const float vb = m2b == -INFINITY ? 0.f : expf(m2b - Mb);
        l_a = l_a * wa + rr[ra * RW + D + 1] * va;
        l_b = l_b * wb + rr[rb * RW + D + 1] * vb;
        m_a = Ma;
        m_b = Mb;
#pragma unroll
        for (int nd = 0; nd < C::kNd; ++nd) {
          acc[nd][0] = acc[nd][0] * wa + rr[ra * RW + 8 * nd + 2 * t] * va;
          acc[nd][1] = acc[nd][1] * wa + rr[ra * RW + 8 * nd + 2 * t + 1] * va;
          acc[nd][2] = acc[nd][2] * wb + rr[rb * RW + 8 * nd + 2 * t] * vb;
          acc[nd][3] = acc[nd][3] * wb + rr[rb * RW + 8 * nd + 2 * t + 1] * vb;
        }
      }
    }
  }

  // write: the rows themselves (one split) or this split's partial
  auto row_of = [&](int r) {
    const int sr = tl.r0 + r;
    return (size_t)(tl.tok0 + sr / p.rep) * p.Hq + h * p.rep + sr % p.rep;
  };
  if (active && kg == 0) {
    const size_t TH = (size_t)p.T * p.Hq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= tl.rows) continue;
      const size_t gr = row_of(r);
      const float l = half ? l_b : l_a;
      if (tl.ns == 1) {
        float* o = p.out + gr * D;
#pragma unroll
        for (int nd = 0; nd < C::kNd; ++nd)
          *reinterpret_cast<float2*>(o + 8 * nd + 2 * t) =
              l == 0.f ? make_float2(0.f, 0.f)
                       : make_float2(acc[nd][2 * half] / l, acc[nd][2 * half + 1] / l);
      } else {
        float* o = p.part_acc + (split * TH + gr) * D;
#pragma unroll
        for (int nd = 0; nd < C::kNd; ++nd)
          *reinterpret_cast<float2*>(o + 8 * nd + 2 * t) =
              make_float2(acc[nd][2 * half], acc[nd][2 * half + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(p.part_ml + (split * TH + gr) * 2) =
              make_float2(half ? m_b : m_a, l);
      }
    }
  }
  if (tl.ns > 1)
    finish_split(p, tl.ns, tl.id * p.Hk + h, tl.rows, row_of, s_last,
                 reinterpret_cast<float*>(buf), C::kBufBytes / 4);
}

template <bool Q8, int D>
__global__ void __launch_bounds__(kThreads, (MixCfg<Q8, D>::kMinBlocks))
    paged_attention_mixed_kernel(Params p) {
  using C = MixCfg<Q8, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* buf = smem + C::kQBytes;
  Plan pl = load_plan(p, reinterpret_cast<int*>(smem + C::kSmem));
  const int max_pages = max_unit_pages(p);
  int* tab = pl.pages + max_pages;
  zero_dead_rows(p, pl);
  Tile tl;
  int split;
  const int units = mixed_plan(p, pl, tab) * p.Hk;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int h = u % p.Hk;
    plan_unit(p, tab, u / p.Hk, tl, split);
    mixed_unit<Q8, D>(p, pl, max_pages, tl, h, split, qs, buf, &s_last);
  }
}

// --------------------------------------------------------- decode route --
// The decode route's plan, made once a CTA into shared memory `tab` (B x
// 6 ints): each token of each segment (q_block 1: a segment is its q_len
// tokens) with the splits of its segment's kv_len. Returns the number of
// token-split units (one kv head's).
__device__ int decode_plan(const Params& p, const Plan& pl, int* tab) {
  __shared__ int s_units;
  for (int b = threadIdx.x; b < p.B; b += kThreads)
    split_geom(pl.kv[b], p.split_tokens, p.max_splits, tab[6 * b + 3], tab[6 * b + 4]);
  __syncthreads();
  if (threadIdx.x == 0) {  // running sums: packed tokens, units
    int tok0 = 0, units = 0;
    for (int b = 0; b < p.B; ++b) {
      const int seg = seg_tokens(p, pl, b);
      const int ntok = tok0 < p.T ? min(seg, p.T - tok0) : 0;
      tab[6 * b] = tok0, tab[6 * b + 1] = ntok, tab[6 * b + 5] = units;
      units += ntok * tab[6 * b + 3];
      tok0 += seg;
    }
    s_units = units;
  }
  __syncthreads();
  return s_units;
}

// Token-split unit ts of the plan: its segment b, token (packed index
// tok, and i within the segment), split, and the segment's splits.
__device__ inline void decode_unit(const Params& p, const int* tab, int ts, int& b, int& tok,
                                   int& i, int& split, int& ns, int& len) {
  for (b = 0; b + 1 < p.B; ++b)
    if (tab[6 * b + 1] > 0 && ts < tab[6 * b + 5] + tab[6 * b + 1] * tab[6 * b + 3]) break;
  const int* t = tab + 6 * b;
  ns = t[3], len = t[4];
  const int k = ts - t[5];
  i = k / ns;
  split = k - i * ns;
  tok = t[0] + i;
}

template <bool Q8, int REP>
__global__ void __launch_bounds__(kThreads) paged_attention_decode_kernel(Params p) {
  constexpr int kVec = Q8 ? 16 : 4;  // values in a lane's 16 bytes of a row
  // tokens a group has in flight: 8, or 4 where REP rows of q and of the
  // sums take the registers
  constexpr int kUnroll = REP == 1 ? 8 : 4;
  extern __shared__ __align__(16) float dsm[];
  __shared__ int s_last;
  __shared__ float s_M[REP], s_L[REP];
  const int D = p.D;
  const int G = D / kVec;          // lanes a token: 1 .. 32, a power of 2
  const int NG = kThreads / G;     // token groups in the CTA
  const int tid = threadIdx.x;
  const int gi = tid / G, sl = tid % G;
  float* red = dsm;                       // [NG][REP][D]
  float* ml = red + (size_t)NG * REP * D;  // [NG][REP][2]
  float* wt = ml + NG * REP * 2;           // [NG][REP]
  const size_t TH = (size_t)p.T * p.Hq;
  Plan pl = load_plan(p, reinterpret_cast<int*>(wt + NG * REP));
  const int max_pages = max_unit_pages(p);
  int* tab = pl.pages + max_pages;
  zero_dead_rows(p, pl);

  int b, tok, i, split, ns, len;
  const int units = decode_plan(p, pl, tab) * p.Hk;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int h = u % p.Hk;
    decode_unit(p, tab, u / p.Hk, b, tok, i, split, ns, len);
    const int kv_len = pl.kv[b];
    const int kv_need = max(0, min(kv_len, kv_len - pl.q[b] + i + 1));
    const int lo = split * len, hi = min(lo + len, kv_need);
    __syncthreads();  // the previous unit is done with shared memory
    load_pages(p, pl, b, lo, hi, max_pages);

    float qv[REP][kVec], acc[REP][kVec], m[REP], l[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(
          p.q + ((size_t)tok * p.Hq + h * REP + r) * D + sl * kVec);
#pragma unroll
      for (int v4 = 0; v4 < kVec / 4; ++v4) {
        const float4 x = __ldg(qr + v4);
        qv[r][4 * v4] = x.x * p.scale;
        qv[r][4 * v4 + 1] = x.y * p.scale;
        qv[r][4 * v4 + 2] = x.z * p.scale;
        qv[r][4 * v4 + 3] = x.w * p.scale;
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    __syncthreads();  // the page ids

    for (int base = lo; base < hi; base += NG * kUnroll) {
      int page[kUnroll], pos[kUnroll];
#pragma unroll
      for (int x = 0; x < kUnroll; ++x) {
        pos[x] = base + x * NG + gi;
        page[x] = pos[x] < hi ? pl.pages[page_of(p, pos[x]) - pl.page0] : 0;
      }
      uint4 kr[kUnroll], vr[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int x = 0; x < kUnroll; ++x) {
        kr[x] = vr[x] = make_uint4(0, 0, 0, 0);
        ksc[x] = vsc[x] = 0.f;
        if (pos[x] < hi) {
          const size_t slot = ((size_t)h * p.P + page[x]) * p.page_size + in_page(p, pos[x]);
          const size_t off = (slot * D + sl * kVec) * (Q8 ? 1 : 4);
          kr[x] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const unsigned char*>(p.k_pages) + off));
          vr[x] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const unsigned char*>(p.v_pages) + off));
          if constexpr (Q8) {
            ksc[x] = __ldg(p.k_scales + slot);
            vsc[x] = __ldg(p.v_scales + slot);
          }
        }
      }
      float sc[kUnroll][REP];
#pragma unroll
      for (int x = 0; x < kUnroll; ++x) {
        float kf[kVec];
        if constexpr (Q8) {
          i8x16_to_f32(kr[x], kf);
        } else {
          const float4 k4 = *reinterpret_cast<const float4*>(&kr[x]);
          kf[0] = k4.x;
          kf[1] = k4.y;
          kf[2] = k4.z;
          kf[3] = k4.w;
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < kVec; ++v) s = fmaf(qv[r][v], kf[v], s);
          for (int o = G >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
          sc[x][r] = pos[x] < hi ? (Q8 ? s * ksc[x] : s) : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = sc[0][r];
#pragma unroll
        for (int x = 1; x < kUnroll; ++x) mx = fmaxf(mx, sc[x][r]);
        const float mn = fmaxf(m[r], mx);
        const float alpha = mn == -INFINITY ? 1.f : expf(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[r][v] *= alpha;
#pragma unroll
        for (int x = 0; x < kUnroll; ++x) {
          const float pr = mn == -INFINITY ? 0.f : expf(sc[x][r] - mn);
          l[r] += pr;
          if constexpr (Q8) {
            float vf[kVec];
            i8x16_to_f32(vr[x], vf);
            const float pv = pr * vsc[x];
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(pv, vf[v], acc[r][v]);
          } else {
            const float* vf = reinterpret_cast<const float*>(&vr[x]);
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(pr, vf[v], acc[r][v]);
          }
        }
      }
    }

    // merge the groups, in group order
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float4* dst = reinterpret_cast<float4*>(red + ((size_t)gi * REP + r) * D + sl * kVec);
#pragma unroll
      for (int v4 = 0; v4 < kVec / 4; ++v4)
        dst[v4] = make_float4(acc[r][4 * v4], acc[r][4 * v4 + 1], acc[r][4 * v4 + 2],
                              acc[r][4 * v4 + 3]);
      if (sl == 0) {
        ml[(gi * REP + r) * 2] = m[r];
        ml[(gi * REP + r) * 2 + 1] = l[r];
      }
    }
    __syncthreads();
    // warp r finds row r's largest running max over the groups, each
    // group's weight and the row's sum (REP <= 4 warps)
    if ((tid >> 5) < REP) {
      const int r = tid >> 5, lane = tid & 31;
      float M = -INFINITY;
      for (int k = lane; k < NG; k += 32) M = fmaxf(M, ml[(k * REP + r) * 2]);
      for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
      float L = 0.f;
      for (int k = lane; k < NG; k += 32) {
        const float mk = ml[(k * REP + r) * 2];
        const float w = mk == -INFINITY ? 0.f : expf(mk - M);
        wt[k * REP + r] = w;
        L += ml[(k * REP + r) * 2 + 1] * w;
      }
      for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(kFull, L, o);
      if (lane == 0) {
        s_M[r] = M;
        s_L[r] = L;
      }
    }
    __syncthreads();
    for (int e = tid; e < REP * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      float a = 0.f;
      for (int k = 0; k < NG; ++k) a += red[((size_t)k * REP + r) * D + d] * wt[k * REP + r];
      const size_t gr = (size_t)tok * p.Hq + h * REP + r;
      const float L = s_L[r];
      if (ns == 1) {
        p.out[gr * D + d] = L == 0.f ? 0.f : a / L;
      } else {
        p.part_acc[(split * TH + gr) * D + d] = a;
        if (d == 0) {
          p.part_ml[(split * TH + gr) * 2] = s_M[r];
          p.part_ml[(split * TH + gr) * 2 + 1] = L;
        }
      }
    }
    if (ns > 1)
      finish_split(
          p, ns, tok * p.Hk + h, REP,
          [&](int k) { return (size_t)tok * p.Hq + h * REP + k; }, &s_last, red, NG * REP * D);
  }
}

// ------------------------------------------------------------ launches --
int g_sms[64];

int sm_count() {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (g_sms[dev] == 0) cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return g_sms[dev] > 0 ? g_sms[dev] : 1;
}

// What one kernel instantiation keeps between launches: its occupancy
// at the shared-memory size last launched (the plan's part of it varies
// with B and the split length), and, by device, that its shared-memory
// limit was raised to the card's maximum.
struct LaunchCache {
  int occ = 0, smem = -1;
  unsigned long long raised = 0;  // bit d: device d
};

// grid: the CTAs resident at once (persistent), at most `cap`
template <typename K>
int launch_persistent(K kernel, int smem, long long cap, LaunchCache& lc,
                      const Params& p, void* stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && !(lc.raised >> (dev & 63) & 1)) {
    int most = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)  // the static shared memory counts against it too
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    lc.raised |= 1ull << (dev & 63);
  }
  if (lc.smem != smem) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lc.occ, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    lc.smem = smem;
  }
  long long grid = (long long)sm_count() * (lc.occ > 0 ? lc.occ : 1);
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// shared memory of the plan: q_lens, kv_lens and a unit's page ids
inline int plan_bytes(const Params& p) {
  return (2 * p.B + max_unit_pages(p)) * (int)sizeof(int);
}

template <bool Q8, int D>
int launch_mixed(const Params& p, void* stream) {
  static LaunchCache lc;
  const long long tiles = max_tiles(p);
  return launch_persistent(paged_attention_mixed_kernel<Q8, D>,
                           MixCfg<Q8, D>::kSmem + plan_bytes(p) +
                               (11 * max_tiles(p) + 1) * (int)sizeof(int),
                           tiles * p.Hk * p.max_splits, lc, p, stream);
}

template <bool Q8, int REP>
int launch_decode(const Params& p, void* stream) {
  static LaunchCache lc;
  const int G = p.D / (Q8 ? 16 : 4);
  const int NG = kThreads / G;
  const int smem = (int)(((size_t)NG * REP * p.D + (size_t)NG * REP * 3) * sizeof(float)) +
                   plan_bytes(p) + 6 * p.B * (int)sizeof(int);
  return launch_persistent(paged_attention_decode_kernel<Q8, REP>, smem,
                           (long long)p.T * p.Hk * p.max_splits, lc, p, stream);
}

template <bool Q8>
int dispatch(int route, const Params& p, void* stream) {
  if (route == 1) {
    const int G = p.D / (Q8 ? 16 : 4);
    if (p.D % (Q8 ? 16 : 4) || G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
    switch (p.rep) {
      case 1: return launch_decode<Q8, 1>(p, stream);
      case 2: return launch_decode<Q8, 2>(p, stream);
      case 4: return launch_decode<Q8, 4>(p, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.D) {
    case 8: return Q8 ? (int)cudaErrorInvalidValue : launch_mixed<false, 8>(p, stream);
    case 16: return launch_mixed<Q8, 16>(p, stream);
    case 32: return launch_mixed<Q8, 32>(p, stream);
    case 64: return launch_mixed<Q8, 64>(p, stream);
    case 128: return launch_mixed<Q8, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// route: 0 mixed, 1 decode. int8 pools (q8 != 0) take k_scales/v_scales
// [Hk, P, page_size]; fp32 pools pass null for them. part_acc/part_ml:
// [max_splits, T * Hq, D] and [max_splits, T * Hq, 2] floats; counters:
// at least (ceil(T * rep / 64) + B) * Hk (mixed) or T * Hk (decode) ints,
// 0 before the launch and 0 after it. Launches on `stream` (a
// cudaStream_t); returns a cudaError_t as int.
int pdt_ragged_paged_attention(int route, int q8, const float* q, const void* k_pages,
                               const void* v_pages, const float* k_scales,
                               const float* v_scales, const int* block_tables,
                               const int* kv_lens, const int* q_lens, float* out,
                               float* part_acc, float* part_ml, int* counters, int T,
                               int Hq, int Hk, int D, int P, int page_size, int B, int NP,
                               int q_block, int split_tokens, int max_splits, float scale,
                               void* stream) {
  if (T <= 0 || Hk <= 0) return (int)cudaSuccess;
  int shift = -1;
  for (int k = 0; k < 31; ++k)
    if ((1 << k) == page_size) shift = k;
  const Params p{q, k_pages, v_pages, k_scales, v_scales, block_tables, kv_lens,
                 q_lens, out, part_acc, part_ml, counters, T, Hq, Hk, D, P, page_size,
                 B, NP, q_block, Hq / Hk, split_tokens, max_splits, shift, scale};
  return q8 ? dispatch<true>(route, p, stream) : dispatch<false>(route, p, stream);
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
