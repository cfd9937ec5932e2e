// The f32 chunk loop (C > 1) of K1 (paged_attention.cu) and K3
// (paged_attention_int8.cu) on Hopper's tensor cores: the geometry and
// page-table loaders of the bf16 tile loop (paged_tiles.cuh) with the
// 3xTF32 arithmetic of K2's f32 kernel (flash_attention.cu, helpers in
// tf32_common.cuh), and a split over keys.
//
// What it computes is the Pallas kernels' function: folded row
// r = c * G + g is query position q_pos[b] + c of head kvh * G + g; it sees
// keys t < kv_len = min(kv_lens[b], Pmax * ps) with t <= q_pos[b] + c and,
// under a window, t > q_pos[b] + c - window; optional tanh softcap; a row
// with no visible key writes 0.
//
// What bounds it on an H100: a chunk of C rows does ~4 d flops per (query
// row, visible key) over ~(C H + 2 keys KV) d f32 elements.  At qwen3's
// chunk of 256 (B = 2, 16 / 8 heads of 128, up to 1024 keys) that is 2.1
// GFLOP: in 3xTF32 (three TF32 products an f32 one, at 494.7 TFLOP/s)
// 0.013 ms, against 0.003 ms of bytes, so operations; at gemma2's (d =
// 256, a 4096-key window) 0.10 ms.  The CUDA-core loop it replaces read
// each K/V tile once per 4 query rows and scored a key a lane with a
// serial fmaf chain.
//
// Design:
//   - One block of 4 warps per (64 folded query rows, kv head, sequence,
//     key split) on a 1-D grid that launches the row tiles with the most
//     keys first; each warp owns 16 rows.  Each key tile is read once for
//     64 rows.
//   - The block's key range is the union of its rows' causal and window
//     ranges, cut to its split.  Key tiles start at the range's first key;
//     each key row is copied by 16-byte cp.async from its own address,
//     ((clamp(table[t / ps]) * ps + t % ps) * KV + kvh) * d, double-buffered.
//     Only pages below ceil(kv_len / ps) are looked up; rows past the range
//     are zero-filled (source size 0) and masked.
//   - Products on mma.sync.m16n8k8.tf32 with f32 accumulators, as in K2's
//     f32 kernel: Q stays f32 in shared memory and is split hi/lo per
//     8-wide step (tf32::split_fast: integer rounding, no cvt); an
//     accumulator takes at most CHAIN = 4 steps before the CUDA cores add
//     it to S or O (mma.sync rounds its f32 sums less finely than an
//     FADD); P is reused as the A operand through the PERM key order
//     (accumulator keys 2t, 2t + 1 are A columns t, t + 4), so V's B
//     fragment is V[keys 2t | 2t + 1][dim g].  In Q·K^T the contraction
//     index k of an 8-wide step maps to dim 2k for k < 4 and 2 (k - 4) + 1
//     above, so each lane reads its A (Q[g | g + 8][2t, 2t + 1]) and B
//     (K[key g][2t, 2t + 1]) operands 8 bytes at a time: half the
//     shared-memory load instructions of K2's f32 Q·K^T.  Q and K rows are DP + 8
//     floats (8 banks apart: those 8-byte loads are conflict-free), V rows
//     DP + 4 (4 apart: its 4-byte loads at keys 2t and 2t + 1 are).  Key
//     tiles are 64 keys at DP <= 64 and 32 above (tf32::block_n), and
//     __launch_bounds__ asks for the blocks the shared memory allows.  The
//     online softmax is tf32::softmax_tile (log2 units, ex2, softcap a
//     compile-time flag).
//   - The key split fills the card when the grid is small: qwen3's chunk
//     of 128 tokens for 2 sequences is 64 blocks for an H100's 264 slots
//     (two blocks an SM).  The host
//     picks S splits of L keys (whole pages) from shapes alone
//     (kernels/paged_attention.py::chunk_splits); split s covers the
//     absolute keys [s L, (s + 1) L).  With S == 1 the block normalizes by
//     max(l, 1e-30) and writes out; else it writes f32 partials (acc,
//     m in natural-log units, l) for each of its rows to the wrapper's
//     workspace, a split that sees no key writing l = 0, and
//     paged_decode.cuh's combine merges them on the grid (H, B C), whose
//     row (b C + c) H + h is out [B, C, H, d]'s.
// The two page types differ in the loader and in the passes:
//   - FpTiles (K1): f32 rows into two stages of K/V tiles; 3xTF32 for both
//     products (a_lo b_hi + a_hi b_lo + a_hi b_hi).  103,424 bytes of
//     shared memory at DP = 128: two blocks an SM.
//   - Q8Tiles (K3): two stages of raw int8 codes and their f32 scales by
//     cp.async; after each wait a pass writes the codes, unscaled, into one
//     f32 K/V tile.  A code is exact in TF32 (8 significant bits of 11), so
//     only the f32 side is split: S_t = k_scale[t] ((q_hi + q_lo) code_t)
//     and o = sum_t (p_t v_scale[t]) code_t with the folded P split hi/lo,
//     two products each (l sums the unscaled p_t).  The Pallas kernel
//     dequantizes before both products; this is the same function with
//     another f32 rounding.  86,016 bytes at DP = 128.
#pragma once

#include "attention_common.cuh"
#include "paged_decode.cuh"
#include "tf32_common.cuh"

namespace paged_f32 {

using tf32::BLOCK_M;
using tf32::THREADS;

// An accumulator's 8-wide steps before the CUDA cores add it to S or O.
constexpr int CHAIN = 4;

// This block's (sequence, kv head, first folded row, key split).  Block
// x = ((n_qtiles - 1 - tile) * S + s) * KV * B + b * KV + kvh, so the last
// row tiles (most keys) of every (sequence, kv head) are launched first.
struct BlockTile {
  int b, kvh, r0, s;
};

__device__ __forceinline__ BlockTile block_tile(int n_rows, int KV, int S) {
  const int n_qtiles = (n_rows + BLOCK_M - 1) / BLOCK_M;
  const int per_tile = gridDim.x / n_qtiles, pairs = per_tile / S;
  const int x = blockIdx.x, tile = x / per_tile, rest = x - tile * per_tile;
  const int s = rest / pairs, pair = rest - s * pairs, b = pair / KV;
  return {b, pair - b * KV, (n_qtiles - 1 - tile) * BLOCK_M, s};
}

// Shared row strides, floats: Q and K rows (read 8 bytes a lane), V rows
// (read 4 bytes a lane).
template <int DP>
__host__ __device__ constexpr int qk_stride() { return DP + 8; }
template <int DP>
__host__ __device__ constexpr int v_stride() { return DP + 4; }

// Floats of the f32 Q tile [BLOCK_M][DP + 8]; the loader's tiles follow it.
template <int DP>
__host__ __device__ constexpr size_t q_floats() {
  return size_t(BLOCK_M) * qk_stride<DP>();
}

// f32 K/V pages: two stages of K [BN][DP + 8], then V [BN][DP + 4].
template <int DP>
struct FpTiles {
  static constexpr int BN = tf32::block_n<DP>();
  static constexpr int KS = qk_stride<DP>(), VS = v_stride<DP>();
  static constexpr int STAGE = BN * (KS + VS);  // floats a stage
  static constexpr int CPR = DP / 4;            // 16-byte chunks a padded row
  static constexpr int RPP = THREADS / CPR;     // rows a pass of the block's copies
  static constexpr bool CODES = false;
  static constexpr size_t bytes = sizeof(float) * size_t(2 * STAGE);

  const float* k;
  const float* v;
  attn::PageRows rows;
  int d;
  float* kv_s;

  // Zero the half-step between d and 8 * ceil(d / 8) in every row once.
  __device__ __forceinline__ void zero_tail(int vecs) const {
    for (int j = threadIdx.x; j < 4 * BN; j += THREADS) {
      const int r = j % (2 * BN);
      float* row = kv_s + j / (2 * BN) * STAGE + (r < BN ? r * KS : BN * KS + (r - BN) * VS);
      *reinterpret_cast<float4*>(row + vecs * 4) = make_float4(0, 0, 0, 0);
    }
  }

  // Start the copies of keys [t0, t0 + BN) into `stage`; rows at or past
  // t_end are zero-filled.  Every row is looked up before the first copy.
  __device__ __forceinline__ void issue(int t0, int t_end, int stage) const {
    const int lc = threadIdx.x % CPR, lr = threadIdx.x / CPR;
    if (lc * 4 >= d) return;
    size_t off[BN / RPP];
#pragma unroll
    for (int i = 0; i < BN / RPP; ++i) {
      const int t = t0 + lr + i * RPP;
      off[i] = (t < t_end ? rows.row(t) : 0) * d + lc * 4;
    }
    float* ks = kv_s + stage * STAGE + lc * 4;
    float* vs = ks + BN * KS;
#pragma unroll
    for (int i = 0; i < BN / RPP; ++i) {
      const int j = lr + i * RPP;
      const bool ok = t0 + j < t_end;
      tc::cp_async16(ks + j * KS, k + off[i], ok);
      tc::cp_async16(vs + j * VS, v + off[i], ok);
    }
  }

  // The K tile of `stage` (V follows it, at BN * KS), once its copies have
  // landed and the block has synchronized.
  __device__ __forceinline__ const float* ready(int stage) const {
    return kv_s + stage * STAGE;
  }
};

// int8 code pages with an f32 scale per (token, head): one f32 tile of
// unscaled codes, K [BN][DP + 8] then V [BN][DP + 4], then two stages of
// codes [K, V][BN][DP] and of scales [K, V][BN].  d % 16 == 0, so no
// half-step.
template <int DP>
struct Q8Tiles {
  static constexpr int BN = tf32::block_n<DP>();
  static constexpr int KS = qk_stride<DP>(), VS = v_stride<DP>();
  static constexpr int CPR = DP / 16;           // 16-byte code chunks a row
  static constexpr int RPP = THREADS / CPR;
  static constexpr int WPR = DP / 4;            // 4-code words a row
  static constexpr bool CODES = true;
  static constexpr size_t tile_bytes = sizeof(float) * size_t(BN) * (KS + VS);
  static constexpr size_t code_bytes = size_t(2 * BN) * DP;     // a stage
  static constexpr size_t bytes =
      tile_bytes + 2 * code_bytes + sizeof(float) * size_t(4 * BN);
  static_assert(2 * BN <= THREADS, "one thread a scale");

  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  attn::PageRows rows;
  int d;
  float* kv_s;

  __device__ __forceinline__ int8_t* codes(int stage) const {
    return reinterpret_cast<int8_t*>(reinterpret_cast<unsigned char*>(kv_s) + tile_bytes +
                                     stage * code_bytes);
  }
  // K's BN scales of `stage`, then V's.
  __device__ __forceinline__ float* scales(int stage) const {
    return reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kv_s) + tile_bytes +
                                    2 * code_bytes) + stage * 2 * BN;
  }

  __device__ __forceinline__ void zero_tail(int) const {}

  // Every row is looked up before the first copy, as in FpTiles.
  __device__ __forceinline__ void issue(int t0, int t_end, int stage) const {
    const int tid = threadIdx.x;
    if (tid < 2 * BN) {           // one scale a thread: K's, then V's
      const int ts = t0 + tid % BN;
      const size_t srow = ts < t_end ? rows.row(ts) : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       tc::smem_u32(scales(stage) + tid)),
                   "l"((tid < BN ? ks : vs) + srow), "r"(ts < t_end ? 4 : 0)
                   : "memory");
    }
    const int lc = tid % CPR, lr = tid / CPR;
    if (lc * 16 >= d) return;
    size_t off[BN / RPP];
#pragma unroll
    for (int i = 0; i < BN / RPP; ++i) {
      const int t = t0 + lr + i * RPP;
      off[i] = (t < t_end ? rows.row(t) : 0) * d + lc * 16;
    }
    int8_t* kc = codes(stage) + lc * 16;
    int8_t* vc = kc + BN * DP;
#pragma unroll
    for (int i = 0; i < BN / RPP; ++i) {
      const int j = lr + i * RPP;
      const bool ok = t0 + j < t_end;
      tc::cp_async16(kc + j * DP, k + off[i], ok);
      tc::cp_async16(vc + j * DP, v + off[i], ok);
    }
  }

  // The landed codes of `stage` into the f32 tile (exactly, unscaled),
  // synchronize, and return the K tile (V follows it, at BN * KS).
  __device__ __forceinline__ const float* ready(int stage) const {
    const int8_t* c = codes(stage);
    for (int e = threadIdx.x; e < 2 * BN * WPR; e += THREADS) {
      const int j = e / WPR, i = e - j * WPR;   // j: row of [K, V] stacked
      if (i * 4 >= d) continue;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(c + j * DP + i * 4);
      float* row = kv_s + (j < BN ? j * KS : BN * KS + (j - BN) * VS);
      *reinterpret_cast<float4*>(row + i * 4) =
          make_float4(float(int8_t(w)), float(int8_t(w >> 8)), float(int8_t(w >> 16)),
                      float(int8_t(w >> 24)));
    }
    __syncthreads();
    return kv_s;
  }
};

// c[i] += a * b[i] for the four fragments i < n with b exact in TF32 (a
// code): a_lo b, then a_hi b, one pass of each over the four.
__device__ __forceinline__ void mma2_x4(float (&c)[4][4], int n, const uint32_t (&a_hi)[4],
                                        const uint32_t (&a_lo)[4], const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) tf32::mma(c[i], a_lo, b[i][0], b[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) tf32::mma(c[i], a_hi, b[i][0], b[i][1]);
}

// Attend this block's 64 folded rows of sequence at.b, kv head at.kvh
// over the keys of split at.s that the tile loader reads through the page
// table.  q_s is the dynamic shared memory: the Q tile, then the loader's
// tiles.  S == 1 writes out; S > 1 writes the partials ws_acc
// [B, C, H, S, d] and ws_ml [B, C, H, S, 2] (m in natural-log units, l).
template <int DP, bool CAPPED, class Tiles>
__device__ __forceinline__ void attend(const Tiles& tiles, BlockTile at, float* q_s,
                                       const float* __restrict__ q, float* __restrict__ out,
                                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                                       int kv_len, int q_pos0, int C, int H, int KV, int d,
                                       int S, int L, float scale, int window, float softcap) {
  using namespace tf32;
  constexpr int KS = qk_stride<DP>();  // Q and K row stride, floats
  constexpr int VS = v_stride<DP>();   // V row stride, floats
  constexpr int BN = block_n<DP>();    // keys a tile
  constexpr int NJ = BN / 8;           // 8-key fragments a tile
  constexpr int KSTEPS = DP / 8;       // 8-wide steps of the head dim (a multiple of 4)
  constexpr int CPR = DP / 4;          // 16-byte chunks a padded row
  constexpr int RPP = THREADS / CPR;   // rows a pass of the block's copies

  const int G = H / KV;
  const int n_rows = C * G;
  const int b = at.b, kvh = at.kvh, r0 = at.r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vecs = d / 4;                         // 16-byte vectors a row
  const int ksteps = (d + 7) / 8;                 // 8-wide steps of d
  // row r's index in out [B, C, H] (and in the partials, times S)
  auto row_id = [&](int r) {
    const int c = r / G;
    return (size_t(b) * C + c) * H + kvh * G + (r - c * G);
  };
  // Last visible key + 1 of query position q_pos0 + c, in 64 bits.
  auto row_end = [&](int c) {
    return int(max(0LL, min((long long)kv_len, (long long)q_pos0 + c + 1)));
  };

  // keys any row of the block sees in this split, and keys every row sees
  const int sp_lo = at.s * L, sp_hi = sp_lo + L;
  const int c_lo = r0 / G, c_hi = (min(r0 + BLOCK_M, n_rows) - 1) / G;
  const int t_begin = max(tc::first_key(q_pos0 + c_lo, window), sp_lo);
  const int t_end = min(row_end(c_hi), sp_hi);
  const int all_lo = max(tc::first_key(q_pos0 + c_hi, window), sp_lo);
  const int all_hi = min(row_end(c_lo), sp_hi);

  // This thread's copies of Q: chunk lc of rows lr, lr + RPP, ...
  const int lc = tid % CPR, lr = tid / CPR;
  const bool copies = lc < vecs;

  if (t_begin >= t_end) {                        // no row sees a key here
    if (S == 1) {
      if (copies)
        for (int j = lr; j < BLOCK_M; j += RPP)
          if (r0 + j < n_rows)
            *reinterpret_cast<float4*>(out + row_id(r0 + j) * d + lc * 4) =
                make_float4(0, 0, 0, 0);
    } else {
      for (int j = tid; j < BLOCK_M; j += THREADS)
        if (r0 + j < n_rows) {
          float* ml = ws_ml + (row_id(r0 + j) * S + at.s) * 2;
          ml[0] = NEG_INF;
          ml[1] = 0.f;                           // an empty partial: the combine skips it
        }
    }
    return;
  }

  // Zero the half-step between d and 8 * ksteps in every row once: the
  // copies never write it, and Q·K^T reads it.
  if (vecs & 1) {
    for (int j = tid; j < BLOCK_M; j += THREADS)
      *reinterpret_cast<float4*>(q_s + j * KS + vecs * 4) = make_float4(0, 0, 0, 0);
    tiles.zero_tail(vecs);
  }
  if (copies) {
#pragma unroll
    for (int j = lr; j < BLOCK_M; j += RPP) {
      const bool ok = r0 + j < n_rows;
      tc::cp_async16(q_s + j * KS + lc * 4, ok ? q + row_id(r0 + j) * d + lc * 4 : q, ok);
    }
  }
  tc::cp_async_commit();
  tiles.issue(t_begin, t_end, 0);
  tc::cp_async_commit();

  // This thread's fragment coordinates: rows g and g + 8 of the warp's 16,
  // columns tq and tq + 4 of an A fragment (in Q·K^T dims 2 tq and
  // 2 tq + 1 of the step), 2 tq and 2 tq + 1 of an accumulator.  Each
  // row's visible keys, cut to the split.
  const int g = lane >> 2, tq = lane & 3, t2 = 2 * tq;
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (r0 + warp * 16 + g + 8 * h) / G;
    row_lo[h] = max(tc::first_key(q_pos0 + c, window), sp_lo);
    row_hi[h] = min(row_end(c), sp_hi);
  }
  const float s_mul = CAPPED ? scale / softcap : scale * LOG2E;
  const float cap_mul = softcap * LOG2E;
  const float* q_frag = q_s + (warp * 16 + g) * KS + t2;

  float o[KSTEPS][4];
#pragma unroll
  for (int n = 0; n < KSTEPS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_tiles = (t_end - t_begin + BN - 1) / BN;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * BN;
    if (it + 1 < n_tiles) {
      tiles.issue(t0 + BN, t_end, (it + 1) & 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                              // tile it (and Q) landed
    const float* ks = tiles.ready(it & 1);
    const float* vs = ks + BN * KS;

    // S = Q K^T: 16 rows x BN keys a warp.  Q's A fragment (rows g, g + 8;
    // dims 2 tq, 2 tq + 1 as columns tq, tq + 4) is split once a step and
    // serves every key fragment; K's B fragment is K[key g][dims 2 tq,
    // 2 tq + 1], 8 bytes a lane.
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < KSTEPS; k0 += CHAIN) {
      if (k0 >= ksteps) continue;
      float qk[NJ][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + CHAIN; ++kk) {
        if (kk >= ksteps) continue;
        uint32_t a_hi[4], a_lo[4];
        const float2 qa = *reinterpret_cast<const float2*>(q_frag + kk * 8);
        const float2 qb = *reinterpret_cast<const float2*>(q_frag + 8 * KS + kk * 8);
        split_fast(qa.x, a_hi[0], a_lo[0]);
        split_fast(qb.x, a_hi[1], a_lo[1]);
        split_fast(qa.y, a_hi[2], a_lo[2]);
        split_fast(qb.y, a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kb =
              *reinterpret_cast<const float2*>(ks + (8 * j + g) * KS + kk * 8 + t2);
          if constexpr (Tiles::CODES) {
            // a code is its own TF32 value: two products
            const uint32_t b0 = __float_as_uint(kb.x), b1 = __float_as_uint(kb.y);
            mma(qk[j], a_lo, b0, b1);
            mma(qk[j], a_hi, b0, b1);
          } else {
            uint32_t b_hi[2], b_lo[2];
            split_fast(kb.x, b_hi[0], b_lo[0]);
            split_fast(kb.y, b_hi[1], b_lo[1]);
            mma3(qk[j], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += qk[j][e];
    }
    if constexpr (Tiles::CODES) {                 // S_t = k_scale[t] (q . code_t)
      const float* ksc = tiles.scales(it & 1) + t2;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= ksc[8 * j + (e & 1)];
    }

    if (t0 >= all_lo && t0 + BN <= all_hi)
      softmax_tile<CAPPED, false>(s, o, m, l, s_mul, cap_mul, t0, t2, 0xffffffffu, row_lo,
                                  row_hi);
    else
      softmax_tile<CAPPED, true>(s, o, m, l, s_mul, cap_mul, t0, t2, 0xffffffffu, row_lo,
                                 row_hi);

    // O += P V, P (f32; int8 pages: times v_scale[t]) split per tile as the
    // A operand straight from S's accumulators: inside each 8-key
    // fragment, A column tq is key 2 tq and column tq + 4 is key 2 tq + 1,
    // so V's B fragment is V[keys 2 tq, 2 tq + 1][dim g].
    uint32_t p_hi[NJ][4], p_lo[NJ][4];
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      float p0 = s[kk][0], p1 = s[kk][1], p2 = s[kk][2], p3 = s[kk][3];
      if constexpr (Tiles::CODES) {
        const float* vsc = tiles.scales(it & 1) + BN + 8 * kk + t2;
        p0 *= vsc[0];
        p2 *= vsc[0];
        p1 *= vsc[1];
        p3 *= vsc[1];
      }
      split_fast(p0, p_hi[kk][0], p_lo[kk][0]);
      split_fast(p2, p_hi[kk][1], p_lo[kk][1]);
      split_fast(p1, p_hi[kk][2], p_lo[kk][2]);
      split_fast(p3, p_hi[kk][3], p_lo[kk][3]);
    }
    // Four output fragments at a time, each pass over all four, so no
    // mma.sync waits on the one before it; every CHAIN key fragments sum
    // in fresh accumulators, added to O by the CUDA cores.
#pragma unroll
    for (int n0 = 0; n0 < KSTEPS; n0 += 4) {
      if (n0 >= ksteps) continue;
#pragma unroll
      for (int c0 = 0; c0 < NJ; c0 += CHAIN) {
        float pv[4][4] = {};
#pragma unroll
        for (int kk = c0; kk < c0 + CHAIN && kk < NJ; ++kk) {
          const float* vb = vs + (8 * kk + t2) * VS + n0 * 8 + g;
          if constexpr (Tiles::CODES) {
            uint32_t b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (n0 + i >= ksteps) continue;
              b[i][0] = __float_as_uint(vb[i * 8]);
              b[i][1] = __float_as_uint(vb[VS + i * 8]);
            }
            mma2_x4(pv, ksteps - n0, p_hi[kk], p_lo[kk], b);
          } else {
            uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (n0 + i >= ksteps) continue;
              split_fast(vb[i * 8], b_hi[i][0], b_lo[i][0]);
              split_fast(vb[VS + i * 8], b_hi[i][1], b_lo[i][1]);
            }
            mma3_x4(pv, ksteps - n0, p_hi[kk], p_lo[kk], b_hi, b_lo);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + i][e] += pv[i][e];
      }
    }
    __syncthreads();                              // stage it & 1 free again
  }

  // Each row's sum over its 4 threads; then two floats (dims 8 n + 2 tq,
  // + 1) of rows g, g + 8 a fragment: each row's 4 threads write 32
  // contiguous bytes, normalized into out or as a partial.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r >= n_rows) continue;
    float* row;
    float denom;
    if (S == 1) {
      row = out + row_id(r) * d + t2;
      denom = fmaxf(l[h], 1e-30f);
    } else {
      const size_t slot = row_id(r) * S + at.s;
      row = ws_acc + slot * d + t2;
      denom = 1.f;
      if (tq == 0) {
        ws_ml[slot * 2] = m[h] * LN2;             // the combine takes m in natural-log units
        ws_ml[slot * 2 + 1] = l[h];
      }
    }
#pragma unroll
    for (int n = 0; n < KSTEPS; ++n)
      if (n < ksteps && 8 * n + t2 < d)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

// A split must be whole pages and cover the table's Pmax * ps keys;
// S > 1 needs the workspace.
inline bool bad_split(int ps, int Pmax, int S, int L, const void* ws_acc,
                      const void* ws_ml) {
  return S < 1 || ps < 1 || L < ps || L % ps || (long long)S * L < (long long)Pmax * ps ||
         (long long)S * L > 0x7fffffffLL || (S > 1 && (ws_acc == nullptr || ws_ml == nullptr));
}

// Launch a chunk kernel on the 1-D grid of attend's block order, after
// raising its dynamic shared-memory limit, and, when S > 1, the combine
// on grid (H, B C); returns cudaGetLastError() after the last launch (or
// the first error).
template <typename Kernel, typename Combine, typename... Args>
int launch(Kernel kernel, Combine comb, size_t smem, int B, int C, int H, int KV, int d,
           int S, const float* ws_acc, const float* ws_ml, float* out, void* stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = C * (H / KV);
  const unsigned grid = unsigned((rows + BLOCK_M - 1) / BLOCK_M) * KV * B * S;
  kernel<<<grid, THREADS, smem, st>>>(args...);
  if (S == 1) return int(cudaGetLastError());
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  comb<<<dim3(H, B * C), pdec::COMBINE_THREADS, 0, st>>>(ws_acc, ws_ml, out, d, S);
  return int(cudaGetLastError());
}

// Resident blocks an SM of `kernel` at `smem` bytes of dynamic shared
// memory (cudaOccupancy...), or -1 on a CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)) !=
          cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace paged_f32
