// The paged tensor-core tile loop of K1 (paged_attention.cu) and K3
// (paged_attention_int8.cu) for bf16 chunks (C > 1): K2's tile recipe
// (flash_attention.cu, helpers in tc_common.cuh) read through a page
// table.  Decode (C = 1) runs paged_decode.cuh, f32 chunks
// paged_tiles_f32.cuh.
//
// What it computes is the Pallas kernels' function: folded row
// r = c * G + g is query position q_pos[b] + c of head kvh * G + g; it sees
// keys t < kv_len = min(kv_lens[b], Pmax * ps) with t <= q_pos[b] + c and,
// under a window, t > q_pos[b] + c - window; optional tanh softcap; a row
// with no visible key writes 0.
//
// Design, for both page types:
//   - One block of 4 warps per (64 folded query rows, kv head, sequence)
//     on a 1-D grid that launches the tiles with the most keys first.
//     Each key tile is read once for 64 rows.
//   - The block's key range is the union of its rows' causal and window
//     ranges; only pages below ceil(kv_len / ps) are looked up, and page
//     ids are clamped into the pool.  Tiles of 64 keys start at the range's
//     first key, which need not be page-aligned: each key row is copied from
//     its own address, ((clamp(table[t / ps]) * ps + t % ps) * KV + kvh) * d,
//     so one tile spans up to 5 pages at ps = 16 and 17 at ps = 4.  Rows past
//     the range are zero-filled (cp.async source size 0) and masked.
//   - Q·K^T and P·V are mma.sync.m16n8k16 products from ldmatrix fragments
//     (.trans for V), Q in registers, online softmax in f32 with exp2, P
//     rounded to bf16, one normalization by max(l, 1e-30).  Masked and
//     unmasked tile bodies are chosen per tile; softcap is a compile-time
//     instantiation.  The head dim is padded to DP in {32, 64, 128, 256}
//     and the half-step past d is zeroed once.
// The two page types differ only in the tile loader:
//   - FpTiles (K1): bf16 rows straight into two stages of K/V tiles by
//     16-byte cp.async; (64 + 4 * 64) rows of DP + 8 in shared memory,
//     87,040 bytes at DP = 128.
//   - Q8Tiles (K3): cp.async cannot convert, so two stages of raw int8 codes
//     and their f32 scales are staged by cp.async, and after each wait a
//     conversion pass writes code * scale (f32, rounded to bf16) into one
//     pair of bf16 K/V tiles that the products read: 86,016 bytes at
//     DP = 128.  Both stay at two blocks an SM up to DP = 128.
#pragma once

#include "attention_common.cuh"
#include "tc_common.cuh"

namespace paged_tc {

using tc::bf16;
using tc::BLOCK_M;
using tc::BLOCK_N;
using tc::THREADS;

// This block's (sequence, kv head, first folded row).  Block x =
// (n_qtiles - 1 - tile) * KV * B + b * KV + kvh, so the last row tiles
// (most keys) of every (sequence, kv head) are launched first.
struct BlockTile {
  int b, kvh, r0;
};

__device__ __forceinline__ BlockTile block_tile(int n_rows, int KV) {
  const int n_qtiles = (n_rows + BLOCK_M - 1) / BLOCK_M;
  const int pairs = gridDim.x / n_qtiles, pair = blockIdx.x % pairs;
  const int b = pair / KV;
  return {b, pair - b * KV, (n_qtiles - 1 - int(blockIdx.x) / pairs) * BLOCK_M};
}

// Shared memory of the Q tile, in bytes; the loader's tiles follow it.
template <int DP>
__host__ __device__ constexpr size_t q_bytes() {
  return sizeof(bf16) * size_t(BLOCK_M) * (DP + 8);
}

// bf16 K/V pages: two stages of [K, V][BLOCK_N][DP + 8].
template <int DP>
struct FpTiles {
  static constexpr int S = DP + 8;
  static constexpr int CPR = DP / 8;            // 16-byte chunks a padded row
  static constexpr int RPP = THREADS / CPR;     // rows a pass of the block's copies
  static constexpr size_t bytes = sizeof(bf16) * size_t(4 * BLOCK_N) * S;

  const bf16* k;
  const bf16* v;
  attn::PageRows rows;
  int d;
  bf16* kv_s;

  // Zero the half-step between d and 16 * ceil(d / 16) in every row once.
  __device__ __forceinline__ void zero_tail(int vecs) const {
    for (int j = threadIdx.x; j < 4 * BLOCK_N; j += THREADS)
      *reinterpret_cast<uint4*>(kv_s + j * S + vecs * 8) = make_uint4(0, 0, 0, 0);
  }

  // Start the copies of keys [t0, t0 + BLOCK_N) into `stage`; rows at or
  // past t_end are zero-filled.
  // Every row is looked up before the first copy, so the table loads are
  // in flight together.
  __device__ __forceinline__ void issue(int t0, int t_end, int stage) const {
    const int lc = threadIdx.x % CPR, lr = threadIdx.x / CPR;
    if (lc * 8 >= d) return;
    size_t off[BLOCK_N / RPP];
#pragma unroll
    for (int i = 0; i < BLOCK_N / RPP; ++i) {
      const int t = t0 + lr + i * RPP;
      off[i] = (t < t_end ? rows.row(t) : 0) * d + lc * 8;
    }
    bf16* ks = kv_s + 2 * stage * BLOCK_N * S + lc * 8;
    bf16* vs = ks + BLOCK_N * S;
#pragma unroll
    for (int i = 0; i < BLOCK_N / RPP; ++i) {
      const int j = lr + i * RPP;
      const bool ok = t0 + j < t_end;
      tc::cp_async16(ks + j * S, k + off[i], ok);
      tc::cp_async16(vs + j * S, v + off[i], ok);
    }
  }

  // The K tile of `stage` (V follows it), once its copies have landed and
  // the block has synchronized.
  __device__ __forceinline__ const bf16* ready(int stage) const {
    return kv_s + 2 * stage * BLOCK_N * S;
  }
};

// int8 code pages with an f32 scale per (token, head): bf16 tiles
// [K, V][BLOCK_N][DP + 8], then two stages of codes [K, V][BLOCK_N][DP]
// and of scales [K, V][BLOCK_N].  d % 16 == 0, so no half-step.
template <int DP>
struct Q8Tiles {
  static constexpr int S = DP + 8;
  static constexpr int CPR = DP / 16;           // 16-byte code chunks a row
  static constexpr int RPP = THREADS / CPR;
  static constexpr int CVT = DP / 8;            // 8-code conversion steps a row
  static constexpr size_t tile_bytes = sizeof(bf16) * size_t(2 * BLOCK_N) * S;
  static constexpr size_t code_bytes = size_t(2 * BLOCK_N) * DP;     // a stage
  static constexpr size_t bytes =
      tile_bytes + 2 * code_bytes + sizeof(float) * size_t(4 * BLOCK_N);
  static_assert(THREADS == 2 * BLOCK_N, "one thread a scale");

  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  attn::PageRows rows;
  int d;
  bf16* kv_s;

  __device__ __forceinline__ int8_t* codes(int stage) const {
    return reinterpret_cast<int8_t*>(reinterpret_cast<unsigned char*>(kv_s) + tile_bytes +
                                     stage * code_bytes);
  }
  __device__ __forceinline__ float* scales(int stage) const {
    return reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kv_s) + tile_bytes +
                                    2 * code_bytes) + stage * 2 * BLOCK_N;
  }

  __device__ __forceinline__ void zero_tail(int) const {}

  // Every row is looked up before the first copy, as in FpTiles.
  __device__ __forceinline__ void issue(int t0, int t_end, int stage) const {
    const int tid = threadIdx.x;
    const int lc = tid % CPR, lr = tid / CPR;
    const bool codes_here = lc * 16 < d;
    // one scale a thread: K's for rows 0-63, V's for rows 64-127
    const int ts = t0 + tid % BLOCK_N;
    const size_t srow = ts < t_end ? rows.row(ts) : 0;
    size_t off[BLOCK_N / RPP];
#pragma unroll
    for (int i = 0; i < BLOCK_N / RPP; ++i) {
      const int t = t0 + lr + i * RPP;
      off[i] = (codes_here && t < t_end ? rows.row(t) : 0) * d + lc * 16;
    }
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     tc::smem_u32(scales(stage) + tid)),
                 "l"((tid < BLOCK_N ? ks : vs) + srow), "r"(ts < t_end ? 4 : 0)
                 : "memory");
    if (!codes_here) return;
    int8_t* kc = codes(stage) + lc * 16;
    int8_t* vc = kc + BLOCK_N * DP;
#pragma unroll
    for (int i = 0; i < BLOCK_N / RPP; ++i) {
      const int j = lr + i * RPP;
      const bool ok = t0 + j < t_end;
      tc::cp_async16(kc + j * DP, k + off[i], ok);
      tc::cp_async16(vc + j * DP, v + off[i], ok);
    }
  }

  // Dequantize the landed codes of `stage` into the bf16 tiles (code *
  // scale in f32, rounded once), synchronize, and return the K tile.
  __device__ __forceinline__ const bf16* ready(int stage) const {
    const int8_t* c = codes(stage);
    const float* s = scales(stage);
#pragma unroll
    for (int e = threadIdx.x; e < 2 * BLOCK_N * CVT; e += THREADS) {
      const int i = e % CVT, j = e / CVT;       // j: row of [K, V] stacked
      if (i * 8 >= d) continue;
      const uint2 raw = *reinterpret_cast<const uint2*>(c + j * DP + i * 8);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      const float sc = s[j];
      uint4 w;
      w.x = tc::pack_bf16(float(x[0]) * sc, float(x[1]) * sc);
      w.y = tc::pack_bf16(float(x[2]) * sc, float(x[3]) * sc);
      w.z = tc::pack_bf16(float(x[4]) * sc, float(x[5]) * sc);
      w.w = tc::pack_bf16(float(x[6]) * sc, float(x[7]) * sc);
      *reinterpret_cast<uint4*>(kv_s + j * S + i * 8) = w;
    }
    __syncthreads();
    return kv_s;
  }
};

// Attend this block's 64 folded rows of sequence at.b, kv head at.kvh over
// the keys the tile loader reads through the page table.  q_s is the
// dynamic shared memory: the Q tile, then the loader's tiles.
template <int DP, bool CAPPED, class Tiles>
__device__ __forceinline__ void attend(const Tiles& tiles, BlockTile at, bf16* q_s,
                                       const bf16* __restrict__ q, bf16* __restrict__ out,
                                       int kv_len, int q_pos0, int C, int H, int KV, int d,
                                       float scale, int window, float softcap) {
  using namespace tc;
  constexpr int S = DP + 8;            // shared row stride, elements
  constexpr int KSTEPS = DP / 16;
  constexpr int CPR = DP / 8;          // 16-byte chunks a padded row
  constexpr int RPP = THREADS / CPR;   // rows a pass of the block's copies

  const int G = H / KV;
  const int n_rows = C * G;
  const int b = at.b, kvh = at.kvh, r0 = at.r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vecs = d / 8;                         // 16-byte vectors a row
  const int ksteps = (d + 15) / 16;               // 16-wide steps of d
  auto q_off = [&](int r) {
    const int c = r / G;
    return ((size_t(b) * C + c) * H + kvh * G + (r - c * G)) * size_t(d);
  };
  // Last visible key + 1 of query position q_pos0 + c, in 64 bits.
  auto row_end = [&](int c) {
    return int(max(0LL, min((long long)kv_len, (long long)q_pos0 + c + 1)));
  };

  // keys any row of the block sees, and keys every row sees
  const int c_lo = r0 / G, c_hi = (min(r0 + BLOCK_M, n_rows) - 1) / G;
  const int t_begin = first_key(q_pos0 + c_lo, window);
  const int t_end = row_end(c_hi);
  const int all_lo = first_key(q_pos0 + c_hi, window);
  const int all_hi = row_end(c_lo);

  // This thread's copies of Q: chunk lc of rows lr, lr + RPP, ...
  const int lc = tid % CPR, lr = tid / CPR;
  const bool copies = lc < vecs;

  if (t_begin >= t_end) {                        // no row sees a key
    if (copies)
      for (int j = lr; j < BLOCK_M; j += RPP)
        if (r0 + j < n_rows)
          *reinterpret_cast<uint4*>(out + q_off(r0 + j) + lc * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  if (vecs & 1) {
    for (int j = tid; j < BLOCK_M; j += THREADS)
      *reinterpret_cast<uint4*>(q_s + j * S + vecs * 8) = make_uint4(0, 0, 0, 0);
    tiles.zero_tail(vecs);
  }
  if (copies) {
#pragma unroll
    for (int j = lr; j < BLOCK_M; j += RPP) {
      const bool ok = r0 + j < n_rows;
      cp_async16(q_s + j * S + lc * 8, ok ? q + q_off(r0 + j) + lc * 8 : q, ok);
    }
  }
  cp_async_commit();
  tiles.issue(t_begin, t_end, 0);
  cp_async_commit();

  // This thread's two rows of the warp's 16: g and g + 8.
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (r0 + warp * 16 + g + 8 * h) / G;
    row_lo[h] = first_key(q_pos0 + c, window);
    row_hi[h] = row_end(c);
  }
  const float s_mul = CAPPED ? scale / softcap : scale * LOG2E;
  const float cap_mul = softcap * LOG2E;

  // The warp's Q rows into registers once, while K/V tile 0 is in flight.
  uint32_t qf[KSTEPS][4];
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    if (kk < ksteps)
      ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_tiles = (t_end - t_begin + BLOCK_N - 1) / BLOCK_N;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * BLOCK_N;
    if (it + 1 < n_tiles) {
      tiles.issue(t0 + BLOCK_N, t_end, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                              // tile it landed
    const bf16* ks = tiles.ready(it & 1);
    const bf16* vs = ks + BLOCK_N * S;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk >= ksteps) continue;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * S + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    if (t0 >= all_lo && t0 + BLOCK_N <= all_hi)
      softmax_tile<CAPPED, false>(s, o, m, l, s_mul, cap_mul, t0, t2, row_lo, row_hi);
    else
      softmax_tile<CAPPED, true>(s, o, m, l, s_mul, cap_mul, t0, t2, row_lo, row_hi);

    // O += P V: P (bf16) as the A operand straight from S's fragments
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int np = 0; np < KSTEPS; ++np) {
      if (np >= ksteps) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + np * 16 +
                              (lane >> 4) * 8);
        mma(o[2 * np], pf[kk], vb[0], vb[1]);
        mma(o[2 * np + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();                              // stage it & 1 free again
  }

  // Normalize, round once, stage in this warp's own Q rows, store 16 bytes
  // at a time.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    bf16* row = q_s + (warp * 16 + g + 8 * h) * S + t2;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n < vecs)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
  __syncwarp();
  constexpr int WPP = 32 / CPR;                  // rows a pass of the warp's stores
  const int sc = lane % CPR;
  if (sc < vecs) {
    for (int j = lane / CPR; j < 16; j += WPP) {
      const int r = r0 + warp * 16 + j;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + q_off(r) + sc * 8) =
            *reinterpret_cast<const uint4*>(q_s + (warp * 16 + j) * S + sc * 8);
    }
  }
}

// Launch a paged tile kernel on the 1-D grid of attend's block order, after
// raising its dynamic shared-memory limit; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int B, int C, int H, int KV, void* stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int rows = C * (H / KV);
  const unsigned grid = unsigned((rows + BLOCK_M - 1) / BLOCK_M) * KV * B;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace paged_tc
