// K2: flash attention, forward, for Hopper (sm_90a) — the monolithic
// prompt prefill of `sequential` serving and of the zamba2 hybrid's
// shared attention, and (f32, with its log-normalizer) every attention
// forward of a training step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`).  It computes the same function:
// online softmax in f32 with the G query heads of a kv head folded into
// rows (row r = c * G + g is query position c of head kvh * G + g), masks
// kv_pos < kv_lens[b], causal kv_pos <= q_pos, an optional window and tanh
// softcap; query and key positions are their indices.  Tiles wholly above
// the diagonal or outside the window are skipped, as the Pallas grid skips
// those blocks.  A row with no visible key writes zeros, never NaN.
//
// What bounds it on an H100: a causal prompt does ~2 T^2 d H flops over
// ~2 (T H + Tk KV) d elements of q/k/v/o.  At qwen3's prefill (B=4,
// T=1024, H=16, KV=8, d=128, bf16) that is operations: 17.2 GFLOP at
// 989 TFLOP/s, 0.0174 ms.  At the hybrid's (B=8, T=1024, 32 heads of 112,
// G=1) it is bytes: 235 MB at 3.35 TB/s, 0.0701 ms.  In f32 every product
// is three TF32 ones (below) at the tensor cores' 494.7 TFLOP/s: qwen3's
// training shape (B=4, T=512) is 4.3 GFLOP, 0.026 ms; the hybrid's (B=4,
// T=1024, d=112) 0.18 ms.
//
// Both dtypes share the geometry:
//   - One block of 4 warps per (tile of 64 folded query rows, kv head,
//     batch row); each warp owns 16 rows.  The grid is one-dimensional
//     and launches the last tiles (most keys under the causal mask) of
//     every (batch row, kv head) first, so the short tiles fill the end
//     of the grid.  A 64-row tile reads each key tile once for 64 rows,
//     16 times fewer K/V bytes than 4-row blocks.
//   - The key range is clipped to the union of the block's rows' causal
//     and window ranges; S is scaled in f32 (log2 e folded in, exp2 by
//     ex2.approx), soft-capped (a separate instantiation, so calls without
//     a softcap pay no tanh) and masked per element only on tiles some row
//     does not see whole.  Row sums l stay in f32.
//   - K/V tiles move to shared memory by 16-byte cp.async,
//     double-buffered: tile i + 1 is in flight while tile i is multiplied.
//     Key rows past the block's key range are zero-filled by the copy
//     (source size 0) and masked, so stale shared memory never meets
//     P = 0.
//   - The head dim is padded to DP in {32, 64, 128, 256} (112 runs at 128),
//     the products walk only the steps of it that d reaches, and a
//     half-step past d is zero-filled once.
//   - The output is normalized by max(l, 1e-30) in f32.
//
// bf16 (flash_attention_kernel_tc):
//   - Q·K^T and P·V are mma.sync.m16n8k16 products, bf16 in, f32
//     accumulators, fragments loaded from shared memory by ldmatrix
//     (.trans for V).  The Q tile stays in registers for the whole key
//     loop.  P is rounded to bf16 for its product, as SDPA does.
//   - With 16 rows a warp, every mma.sync needs 256 bytes of ldmatrix
//     traffic, so shared-memory bandwidth and the mma.sync rate bound the
//     product phases together; wgmma (64 rows a warpgroup, B read once
//     from shared memory) is the step past that.
//   - Key tiles of 64; rows are padded by 16 bytes, so the 8 rows one
//     ldmatrix reads fall in 8 different bank groups.  Dynamic shared
//     memory is (64 + 4 * 64) rows of DP + 8: 85 KB at DP = 128, two
//     blocks an SM.
//   - The output is rounded once, staged in the warp's own rows of the Q
//     tile and stored in 16-byte vectors.
//
// f32 (flash_attention_kernel_f32, helpers in tf32_common.cuh): the same
// tiles on the tensor cores in 3xTF32, so results stay f32-grade (~2^-21
// a product; one TF32 pass would miss the 1e-4 the card-vs-CPU checks
// hold).
//   - Both products are mma.sync.m16n8k8.tf32 with f32 accumulators.  Each
//     operand x is split into hi = tf32(x) and lo = tf32(x - hi), both by
//     cvt.rna (the tensor cores ignore the low 13 bits of a word), and a
//     product is a_lo b_hi + a_hi b_lo, then a_hi b_hi.  Q's A fragment is
//     split once an 8-wide step and serves every key fragment; K and V are
//     split as their fragments are loaded; P stays f32 and is split per
//     tile.  P·V runs four output fragments a pass, so no mma.sync waits
//     on the one before it.
//   - mma.sync rounds its f32 sums less finely than an FADD (on the card
//     o's error grew with the row's length, 8.7e-6 at 1024 keys), so an
//     accumulator takes at most CHAIN = 4 steps (32 dims of Q·K^T, 32
//     keys of P·V) before the CUDA cores add it to S or O: 2-4e-6 at the
//     main paths' shapes (2 and 1 steps were slower and no closer).
//   - P is the A operand without shuffles: an accumulator holds keys 2t
//     and 2t + 1 (t = lane % 4) where the A fragment wants columns t and
//     t + 4, so inside each 8-key fragment column t is key 2t and column
//     t + 4 key 2t + 1, and V's B fragment is read as V[key 2t | 2t + 1]
//     [dim g] (g = lane / 4).  K's B fragment is K[key g][dim t | t + 4].
//   - Shared rows are DP + 4 floats, so each of those fragment loads (and
//     Q's) reads 32 distinct banks.  Q stays in shared memory in f32 (its
//     hi and lo fragments would take 128 registers a thread at DP = 128).
//     Key tiles are 64 keys at DP <= 64 (87,040 B at DP = 64) and 32 keys
//     above (101,376 B at DP = 128, two blocks an SM, where 64-key tiles
//     would leave one and ran 1.8x slower on the card; 199,680 B at
//     DP = 256).  __launch_bounds__ asks for the blocks the shared memory
//     allows, so ptxas does not spill to reach more.
//   - A forward-only call of at most 16 folded rows (T = 1
//     cross-attention) runs the SPLIT instantiation: every warp takes the
//     same 16 rows and a quarter of each key tile's 8-key fragments, and
//     warp 0 merges the four partial softmaxes through shared memory at
//     the end.
//   - Each row's 4 threads store their two floats a fragment, 32
//     contiguous bytes.
//
// The training forward (flash_attention_lse_{f32,bf16}) is the same code
// with a compile-time flag (LSE) that also writes each folded row's
// log-normalizer, lse [B, KV, G, T_q] f32 = m + log(max(l, 1e-30)) in the
// capped-logit scale (both kernels keep m in log2 units: m ln 2); a row
// that sees no key writes -1e30.  The recompute backward
// (models/layers.py::flash_attention_ckpt) reads it.  The forward-only
// entry points instantiate the kernels without the flag, as before.
//
// Layouts (the model's): q, out [B, T, H, d]; k, v [B, Tk, KV, d];
// kv_lens [B] int32.
#include "tc_common.cuh"
#include "tf32_common.cuh"

namespace {

// -------------------------------------------- f32, 3xTF32 tensor cores ---
// tf32:: helpers (the split, mma.sync.m16n8k8, the softmax step at any
// tile width) are in tf32_common.cuh.

template <int DP, bool CAPPED, bool LSE, bool SPLIT>
__global__ void __launch_bounds__(tf32::THREADS, tf32::min_blocks<DP>())
flash_attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ kv_lens,
                           float* __restrict__ out, int T_q, int Tk, int H, int KV, int d,
                           float scale, int causal, int window, float softcap,
                           float* __restrict__ lse) {
  using namespace tf32;
  constexpr int S = DP + 4;            // shared row stride, floats
  constexpr int BN = block_n<DP>();    // keys a tile
  constexpr int NJ = BN / 8;           // 8-key fragments a tile
  constexpr int KSTEPS = DP / 8;       // 8-wide steps of the head dim (a multiple of 4)
  constexpr int CPR = DP / 4;          // 16-byte chunks a padded row
  constexpr int RPP = THREADS / CPR;   // rows a pass of the block's copies
  // 8-wide steps a tensor-core accumulator sums before the CUDA cores add
  // it to S or O: mma.sync rounds its f32 sums less finely than an FADD,
  // so a chain over a whole row (P·V over every key tile) would carry
  // that error the row's length.  Short chains are also independent
  // products for the tensor cores.
  constexpr int CHAIN = 4;
  extern __shared__ __align__(16) float smem_f32[];
  float* q_s = smem_f32;               // [BLOCK_M][S]
  float* kv_s = q_s + BLOCK_M * S;     // [2 stages][K, V][BN][S]

  const int G = H / KV;
  const int n_rows = T_q * G;
  // Block x = (n_qtiles - 1 - tile) * KV * B + b * KV + kvh: the tiles with
  // the most keys, of every (batch row, kv head), are launched first.
  const int n_qtiles = (n_rows + BLOCK_M - 1) / BLOCK_M;
  const int pairs = gridDim.x / n_qtiles, pair = blockIdx.x % pairs;
  const int b = pair / KV, kvh = pair - b * KV;
  const int r0 = (n_qtiles - 1 - blockIdx.x / pairs) * BLOCK_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vecs = d / 4;                         // 16-byte vectors a row
  const int ksteps = (d + 7) / 8;                 // 8-wide steps of d
  const int kv_len = max(0, min(kv_lens[b], Tk));
  auto q_off = [&](int r) {
    const int c = r / G;
    return ((size_t(b) * T_q + c) * H + kvh * G + (r - c * G)) * size_t(d);
  };
  // row r's log-normalizer slot in lse [B, KV, G, T_q]
  auto lse_off = [&](int r) {
    const int c = r / G;
    return ((size_t(b) * KV + kvh) * G + (r - c * G)) * size_t(T_q) + c;
  };

  // keys any row of the block sees, and keys every row sees
  const int c_lo = r0 / G, c_hi = (min(r0 + BLOCK_M, n_rows) - 1) / G;
  const int t_begin = tc::first_key(c_lo, window);
  const int t_end = causal ? min(kv_len, c_hi + 1) : kv_len;
  const int all_lo = tc::first_key(c_hi, window);
  const int all_hi = causal ? min(kv_len, c_lo + 1) : kv_len;

  // This thread's copies: chunk lc of rows lr, lr + RPP, ...
  const int lc = tid % CPR, lr = tid / CPR;
  const bool copies = lc < vecs;

  if (t_begin >= t_end) {                        // no row sees a key
    if (copies)
      for (int j = lr; j < BLOCK_M; j += RPP)
        if (r0 + j < n_rows)
          *reinterpret_cast<float4*>(out + q_off(r0 + j) + lc * 4) = make_float4(0, 0, 0, 0);
    if constexpr (LSE) {
      if (tid < BLOCK_M && r0 + tid < n_rows) lse[lse_off(r0 + tid)] = NEG_INF;
    }
    return;
  }

  // Zero the half-step between d and 8 * ksteps in every row once: the
  // copies never write it, and Q·K^T reads it.
  if (vecs & 1) {
    for (int j = tid; j < BLOCK_M + 4 * BN; j += THREADS)
      *reinterpret_cast<float4*>(q_s + j * S + vecs * 4) = make_float4(0, 0, 0, 0);
  }
  if (copies) {
#pragma unroll
    for (int j = lr; j < BLOCK_M; j += RPP) {
      const bool ok = r0 + j < n_rows;
      tc::cp_async16(q_s + j * S + lc * 4, ok ? q + q_off(r0 + j) + lc * 4 : q, ok);
    }
  }
  tc::cp_async_commit();
  const size_t kv_row = size_t(KV) * d;           // elements between keys
  const size_t kv_base = (size_t(b) * Tk * KV + kvh) * d + lc * 4;
  auto load_kv = [&](int t0, int stage) {
    float* ks = kv_s + 2 * stage * BN * S + lc * 4;
    float* vs = ks + BN * S;
    if (!copies) return;
#pragma unroll
    for (int j = lr; j < BN; j += RPP) {
      const int t = t0 + j;
      const bool ok = t < t_end;
      const size_t off = kv_base + size_t(ok ? t : 0) * kv_row;
      tc::cp_async16(ks + j * S, k + off, ok);
      tc::cp_async16(vs + j * S, v + off, ok);
    }
  };
  load_kv(t_begin, 0);
  tc::cp_async_commit();

  // SPLIT (a forward-only call of at most 16 folded rows, as T = 1
  // cross-attention makes): each key tile is split across the warps
  // instead of the rows.  Every warp takes the block's first 16 rows and
  // the 8-key fragments j with j % 4 == warp, and warp 0 merges the four
  // partial softmaxes at the end; otherwise three warps of four would
  // multiply rows no one reads.  A compile-time flag, so the row-split
  // loop has no such tests.
  const int wrow = SPLIT ? 0 : warp * 16;         // the warp's first row in the block
  const unsigned own = SPLIT ? 0x11u << warp : 0xffu;   // its fragments, a bit each

  // This thread's fragment coordinates: rows g and g + 8 of the warp's 16,
  // columns tq and tq + 4 of an A fragment, 2 tq and 2 tq + 1 of an
  // accumulator.
  const int g = lane >> 2, tq = lane & 3, t2 = 2 * tq;
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (r0 + wrow + g + 8 * h) / G;
    row_lo[h] = tc::first_key(c, window);
    row_hi[h] = causal ? min(kv_len, c + 1) : kv_len;
  }
  const float s_mul = CAPPED ? scale / softcap : scale * LOG2E;
  const float cap_mul = softcap * LOG2E;
  const float* q_frag = q_s + (wrow + g) * S + tq;

  float o[KSTEPS][4];
#pragma unroll
  for (int n = 0; n < KSTEPS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_tiles = (t_end - t_begin + BN - 1) / BN;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * BN;
    if (it + 1 < n_tiles) {
      load_kv(t0 + BN, (it + 1) & 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();                              // tile it (and Q) landed
    const float* ks = kv_s + 2 * (it & 1) * BN * S;
    const float* vs = ks + BN * S;

    // S = Q K^T: 16 rows x BN keys a warp.  Q's A fragment (rows g, g + 8;
    // dims tq, tq + 4) is split once a step and serves every key fragment;
    // K's B fragment is K[key g][dims tq, tq + 4].
    // Every CHAIN 8-wide steps sum in fresh accumulators, added to S by
    // the CUDA cores (see CHAIN).
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
        const float* qa = q_frag + kk * 8;
        split(qa[0], a_hi[0], a_lo[0]);
        split(qa[8 * S], a_hi[1], a_lo[1]);
        split(qa[4], a_hi[2], a_lo[2]);
        split(qa[8 * S + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (SPLIT && !(own >> j & 1)) continue;
          const float* kb = ks + (8 * j + g) * S + kk * 8 + tq;
          uint32_t b_hi[2], b_lo[2];
          split(kb[0], b_hi[0], b_lo[0]);
          split(kb[4], b_hi[1], b_lo[1]);
          mma3(qk[j], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += qk[j][e];
    }

    if (!SPLIT && t0 >= all_lo && t0 + BN <= all_hi)
      softmax_tile<CAPPED, false>(s, o, m, l, s_mul, cap_mul, t0, t2, own, row_lo, row_hi);
    else
      softmax_tile<CAPPED, true>(s, o, m, l, s_mul, cap_mul, t0, t2, own, row_lo, row_hi);

    // O += P V, P (f32, split per tile) as the A operand straight from S's
    // accumulators: inside each 8-key fragment, A column tq is key 2 tq and
    // column tq + 4 is key 2 tq + 1, so V's B fragment is
    // V[keys 2 tq, 2 tq + 1][dim g].
    uint32_t p_hi[NJ][4], p_lo[NJ][4];
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      split(s[kk][0], p_hi[kk][0], p_lo[kk][0]);
      split(s[kk][2], p_hi[kk][1], p_lo[kk][1]);
      split(s[kk][1], p_hi[kk][2], p_lo[kk][2]);
      split(s[kk][3], p_hi[kk][3], p_lo[kk][3]);
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
          if (SPLIT && !(own >> kk & 1)) continue;
          const float* vb = vs + (8 * kk + t2) * S + n0 * 8 + g;
          uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (n0 + i >= ksteps) continue;
            split(vb[i * 8], b_hi[i][0], b_lo[i][0]);
            split(vb[S + i * 8], b_hi[i][1], b_lo[i][1]);
          }
          mma3_x4(pv, ksteps - n0, p_hi[kk], p_lo[kk], b_hi, b_lo);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + i][e] += pv[i][e];
      }
    }
    __syncthreads();                              // stage it & 1 free again
  }

  // Each row's sum over its 4 threads.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if constexpr (SPLIT) {
    // Every warp's m, l and O into the free K/V tiles ([warp][row] m and
    // l after [warp][row][DP + 4] O), then warp 0 rescales each to the
    // rows' common max and sums them.
    float* part_o = kv_s + warp * 16 * S;
    float* part_ml = kv_s + WARPS * 16 * S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (tq == 0) {
        part_ml[2 * (warp * 16 + row)] = m[h];
        part_ml[2 * (warp * 16 + row) + 1] = l[h];
      }
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n)
        if (n < ksteps)
          *reinterpret_cast<float2*>(part_o + row * S + 8 * n + t2) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, part_ml[2 * (w * 16 + row)]);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n) o[n][2 * h] = o[n][2 * h + 1] = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        // rows no warp saw keep mx = -1e30 and add 0 * 1
        const float corr = tc::ex2(part_ml[2 * (w * 16 + row)] - mx);
        sum += part_ml[2 * (w * 16 + row) + 1] * corr;
        const float* po = kv_s + (w * 16 + row) * S + t2;
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n) {
          if (n >= ksteps) continue;
          o[n][2 * h] += po[8 * n] * corr;
          o[n][2 * h + 1] += po[8 * n + 1] * corr;
        }
      }
      m[h] = mx;
      l[h] = sum;
    }
  }

  // Normalize and store two floats (dims 8 n + 2 tq, + 1) of rows g, g + 8
  // a fragment: each row's 4 threads write 32 contiguous bytes.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(l[h], 1e-30f);
    const int r = r0 + wrow + g + 8 * h;
    if (r >= n_rows) continue;
    if constexpr (LSE) {
      // m is in log2 units; a row that saw no key keeps the mask value,
      // as the plain version's m + log(1e-30) rounds back to -1e30
      if (tq == 0) lse[lse_off(r)] = m[h] == NEG_INF ? NEG_INF : m[h] * LN2 + logf(denom);
    }
    float* row = out + q_off(r) + t2;
#pragma unroll
    for (int n = 0; n < KSTEPS; ++n)
      if (n < ksteps && 8 * n + t2 < d)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

// The f32 kernel at padded head dim DP for a call with or without
// softcap, its dynamic shared memory limit raised to what it takes (a CUDA
// error code in e when refused).
template <int DP, bool LSE, bool SPLIT>
auto f32_kernel(float softcap, cudaError_t& e) {
  const auto kernel = softcap > 0.f ? flash_attention_kernel_f32<DP, true, LSE, SPLIT>
                                    : flash_attention_kernel_f32<DP, false, LSE, SPLIT>;
  constexpr size_t smem = tf32::smem_bytes<DP>();
  e = smem > 48 * 1024
          ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))
          : cudaSuccess;
  return kernel;
}

template <int DP, bool LSE>
int run_f32_dp(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
               float* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
               int causal, int window, float softcap, void* stream) {
  const int rows = T_q * (H / KV);
  cudaError_t e;
  auto kernel = f32_kernel<DP, LSE, false>(softcap, e);
  // The key split serves forward-only calls of at most 16 rows (T = 1
  // cross-attention); a training forward that short runs the row split.
  if constexpr (!LSE)
    if (rows <= 16) kernel = f32_kernel<DP, false, true>(softcap, e);
  if (e != cudaSuccess) return int(e);
  const unsigned grid = unsigned((rows + tf32::BLOCK_M - 1) / tf32::BLOCK_M) * KV * B;
  kernel<<<grid, tf32::THREADS, tf32::smem_bytes<DP>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(kv_lens),
      static_cast<float*>(out), T_q, Tk, H, KV, d, scale, causal, window, softcap, lse);
  return int(cudaGetLastError());
}

// Resident blocks an SM of the training forward without softcap at padded
// head dim DP (cudaOccupancy...), or -1 on a CUDA error.
template <int DP>
int f32_blocks_per_sm() {
  cudaError_t e;
  const auto kernel = f32_kernel<DP, true, false>(0.f, e);
  int n = 0;
  if (e != cudaSuccess || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                              &n, kernel, tf32::THREADS, tf32::smem_bytes<DP>()) != cudaSuccess)
    return -1;
  return n;
}

template <bool LSE>
int run_f32(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
            float* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
            int causal, int window, float softcap, void* stream) {
  auto* fn = &run_f32_dp<256, LSE>;
  switch (tc::padded_dim(d)) {
    case 32: fn = &run_f32_dp<32, LSE>; break;
    case 64: fn = &run_f32_dp<64, LSE>; break;
    case 128: fn = &run_f32_dp<128, LSE>; break;
  }
  return fn(q, k, v, kv_lens, out, lse, B, T_q, Tk, H, KV, d, scale, causal, window,
            softcap, stream);
}

// ------------------------------------------------ bf16, tensor cores ---
// tc:: helpers (cp.async, ldmatrix, mma.sync, the softmax step) are in
// tc_common.cuh, shared with the paged tile loop of K1/K3.

template <int DP, bool CAPPED, bool LSE = false>
__global__ void __launch_bounds__(tc::THREADS, DP <= 128 ? 2 : 1)
flash_attention_kernel_tc(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                          const tc::bf16* __restrict__ v, const int* __restrict__ kv_lens,
                          tc::bf16* __restrict__ out, int T_q, int Tk, int H, int KV,
                          int d, float scale, int causal, int window, float softcap,
                          float* __restrict__ lse) {
  using namespace tc;
  constexpr int S = DP + 8;            // shared row stride, elements
  constexpr int KSTEPS = DP / 16;
  constexpr int CPR = DP / 8;          // 16-byte chunks a padded row
  constexpr int RPP = THREADS / CPR;   // rows a pass of the block's copies
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [BLOCK_M][S]
  bf16* kv_s = q_s + BLOCK_M * S;                   // [2 stages][K, V][BLOCK_N][S]

  const int G = H / KV;
  const int n_rows = T_q * G;
  // Block x = (n_qtiles - 1 - tile) * KV * B + b * KV + kvh: the tiles with
  // the most keys, of every (batch row, kv head), are launched first.
  const int n_qtiles = (n_rows + BLOCK_M - 1) / BLOCK_M;
  const int pairs = gridDim.x / n_qtiles, pair = blockIdx.x % pairs;
  const int b = pair / KV, kvh = pair - b * KV;
  const int r0 = (n_qtiles - 1 - blockIdx.x / pairs) * BLOCK_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vecs = d / 8;                         // 16-byte vectors a row
  const int ksteps = (d + 15) / 16;               // 16-wide steps of d
  const int kv_len = max(0, min(kv_lens[b], Tk));
  auto q_off = [&](int r) {
    const int c = r / G;
    return ((size_t(b) * T_q + c) * H + kvh * G + (r - c * G)) * size_t(d);
  };
  // row r's log-normalizer slot in lse [B, KV, G, T_q]
  auto lse_off = [&](int r) {
    const int c = r / G;
    return ((size_t(b) * KV + kvh) * G + (r - c * G)) * size_t(T_q) + c;
  };

  // keys any row of the block sees, and keys every row sees
  const int c_lo = r0 / G, c_hi = (min(r0 + BLOCK_M, n_rows) - 1) / G;
  const int t_begin = first_key(c_lo, window);
  const int t_end = causal ? min(kv_len, c_hi + 1) : kv_len;
  const int all_lo = first_key(c_hi, window);
  const int all_hi = causal ? min(kv_len, c_lo + 1) : kv_len;

  // This thread's copies: chunk lc of rows lr, lr + RPP, ...
  const int lc = tid % CPR, lr = tid / CPR;
  const bool copies = lc < vecs;

  if (t_begin >= t_end) {                        // no row sees a key
    if (copies)
      for (int j = lr; j < BLOCK_M; j += RPP)
        if (r0 + j < n_rows)
          *reinterpret_cast<uint4*>(out + q_off(r0 + j) + lc * 8) = make_uint4(0, 0, 0, 0);
    if constexpr (LSE) {
      if (tid < BLOCK_M && r0 + tid < n_rows) lse[lse_off(r0 + tid)] = NEG_INF;
    }
    return;
  }

  // Zero the half-step between d and 16 * ksteps in every tile once.
  if (vecs & 1) {
    for (int j = tid; j < BLOCK_M + 4 * BLOCK_N; j += THREADS)
      *reinterpret_cast<uint4*>(q_s + j * S + vecs * 8) = make_uint4(0, 0, 0, 0);
  }
  if (copies) {
#pragma unroll
    for (int j = lr; j < BLOCK_M; j += RPP) {
      const bool ok = r0 + j < n_rows;
      cp_async16(q_s + j * S + lc * 8, ok ? q + q_off(r0 + j) + lc * 8 : q, ok);
    }
  }
  cp_async_commit();
  const size_t kv_row = size_t(KV) * d;           // elements between keys
  const size_t kv_base = (size_t(b) * Tk * KV + kvh) * d + lc * 8;
  auto load_kv = [&](int t0, int stage) {
    bf16* ks = kv_s + 2 * stage * BLOCK_N * S + lc * 8;
    bf16* vs = ks + BLOCK_N * S;
    if (!copies) return;
#pragma unroll
    for (int j = lr; j < BLOCK_N; j += RPP) {
      const int t = t0 + j;
      const bool ok = t < t_end;
      const size_t off = kv_base + size_t(ok ? t : 0) * kv_row;
      cp_async16(ks + j * S, k + off, ok);
      cp_async16(vs + j * S, v + off, ok);
    }
  };
  load_kv(t_begin, 0);
  cp_async_commit();

  // This thread's two rows of the warp's 16: g and g + 8.
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (r0 + warp * 16 + g + 8 * h) / G;
    row_lo[h] = first_key(c, window);
    row_hi[h] = causal ? min(kv_len, c + 1) : kv_len;
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
      load_kv(t0 + BLOCK_N, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                              // tile it landed
    const bf16* ks = kv_s + 2 * (it & 1) * BLOCK_N * S;
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
    if constexpr (LSE) {
      // m is in log2 units; a row that saw no key keeps the mask value,
      // as the plain version's m + log(1e-30) rounds back to -1e30
      const int r = r0 + warp * 16 + g + 8 * h;
      if ((lane & 3) == 0 && r < n_rows)
        lse[lse_off(r)] = m[h] == NEG_INF ? NEG_INF : m[h] * LN2 + logf(denom);
    }
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

template <int DP, bool LSE>
int run_tc(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
           float* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
           int causal, int window, float softcap, void* stream) {
  constexpr size_t smem = tc::smem_bytes<DP>();
  const auto kernel = softcap > 0.f ? flash_attention_kernel_tc<DP, true, LSE>
                                    : flash_attention_kernel_tc<DP, false, LSE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int rows = T_q * (H / KV);
  const unsigned grid = unsigned((rows + tc::BLOCK_M - 1) / tc::BLOCK_M) * KV * B;
  kernel<<<grid, tc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const int*>(kv_lens),
      static_cast<tc::bf16*>(out), T_q, Tk, H, KV, d, scale, causal, window, softcap,
      lse);
  return int(cudaGetLastError());
}

template <bool LSE>
int run_bf16(const void* q, const void* k, const void* v, const void* kv_lens, void* out,
             float* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
             int causal, int window, float softcap, void* stream) {
  auto* fn = &run_tc<256, LSE>;
  switch (tc::padded_dim(d)) {
    case 32: fn = &run_tc<32, LSE>; break;
    case 64: fn = &run_tc<64, LSE>; break;
    case 128: fn = &run_tc<128, LSE>; break;
  }
  return fn(q, k, v, kv_lens, out, lse, B, T_q, Tk, H, KV, d, scale, causal, window,
            softcap, stream);
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run_f32<false>(q, k, v, kv_lens, out, nullptr, B, T_q, Tk, H, KV, d, scale,
                        causal, window, softcap, stream);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run_bf16<false>(q, k, v, kv_lens, out, nullptr, B, T_q, Tk, H, KV, d, scale,
                         causal, window, softcap, stream);
}

// The training forward: the same, plus each folded row's log-normalizer
// lse [B, KV, G, T_q] f32 (m + log(max(l, 1e-30)) in the capped-logit
// scale, the reference's layout), which the recompute backward reads.
extern "C" int flash_attention_lse_f32(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, void* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run_f32<true>(q, k, v, kv_lens, out, static_cast<float*>(lse), B, T_q, Tk, H,
                       KV, d, scale, causal, window, softcap, stream);
}

extern "C" int flash_attention_lse_bf16(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, void* lse, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run_bf16<true>(q, k, v, kv_lens, out, static_cast<float*>(lse), B, T_q, Tk, H,
                        KV, d, scale, causal, window, softcap, stream);
}

// Dynamic shared memory, in bytes, of one block of a bf16 call at head
// dim d (ptxas -v reports only static shared memory).
extern "C" int flash_attention_bf16_smem_bytes(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return int(tc::smem_bytes<32>());
    case 64: return int(tc::smem_bytes<64>());
    case 128: return int(tc::smem_bytes<128>());
  }
  return int(tc::smem_bytes<256>());
}

// Dynamic shared memory, in bytes, of one block of an f32 call at head
// dim d, and the blocks of it one SM holds (-1 on a CUDA error).
extern "C" int flash_attention_f32_smem_bytes(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return int(tf32::smem_bytes<32>());
    case 64: return int(tf32::smem_bytes<64>());
    case 128: return int(tf32::smem_bytes<128>());
  }
  return int(tf32::smem_bytes<256>());
}

extern "C" int flash_attention_f32_blocks_per_sm(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return f32_blocks_per_sm<32>();
    case 64: return f32_blocks_per_sm<64>();
    case 128: return f32_blocks_per_sm<128>();
  }
  return f32_blocks_per_sm<256>();
}
