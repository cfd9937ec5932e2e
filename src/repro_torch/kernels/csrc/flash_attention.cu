// K2: flash attention, forward, for Hopper (sm_90a) — the monolithic
// prompt prefill of `sequential` serving and of the zamba2 hybrid's
// shared attention.
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
// G=1) it is bytes: 235 MB at 3.35 TB/s, 0.0701 ms.
//
// bf16 (flash_attention_kernel_tc): the products run on the tensor cores.
//   - One block of 4 warps per (tile of 64 folded query rows, kv head,
//     batch row); each warp owns 16 rows.  The grid is one-dimensional
//     and launches the last tiles (most keys under the causal mask) of
//     every (batch row, kv head) first, so the short tiles fill the end
//     of the grid.  A 64-row tile reads each key tile once for 64 rows,
//     16 times fewer K/V bytes than 4-row blocks.
//   - Q·K^T and P·V are mma.sync.m16n8k16 products, bf16 in, f32
//     accumulators, fragments loaded from shared memory by ldmatrix
//     (.trans for V).  The Q tile stays in registers for the whole key
//     loop.  S is scaled in f32 (log2 e folded in, exp2 by ex2.approx),
//     soft-capped (a separate instantiation, so calls without a softcap
//     pay no tanh) and masked per element only on tiles some row does not
//     see whole.  P is rounded to bf16 for its product, as SDPA does, while
//     the row sums l stay in f32.
//   - With 16 rows a warp, every mma.sync needs 256 bytes of ldmatrix
//     traffic, so shared-memory bandwidth and the mma.sync rate bound the
//     product phases together; wgmma (64 rows a warpgroup, B read once
//     from shared memory) is the step past that.
//   - K/V tiles of 64 keys move to shared memory by 16-byte cp.async,
//     double-buffered: tile i + 1 is in flight while tile i is multiplied.
//     Rows are padded by 16 bytes, so the 8 rows one ldmatrix reads fall
//     in 8 different bank groups.  Key rows past the block's key range are
//     zero-filled by the copy (source size 0) and masked, so stale shared
//     memory never meets P = 0.
//   - The head dim is padded to DP in {32, 64, 128, 256} (112 runs at 128),
//     the products walk only ceil(d / 16) 16-wide steps of it, and a
//     half-step past d is zero-filled once.  Dynamic shared memory is
//     (64 + 4 * 64) rows of DP + 8: 85 KB at DP = 128, two blocks an SM.
//   - The output is normalized by max(l, 1e-30) in f32, rounded once,
//     staged in the warp's own rows of the Q tile and stored in 16-byte
//     vectors.
// f32 keeps the CUDA-core tile loop of attention_common.cuh (one warp per
// query row), so the card-vs-CPU parity runs stay in full f32, off TF32.
//
// The training forward (flash_attention_lse_{f32,bf16}) is the same code
// with a compile-time flag (LSE) that also writes each folded row's
// log-normalizer, lse [B, KV, G, T_q] f32 = m + log(max(l, 1e-30)) in the
// capped-logit scale (the bf16 kernel's m is in log2 units: m ln 2); a row
// that sees no key writes -1e30.  The recompute backward
// (models/layers.py::flash_attention_ckpt) reads it.  The forward-only
// entry points instantiate the kernels without the flag, as before.
//
// Layouts (the model's): q, out [B, T, H, d]; k, v [B, Tk, KV, d];
// kv_lens [B] int32.
#include "attention_common.cuh"
#include "tc_common.cuh"

namespace {

template <typename T, bool LSE = false>
__global__ void __launch_bounds__(attn::THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_lens,
                       T* __restrict__ out, int T_q, int Tk, int H, int KV,
                       int d, float scale, int causal, int window,
                       float softcap, float* __restrict__ lse) {
  using Src = attn::FpSrc<T, attn::DenseRows>;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int kv_len = min(kv_lens[b], Tk);
  const Src src{k, v, {size_t(b) * Tk * KV + kvh, KV}, d};
  attn::attend_rows<T, Src, LSE>(q, out, src, b, kvh, T_q, H, KV, d,
                                 blockIdx.x * attn::WARPS, /*q_pos0=*/0, kv_len,
                                 scale, causal, window, softcap, lse);
}

template <typename T, bool LSE>
int run(const void* q, const void* k, const void* v, const void* kv_lens,
        void* out, float* lse, int B, int T_q, int Tk, int H, int KV, int d,
        float scale, int causal, int window, float softcap, void* stream) {
  const int rows = T_q * (H / KV);
  const dim3 grid((rows + attn::WARPS - 1) / attn::WARPS, KV, B);
  return attn::launch(flash_attention_kernel<T, LSE>, grid, d, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<const int*>(kv_lens), static_cast<T*>(out),
                      T_q, Tk, H, KV, d, scale, causal, window, softcap, lse);
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
  return run<float, false>(q, k, v, kv_lens, out, nullptr, B, T_q, Tk, H, KV, d,
                           scale, causal, window, softcap, stream);
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
  return run<float, true>(q, k, v, kv_lens, out, static_cast<float*>(lse), B, T_q, Tk,
                          H, KV, d, scale, causal, window, softcap, stream);
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
