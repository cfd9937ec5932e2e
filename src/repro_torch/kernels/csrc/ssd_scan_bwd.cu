// K4's backward: the gradient of the Mamba2 SSD chunk scan for Hopper
// (sm_90a), which the hybrid's training step runs once per Mamba2 block.
//
// The TPU kernel src/repro/kernels/ssd_scan.py (`ssd_chunk_scan`) has no
// backward: the reference trains through its jnp scan
// (src/repro/models/ssm.py::mamba2_chunk_scan), whose gradient XLA
// derives.  This kernel computes that gradient for the forward of
// ssd_scan.cu, which it leaves as it is.  Per chunk of Q steps, with L the
// cumulative sum of la within the chunk, E_ts = exp(L_t - L_s) for s <= t
// (else 0), dec_s = exp(L_last - L_s), G_ts = C_t . B_s, W_ts = dy_t . x_s,
// S_ts = E_ts G_ts W_ts, h the state entering the chunk and dh the
// gradient of the state leaving it:
//   dx_s = sum_{t>=s} E_ts G_ts dy_t + dec_s (dh B_s)
//   dB_s = sum_{t>=s} E_ts W_ts C_t + dec_s (dh^T x_s)       (this head's share)
//   dC_t = sum_{s<=t} E_ts W_ts B_s + exp(L_t) (h^T dy_t)    (this head's share)
//   dL_t = sum_{s<=t} S_ts - sum_{t'>=t} S_t't + exp(L_t) dy_t . (h C_t)
//          - dec_t x_t . (dh B_t), and at the chunk's last step also
//          + sum_s dec_s x_s . (dh B_s) + exp(L_last) <dh, h>
//   dla = the reverse cumulative sum of dL within the chunk
//   dh <- exp(L_last) dh + sum_t exp(L_t) dy_t C_t^T   (after chunk 0: dh0)
// The steps of a ragged last chunk are staged as zeros (la = 0 too, so
// L_last is the last real step's L) and their gradients are never written.
// exp(L_t - L_s) is evaluated only on the branch s <= t: above the
// diagonal it can overflow, and a 0/1 mask would turn inf into NaN.
//
// Two passes in one block per (batch row, head), walking the chunks in a
// loop as the forward does (ssd_scan.cu):
//   1. states: the forward's state update without y, writing the state
//      entering each chunk to an f32 workspace [B, H, n_chunks, P, N]
//      (each thread keeps its 4 x 4 entries of h in registers);
//   2. reverse: the chunks last to first, dh [P, N] carried in shared
//      memory.
// B and C are shared by all heads, so dB and dC are written as per-head
// partials [B, T, H, N] f32 that the wrapper sums over H: no float atomics,
// so the result does not depend on the order blocks run in.
//
// What bounds it: operations.  At the hybrid's training shape (B = 4,
// T = 1024, 112 heads, P = N = 64, chunk 64) it does ~7.5 chunk-sized
// products per chunk (five of them causal triangles), ~28 GFLOP against
// ~0.36 GB of inputs and outputs: at the CUDA cores' 67 TFLOP/s in f32 a
// ceiling near 0.42 ms (chip_smoke.py's ssd_bwd_work).  The design is the
// forward's f32 one, simple first: 16 x 16 threads, each computing 4 x 4
// outputs of every product from shared memory (rows padded by one float:
// no bank conflicts), tiles wholly above a causal diagonal skipped; the
// row reductions of dL run over the 16 lanes that own a row (shuffles),
// the block's <dh, h> over warps in a fixed order.  Its ~150 KB of shared memory allows one block
// an SM.  x, B, C and dy are read in their type (f32 or bf16), all
// arithmetic is f32.
//
// Layouts (the forward's):
//   x, dy, dx [B, T, H, P] (T = x's type)   la, dla [B, T, H] f32
//   Bc, Cc [B, T, N] (x's type)   dB_part, dC_part [B, T, H, N] f32
//   h0, dh_final, dh0 [B, H, P, N] f32 (each may be null: zeros / not
//   written)   ws [B, H, n_chunks, P, N] f32
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;                  // threads per block row and column
constexpr int THREADS = TX * TX;
constexpr int R = 4;                    // outputs per thread along each axis
constexpr int MAX_DIM = TX * R;         // 64: the largest Q, P and N
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory of one block, in floats.
inline size_t smem_floats(int Q, int P, int N) {
  return 2 * size_t(Q) * (P + 1)        // x, dy [Q][P+1]
         + 2 * size_t(Q) * (N + 1)      // B, C  [Q][N+1]
         + 2 * size_t(P) * (N + 1)      // h, dh [P][N+1]
         + 3 * size_t(Q) * (Q + 1)      // E.G, E.W, S [Q][Q+1], lower
         + 7 * size_t(Q)                // L, exp(L), dec, four dL terms
         + WARPS;                       // the block's <dh, h> by warp
}

// acc[r][c] += sum_{k0 <= k < k1} a(r, k) b(k, c) for the row tiles
// rlo <= r <= rhi (r, c: this thread's 4 rows and 4 columns).
template <typename FA, typename FB>
__device__ __forceinline__ void mac(float (&acc)[R][R], int k0, int k1, int rlo, int rhi,
                                    FA a, FB b) {
  for (int k = k0; k < k1; ++k) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      av[i] = a(i, k);
      bv[i] = b(k, i);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rlo || r > rhi) continue;
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// Sum over the 16 lanes that share ty (one half of a warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ la,
                    const T* __restrict__ Bc, const T* __restrict__ Cc,
                    const float* __restrict__ h0, const T* __restrict__ dy,
                    const float* __restrict__ dh_final, float* __restrict__ ws,
                    T* __restrict__ dx, float* __restrict__ dla,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dh0, int T_len, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int XP = P + 1, NP = N + 1, QP = Q + 1;
  float* x_s = smem;
  float* dy_s = x_s + Q * XP;
  float* b_s = dy_s + Q * XP;
  float* c_s = b_s + Q * NP;
  float* h_s = c_s + Q * NP;
  float* dh_s = h_s + P * NP;
  float* a_s = dh_s + P * NP;            // E_ts G_ts, s <= t
  float* v_s = a_s + Q * QP;             // E_ts W_ts
  float* sm_s = v_s + Q * QP;            // S_ts
  float* L_s = sm_s + Q * QP;
  float* eL_s = L_s + Q;                 // exp(L_t)
  float* dk_s = eL_s + Q;                // dec_t = exp(L_last - L_t)
  float* tA_s = dk_s + Q;                // dec_t x_t . (dh B_t)
  float* tC_s = tA_s + Q;                // exp(L_t) C_t . (h^T dy_t)
  float* rS_s = tC_s + Q;                // sum_{s<=t} S_ts
  float* cS_s = rS_s + Q;                // sum_{t>=s} S_ts
  float* red_s = cS_s + Q;               // <dh, h> by warp

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = size_t(b) * T_len;                 // (b, t = 0)
  const size_t h_off = (size_t(b) * H + hd) * P * N;
  const int n_chunks = (T_len + Q - 1) / Q;
  float* ws_bh = ws + (size_t(b) * H + hd) * size_t(n_chunks) * P * N;

  // this thread's rows and columns, clamped into range for loads (the
  // results of clamped rows and columns are never stored)
  int rq[R], cq[R], cp[R], cn[R], rp[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    rq[k] = min(ty + TX * k, Q - 1);
    cq[k] = min(tx + TX * k, Q - 1);
    cp[k] = min(tx + TX * k, P - 1);
    cn[k] = min(tx + TX * k, N - 1);
    rp[k] = min(ty + TX * k, P - 1);
  }

  // Stage chunk t0's x, B (and with `full` dy and C) as f32, zeros past
  // the last real step, and L, exp(L), dec from la (warp 0, Q <= 64).
  auto stage = [&](int t0, int q_valid, bool full) {
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      const size_t off = ((row0 + t0 + i) * H + hd) * P + p;
      x_s[i * XP + p] = i < q_valid ? to_f(x[off]) : 0.f;
      if (full) dy_s[i * XP + p] = i < q_valid ? to_f(dy[off]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const size_t off = (row0 + t0 + i) * N + n;
      b_s[i * NP + n] = i < q_valid ? to_f(Bc[off]) : 0.f;
      if (full) c_s[i * NP + n] = i < q_valid ? to_f(Cc[off]) : 0.f;
    }
    if (warp == 0) {                     // inclusive scan of la
      float v0 = lane < q_valid ? la[(row0 + t0 + lane) * H + hd] : 0.f;
      float v1 = lane + 32 < q_valid ? la[(row0 + t0 + lane + 32) * H + hd] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(FULL, v0, o);
        const float u1 = __shfl_up_sync(FULL, v1, o);
        if (lane >= o) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(FULL, v0, 31);
      const float last = __shfl_sync(FULL, Q > 32 ? v1 : v0, (Q - 1) & 31);
      if (lane < Q) {
        L_s[lane] = v0; eL_s[lane] = expf(v0); dk_s[lane] = expf(last - v0);
      }
      if (lane + 32 < Q) {
        L_s[lane + 32] = v1; eL_s[lane + 32] = expf(v1); dk_s[lane + 32] = expf(last - v1);
      }
    }
  };

  // ---- 1. states pass: the state entering each chunk into ws ----
  {
    float hr[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c)
        hr[r][c] = h0 ? h0[h_off + size_t(rp[r]) * N + cn[c]] : 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int t0 = ch * Q;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int p = ty + TX * r, n = tx + TX * c;
          if (p < P && n < N) ws_bh[(size_t(ch) * P + p) * N + n] = hr[r][c];
        }
      if (ch == n_chunks - 1) break;     // the last chunk's update is not needed
      __syncthreads();                   // the last chunk's reads done
      stage(t0, min(Q, T_len - t0), false);
      __syncthreads();
      float acc[R][R] = {};
      mac(acc, 0, Q, 0, R - 1,
          [&](int i, int k) { return dk_s[k] * x_s[k * XP + rp[i]]; },
          [&](int k, int i) { return b_s[k * NP + cn[i]]; });
      const float e_last = eL_s[Q - 1];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) hr[r][c] = fmaf(e_last, hr[r][c], acc[r][c]);
    }
  }

  // ---- 2. reverse pass ----
  for (int e = tid; e < P * N; e += THREADS)
    dh_s[(e / N) * NP + e % N] = dh_final ? dh_final[h_off + e] : 0.f;
  __syncthreads();                       // every state of pass 1 written

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * Q, q_valid = min(Q, T_len - t0);
    __syncthreads();                     // the last chunk's reads done
    stage(t0, q_valid, true);
    for (int e = tid; e < P * N; e += THREADS)
      h_s[(e / N) * NP + e % N] = ws_bh[size_t(ch) * P * N + e];
    __syncthreads();

    // E.G, E.W and S on the causal triangle (tiles c <= r; the others lie
    // wholly above the diagonal and are never read)
    {
      float g[R][R] = {}, w[R][R] = {};
      for (int k = 0; k < N; ++k) {
        float cv[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          cv[i] = c_s[rq[i] * NP + k];
          bv[i] = b_s[cq[i] * NP + k];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
      for (int k = 0; k < P; ++k) {
        float dv[R], xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i] = dy_s[rq[i] * XP + k];
          xv[i] = x_s[cq[i] * XP + k];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) w[r][c] = fmaf(dv[r], xv[c], w[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = ty + TX * r;
#pragma unroll
        for (int c = 0; c <= r; ++c) {
          const int s = tx + TX * c;
          if (t < Q && s < Q) {
            const float E = s <= t ? expf(L_s[t] - L_s[s]) : 0.f;
            a_s[t * QP + s] = E * g[r][c];
            v_s[t * QP + s] = E * w[r][c];
            sm_s[t * QP + s] = E * g[r][c] * w[r][c];
          }
        }
      }
    }
    __syncthreads();

    // dx and the dec_t x_t . (dh B_t) term of dL
    {
      float u[R][R] = {}, acc[R][R] = {};
      mac(u, 0, N, 0, R - 1, [&](int i, int k) { return b_s[rq[i] * NP + k]; },
          [&](int k, int i) { return dh_s[cp[i] * NP + k]; });
#pragma unroll
      for (int tb = 0; tb < R; ++tb)     // t >= s: row tiles r <= tb
        mac(acc, TX * tb, min(Q, TX * (tb + 1)), 0, tb,
            [&](int i, int k) { return a_s[k * QP + rq[i]]; },
            [&](int k, int i) { return dy_s[k * XP + cp[i]]; });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = ty + TX * r;
        const float dk = dk_s[rq[r]];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < R; ++c)
          if (tx + TX * c < P) part = fmaf(x_s[rq[r] * XP + cp[c]], u[r][c], part);
        part = row_sum16(part);
        if (tx == 0 && s < Q) tA_s[s] = dk * part;
        if (s >= q_valid) continue;
        T* dxr = dx + ((row0 + t0 + s) * H + hd) * P;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int p = tx + TX * c;
          if (p < P) dxr[p] = from_f<T>(fmaf(dk, u[r][c], acc[r][c]));
        }
      }
    }

    // dB (this head's share)
    {
      float xd[R][R] = {}, acc[R][R] = {};
      mac(xd, 0, P, 0, R - 1, [&](int i, int k) { return x_s[rq[i] * XP + k]; },
          [&](int k, int i) { return dh_s[k * NP + cn[i]]; });
#pragma unroll
      for (int tb = 0; tb < R; ++tb)
        mac(acc, TX * tb, min(Q, TX * (tb + 1)), 0, tb,
            [&](int i, int k) { return v_s[k * QP + rq[i]]; },
            [&](int k, int i) { return c_s[k * NP + cn[i]]; });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = ty + TX * r;
        if (s >= q_valid) continue;
        const float dk = dk_s[s];
        float* dbr = dB_part + ((row0 + t0 + s) * H + hd) * N;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int n = tx + TX * c;
          if (n < N) dbr[n] = fmaf(dk, xd[r][c], acc[r][c]);
        }
      }
    }

    // dC (this head's share) and the exp(L_t) C_t . (h^T dy_t) term of dL
    {
      float z[R][R] = {}, acc[R][R] = {};
      mac(z, 0, P, 0, R - 1, [&](int i, int k) { return dy_s[rq[i] * XP + k]; },
          [&](int k, int i) { return h_s[k * NP + cn[i]]; });
#pragma unroll
      for (int sb = 0; sb < R; ++sb)     // s <= t: row tiles r >= sb
        mac(acc, TX * sb, min(Q, TX * (sb + 1)), sb, R - 1,
            [&](int i, int k) { return v_s[rq[i] * QP + k]; },
            [&](int k, int i) { return b_s[k * NP + cn[i]]; });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = ty + TX * r;
        const float e = eL_s[rq[r]];
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < R; ++c)
          if (tx + TX * c < N) part = fmaf(c_s[rq[r] * NP + cn[c]], z[r][c], part);
        part = row_sum16(part);
        if (tx == 0 && t < Q) tC_s[t] = e * part;
        if (t >= q_valid) continue;
        float* dcr = dC_part + ((row0 + t0 + t) * H + hd) * N;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int n = tx + TX * c;
          if (n < N) dcr[n] = fmaf(e, z[r][c], acc[r][c]);
        }
      }
    }

    // row and column sums of S
    if (tid < Q) {
      float v = 0.f;
      for (int s = 0; s <= tid; ++s) v += sm_s[tid * QP + s];
      rS_s[tid] = v;
    } else if (tid >= 64 && tid < 64 + Q) {
      const int s = tid - 64;
      float v = 0.f;
      for (int t = s; t < Q; ++t) v += sm_s[t * QP + s];
      cS_s[s] = v;
    }
    __syncthreads();                     // every read of dh done

    // dh <- exp(L_last) dh + sum_t exp(L_t) dy_t C_t^T, and <dh, h> (old dh)
    {
      float acc[R][R] = {};
      mac(acc, 0, Q, 0, R - 1, [&](int i, int k) { return eL_s[k] * dy_s[k * XP + rp[i]]; },
          [&](int k, int i) { return c_s[k * NP + cn[i]]; });
      const float e_last = eL_s[Q - 1];
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = ty + TX * r;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int n = tx + TX * c;
          if (p < P && n < N) {
            float* d = dh_s + p * NP + n;
            part = fmaf(*d, h_s[p * NP + n], part);
            *d = fmaf(e_last, *d, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      if (lane == 0) red_s[warp] = part;
    }
    __syncthreads();

    // dL, then dla = its reverse cumulative sum within the chunk
    if (warp == 0) {
      float hdh = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) hdh += red_s[w];
      float a = (lane < Q ? tA_s[lane] : 0.f) + (lane + 32 < Q ? tA_s[lane + 32] : 0.f);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
      const float last = a + eL_s[Q - 1] * hdh;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = lane + 32 * j;
        v[j] = t < Q ? rS_s[t] - cS_s[t] + tC_s[t] - tA_s[t] + (t == Q - 1 ? last : 0.f)
                     : 0.f;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {  // suffix sums within each half
        const float u0 = __shfl_down_sync(FULL, v[0], o);
        const float u1 = __shfl_down_sync(FULL, v[1], o);
        if (lane + o < 32) { v[0] += u0; v[1] += u1; }
      }
      v[0] += __shfl_sync(FULL, v[1], 0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = lane + 32 * j;
        if (t < q_valid) dla[(row0 + t0 + t) * H + hd] = v[j];
      }
    }
  }
  __syncthreads();
  if (dh0)
    for (int e = tid; e < P * N; e += THREADS) dh0[h_off + e] = dh_s[(e / N) * NP + e % N];
}

template <typename T>
int run(const void* x, const void* la, const void* Bc, const void* Cc, const void* h0,
        const void* dy, const void* dh_final, void* ws, void* dx, void* dla, void* dB_part,
        void* dC_part, void* dh0, int B, int T_len, int H, int P, int N, int Q,
        void* stream) {
  if (Q < 1 || Q > MAX_DIM || P < 1 || P > MAX_DIM || N < 1 || N > MAX_DIM)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  ssd_scan_bwd_kernel<T><<<dim3(H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(la), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), static_cast<const float*>(h0), static_cast<const T*>(dy),
      static_cast<const float*>(dh_final), static_cast<float*>(ws), static_cast<T*>(dx),
      static_cast<float*>(dla), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dh0), T_len, H, P, N, Q);
  return int(cudaGetLastError());
}

}  // namespace

#define SSD_BWD_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const void* x, const void* la, const void* Bc, const void* Cc,       \
                      const void* h0, const void* dy, const void* dh_final, void* ws,      \
                      void* dx, void* dla, void* dB_part, void* dC_part, void* dh0, int B, \
                      int T_len, int H, int P, int N, int Q, void* stream) {               \
    return run<T>(x, la, Bc, Cc, h0, dy, dh_final, ws, dx, dla, dB_part, dC_part, dh0, B,  \
                  T_len, H, P, N, Q, stream);                                              \
  }

SSD_BWD_ENTRY(ssd_scan_bwd_f32, float)
SSD_BWD_ENTRY(ssd_scan_bwd_bf16, __nv_bfloat16)

// Dynamic shared memory, in bytes, of one block at chunk Q, P and N.
extern "C" int ssd_scan_bwd_smem_bytes(int Q, int P, int N) {
  return int(smem_floats(Q, P, N) * sizeof(float));
}
