// K4: Mamba2 SSD chunk scan for Hopper (sm_90a) — the scan of every
// Mamba2 block of a zamba2 prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (`ssd_chunk_scan`, body `_kernel`).  It computes the same function and
// also takes what the model's oracle `mamba2_chunk_scan` takes: an initial
// state h0 and any T.  Per chunk of Q steps, with L the cumulative sum of
// the log-decay la over the chunk:
//   y[t]  = sum_{i<=t} exp(L_t - L_i) (C_t . B_i) x_i + exp(L_t) C_t . h
//   h'    = exp(L_last) h + sum_i exp(L_last - L_i) x_i B_i^T
// with the state h [P, N] carried in f32 from chunk to chunk.  The steps
// of a ragged last chunk are staged as x = 0, B = C = 0, la = 0: they add
// nothing to y (never written) and leave h exact.  exp(L_t - L_i) is
// evaluated only on the branch i <= t: above the diagonal it can overflow,
// and a 0/1 mask would turn inf into NaN.
//
// bf16 (ssd_scan_bf16) runs the tensor-core kernel of ssd_tiles.cuh,
// whose note says what bounds it and how.  f32 (ssd_scan_f32) keeps the
// CUDA-core kernel below, so the card-vs-CPU parity runs stay in full
// f32: its four products run on the CUDA cores in f32 (67 TFLOP/s, ~28
// GFLOP at zamba2's prefill, a ceiling near 0.4 ms).
//
// Design of the f32 kernel: one block of 16 x 16 threads per (batch row,
// head) walks the chunks in order — the loop that replaces Pallas's
// sequential third grid axis.  Per chunk it stages x [Q,P], B and C [Q,N]
// in shared memory (rows padded to N + 1 floats: no bank conflicts), scans
// la with warp shuffles, then each thread computes 4 x 4 outputs of each
// product (rows ty + 16 r, columns tx + 16 c).  The 16 x 16 tiles wholly
// above the diagonal of C.B^T are skipped, in that product and in (C.B^T
// o decay) x.  The state stays in shared memory, each entry updated by the
// one thread that owns it once y has read it.
//
// Layouts (the model's, no transposes around the launch):
//   x, y [B, T, H, P] (T = x's type)   la [B, T, H] f32 (<= 0)
//   Bc, Cc [B, T, N] (x's type, shared by all heads)
//   h0 [B, H, P, N] f32 or null (zeros)   h_out [B, H, P, N] f32
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_tiles.cuh"

namespace {

constexpr int TX = 16;                  // threads per block row and column
constexpr int THREADS = TX * TX;
constexpr int R = 4;                    // outputs per thread along each axis
constexpr int MAX_DIM = TX * R;         // 64: the largest Q, P and N
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Dynamic shared memory of one block, in floats.
inline size_t smem_floats(int Q, int P, int N) {
  return size_t(P) * (N + 1)            // h   [P][N+1]
         + size_t(Q) * P                // x   [Q][P]
         + 2 * size_t(Q) * (N + 1)      // B, C [Q][N+1]
         + size_t(Q) * (Q + 1)          // G   [Q][Q+1]: (C.B^T o decay), lower
         + 3 * size_t(Q);               // L, exp(L), exp(L_last - L)
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ la,
                const T* __restrict__ Bc, const T* __restrict__ Cc,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_out, int T_len, int H, int P, int N,
                int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1, QP = Q + 1;
  float* h_s = smem;
  float* x_s = h_s + P * NP;
  float* b_s = x_s + Q * P;
  float* c_s = b_s + Q * NP;
  float* g_s = c_s + Q * NP;
  float* L_s = g_s + Q * QP;
  float* eL_s = L_s + Q;                 // exp(L_t)
  float* dk_s = eL_s + Q;                // exp(L_last - L_i)

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = size_t(b) * T_len;                 // (b, t = 0)
  const size_t h_off = (size_t(b) * H + hd) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    h_s[(e / N) * NP + e % N] = h0 ? h0[h_off + e] : 0.f;

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

  for (int t0 = 0; t0 < T_len; t0 += Q) {
    const int q_valid = min(Q, T_len - t0);
    __syncthreads();                     // last chunk's state update done
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P;
      x_s[e] = i < q_valid ? to_f(x[((row0 + t0 + i) * H + hd) * P + e % P]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const size_t off = (row0 + t0 + i) * N + n;
      b_s[i * NP + n] = i < q_valid ? to_f(Bc[off]) : 0.f;
      c_s[i * NP + n] = i < q_valid ? to_f(Cc[off]) : 0.f;
    }
    if (warp == 0) {                     // inclusive scan of la, Q <= 64
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
    __syncthreads();

    // 1. G[t][i] = exp(L_t - L_i) C_t . B_i for i <= t, else 0 (tiles
    //    c <= r only: the others lie wholly above the diagonal)
    {
      float acc[R][R] = {};
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          cv[k] = c_s[rq[k] * NP + n];
          bv[k] = b_s[cq[k] * NP + n];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = ty + TX * r;
#pragma unroll
        for (int c = 0; c <= r; ++c) {
          const int i = tx + TX * c;
          if (t < Q && i < Q)
            g_s[t * QP + i] = i <= t ? expf(L_s[t] - L_s[i]) * acc[r][c] : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y[t][p] = exp(L_t) C_t . h[p] + sum_{i<=t} G[t][i] x[i][p]
    {
      float acc[R][R] = {};
      for (int n = 0; n < N; ++n) {
        float cv[R], hv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          cv[k] = c_s[rq[k] * NP + n];
          hv[k] = h_s[cp[k] * NP + n];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) acc[r][c] = fmaf(cv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = eL_s[rq[r]];
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] *= e;
      }
#pragma unroll
      for (int ib = 0; ib < R; ++ib) {   // key tile ib feeds row tiles r >= ib
        const int i_end = min(Q, TX * (ib + 1));
        for (int i = TX * ib; i < i_end; ++i) {
          float xv[R];
#pragma unroll
          for (int c = 0; c < R; ++c) xv[c] = x_s[i * P + cp[c]];
#pragma unroll
          for (int r = ib; r < R; ++r) {
            const float g = g_s[rq[r] * QP + i];
#pragma unroll
            for (int c = 0; c < R; ++c) acc[r][c] = fmaf(g, xv[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = ty + TX * r;
        if (t >= q_valid) continue;
        T* yr = y + ((row0 + t0 + t) * H + hd) * P;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int p = tx + TX * c;
          if (p < P) yr[p] = from_f<T>(acc[r][c]);
        }
      }
    }
    __syncthreads();                     // every read of h done

    // 3. h[p][n] = exp(L_last) h[p][n] + sum_i exp(L_last - L_i) x[i][p] B[i][n]
    {
      float acc[R][R] = {};
      for (int i = 0; i < Q; ++i) {
        const float dk = dk_s[i];
        float xv[R], bv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          xv[k] = x_s[i * P + rp[k]] * dk;
          bv[k] = b_s[i * NP + cn[k]];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
      }
      const float e_last = eL_s[Q - 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = ty + TX * r;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int n = tx + TX * c;
          if (p < P && n < N) h_s[p * NP + n] = fmaf(e_last, h_s[p * NP + n], acc[r][c]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS)
    h_out[h_off + e] = h_s[(e / N) * NP + e % N];
}

template <typename T>
int run(const void* x, const void* la, const void* Bc, const void* Cc,
        const void* h0, void* y, void* h_out, int B, int T_len, int H, int P,
        int N, int Q, void* stream) {
  if (Q < 1 || Q > MAX_DIM || P < 1 || P > MAX_DIM || N < 1 || N > MAX_DIM)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  ssd_scan_kernel<T><<<dim3(H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(la),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), T_len, H, P, N, Q);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* la, const void* Bc,
                            const void* Cc, const void* h0, void* y,
                            void* h_out, int B, int T, int H, int P, int N,
                            int Q, void* stream) {
  return run<float>(x, la, Bc, Cc, h0, y, h_out, B, T, H, P, N, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* la, const void* Bc,
                             const void* Cc, const void* h0, void* y,
                             void* h_out, int B, int T, int H, int P, int N,
                             int Q, void* stream) {
  return ssd::run_tc(x, la, Bc, Cc, h0, y, h_out, B, T, H, P, N, Q, stream);
}

// Dynamic shared memory, in bytes, of one block of the bf16 kernel
// (ptxas -v reports only static shared memory).
extern "C" int ssd_scan_bf16_smem_bytes() { return int(ssd::SMEM_BYTES); }

// Blocks of the bf16 kernel (P, N multiples of 8) resident on one SM of
// the current device, or -1 on a CUDA error.
extern "C" int ssd_scan_bf16_blocks_per_sm() { return ssd::blocks_per_sm(); }
