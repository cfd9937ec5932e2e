// K4's backward kernels (see ssd_scan_bwd.cu's note for the recipe and
// the design).  ssd_scan_bwd.cu instantiates them for f32 inputs and
// ssd_scan_bwd_bf16.cu for bf16 inputs: two libraries, so nvcc builds
// them in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tf32_common.cuh"

namespace ssd_bwd {

using tc::bf16;
using tf32::warp_mma;   // the products, in chains of tf32::CHAIN steps

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;                 // steps a chunk tile; the largest Q, P, N
constexpr int SR = TILE + 4;             // row stride of x, dy, B, C and dh
constexpr int ST = TILE + 8;             // row stride of h and of pass 1's tiles
constexpr unsigned FULL = 0xffffffffu;

// Pass 1: 2 stages x (X, Y) tiles, then 2 x (weights, exp(L_last)).
constexpr size_t STATES_SMEM = sizeof(float) * (4 * TILE * ST + 2 * TILE + 4);
// Pass 2: x, dy, B, C, dh at SR, h at ST (h's and dh's places later hold
// the stashed A operands), then L, exp(L), dec, S's row and column sums,
// tA, tC and <dh, h> by warp.
constexpr size_t CHUNKS_SMEM = sizeof(float) * (5 * TILE * SR + TILE * ST + 7 * TILE + WARPS);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Sum over the 4 threads of an accumulator row (lanes differing in lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// rows x width of src (row r at src + r * row_stride) into the 64 x 64
// tile dst (row stride S floats), f32, zeros past rows and width.  VEC:
// width and row_stride are multiples of 8, so rows are whole 16-byte
// vectors: f32 by cp.async (the caller commits and waits), bf16 by 16-byte
// loads widened in registers; else element copies.
template <bool VEC, int NT = THREADS, typename T>
__device__ __forceinline__ void load_tile(float* dst, int S, const T* __restrict__ src,
                                          size_t row_stride, int rows, int width, int tid) {
  if constexpr (VEC && std::is_same<T, float>::value) {
    for (int e = tid; e < TILE * TILE / 4; e += NT) {
      const int r = e >> 4, v = (e & 15) * 4;
      const bool ok = r < rows && v < width;
      tc::cp_async16(dst + r * S + v, ok ? src + r * row_stride + v : src, ok);
    }
  } else if constexpr (VEC) {
    for (int e = tid; e < TILE * TILE / 8; e += NT) {
      const int r = e >> 3, v = (e & 7) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && v < width) u = *reinterpret_cast<const uint4*>(src + r * row_stride + v);
      *reinterpret_cast<float4*>(dst + r * S + v) =
          make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
      *reinterpret_cast<float4*>(dst + r * S + v + 4) =
          make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
    }
  } else {
    for (int e = tid; e < TILE * TILE; e += NT) {
      const int r = e >> 6, c = e & (TILE - 1);
      dst[r * S + c] = r < rows && c < width ? to_f(src[r * row_stride + c]) : 0.f;
    }
  }
}

// Warp 0: L, the inclusive scan of la over the chunk's tile (q_valid real
// steps, then la = 0), as la0 / la1 hold rows lane and lane + 32; returns
// this lane's two L and broadcasts L_last.
__device__ __forceinline__ float2 scan_la(float la0, float la1, int lane, float& last) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(FULL, la0, o);
    const float u1 = __shfl_up_sync(FULL, la1, o);
    if (lane >= o) { la0 += u0; la1 += u1; }
  }
  la1 += __shfl_sync(FULL, la0, 31);
  last = __shfl_sync(FULL, la1, 31);
  return make_float2(la0, la1);
}

// ---------------------------------------------------------- 1. states ---
// 8 warps: warp w keeps state rows [16 (w % 4), + 16) and columns
// [32 (w / 4), + 32), 16 floats a thread.
constexpr int STATES_THREADS = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(STATES_THREADS, 3)   // three blocks an SM by shared memory
ssd_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ la,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ h0, const T* __restrict__ dy,
                      const float* __restrict__ dh_final, float* __restrict__ ws_h,
                      float* __restrict__ ws_dh, float* __restrict__ dh0, int T_len, int H,
                      int P, int N, int Q) {
  constexpr bool EXACT = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                          // [stage][X, Y][TILE][ST]
  float* w_s = tiles + 4 * TILE * ST;           // [stage][TILE]: dec or exp(L)
  float* el_s = w_s + 2 * TILE;                 // [stage]: exp(L_last)

  const int hd = blockIdx.x, b = blockIdx.y, dir = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 3) * 16;               // the warp's state rows p
  const int nb = (warp >> 2) * 4;               // its first n fragment
  const int n_chunks = (T_len + Q - 1) / Q;
  // direction 0: h forward from h0 over x, B and dec; direction 1: dh
  // backward from dh_final over dy, C and exp(L), down to dh0
  const T* X = dir ? dy : x;
  const T* Y = dir ? Cc : Bc;
  const float* s0 = dir ? dh_final : h0;
  float* out = dir ? ws_dh : ws_h;
  const size_t bh = size_t(b) * H + hd;
  const size_t state = size_t(P) * N;
  const int steps = dir ? n_chunks - (dh0 ? 0 : 1) : n_chunks - 1;
  auto chunk_of = [&](int i) { return dir ? n_chunks - 1 - i : i; };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = m0 + g + 8 * (e >> 1), n = 8 * (nb + j) + 2 * tq + (e & 1);
      acc[j][e] = s0 && p < P && n < N ? s0[bh * state + size_t(p) * N + n] : 0.f;
    }

  auto load = [&](int i, int st) {
    const int t0 = chunk_of(i) * Q, qv = min(Q, T_len - t0);
    const size_t row = size_t(b) * T_len + t0;
    float* xs = tiles + 2 * st * TILE * ST;
    load_tile<VEC, STATES_THREADS>(xs, ST, X + (row * H + hd) * P, size_t(H) * P, qv, P, tid);
    load_tile<VEC, STATES_THREADS>(xs + TILE * ST, ST, Y + row * N, size_t(N), qv, N, tid);
  };
  float la0 = 0.f, la1 = 0.f;
  auto load_la = [&](int i) {
    const int t0 = chunk_of(i) * Q, qv = min(Q, T_len - t0);
    const size_t row = size_t(b) * T_len + t0;
    la0 = lane < qv ? la[(row + lane) * H + hd] : 0.f;
    la1 = lane + 32 < qv ? la[(row + lane + 32) * H + hd] : 0.f;
  };
  if (steps > 0) {
    load(0, 0);
    tc::cp_async_commit();
    if (warp == 0) load_la(0);
  }

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, c = chunk_of(i);
    if (warp == 0) {
      float last;
      const float2 L = scan_la(la0, la1, lane, last);
      w_s[st * TILE + lane] = dir ? expf(L.x) : expf(last - L.x);
      w_s[st * TILE + lane + 32] = dir ? expf(L.y) : expf(last - L.y);
      if (lane == 0) el_s[st] = expf(last);
    }
    tc::cp_async_wait<0>();
    __syncthreads();                  // step i's tiles and weights in; every warp past i - 1
    if (i + 1 < steps) {
      load(i + 1, st ^ 1);
      tc::cp_async_commit();
      if (warp == 0) load_la(i + 1);
    }
    const float* xs = tiles + 2 * st * TILE * ST;
    const float* ys = xs + TILE * ST;
    const float* ws = w_s + st * TILE;
    const float e_last = el_s[st];
    const int kq = (min(Q, T_len - c * Q) + 7) / 8;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= e_last;
    // state += (w o X)^T Y: A[p][t] = w_t X[t][p] (rows tq, columns g of
    // X's tile), B[t][n] = Y[t][n]
    warp_mma<4, false, EXACT>(
        acc, 0, kq,
        [&](int kk, float (&a)[4]) {
          const int t = 8 * kk + tq;
          const float* xa = xs + t * ST + m0 + g;
          const float w0 = ws[t], w1 = ws[t + 4];
          a[0] = w0 * xa[0];
          a[1] = w0 * xa[8];
          a[2] = w1 * xa[4 * ST];
          a[3] = w1 * xa[4 * ST + 8];
        },
        [&](int kk, int j, float (&v)[2]) {
          const float* yb = ys + (8 * kk + tq) * ST + 8 * (nb + j) + g;
          v[0] = yb[0];
          v[1] = yb[4 * ST];
        });
    // dir 0 after chunk c: h entering c + 1; dir 1 after chunk c >= 1: dh
    // leaving c - 1 (after chunk 0: dh0, below)
    if (dir == 0 || c > 0) {
      float* o = out + (bh * n_chunks + (dir ? c - 1 : c + 1)) * state;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = m0 + g + 8 * (e >> 1), n = 8 * (nb + j) + 2 * tq;
          if (p >= P || n >= N) continue;
          if (VEC) {
            *reinterpret_cast<float2*>(o + size_t(p) * N + n) = make_float2(acc[j][e], acc[j][e + 1]);
          } else {
            o[size_t(p) * N + n] = acc[j][e];
            if (n + 1 < N) o[size_t(p) * N + n + 1] = acc[j][e + 1];
          }
        }
    }
  }
  if (dir == 1 && dh0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m0 + g + 8 * (e >> 1), n = 8 * (nb + j) + 2 * tq + (e & 1);
        if (p < P && n < N) dh0[bh * state + size_t(p) * N + n] = acc[j][e];
      }
  }
}

// ---------------------------------------------------------- 2. chunks ---
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, tf32::min_blocks(CHUNKS_SMEM))
ssd_bwd_chunks_kernel(const T* __restrict__ x, const float* __restrict__ la,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ h0, const T* __restrict__ dy,
                      const float* __restrict__ dh_final, const float* __restrict__ ws_h,
                      const float* __restrict__ ws_dh, T* __restrict__ dx,
                      float* __restrict__ dla, float* __restrict__ dB_part,
                      float* __restrict__ dC_part, int T_len, int H, int P, int N, int Q) {
  constexpr bool EXACT = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                            // [TILE (s)][SR]
  float* dy_s = x_s + TILE * SR;                // [TILE (t)][SR]
  float* b_s = dy_s + TILE * SR;                // [TILE][SR]
  float* c_s = b_s + TILE * SR;                 // [TILE][SR]
  float* dh_s = c_s + TILE * SR;                // [TILE (p)][SR]; then (E o G)^T's fragments
  float* h_s = dh_s + TILE * SR;                // [TILE (p)][ST]; then E o W's, (E o W)^T's
  float* L_s = h_s + TILE * ST;                 // L in log2 units (E = 2^(L_t - L_s))
  float* eL_s = L_s + TILE;                     // exp(L)
  float* dk_s = eL_s + TILE;                    // dec = exp(L_last - L)
  float* rS_s = dk_s + TILE;                    // sum_{s<=t} S_ts
  float* cS_s = rS_s + TILE;                    // sum_{t>=s} S_ts
  float* tA_s = cS_s + TILE;                    // dec_t x_t . (dh B_t)
  float* tC_s = tA_s + TILE;                    // exp(L_t) C_t . (h^T dy_t)
  float* red_s = tC_s + TILE;                   // <dh, h> by warp

  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, t2 = 2 * tq;
  const int m0 = warp * 16;                     // the warp's rows t, then columns s
  const int n_chunks = gridDim.x;
  const int t0 = c * Q, qv = min(Q, T_len - t0);
  const size_t row = size_t(b) * T_len + t0;    // (b, t0)
  const size_t bh = size_t(b) * H + hd;
  const size_t state = size_t(P) * N;
  const int kq = (qv + 7) / 8, kp = (P + 7) / 8, kn = (N + 7) / 8;
  // h entering the chunk and dh leaving it, or null where they are zero
  const float* h_in = c > 0 ? ws_h + (bh * n_chunks + c) * state : h0 ? h0 + bh * state : nullptr;
  const float* dh_in = c + 1 < n_chunks ? ws_dh + (bh * n_chunks + c) * state
                       : dh_final       ? dh_final + bh * state
                                        : nullptr;

  // four groups of copies, in the order the products first read them
  load_tile<VEC>(dy_s, SR, dy + (row * H + hd) * P, size_t(H) * P, qv, P, tid);
  if (h_in) load_tile<VEC>(h_s, ST, h_in, size_t(N), P, N, tid);
  tc::cp_async_commit();
  if (dh_in) load_tile<VEC>(dh_s, SR, dh_in, size_t(N), P, N, tid);
  tc::cp_async_commit();
  load_tile<VEC>(c_s, SR, Cc + row * N, size_t(N), qv, N, tid);
  load_tile<VEC>(b_s, SR, Bc + row * N, size_t(N), qv, N, tid);
  tc::cp_async_commit();
  load_tile<VEC>(x_s, SR, x + (row * H + hd) * P, size_t(H) * P, qv, P, tid);
  tc::cp_async_commit();
  if (warp == 0) {
    float last;
    const float2 L = scan_la(lane < qv ? la[(row + lane) * H + hd] : 0.f,
                             lane + 32 < qv ? la[(row + lane + 32) * H + hd] : 0.f, lane, last);
    L_s[lane] = L.x * tc::LOG2E;
    L_s[lane + 32] = L.y * tc::LOG2E;
    eL_s[lane] = expf(L.x);
    eL_s[lane + 32] = expf(L.y);
    dk_s[lane] = expf(last - L.x);
    dk_s[lane + 32] = expf(last - L.y);
  }

  // Loaders of fragments as f32 (kk: the 8-wide step, i: the n
  // fragment).  A from a row-major [m][k] tile: rows g, g + 8 of the
  // warp's 16, columns tq, tq + 4.
  auto a_rows = [&](const float* tile) {
    return [=](int kk, float (&a)[4]) {
      const float* p = tile + (m0 + g) * SR + 8 * kk + tq;
      a[0] = p[0];
      a[1] = p[8 * SR];
      a[2] = p[4];
      a[3] = p[8 * SR + 4];
    };
  };
  // A from a row-major [m][k] tile with column tq taken as k = 8 kk + 2 tq
  // and column tq + 4 as k = 8 kk + 2 tq + 1 (for a B read by b_pairs).
  auto a_pairs = [&](const float* tile) {
    return [=](int kk, float (&a)[4]) {
      const float2 r0 = *reinterpret_cast<const float2*>(tile + (m0 + g) * SR + 8 * kk + t2);
      const float2 r1 = *reinterpret_cast<const float2*>(tile + (m0 + g + 8) * SR + 8 * kk + t2);
      a[0] = r0.x;
      a[1] = r1.x;
      a[2] = r0.y;
      a[3] = r1.y;
    };
  };
  // A kept by each thread in its own slots (see stash), k paired as above.
  auto a_stash = [&](const float* slots) {
    return [=](int kk, float (&a)[4]) {
      const float4 v = *reinterpret_cast<const float4*>(slots + (kk * 32 + lane) * 4);
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    };
  };
  // B from an [n][k] tile (B[k][n] = tile[n][k]): row 8 i + g, columns tq,
  // tq + 4.
  auto b_rows = [&](const float* tile) {
    return [=](int kk, int i, float (&v)[2]) {
      const float* p = tile + (8 * i + g) * SR + 8 * kk + tq;
      v[0] = p[0];
      v[1] = p[4];
    };
  };
  // B from a [k][n] tile for a paired A: rows k = 8 kk + 2 tq, + 1.
  auto b_pairs = [&](const float* tile) {
    return [=](int kk, int i, float (&v)[2]) {
      const float* p = tile + (8 * kk + t2) * SR + 8 * i + g;
      v[0] = p[0];
      v[1] = p[SR];
    };
  };
  // Accumulators m[kk] into this thread's slots, as
  // a_stash reads them back: the k loops of the products that take them
  // as A run at run time, so the kernel stays small.
  auto stash = [&](float* slots, const float (&m)[8][4]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      *reinterpret_cast<float4*>(slots + (kk * 32 + lane) * 4) =
          make_float4(m[kk][0], m[kk][2], m[kk][1], m[kk][3]);
  };
  // Rows m0 + g (+ 8) of the accumulators, n < width, to out (row r at
  // out + r * stride), rows past the chunk's real steps skipped.
  auto store = [&](auto* out, size_t stride, const float (&m)[8][4], int width) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      if (r >= qv) continue;
      auto* o = out + r * stride;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 8 * i + t2;
        if (n >= width) continue;
        const float v0 = m[i][2 * h], v1 = m[i][2 * h + 1];
        if constexpr (std::is_same<decltype(o), bf16*>::value) {
          if (VEC) {
            *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            o[n] = __float2bfloat16(v0);
            if (n + 1 < width) o[n + 1] = __float2bfloat16(v1);
          }
        } else {
          if (VEC) {
            *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
          } else {
            o[n] = v0;
            if (n + 1 < width) o[n + 1] = v1;
          }
        }
      }
    }
  };
  float* own_h = h_s + warp * 8 * 32 * 4;       // this warp's slots in h's place
  float* own_dh = dh_s + warp * 8 * 32 * 4;     // ... and in dh's

  // ---- the rows t = m0 + g (+ 8) ----
  {
    tc::cp_async_wait<3>();
    __syncthreads();                            // dy, h, L in
    float dc[8][4];
    zero(dc);
    if (h_in)                                   // Z = dy h: B[p][n] = h[p][n], rows tq
      warp_mma<8, EXACT, false>(dc, 0, kp, a_rows(dy_s), [&](int kk, int i, float (&v)[2]) {
        const float* p = h_s + (8 * kk + tq) * ST + 8 * i + g;
        v[0] = p[0];
        v[1] = p[4 * ST];
      });
    tc::cp_async_wait<2>();
    __syncthreads();                            // dh in
    {                                           // <dh, h> over the warp's rows p
      float hdh = 0.f;
      if (h_in && dh_in)
        for (int e = lane; e < 16 * TILE; e += 32) {
          const int p = m0 + (e >> 6), n = e & (TILE - 1);
          hdh = fmaf(dh_s[p * SR + n], h_s[p * ST + n], hdh);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hdh += __shfl_xor_sync(FULL, hdh, o);
      if (lane == 0) red_s[warp] = hdh;
    }
    tc::cp_async_wait<1>();
    __syncthreads();                            // C, B in; every read of h done
    float tc_part[2] = {0.f, 0.f};
    if (h_in) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + 8 * (e >> 1), n = 8 * i + t2 + (e & 1);
          tc_part[e >> 1] += c_s[t * SR + n] * dc[i][e];
          dc[i][e] *= eL_s[t];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + g + 8 * h;
      const float v = quad_sum(tc_part[h]);
      if (tq == 0) tC_s[t] = eL_s[t] * v;
    }

    // G = C B^T and W = dy x^T (then masked to s <= t)
    const int jr = min(2 * warp + 2, kq);       // the fragments s <= the warp's last row
    float gm[8][4], wm[8][4];
    zero(gm);
    zero(wm);
    warp_mma<8, EXACT, EXACT>(gm, 0, kn, a_rows(c_s), b_rows(b_s));
    tc::cp_async_wait<0>();
    __syncthreads();                            // x in
    warp_mma<8, EXACT, EXACT>(wm, 0, kp, a_rows(dy_s), b_rows(x_s));
    // E o W into wm, S's row sums
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = m0 + g + 8 * (e >> 1), s = 8 * j + t2 + (e & 1);
        const float E = s <= t ? tc::ex2(L_s[t] - L_s[s]) : 0.f;
        wm[j][e] *= E;
        rs[e >> 1] = fmaf(gm[j][e], wm[j][e], rs[e >> 1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(rs[h]);
      if (tq == 0) rS_s[m0 + g + 8 * h] = v;
    }
    // dC += (E o W) B, E o W through this thread's slots in h's place
    stash(own_h, wm);
    warp_mma<8, false, EXACT>(dc, 0, jr, a_stash(own_h), b_pairs(b_s));
    store(dC_part + (row * H + hd) * N, size_t(H) * N, dc, N);
  }

  // ---- the columns s = m0 + g (+ 8) ----
  {
    // dx = dec o (B dh^T) and dB = dec o (x dh) first (then dh is free),
    // with tA
    float ax[8][4], ab[8][4];
    zero(ax);
    zero(ab);
    float ta[2] = {0.f, 0.f};
    if (dh_in) {
      warp_mma<8, EXACT, false>(ax, 0, kn, a_rows(b_s), b_rows(dh_s));
      warp_mma<8, EXACT, false>(ab, 0, kp, a_pairs(x_s), b_pairs(dh_s));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = m0 + g + 8 * (e >> 1), p = 8 * i + t2 + (e & 1);
          ta[e >> 1] = fmaf(x_s[s * SR + p], ax[i][e], ta[e >> 1]);
          ax[i][e] *= dk_s[s];
          ab[i][e] *= dk_s[s];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = m0 + g + 8 * h;
      const float v = quad_sum(ta[h]);
      if (tq == 0) tA_s[s] = dk_s[s] * v;
    }
    __syncthreads();                            // every read of dh done

    // G^T = B C^T and W^T = x dy^T (then masked to t >= s), E o G^T (kept
    // in the slots in dh's place), E o W^T (in h's) and S's column sums
    const int jc = 2 * warp;                    // the first fragment t >= the warp's columns
    {
      float gt[8][4];
      zero(gt);
      warp_mma<8, EXACT, EXACT>(gt, 0, kn, a_rows(b_s), b_rows(c_s));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = m0 + g + 8 * (e >> 1), t = 8 * j + t2 + (e & 1);
          gt[j][e] *= s <= t ? tc::ex2(L_s[t] - L_s[s]) : 0.f;
        }
      stash(own_dh, gt);
    }
    {
      float wt[8][4];
      zero(wt);
      warp_mma<8, EXACT, EXACT>(wt, 0, kp, a_rows(x_s), b_rows(dy_s));
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 eg = *reinterpret_cast<const float4*>(own_dh + (j * 32 + lane) * 4);
        cs[0] = fmaf(eg.x, wt[j][0], fmaf(eg.z, wt[j][1], cs[0]));
        cs[1] = fmaf(eg.y, wt[j][2], fmaf(eg.w, wt[j][3], cs[1]));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = m0 + g + 8 * (e >> 1), t = 8 * j + t2 + (e & 1);
          wt[j][e] *= s <= t ? tc::ex2(L_s[t] - L_s[s]) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(cs[h]);
        if (tq == 0) cS_s[m0 + g + 8 * h] = v;
      }
      stash(own_h, wt);
    }
    // dx += (E o G)^T dy, dB += (E o W)^T C
    warp_mma<8, false, EXACT>(ax, jc, kq, a_stash(own_dh), b_pairs(dy_s));
    store(dx + (row * H + hd) * P, size_t(H) * P, ax, P);
    warp_mma<8, false, EXACT>(ab, jc, kq, a_stash(own_h), b_pairs(c_s));
    store(dB_part + (row * H + hd) * N, size_t(H) * N, ab, N);
  }
  __syncthreads();

  // dL, then dla = its reverse cumulative sum within the chunk (warp 0)
  if (warp == 0) {
    float a = tA_s[lane] + tA_s[lane + 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
    float hdh = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) hdh += red_s[w];
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = lane + 32 * j;
      v[j] = rS_s[t] - cS_s[t] + tC_s[t] - tA_s[t];
    }
    if (lane == 31) v[1] += a + eL_s[TILE - 1] * hdh;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {   // suffix sums within each half
      const float u0 = __shfl_down_sync(FULL, v[0], o);
      const float u1 = __shfl_down_sync(FULL, v[1], o);
      if (lane + o < 32) { v[0] += u0; v[1] += u1; }
    }
    v[0] += __shfl_sync(FULL, v[1], 0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = lane + 32 * j;
      if (t < qv) dla[(row + t) * H + hd] = v[j];
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T, bool VEC>
int run_vec(const void* x, const void* la, const void* Bc, const void* Cc, const void* h0,
            const void* dy, const void* dh_final, void* ws, void* dx, void* dla, void* dB_part,
            void* dC_part, void* dh0, int B, int T_len, int H, int P, int N, int Q,
            cudaStream_t stream) {
  const int n_chunks = (T_len + Q - 1) / Q;
  float* ws_h = static_cast<float*>(ws);
  float* ws_dh = ws_h + size_t(B) * H * n_chunks * P * N;
  {
    const auto k1 = ssd_bwd_states_kernel<T, VEC>;
    cudaError_t e = set_smem(k1, STATES_SMEM);
    if (e != cudaSuccess) return int(e);
    k1<<<dim3(H, B, 2), STATES_THREADS, STATES_SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(la), static_cast<const T*>(Bc),
        static_cast<const T*>(Cc), static_cast<const float*>(h0), static_cast<const T*>(dy),
        static_cast<const float*>(dh_final), ws_h, ws_dh, static_cast<float*>(dh0), T_len, H,
        P, N, Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  if (n_chunks > 0) {
    const auto k2 = ssd_bwd_chunks_kernel<T, VEC>;
    cudaError_t e = set_smem(k2, CHUNKS_SMEM);
    if (e != cudaSuccess) return int(e);
    k2<<<dim3(n_chunks, H, B), THREADS, CHUNKS_SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(la), static_cast<const T*>(Bc),
        static_cast<const T*>(Cc), static_cast<const float*>(h0), static_cast<const T*>(dy),
        static_cast<const float*>(dh_final), ws_h, ws_dh, static_cast<T*>(dx),
        static_cast<float*>(dla), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
        T_len, H, P, N, Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T>
int run(const void* x, const void* la, const void* Bc, const void* Cc, const void* h0,
        const void* dy, const void* dh_final, void* ws, void* dx, void* dla, void* dB_part,
        void* dC_part, void* dh0, int B, int T_len, int H, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > TILE || P < 1 || P > TILE || N < 1 || N > TILE)
    return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return P % 8 == 0 && N % 8 == 0
             ? run_vec<T, true>(x, la, Bc, Cc, h0, dy, dh_final, ws, dx, dla, dB_part, dC_part,
                                dh0, B, T_len, H, P, N, Q, s)
             : run_vec<T, false>(x, la, Bc, Cc, h0, dy, dh_final, ws, dx, dla, dB_part,
                                 dC_part, dh0, B, T_len, H, P, N, Q, s);
}

// Resident blocks an SM of kernel k (the main path's instantiation), or -1.
template <typename K>
int occupancy(K kernel, int threads, size_t smem) {
  int n = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace ssd_bwd
