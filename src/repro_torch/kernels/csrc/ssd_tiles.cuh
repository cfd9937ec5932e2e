// K4's bf16 path on Hopper's tensor cores: the Mamba2 SSD chunk scan
// with its four products on mma.sync (ssd_scan.cu's ssd_scan_bf16
// launches it; the f32 path runs ssd_tiles_f32.cuh's 3xTF32 kernel).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (`ssd_chunk_scan`, body `_kernel`) and computes ssd_scan.cu's function:
// per chunk, with L the cumulative log-decay,
//   y[t] = exp(L_t) C_t . h + sum_{i<=t} exp(L_t - L_i) (C_t . B_i) x_i
//   h'   = exp(L_last) h + sum_i exp(L_last - L_i) x_i B_i^T
//
// What bounds it on an H100: at zamba2's prefill (B=8, T=1024, H=112,
// P=N=64) a call moves ~0.25 GB, x and y dominating (0.076 ms at
// 3.35 TB/s), and its products, hi/lo halves included, are ~73 GFLOP
// (0.074 ms at 989 TFLOP/s): on the tensor cores the bytes and the
// products bound it about equally.  This design reaches neither: each
// block keeps one chunk in flight and every chunk ends at a barrier that
// waits for the warp with the most of the causal triangle (warp 3: 192
// mma.sync a chunk against warp 0's 120).  PERF.md has its measurements.
//
// Design:
//   - One block of 4 warps per (head, batch row) walks the chunks in
//     order, the loop that replaces Pallas's sequential grid axis.  Every
//     chunk is a 64-row tile; rows past the chunk or past T, and columns
//     past P or N, are zero-filled (x = B = C = 0, la = 0), so a chunk
//     below 64, a ragged last chunk and P, N < 64 need no other path.
//   - Warp w owns the steps t in [16w, 16w + 16) of the chunk and the
//     state rows p in [16w, 16w + 16).  S = C.B^T and C.h^T are K2's Q.K^T
//     (A from the warp's C rows by ldmatrix, B rows by ldmatrix); key
//     tiles wholly above the diagonal are skipped.  G = S o exp(L_t - L_i)
//     is evaluated in the accumulator fragments only where i <= t (above
//     the diagonal the exponent can overflow) and becomes the A operand of
//     G.x (K2's P.V, x by ldmatrix.trans).  The state update
//     (x o dk)^T.B takes x^T by ldmatrix.trans and scales it in registers.
//   - Numerics: x, B and C are bf16 already, so S is exact up to f32
//     sums.  G and x o dk would lose 8 bits if rounded once, which is 20x
//     the 1e-4 that h_final is held to: each goes in as a hi + lo bf16
//     pair (two products), so they keep ~16 bits.  C.h^T reads h rounded
//     once to bf16: its error is far below y's bf16 step, though it can
//     move y across a rounding boundary (one step from the plain version,
//     inside the 2e-2 tolerance while |y| < 4).  The state
//     itself stays in f32 registers across all chunks (32 floats a
//     thread); after each update the warps write bf16(h) to shared memory
//     for the next chunk's C.h^T.  L is kept in log2 units, exp as ex2.
//   - x, B and C of chunk c + 1 move by 16-byte cp.async into the second
//     stage of a double-buffered ring while chunk c computes (K2's K/V
//     pipeline); warp 0 loads la of chunk c + 1 into registers and scans
//     it with shuffles.  One __syncthreads a chunk: h and (L, dk) are
//     double-buffered too.  y is staged in the warp's own C rows of the
//     finished stage and stored as 16-byte rows.
//   - Shared memory: 2 stages of x, B, C and 2 of bf16 h, rows of 72
//     elements (16-byte padding: conflict-free ldmatrix), plus L and dk:
//     74,752 bytes, 3 blocks an SM.  P or N not a multiple of 8 (rows not
//     whole 16-byte vectors) take element copies instead of cp.async.
#pragma once

#include "tc_common.cuh"

namespace ssd {

using tc::bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;                 // steps a chunk tile; the largest Q, P, N
constexpr int S = TILE + 8;              // shared row stride, elements
constexpr int TILE_ELEMS = TILE * S;
constexpr unsigned FULL = 0xffffffffu;
// 2 stages x (x, B, C) + 2 buffers of h, bf16; 2 buffers of (L, dk), f32
constexpr size_t SMEM_BYTES = sizeof(bf16) * 8 * TILE_ELEMS + sizeof(float) * 4 * TILE;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as a hi + lo pair of packed bf16: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// A packed bf16 pair times (d.x, d.y), as a hi + lo pair.
__device__ __forceinline__ void scale_split(uint32_t v, float2 d, uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * d.x, f.y * d.y, hi, lo);
}

// VEC: P and N are multiples of 8, so tile rows are whole 16-byte vectors.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel_tc(const bf16* __restrict__ x, const float* __restrict__ la,
                   const bf16* __restrict__ Bc, const bf16* __restrict__ Cc,
                   const float* __restrict__ h0, bf16* __restrict__ y,
                   float* __restrict__ h_out, int T_len, int H, int P, int N, int Q) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);          // [stage][x, B, C][TILE][S]
  bf16* h_s = tiles + 6 * TILE_ELEMS;                         // [2][TILE (p)][S]
  float* L_s = reinterpret_cast<float*>(h_s + 2 * TILE_ELEMS);  // [2][TILE], log2 units
  float* dk_s = L_s + 2 * TILE;                               // [2][TILE]: 2^(L_last - L_i)

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = warp * 16;                                   // the warp's rows t and p
  const size_t row0 = size_t(b) * T_len;                      // (b, t = 0)
  const size_t h_off = (size_t(b) * H + hd) * P * N;
  const int n_chunks = (T_len + Q - 1) / Q;
  const bf16 zero = __float2bfloat16(0.f);

  auto load_tiles = [&](int c, int stage) {
    const int t0 = c * Q, qv = min(Q, T_len - t0);
    bf16* xs = tiles + 3 * stage * TILE_ELEMS;
    bf16* bs = xs + TILE_ELEMS;
    bf16* cs = bs + TILE_ELEMS;
    if constexpr (VEC) {
      const int v = (tid & 7) * 8;
#pragma unroll
      for (int r = tid >> 3; r < TILE; r += THREADS / 8) {
        const bool row = r < qv;
        const size_t t = row0 + t0 + (row ? r : 0);
        const bool xo = row && v < P, bo = row && v < N;
        cp_async16(xs + r * S + v, xo ? x + (t * H + hd) * P + v : x, xo);
        cp_async16(bs + r * S + v, bo ? Bc + t * N + v : Bc, bo);
        cp_async16(cs + r * S + v, bo ? Cc + t * N + v : Cc, bo);
      }
    } else {
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int r = e / TILE, col = e % TILE;
        const size_t t = row0 + t0 + r;
        const bool row = r < qv;
        xs[r * S + col] = row && col < P ? x[(t * H + hd) * P + col] : zero;
        bs[r * S + col] = row && col < N ? Bc[t * N + col] : zero;
        cs[r * S + col] = row && col < N ? Cc[t * N + col] : zero;
      }
    }
  };
  // la of chunk c, rows lane and lane + 32, into warp 0's registers
  float la0 = 0.f, la1 = 0.f;
  auto load_la = [&](int c) {
    const int t0 = c * Q, qv = min(Q, T_len - t0);
    la0 = lane < qv ? la[(row0 + t0 + lane) * H + hd] : 0.f;
    la1 = lane + 32 < qv ? la[(row0 + t0 + lane + 32) * H + hd] : 0.f;
  };

  // The state: rows p = r0 + g (e = 0, 1) and r0 + g + 8 (e = 2, 3),
  // columns n = 8 nt + t2 + (e & 1), in f32 for the whole scan.
  float hacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + g + 8 * (e >> 1), n = 8 * nt + t2 + (e & 1);
      hacc[nt][e] = h0 && p < P && n < N ? h0[h_off + size_t(p) * N + n] : 0.f;
    }
  auto store_h_bf16 = [&](bf16* hs) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(hs + (r0 + g) * S + 8 * nt + t2) =
          __floats2bfloat162_rn(hacc[nt][0], hacc[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(hs + (r0 + g + 8) * S + 8 * nt + t2) =
          __floats2bfloat162_rn(hacc[nt][2], hacc[nt][3]);
    }
  };
  store_h_bf16(h_s);

  if (n_chunks > 0) {
    load_tiles(0, 0);
    cp_async_commit();
    if (warp == 0) load_la(0);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    if (warp == 0) {               // inclusive scan of la (log2 units) over the tile
      float v0 = la0 * LOG2E, v1 = la1 * LOG2E;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(FULL, v0, o);
        const float u1 = __shfl_up_sync(FULL, v1, o);
        if (lane >= o) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(FULL, v0, 31);
      const float last = __shfl_sync(FULL, v1, 31);   // padded rows add 0
      L_s[st * TILE + lane] = v0;
      L_s[st * TILE + lane + 32] = v1;
      dk_s[st * TILE + lane] = ex2(last - v0);
      dk_s[st * TILE + lane + 32] = ex2(last - v1);
    }
    cp_async_wait<0>();
    __syncthreads();               // chunk c landed; L, dk and h of chunk c written;
                                   // every warp is past chunk c - 1
    if (c + 1 < n_chunks) {
      load_tiles(c + 1, st ^ 1);
      cp_async_commit();
      if (warp == 0) load_la(c + 1);
    }
    bf16* xs = tiles + 3 * st * TILE_ELEMS;
    bf16* bs = xs + TILE_ELEMS;
    bf16* cs = bs + TILE_ELEMS;
    const bf16* hs = h_s + st * TILE_ELEMS;
    const float* Lc = L_s + st * TILE;
    const float* dkc = dk_s + st * TILE;
    const float Lt0 = Lc[r0 + g], Lt1 = Lc[r0 + g + 8];

    // the warp's 16 rows of C as A fragments, for S and C.h^T
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(cf[kk], cs + (r0 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

    // y = 2^(L_t) (C.h^T): p in 8 tiles of 8
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    if (c > 0 || h0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t hb[4];
          ldsm_x4(hb, hs + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma(o[2 * jp], cf[kk], hb[0], hb[1]);
          mma(o[2 * jp + 1], cf[kk], hb[2], hb[3]);
        }
      const float e0 = ex2(Lt0), e1 = ex2(Lt1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= e0; o[n][1] *= e0;
        o[n][2] *= e1; o[n][3] *= e1;
      }
    }

    // S = C.B^T over the 16-key blocks kk <= warp (the others lie wholly
    // above the diagonal), then G = S o 2^(L_t - L_i) for i <= t, as hi +
    // lo A fragments
    uint32_t gh[4][4], gl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) continue;
      float s[2][4] = {};
#pragma unroll
      for (int kn = 0; kn < 4; ++kn) {
        uint32_t kb[4];
        ldsm_x4(kb, bs + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * S + kn * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[0], cf[kn], kb[0], kb[1]);
        mma(s[1], cf[kn], kb[2], kb[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = kk * 16 + 8 * h + t2, ta = r0 + g, tb = ta + 8;
        const float2 Li = *reinterpret_cast<const float2*>(Lc + i);
        const float g00 = i <= ta ? s[h][0] * ex2(Lt0 - Li.x) : 0.f;
        const float g01 = i + 1 <= ta ? s[h][1] * ex2(Lt0 - Li.y) : 0.f;
        const float g10 = i <= tb ? s[h][2] * ex2(Lt1 - Li.x) : 0.f;
        const float g11 = i + 1 <= tb ? s[h][3] * ex2(Lt1 - Li.y) : 0.f;
        split_bf16(g00, g01, gh[kk][2 * h], gl[kk][2 * h]);
        split_bf16(g10, g11, gh[kk][2 * h + 1], gl[kk][2 * h + 1]);
      }
    }

    // y += G.x: x rows i as the B operand (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) continue;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + np * 16 +
                              (lane >> 4) * 8);
        mma(o[2 * np], gh[kk], vb[0], vb[1]);
        mma(o[2 * np + 1], gh[kk], vb[2], vb[3]);
        mma(o[2 * np], gl[kk], vb[0], vb[1]);
        mma(o[2 * np + 1], gl[kk], vb[2], vb[3]);
      }
    }

    // y, rounded once, staged in the warp's own C rows (no other warp
    // reads them), then stored row by row
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(cs + (r0 + g) * S + 8 * n + t2) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (r0 + g + 8) * S + 8 * n + t2) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
    __syncwarp();
    {
      const int t0 = c * Q, qv = min(Q, T_len - t0);
      if constexpr (VEC) {
        const int v = (lane & 7) * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = r0 + (lane >> 3) + 4 * k;
          if (r < qv && v < P)
            *reinterpret_cast<uint4*>(y + ((row0 + t0 + r) * H + hd) * P + v) =
                *reinterpret_cast<const uint4*>(cs + r * S + v);
        }
      } else {
        for (int e = lane; e < 16 * TILE; e += 32) {
          const int r = r0 + e / TILE, col = e % TILE;
          if (r < qv && col < P) y[((row0 + t0 + r) * H + hd) * P + col] = cs[r * S + col];
        }
      }
    }

    // h = 2^(L_last) h + (x o dk)^T.B: the warp's state rows p; x^T by
    // ldmatrix.trans, scaled by dk_i and split into hi + lo in registers
    const float e_last = ex2(Lc[TILE - 1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] *= e_last;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xa[4], xh[4], xl[4];
      ldsm_x4_trans(xa, xs + (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * S + r0 +
                            ((lane >> 3) & 1) * 8);
      const float2 d0 = *reinterpret_cast<const float2*>(dkc + kk * 16 + t2);
      const float2 d1 = *reinterpret_cast<const float2*>(dkc + kk * 16 + 8 + t2);
      scale_split(xa[0], d0, xh[0], xl[0]);
      scale_split(xa[1], d0, xh[1], xl[1]);
      scale_split(xa[2], d1, xh[2], xl[2]);
      scale_split(xa[3], d1, xh[3], xl[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + np * 16 +
                              (lane >> 4) * 8);
        mma(hacc[2 * np], xh, bb[0], bb[1]);
        mma(hacc[2 * np + 1], xh, bb[2], bb[3]);
        mma(hacc[2 * np], xl, bb[0], bb[1]);
        mma(hacc[2 * np + 1], xl, bb[2], bb[3]);
      }
    }
    store_h_bf16(h_s + (st ^ 1) * TILE_ELEMS);   // read after the next sync
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + g + 8 * (e >> 1), n = 8 * nt + t2 + (e & 1);
      if (p < P && n < N) h_out[h_off + size_t(p) * N + n] = hacc[nt][e];
    }
}

inline int run_tc(const void* x, const void* la, const void* Bc, const void* Cc,
                  const void* h0, void* y, void* h_out, int B, int T_len, int H, int P,
                  int N, int Q, void* stream) {
  if (Q < 1 || Q > TILE || P < 1 || P > TILE || N < 1 || N > TILE)
    return int(cudaErrorInvalidValue);
  const auto kernel = P % 8 == 0 && N % 8 == 0 ? ssd_scan_kernel_tc<true>
                                               : ssd_scan_kernel_tc<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<dim3(H, B), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(la),
      static_cast<const bf16*>(Bc), static_cast<const bf16*>(Cc),
      static_cast<const float*>(h0), static_cast<bf16*>(y), static_cast<float*>(h_out),
      T_len, H, P, N, Q);
  return int(cudaGetLastError());
}

// Resident blocks an SM of the main-path instantiation (cudaOccupancy...).
inline int blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(ssd_scan_kernel_tc<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(SMEM_BYTES)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_scan_kernel_tc<true>, THREADS,
                                                    SMEM_BYTES) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace ssd
