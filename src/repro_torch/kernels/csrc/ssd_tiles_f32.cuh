// K4's f32 path on Hopper's tensor cores: the Mamba2 SSD chunk scan with
// its four products in 3xTF32 on mma.sync (ssd_scan.cu's ssd_scan_f32
// launches it; ssd_scan.cu's note gives the function and what bounds the
// kernel).
//
// Design (ssd_tiles.cuh's structure, K4's backward's products):
//   - One block of 4 warps per (head, batch row) walks the chunks in
//     order, the loop that replaces Pallas's sequential grid axis.  Every
//     chunk is a 64-row tile; rows past the chunk or past T, and columns
//     past P or N, are zero-filled (x = B = C = 0, la = 0), so a chunk
//     below 64, a ragged last chunk and P, N < 64 need no other path.
//   - Warp w owns the steps t in [16w, 16w + 16) of the chunk (y's rows)
//     and the state rows p in [16w, 16w + 16).  The state stays in f32
//     registers for the whole scan (32 floats a thread); after each
//     update the warps write it to shared memory, where C.h^T reads all
//     of its rows.
//   - The products, each tf32::warp_mma (3xTF32 on mma.sync.m16n8k8, hi
//     by split_fast, chains of at most CHAIN = 4 8-wide steps summed in
//     fresh accumulators and added by FADD, the next step's fragments
//     loaded while a step's products run):
//       y  = 2^(L_t) (C.h^T)                 A: C rows, B: h rows
//       h  = 2^(L_last) h + (x o dk)^T.B     A: x^T scaled, B: B's rows
//       S  = C.B^T                           A: C rows, B: B rows
//       y += G.x, G = S o 2^(L_t - L_i)      A: G, B: x's rows
//     G is formed in S's accumulators, only where i <= t (above the
//     diagonal the exponent can overflow), and goes through the warp's
//     own rows of the C tile (read by no other warp, and done with) in
//     fragment order, so G.x's k loop runs at run time; its steps stop at
//     the warp's last row.  An accumulator's column pairs (2tq, 2tq + 1)
//     are an A fragment when k is taken in the order 2tq, 2tq + 1 for tq,
//     tq + 4 and B's rows are read in the same order; (x o dk)^T.B reads
//     both operands that way.  Each chunk's state update is summed in its
//     own chains and added to the state by FADD (mma.sync sums f32 less
//     finely than an FADD, and h_final is held to 1e-4 after 16 chunks).
//     L is kept in log2 units, every exponential an ex2.
//   - x, B and C of chunk c + 1 move by 16-byte cp.async into the second
//     stage of a double buffer while chunk c computes; warp 0 loads la of
//     chunk c + 1 into registers and scans it with shuffles.  Two
//     __syncthreads a chunk: one before the chunk's tiles are read, one
//     between the last read of h (C.h^T) and its update, since h has one
//     buffer.  y is stored from the accumulators, 8 bytes a lane (a quad
//     writes 32 contiguous bytes of a row).
//   - Shared memory: 2 stages of x, B and C and one tile of h, 64 x 64
//     floats each, unpadded, with the 16-byte column groups of row r
//     XORed by r % 8 (the fragment reads, rows g and columns tq, or rows
//     2tq and columns g, hit 32 distinct banks), plus two buffers of L and
//     dk: 115,712 bytes, 2 blocks an SM (tf32::min_blocks).  P or N not a
//     multiple of 8 takes element copies instead of cp.async.
#pragma once

#include "tf32_common.cuh"

namespace ssd_f32 {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;                 // steps a chunk tile; the largest Q, P, N
constexpr int TILE_FLOATS = TILE * TILE;
constexpr unsigned FULL = 0xffffffffu;
// 2 stages x (x, B, C) + h; 2 buffers of (L, dk)
constexpr size_t SMEM_BYTES = sizeof(float) * (7 * TILE_FLOATS + 4 * TILE);

// Where element (r, c) of a tile lies: the 16-byte group c / 4 XORed by r % 8.
__device__ __forceinline__ int sw(int r, int c) {
  return r * TILE + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// VEC: P and N are multiples of 8 (rows of whole 16-byte vectors).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, tf32::min_blocks(SMEM_BYTES))
ssd_scan_kernel_f32(const float* __restrict__ x, const float* __restrict__ la,
                    const float* __restrict__ Bc, const float* __restrict__ Cc,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, int T_len, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                          // [stage][x, B, C][TILE * TILE]
  float* h_s = tiles + 6 * TILE_FLOATS;         // [TILE (p)][TILE (n)]
  float* L_s = h_s + TILE_FLOATS;               // [2][TILE], log2 units
  float* dk_s = L_s + 2 * TILE;                 // [2][TILE]: 2^(L_last - L_i)

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, t2 = 2 * tq;
  const int r0 = warp * 16;                     // the warp's rows t and p
  const size_t row0 = size_t(b) * T_len;        // (b, t = 0)
  const size_t h_off = (size_t(b) * H + hd) * P * N;
  const int n_chunks = (T_len + Q - 1) / Q;
  const int kn = (N + 7) / 8;

  auto load_tiles = [&](int c, int stage) {
    const int t0 = c * Q, qv = min(Q, T_len - t0);
    float* xs = tiles + 3 * stage * TILE_FLOATS;
    float* bs = xs + TILE_FLOATS;
    float* cs = bs + TILE_FLOATS;
    if constexpr (VEC) {
      for (int e = tid; e < TILE * TILE / 4; e += THREADS) {
        const int r = e >> 4, v = (e & 15) * 4;
        const bool row = r < qv;
        const size_t t = row0 + t0 + (row ? r : 0);
        const bool xo = row && v < P, bo = row && v < N;
        const int d = sw(r, v);
        tc::cp_async16(xs + d, xo ? x + (t * H + hd) * P + v : x, xo);
        tc::cp_async16(bs + d, bo ? Bc + t * N + v : Bc, bo);
        tc::cp_async16(cs + d, bo ? Cc + t * N + v : Cc, bo);
      }
    } else {
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int r = e >> 6, col = e & (TILE - 1);
        const size_t t = row0 + t0 + r;
        const bool row = r < qv;
        const int d = sw(r, col);
        xs[d] = row && col < P ? x[(t * H + hd) * P + col] : 0.f;
        bs[d] = row && col < N ? Bc[t * N + col] : 0.f;
        cs[d] = row && col < N ? Cc[t * N + col] : 0.f;
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

  // Fragment loaders as f32 (kk: the 8-wide step, i: the n fragment).
  // Rows g and g + 8 of the warp's 16 (r0 + g has r0 + g % 8 = g), columns
  // 8 kk + tq and + 4: A from a row-major [m][k] tile, or B from an [n][k]
  // tile (B[k][n] = tile[n][k]) with rows 8 i + g.
  auto col_tq = [&](int kk) { return (((2 * kk) ^ g) << 2) + tq; };
  auto a_rows = [&](const float* tile) {
    return [=](int kk, float (&a)[4]) {
      const int c0 = col_tq(kk), c1 = c0 ^ 4;
      const float* p = tile + (r0 + g) * TILE;
      a[0] = p[c0];
      a[1] = p[8 * TILE + c0];
      a[2] = p[c1];
      a[3] = p[8 * TILE + c1];
    };
  };
  auto b_rows = [&](const float* tile) {
    return [=](int kk, int i, float (&v)[2]) {
      const int c0 = col_tq(kk);
      const float* p = tile + (8 * i + g) * TILE;
      v[0] = p[c0];
      v[1] = p[c0 ^ 4];
    };
  };
  // B from a [k][n] tile, k in pair order: rows 8 kk + 2tq and + 1, column
  // 8 i + g (its group 2i + g / 4 XORed by 2tq, and by 2tq + 1).
  auto b_pairs = [&](const float* tile) {
    return [=](int kk, int i, float (&v)[2]) {
      const float* p = tile + (8 * kk + t2) * TILE + 8 * (i ^ tq);
      v[0] = p[g];
      v[1] = p[TILE + (g ^ 4)];
    };
  };
  // G's A fragments, kept by each thread in the warp's own C rows
  auto a_stash = [&](const float* slots) {
    return [=](int kk, float (&a)[4]) {
      const float4 v = *reinterpret_cast<const float4*>(slots + (kk * 32 + lane) * 4);
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    };
  };

  // The state: rows p = r0 + g (e = 0, 1) and r0 + g + 8 (e = 2, 3),
  // columns n = 8 nt + 2tq + (e & 1), in f32 for the whole scan.
  float hacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + g + 8 * (e >> 1), n = 8 * nt + t2 + (e & 1);
      hacc[nt][e] = h0 && p < P && n < N ? h0[h_off + size_t(p) * N + n] : 0.f;
    }
  auto store_h = [&]() {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<float2*>(h_s + sw(r0 + g, 8 * nt + t2)) =
          make_float2(hacc[nt][0], hacc[nt][1]);
      *reinterpret_cast<float2*>(h_s + sw(r0 + g + 8, 8 * nt + t2)) =
          make_float2(hacc[nt][2], hacc[nt][3]);
    }
  };
  store_h();

  if (n_chunks > 0) {
    load_tiles(0, 0);
    tc::cp_async_commit();
    if (warp == 0) load_la(0);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    const int t0 = c * Q, qv = min(Q, T_len - t0), kq = (qv + 7) / 8;
    if (warp == 0) {               // inclusive scan of la (log2 units) over the tile
      float v0 = la0 * tc::LOG2E, v1 = la1 * tc::LOG2E;
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
      dk_s[st * TILE + lane] = tc::ex2(last - v0);
      dk_s[st * TILE + lane + 32] = tc::ex2(last - v1);
    }
    tc::cp_async_wait<0>();
    __syncthreads();               // chunk c landed; L, dk and h of chunk c written;
                                   // every warp is past chunk c - 1
    if (c + 1 < n_chunks) {
      load_tiles(c + 1, st ^ 1);
      tc::cp_async_commit();
      if (warp == 0) load_la(c + 1);
    }
    const float* xs = tiles + 3 * st * TILE_FLOATS;
    const float* bs = xs + TILE_FLOATS;
    float* cs = tiles + (3 * st + 2) * TILE_FLOATS;
    const float* Lc = L_s + st * TILE;
    const float* dkc = dk_s + st * TILE;
    const float Lt0 = Lc[r0 + g], Lt1 = Lc[r0 + g + 8];

    // y = 2^(L_t) (C.h^T): p in 8 fragments
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    if (c > 0 || h0) {
      tf32::warp_mma<8, false, false>(o, 0, kn, a_rows(cs), b_rows(h_s));
      const float e0 = tc::ex2(Lt0), e1 = tc::ex2(Lt1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= e0; o[n][1] *= e0;
        o[n][2] *= e1; o[n][3] *= e1;
      }
    }
    __syncthreads();               // every read of h done

    // h = 2^(L_last) h + (x o dk)^T.B: the warp's state rows p, k = i in
    // pair order on both sides; then h for the next chunk's C.h^T
    {
      const float e_last = tc::ex2(Lc[TILE - 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= e_last;
      const int q0 = 8 * ((2 * warp) ^ tq), q1 = 8 * ((2 * warp + 1) ^ tq);
      tf32::warp_mma<8, false, false>(
          hacc, 0, kq,
          [&](int kk, float (&a)[4]) {
            const int i = 8 * kk + t2;
            const float2 d = *reinterpret_cast<const float2*>(dkc + i);
            const float* p = xs + i * TILE;
            a[0] = d.x * p[q0 + g];
            a[1] = d.x * p[q1 + g];
            a[2] = d.y * p[TILE + q0 + (g ^ 4)];
            a[3] = d.y * p[TILE + q1 + (g ^ 4)];
          },
          b_pairs(bs));
      store_h();                   // read after the next chunk's first sync
    }

    // S = C.B^T, then G = S o 2^(L_t - L_i) where i <= t (else 0)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    tf32::warp_mma<8, false, false>(s, 0, kn, a_rows(cs), b_rows(bs));
    const int ta = r0 + g, tb = ta + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 8 * j + t2;
      const float2 Li = *reinterpret_cast<const float2*>(Lc + i);
      s[j][0] = i <= ta ? s[j][0] * tc::ex2(Lt0 - Li.x) : 0.f;
      s[j][1] = i + 1 <= ta ? s[j][1] * tc::ex2(Lt0 - Li.y) : 0.f;
      s[j][2] = i <= tb ? s[j][2] * tc::ex2(Lt1 - Li.x) : 0.f;
      s[j][3] = i + 1 <= tb ? s[j][3] * tc::ex2(Lt1 - Li.y) : 0.f;
    }
    // G into this thread's slots in the warp's C rows (every lane is done
    // reading them), as A fragments with k in pair order
    float* slots = cs + r0 * TILE;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(slots + (j * 32 + lane) * 4) =
          make_float4(s[j][0], s[j][2], s[j][1], s[j][3]);

    // y += G.x over the keys i up to the warp's last row
    tf32::warp_mma<8, false, false>(o, 0, min(2 * warp + 2, kq), a_stash(slots), b_pairs(xs));

    // y, rows t < q_valid and columns p < P
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r0 + g + 8 * h;
      if (t >= qv) continue;
      float* yr = y + ((row0 + t0 + t) * H + hd) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + t2;
        if (p >= P) continue;
        if constexpr (VEC) {
          *reinterpret_cast<float2*>(yr + p) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
        } else {
          yr[p] = o[j][2 * h];
          if (p + 1 < P) yr[p + 1] = o[j][2 * h + 1];
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + g + 8 * (e >> 1), n = 8 * nt + t2 + (e & 1);
      if (p < P && n < N) h_out[h_off + size_t(p) * N + n] = hacc[nt][e];
    }
}

inline int run(const void* x, const void* la, const void* Bc, const void* Cc, const void* h0,
               void* y, void* h_out, int B, int T_len, int H, int P, int N, int Q,
               void* stream) {
  if (Q < 1 || Q > TILE || P < 1 || P > TILE || N < 1 || N > TILE)
    return int(cudaErrorInvalidValue);
  const auto kernel = P % 8 == 0 && N % 8 == 0 ? ssd_scan_kernel_f32<true>
                                               : ssd_scan_kernel_f32<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (e != cudaSuccess) return int(e);
  kernel<<<dim3(H, B), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(la),
      static_cast<const float*>(Bc), static_cast<const float*>(Cc),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out),
      T_len, H, P, N, Q);
  return int(cudaGetLastError());
}

// Resident blocks an SM of the main path's instantiation (VEC), or -1.
inline int blocks_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(ssd_scan_kernel_f32<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(SMEM_BYTES)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_scan_kernel_f32<true>, THREADS,
                                                    SMEM_BYTES) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace ssd_f32
