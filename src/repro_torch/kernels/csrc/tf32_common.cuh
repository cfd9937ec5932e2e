// Device helpers of the f32 tensor-core kernels: products in 3xTF32 on
// mma.sync.m16n8k8, the online softmax over key tiles of any multiple of
// 8 keys (K2's flash_attention.cu, K1/K3's paged_tiles_f32.cuh), and
// warp_mma, a warp's product in chains of CHAIN steps (K4's
// ssd_tiles_f32.cuh and ssd_scan_bwd.cuh).
//
// 3xTF32: the tensor cores read only the top 19 bits (sign, 8 exponent,
// 10 mantissa) of a 32-bit operand, so each f32 operand x is split
// explicitly into hi = tf32(x) and lo = tf32(x - hi) (both rounded to
// nearest, cvt.rna) and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated in f32: relative error ~2^-21 a product (the dropped
// a_lo b_lo is ~2^-22), where one TF32 pass keeps ~2^-11.
//
// The cp.async copies, ex2, first_key and the constants are tc_common.cuh's.
#pragma once

#include "tc_common.cuh"

namespace tf32 {

using tc::LN2;
using tc::LOG2E;
using tc::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_M = 16 * WARPS;  // folded query rows per block

// Keys a tile at padded head dim DP.  Dynamic shared memory holds the f32
// Q tile and two stages of K and V, rows of DP + 4 floats: 87,040 B at
// DP = 64 with 64-key tiles, 101,376 B at DP = 128 with 32-key tiles (two
// blocks an SM; 64-key tiles would take 168,960 B and one), 199,680 B at
// DP = 256.
template <int DP>
__host__ __device__ constexpr int block_n() { return DP <= 64 ? 64 : 32; }

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * size_t(BLOCK_M + 4 * block_n<DP>()) * (DP + 4);
}

// Blocks an SM holds by shared memory (233,472 B, 1 KB reserved a block),
// at most 2: the f32 kernels' __launch_bounds__ minimum, so ptxas may take
// the registers those blocks leave (255 a thread) rather than spill to
// reach an occupancy the shared memory does not allow (at 4 blocks, DP =
// 32's 128 registers a thread spilled).
__host__ __device__ constexpr int min_blocks(size_t smem) {
  return smem + 1024 <= 233472 / 2 ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr int min_blocks() {
  return min_blocks(smem_bytes<DP>());
}

// x rounded to nearest into TF32 (the low 13 bits zero), as a b32 operand.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo as two TF32 operands without a conversion instruction: hi
// is x rounded to nearest, ties away from zero, to TF32 by integer ops
// (cvt.rna's rounding, for finite x) and lo = x - hi, exact in f32, is
// passed whole: mma.sync reads a .tf32 operand's top 19 bits, so lo is
// truncated there (at most 2^-10 of lo, 2^-21 of x; cvt.rna would keep
// 2^-22).  Every operand of every product is split, several times over
// (each warp splits the K and V fragments it reads): split takes two cvt.rna
// a value, this an integer add, an AND and an FADD.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col): TF32 in, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small terms first, then hi * hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(c, a_lo, b_hi[0], b_hi[1]);
  mma(c, a_hi, b_lo[0], b_lo[1]);
  mma(c, a_hi, b_hi[0], b_hi[1]);
}

// c[i] += a * b[i] in 3xTF32 for the four fragments i < n, one
// pass of each term over them before the next: independent products
// between each mma.sync and the one that adds to the same fragment.
__device__ __forceinline__ void mma3_x4(float (&c)[4][4], int n, const uint32_t (&a_hi)[4],
                                        const uint32_t (&a_lo)[4],
                                        const uint32_t (&b_hi)[4][2],
                                        const uint32_t (&b_lo)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) mma(c[i], a_lo, b_hi[i][0], b_hi[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) mma(c[i], a_hi, b_lo[i][0], b_lo[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) mma(c[i], a_hi, b_hi[i][0], b_hi[i][1]);
}

constexpr int CHAIN = 4;  // steps an mma.sync chain sums (warp_mma)

// v as an mma.sync operand: hi (+ lo) unless it is EXACT in TF32 already.
template <bool EXACT>
__device__ __forceinline__ void operand(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    split_fast(v, hi, lo);
  }
}

// acc[i] += A.B for the NF n fragments i over the 8-wide steps kk in
// [k_lo, k_hi) (<= 8): the steps in chains of CHAIN summed by mma.sync in
// fresh accumulators and added to acc by the CUDA cores.  fa(kk, a) gives
// this thread's A fragment of step kk as f32, fb(kk, i, b) its B fragment
// of step kk and n fragment i; AX / BX: that operand is exact in TF32 (its
// lo terms are skipped).  Step kk + 1's fragments are loaded while step
// kk's products run, and each pass of a step runs over all the n
// fragments before the next, so no mma.sync waits on the one before it.
// Every n fragment is computed (tiles are zero past P, N and the chunk),
// so no run-time test stands between the mma.syncs, and the steps loop
// at run time, which keeps the kernel small enough for the instruction
// cache (unrolled, K4's backward's ten products were not).
template <int NF, bool AX, bool BX, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NF][4], int k_lo, int k_hi, FA fa, FB fb) {
  if (k_lo >= k_hi) return;
  float ra[4], rb[NF][2];
  fa(k_lo, ra);
#pragma unroll
  for (int i = 0; i < NF; ++i) fb(k_lo, i, rb[i]);
#pragma unroll 1
  for (int k0 = k_lo; k0 < k_hi; k0 += CHAIN) {
    float part[NF][4];
#pragma unroll
    for (int i = 0; i < NF; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
    const int k1 = min(k0 + CHAIN, k_hi);
#pragma unroll 1
    for (int kk = k0; kk < k1; ++kk) {
      uint32_t ah[4], al[4], bh[NF][2], bl[NF][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) operand<AX>(ra[e], ah[e], al[e]);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        operand<BX>(rb[i][0], bh[i][0], bl[i][0]);
        operand<BX>(rb[i][1], bh[i][1], bl[i][1]);
      }
      const int knext = min(kk + 1, k_hi - 1);   // the last step loads itself again
      fa(knext, ra);
#pragma unroll
      for (int i = 0; i < NF; ++i) fb(knext, i, rb[i]);
      if constexpr (!AX) {
#pragma unroll
        for (int i = 0; i < NF; ++i) mma(part[i], al, bh[i][0], bh[i][1]);
      }
      if constexpr (!BX) {
#pragma unroll
        for (int i = 0; i < NF; ++i) mma(part[i], ah, bl[i][0], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NF; ++i) mma(part[i], ah, bh[i][0], bh[i][1]);
    }
#pragma unroll
    for (int i = 0; i < NF; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  }
}

// One key tile's softmax step for this thread's rows g and g + 8, over NJ
// fragments of 8 keys: tc::softmax_tile's arithmetic (S into log2 units,
// softcap when CAPPED, per-element masks when MASKED, then the online
// update of m, l and the NO output fragments) at any tile width.  When
// MASKED, fragment j counts only if bit j of `own` is set (the fragments
// of a split key tile this warp takes).  Leaves P (f32) in s.
template <bool CAPPED, bool MASKED, int NJ, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NJ][4], float (&o)[NO][4],
                                             float (&m)[2], float (&l)[2], float s_mul,
                                             float cap_mul, int t0, int t2, unsigned own,
                                             const int (&row_lo)[2], const int (&row_hi)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * s_mul;
      if constexpr (CAPPED) x = tanhf(x) * cap_mul;
      if constexpr (MASKED) {
        const int t = t0 + 8 * j + t2 + (e & 1), h = e >> 1;
        if (!(own >> j & 1) || t < row_lo[h] || t >= row_hi[h]) x = NEG_INF;
      }
      s[j][e] = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = tc::ex2(m[h] - mx);
    m[h] = mx;
    // nothing visible yet: masked exponents stay -1e30, so p = 0
    const float base = mx == NEG_INF ? 0.f : mx;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][2 * h + e] = tc::ex2(s[j][2 * h + e] - base);
        sum[e] += s[j][2 * h + e];
      }
    }
    l[h] = l[h] * corr + (sum[0] + sum[1]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * h] *= corr;
      o[n][2 * h + 1] *= corr;
    }
  }
}

}  // namespace tf32
