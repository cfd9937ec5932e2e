// Device helpers of the bf16 tensor-core attention kernels: K2's
// (flash_attention.cu) and the paged tile loop of K1/K3 (paged_tiles.cuh).
//
// Blocks of 4 warps own 64 folded query rows (16 a warp); key tiles are 64
// keys, moved to shared memory by 16-byte cp.async; Q·K^T and P·V are
// mma.sync.m16n8k16 products (bf16 in, f32 accumulators) on ldmatrix
// fragments; the online softmax runs in f32 in log2 units with exp2 by
// ex2.approx.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_M = 16 * WARPS;  // folded query rows per block
constexpr int BLOCK_N = 64;          // keys per tile
constexpr float NEG_INF = -1e30f;    // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Q, then two stages of K and V, each row DP + 8 elements.
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * size_t(BLOCK_M + 4 * BLOCK_N) * (DP + 8);
}

// The padded head dim a bf16 call at head dim d runs at.
inline int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2**x in one MUFU op (relative error ~2**-22, far below P's bf16 step).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// First key query position c sees under the window, in 64 bits so that
// neither window = NO_WINDOW (2**30) nor a negative window overflows.
__device__ __forceinline__ int first_key(int c, int window) {
  return int(min(max(0LL, (long long)c - window + 1), 0x7fffffffLL));
}

// One key tile's softmax step for this thread's rows g and g + 8: S into
// log2 units (scale, then the softcap when CAPPED), masked per element
// when MASKED (keys outside [row_lo, row_hi)); then the online update of
// m, l and the O accumulators.  Leaves P (f32) in s.  Both flags are
// compile-time, so a tile every row sees whole pays for no mask and a
// call without softcap for no tanh.
template <bool CAPPED, bool MASKED, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&o)[NO][4],
                                             float (&m)[2], float (&l)[2], float s_mul,
                                             float cap_mul, int t0, int t2,
                                             const int (&row_lo)[2], const int (&row_hi)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * s_mul;
      if constexpr (CAPPED) x = tanhf(x) * cap_mul;
      if constexpr (MASKED) {
        const int t = t0 + 8 * j + t2 + (e & 1), h = e >> 1;
        if (t < row_lo[h] || t >= row_hi[h]) x = NEG_INF;
      }
      s[j][e] = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = ex2(m[h] - mx);
    m[h] = mx;
    // nothing visible yet: masked exponents stay -1e30, so p = 0
    const float base = mx == NEG_INF ? 0.f : mx;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][2 * h + e] = ex2(s[j][2 * h + e] - base);
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

}  // namespace tc
