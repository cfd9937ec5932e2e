// Helpers shared by the paged attention kernels of K1 (paged_attention.cu)
// and K3 (paged_attention_int8.cu): the split-KV decode (paged_decode.cuh)
// and the chunk tile loops (paged_tiles.cuh, paged_tiles_f32.cuh).
//
// Query rows fold the G query heads of a kv head, as the Pallas kernels
// do: flattened row r = c * G + g is query position c, head kvh * G + g.
// Layouts are the model's, so no transpose is needed around a launch:
//   q, out [B, C, H, d]   (H = KV * G)
// Keys are followed through a sequence's block table (PageRows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// (token, kv head) row index of key position t in one sequence's pages.
// Only the pages below ceil(kv_len / ps) are looked up; page ids are
// clamped into the pool, as JAX clamps gather indices.
struct PageRows {
  const int* table;   // this sequence's block-table row
  int ps, KV, kvh, N;
  __device__ __forceinline__ size_t row(int t) const {
    int page = table[t / ps];
    page = min(max(page, 0), N - 1);
    return (size_t(page) * ps + t % ps) * KV + kvh;
  }
};

}  // namespace attn
