// K1: ragged paged attention for Hopper (sm_90a), decode (C = 1) and
// chunked prefill (C > 1) in one kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, body `_kernel`).  It computes the same function:
// each sequence's keys are followed through its block table page by
// page, with an online softmax in f32, the G query heads of a kv head
// folded into C * G rows, masks kv_pos < kv_len and causal
// kv_pos <= q_pos + row / G, an optional window and tanh softcap.
//
// What bounds it on an H100: decode reads every K/V byte of the batch
// once and does 4 flops per element read, far below the card's ~295
// flops per byte, so it is bound by bytes (3.35 TB/s).  The design keeps
// each K/V element to one read from device memory per block: a tile of
// 32 keys is staged in shared memory with 16-byte loads by all four
// warps and shared by the block's query rows.  Only the pages below
// ceil(kv_len / ps) are read; table entries past them may hold zeros or
// stale ids and are never touched.  Split-KV for small batches, TMA and
// wgmma for chunks are later work.
//
// Layouts (the model's): q, out [B, C, H, d]; pages [N, ps, KV, d];
// block_table [B, Pmax], kv_lens [B], q_pos [B] int32.
#include "attention_common.cuh"

namespace {

template <typename T>
struct PagedSrc {
  const T* k;
  const T* v;
  const int* table;   // this sequence's block-table row
  int ps, KV, d, kvh, N;
  __device__ __forceinline__ size_t offset(int t) const {
    int page = table[t / ps];
    page = min(max(page, 0), N - 1);   // JAX clamps gather indices too
    return ((size_t(page) * ps + t % ps) * KV + kvh) * size_t(d);
  }
};

template <typename T>
__global__ void __launch_bounds__(attn::THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_pos, T* __restrict__ out,
                       int C, int H, int KV, int d, int N, int ps, int Pmax,
                       float scale, int window, float softcap) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  // keys past the table's last page do not exist (the reference gathers
  // exactly Pmax pages)
  const int kv_len = min(kv_lens[b], Pmax * ps);
  const PagedSrc<T> src{k_pages, v_pages, block_table + size_t(b) * Pmax,
                        ps, KV, d, kvh, N};
  attn::attend_rows<T>(q, out, src, b, kvh, C, H, KV, d,
                       blockIdx.x * attn::WARPS, q_pos[b], kv_len, scale,
                       /*causal=*/1, window, softcap);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* kv_lens, const void* q_pos,
        void* out, int B, int C, int H, int KV, int d, int N, int ps, int Pmax,
        float scale, int window, float softcap, void* stream) {
  const int rows = C * (H / KV);
  const dim3 grid((rows + attn::WARPS - 1) / attn::WARPS, KV, B);
  return attn::launch(paged_attention_kernel<T>, grid, d, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k_pages),
                      static_cast<const T*>(v_pages),
                      static_cast<const int*>(block_table),
                      static_cast<const int*>(kv_lens),
                      static_cast<const int*>(q_pos), static_cast<T*>(out),
                      C, H, KV, d, N, ps, Pmax, scale, window, softcap);
}

}  // namespace

extern "C" int paged_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* kv_lens, const void* q_pos, void* out,
    int B, int C, int H, int KV, int d, int N, int ps, int Pmax, float scale,
    int window, float softcap, void* stream) {
  return run<float>(q, k_pages, v_pages, block_table, kv_lens, q_pos, out, B,
                    C, H, KV, d, N, ps, Pmax, scale, window, softcap, stream);
}

extern "C" int paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* kv_lens, const void* q_pos, void* out,
    int B, int C, int H, int KV, int d, int N, int ps, int Pmax, float scale,
    int window, float softcap, void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, block_table, kv_lens, q_pos,
                            out, B, C, H, KV, d, N, ps, Pmax, scale, window,
                            softcap, stream);
}
