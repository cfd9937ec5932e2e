// K3: ragged paged attention over int8 KV pages for Hopper (sm_90a),
// decode (C = 1) and chunked prefill (C > 1) in one kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention_int8.py
// (`paged_attention_int8`, body `_kernel`).  It computes K1's function
// over int8 code pages plus an f32 scale per (token, kv head), both
// following one page table: every key and value row is dequantized
// (code * scale, in f32) as its tile is staged, before both products.
// Masks, the online softmax, the GQA row folding and the empty-row rule
// are K1's (attention_common.cuh).
//
// What bounds it on an H100: like K1's decode it does ~4 flops per K/V
// element and is bound by bytes (3.35 TB/s) — but an element is one byte
// here plus 4 bytes of scale per 128-element row, 132 bytes per
// (token, head) instead of K1's 256 in bf16.  The design is K1's: each
// code is read once from device memory per block, 16 codes per 16-byte
// load, dequantized straight into the f32 shared tiles that the block's
// query rows share; the row's scale is one extra 4-byte load per 16
// codes.  Only the pages below ceil(kv_len / ps) are read; table entries
// past them may hold zeros or stale ids and are never touched.
//
// Layouts (the model's): q, out [B, C, H, d] f32 or bf16; code pages
// [N, ps, KV, d] int8; scales [N, ps, KV, 1] f32; block_table [B, Pmax],
// kv_lens [B], q_pos [B] int32.  d % 16 == 0, d <= 256.
#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(attn::THREADS)
paged_attention_int8_kernel(const T* __restrict__ q,
                            const int8_t* __restrict__ k_pages,
                            const float* __restrict__ k_scales,
                            const int8_t* __restrict__ v_pages,
                            const float* __restrict__ v_scales,
                            const int* __restrict__ block_table,
                            const int* __restrict__ kv_lens,
                            const int* __restrict__ q_pos, T* __restrict__ out,
                            int C, int H, int KV, int d, int N, int ps,
                            int Pmax, float scale, int window, float softcap) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  // keys past the table's last page do not exist (the reference gathers
  // exactly Pmax pages)
  const int kv_len = min(kv_lens[b], Pmax * ps);
  const attn::Q8Src<attn::PageRows> src{
      k_pages, v_pages, k_scales, v_scales,
      {block_table + size_t(b) * Pmax, ps, KV, kvh, N}, d};
  attn::attend_rows<T>(q, out, src, b, kvh, C, H, KV, d,
                       blockIdx.x * attn::WARPS, q_pos[b], kv_len, scale,
                       /*causal=*/1, window, softcap);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* k_scales,
        const void* v_pages, const void* v_scales, const void* block_table,
        const void* kv_lens, const void* q_pos, void* out, int B, int C, int H,
        int KV, int d, int N, int ps, int Pmax, float scale, int window,
        float softcap, void* stream) {
  const int rows = C * (H / KV);
  const dim3 grid((rows + attn::WARPS - 1) / attn::WARPS, KV, B);
  return attn::launch(paged_attention_int8_kernel<T>, grid, d, stream,
                      static_cast<const T*>(q),
                      static_cast<const int8_t*>(k_pages),
                      static_cast<const float*>(k_scales),
                      static_cast<const int8_t*>(v_pages),
                      static_cast<const float*>(v_scales),
                      static_cast<const int*>(block_table),
                      static_cast<const int*>(kv_lens),
                      static_cast<const int*>(q_pos), static_cast<T*>(out),
                      C, H, KV, d, N, ps, Pmax, scale, window, softcap);
}

}  // namespace

extern "C" int paged_attention_int8_f32(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* kv_lens, const void* q_pos, void* out, int B, int C, int H,
    int KV, int d, int N, int ps, int Pmax, float scale, int window,
    float softcap, void* stream) {
  return run<float>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                    kv_lens, q_pos, out, B, C, H, KV, d, N, ps, Pmax, scale,
                    window, softcap, stream);
}

extern "C" int paged_attention_int8_bf16(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* kv_lens, const void* q_pos, void* out, int B, int C, int H,
    int KV, int d, int N, int ps, int Pmax, float scale, int window,
    float softcap, void* stream) {
  return run<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales,
                            block_table, kv_lens, q_pos, out, B, C, H, KV, d,
                            N, ps, Pmax, scale, window, softcap, stream);
}
