// K2: flash attention, forward, for Hopper (sm_90a) — the monolithic
// prompt prefill of `sequential` serving.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`).  It computes the same function:
// online softmax in f32 with the G query heads of a kv head folded into
// rows, masks kv_pos < kv_lens[b], causal kv_pos <= q_pos, an optional
// window and tanh softcap; query and key positions are their indices.
// Tiles wholly above the diagonal or outside the window are skipped, as
// the Pallas grid skips those blocks.
//
// What bounds it on an H100: a causal prompt of T tokens does ~2 T^2 d H
// flops over ~4 T d KV bytes of q/k/v/o, hundreds of flops per byte, so
// it is bound by operations (989 TFLOP/s on bf16 tensor cores).  This
// first kernel does its products on the CUDA cores in f32 (one warp per
// query row, keys staged in shared memory and shared by the block's
// warps), so it is far from that bound; wgmma tiles fed by TMA are the
// later step that closes the gap.
//
// Layouts (the model's): q, out [B, T, H, d]; k, v [B, Tk, KV, d];
// kv_lens [B] int32.
#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(attn::THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_lens,
                       T* __restrict__ out, int T_q, int Tk, int H, int KV,
                       int d, float scale, int causal, int window,
                       float softcap) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int kv_len = min(kv_lens[b], Tk);
  const attn::FpSrc<T, attn::DenseRows> src{
      k, v, {size_t(b) * Tk * KV + kvh, KV}, d};
  attn::attend_rows<T>(q, out, src, b, kvh, T_q, H, KV, d,
                       blockIdx.x * attn::WARPS, /*q_pos0=*/0, kv_len, scale,
                       causal, window, softcap);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* kv_lens,
        void* out, int B, int T_q, int Tk, int H, int KV, int d, float scale,
        int causal, int window, float softcap, void* stream) {
  const int rows = T_q * (H / KV);
  const dim3 grid((rows + attn::WARPS - 1) / attn::WARPS, KV, B);
  return attn::launch(flash_attention_kernel<T>, grid, d, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      static_cast<const int*>(kv_lens), static_cast<T*>(out),
                      T_q, Tk, H, KV, d, scale, causal, window, softcap);
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run<float>(q, k, v, kv_lens, out, B, T_q, Tk, H, KV, d, scale,
                    causal, window, softcap, stream);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, const void* kv_lens,
    void* out, int B, int T_q, int Tk, int H, int KV, int d, float scale,
    int causal, int window, float softcap, void* stream) {
  return run<__nv_bfloat16>(q, k, v, kv_lens, out, B, T_q, Tk, H, KV, d,
                            scale, causal, window, softcap, stream);
}
