// K3: ragged paged attention over int8 KV pages for Hopper (sm_90a),
// decode (C = 1) and chunked prefill (C > 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention_int8.py
// (`paged_attention_int8`, body `_kernel`).  It computes K1's function
// over int8 code pages plus an f32 scale per (token, kv head), both
// following one page table; the Pallas kernel dequantizes every key and
// value row (code * scale, in f32) before both products, and the decode
// and f32 chunk loops below take the products on the codes and fold the
// scales in.  Masks, the online softmax, the GQA row folding and the
// empty-row rule are K1's.
//
// Three loops, as in K1:
//   - Decode (C = 1), f32 and bf16 q: K1's split-KV kernel
//     (paged_decode.cuh) with the Q8Rows loader
//     (paged_attention_int8_decode_kernel, then
//     paged_attention_int8_decode_combine_kernel when a row's keys are
//     split), behind the C entries paged_attention_int8_decode_{f32,bf16}.
//     Like K1's decode it does ~4 flops per K/V element and is bound by
//     bytes (3.35 TB/s), but an element is one byte here plus 4 bytes of
//     scale per row, 132 bytes per (token, head) at d = 128 instead of
//     K1's 256 in bf16.  A lane loads 16 codes a vector; the dot product
//     is taken on the codes and scaled once per key, and each scale is
//     read once per key row.
//   - f32 chunks (C > 1): K1's paged tile loop in f32 (paged_tiles_f32.cuh,
//     paged_attention_int8_kernel_f32) with the Q8Tiles loader: codes and
//     scales double-buffered by cp.async, a pass writes the codes unscaled
//     into an f32 tile, and as a code is exact in TF32 each product is
//     two TF32 passes, not three: S_t = k_scale[t] ((q_hi + q_lo) code_t),
//     o = sum_t (p_t v_scale[t]) code_t with the folded P split hi/lo; the
//     key split and its combine are K1's.
//   - bf16 chunks (C > 1): K1's paged tensor-core tile loop
//     (paged_tiles.cuh, paged_attention_int8_kernel_tc) with the Q8Tiles
//     loader: raw codes and scales are double-buffered by cp.async, and a
//     conversion pass writes code * scale (f32, rounded to bf16) into the
//     bf16 tiles the mma.sync products read.
// Only the pages below ceil(kv_len / ps) are read; table entries past
// them may hold zeros or stale ids and are never touched.
//
// Layouts (the model's): q, out [B, C, H, d] f32 or bf16; code pages
// [N, ps, KV, d] int8; scales [N, ps, KV, 1] f32; block_table [B, Pmax],
// kv_lens [B], q_pos [B] int32.  d % 16 == 0, d <= 256.
#include "paged_decode.cuh"
#include "paged_tiles.cuh"
#include "paged_tiles_f32.cuh"

namespace {

// bf16 chunks on the tensor cores (paged_tiles.cuh).
template <int DP, bool CAPPED>
__global__ void __launch_bounds__(tc::THREADS, DP <= 128 ? 2 : 1)
paged_attention_int8_kernel_tc(const tc::bf16* __restrict__ q,
                               const int8_t* __restrict__ k_pages,
                               const float* __restrict__ k_scales,
                               const int8_t* __restrict__ v_pages,
                               const float* __restrict__ v_scales,
                               const int* __restrict__ block_table,
                               const int* __restrict__ kv_lens,
                               const int* __restrict__ q_pos, tc::bf16* __restrict__ out,
                               int C, int H, int KV, int d, int N, int ps, int Pmax,
                               float scale, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* q_s = reinterpret_cast<tc::bf16*>(smem_raw);
  const paged_tc::BlockTile at = paged_tc::block_tile(C * (H / KV), KV);
  const paged_tc::Q8Tiles<DP> tiles{
      k_pages, v_pages, k_scales, v_scales,
      {block_table + size_t(at.b) * Pmax, ps, KV, at.kvh, N}, d,
      reinterpret_cast<tc::bf16*>(smem_raw + paged_tc::q_bytes<DP>())};
  const int kv_len = max(0, min(kv_lens[at.b], Pmax * ps));
  paged_tc::attend<DP, CAPPED>(tiles, at, q_s, q, out, kv_len, q_pos[at.b], C, H, KV, d,
                               scale, window, softcap);
}

template <int DP>
constexpr size_t smem_tc() {
  return paged_tc::q_bytes<DP>() + paged_tc::Q8Tiles<DP>::bytes;
}

template <int DP>
int run_tc(const void* q, const void* k_pages, const void* k_scales,
           const void* v_pages, const void* v_scales, const void* block_table,
           const void* kv_lens, const void* q_pos, void* out, int B, int C, int H,
           int KV, int d, int N, int ps, int Pmax, float scale, int window,
           float softcap, void* stream) {
  const auto kernel = softcap > 0.f ? paged_attention_int8_kernel_tc<DP, true>
                                    : paged_attention_int8_kernel_tc<DP, false>;
  return paged_tc::launch(kernel, smem_tc<DP>(), B, C, H, KV, stream,
                          static_cast<const tc::bf16*>(q),
                          static_cast<const int8_t*>(k_pages),
                          static_cast<const float*>(k_scales),
                          static_cast<const int8_t*>(v_pages),
                          static_cast<const float*>(v_scales),
                          static_cast<const int*>(block_table),
                          static_cast<const int*>(kv_lens),
                          static_cast<const int*>(q_pos), static_cast<tc::bf16*>(out),
                          C, H, KV, d, N, ps, Pmax, scale, window, softcap);
}

// Decode (C = 1), f32 and bf16 q: the split-KV kernel over int8 rows and
// its combine (paged_decode.cuh).  A lane holds 16 elements of each of
// GR query rows and accumulators here (8 for fp pages), ~136 registers at
// GR = 2: the minimum of 3 blocks an SM lets ptxas use them (up to 168)
// instead of spilling to reach 4 blocks at 128.
template <typename T, int GR>
__global__ void __launch_bounds__(pdec::THREADS, 3)
paged_attention_int8_decode_kernel(const T* __restrict__ q,
                                   const int8_t* __restrict__ k_pages,
                                   const float* __restrict__ k_scales,
                                   const int8_t* __restrict__ v_pages,
                                   const float* __restrict__ v_scales,
                                   const int* __restrict__ block_table,
                                   const int* __restrict__ kv_lens,
                                   const int* __restrict__ q_pos, T* __restrict__ out,
                                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                                   int H, int KV, int d, int N, int ps, int Pmax, int S,
                                   int L, float scale, int window, float softcap) {
  pdec::attend_split<T, 1, GR>(pdec::Q8Rows{k_pages, v_pages, k_scales, v_scales}, q, out,
                               ws_acc, ws_ml, block_table, kv_lens, q_pos, H, KV, d, N,
                               ps, Pmax, S, L, scale, window, softcap);
}

template <typename T>
__global__ void __launch_bounds__(pdec::COMBINE_THREADS)
paged_attention_int8_decode_combine_kernel(const float* __restrict__ ws_acc,
                                           const float* __restrict__ ws_ml,
                                           T* __restrict__ out, int d, int S) {
  pdec::combine<T>(ws_acc, ws_ml, out, d, S);
}

template <typename T, int GR>
int run_decode_at(const void* q, const void* k_pages, const void* k_scales,
                  const void* v_pages, const void* v_scales, const void* block_table,
                  const void* kv_lens, const void* q_pos, void* out, void* ws_acc,
                  void* ws_ml, int B, int H, int KV, int d, int N, int ps, int Pmax, int S,
                  int L, float scale, int window, float softcap, void* stream) {
  float* acc = static_cast<float*>(ws_acc);
  float* ml = static_cast<float*>(ws_ml);
  return pdec::launch(paged_attention_int8_decode_kernel<T, GR>,
                      paged_attention_int8_decode_combine_kernel<T>, GR, B, H, KV, d, S,
                      acc, ml, static_cast<T*>(out), stream, static_cast<const T*>(q),
                      static_cast<const int8_t*>(k_pages),
                      static_cast<const float*>(k_scales),
                      static_cast<const int8_t*>(v_pages),
                      static_cast<const float*>(v_scales),
                      static_cast<const int*>(block_table),
                      static_cast<const int*>(kv_lens), static_cast<const int*>(q_pos),
                      static_cast<T*>(out), acc, ml, H, KV, d, N, ps, Pmax, S, L, scale,
                      window, softcap);
}

template <typename T>
int run_decode(const void* q, const void* k_pages, const void* k_scales,
               const void* v_pages, const void* v_scales, const void* block_table,
               const void* kv_lens, const void* q_pos, void* out, void* ws_acc,
               void* ws_ml, int B, int H, int KV, int d, int N, int ps, int Pmax, int S,
               int L, float scale, int window, float softcap, void* stream) {
  if (pdec::bad_split(ps, Pmax, S, L, ws_acc, ws_ml)) return int(cudaErrorInvalidValue);
  const int gr = pdec::rows_per_pass(H / KV, pdec::Q8Rows::EPV);
  auto* fn = gr == 1 ? &run_decode_at<T, 1> : &run_decode_at<T, 2>;
  return fn(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens, q_pos, out,
            ws_acc, ws_ml, B, H, KV, d, N, ps, Pmax, S, L, scale, window, softcap, stream);
}

// f32 chunks on the tensor cores, two TF32 passes on the codes
// (paged_tiles_f32.cuh).
template <int DP, bool CAPPED>
__global__ void __launch_bounds__(
    tf32::THREADS,
    tf32::min_blocks(sizeof(float) * paged_f32::q_floats<DP>() +
                     paged_f32::Q8Tiles<DP>::bytes))
paged_attention_int8_kernel_f32(const float* __restrict__ q,
                                const int8_t* __restrict__ k_pages,
                                const float* __restrict__ k_scales,
                                const int8_t* __restrict__ v_pages,
                                const float* __restrict__ v_scales,
                                const int* __restrict__ block_table,
                                const int* __restrict__ kv_lens,
                                const int* __restrict__ q_pos, float* __restrict__ out,
                                float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                                int C, int H, int KV, int d, int N, int ps, int Pmax, int S,
                                int L, float scale, int window, float softcap) {
  extern __shared__ __align__(16) float smem_f32[];
  const paged_f32::BlockTile at = paged_f32::block_tile(C * (H / KV), KV, S);
  const paged_f32::Q8Tiles<DP> tiles{
      k_pages, v_pages, k_scales, v_scales,
      {block_table + size_t(at.b) * Pmax, ps, KV, at.kvh, N}, d,
      smem_f32 + paged_f32::q_floats<DP>()};
  const int kv_len = max(0, min(kv_lens[at.b], Pmax * ps));
  paged_f32::attend<DP, CAPPED>(tiles, at, smem_f32, q, out, ws_acc, ws_ml, kv_len,
                                q_pos[at.b], C, H, KV, d, S, L, scale, window, softcap);
}

template <int DP>
constexpr size_t smem_chunk_f32() {
  return sizeof(float) * paged_f32::q_floats<DP>() + paged_f32::Q8Tiles<DP>::bytes;
}

template <int DP>
int run_f32(const void* q, const void* k_pages, const void* k_scales,
            const void* v_pages, const void* v_scales, const void* block_table,
            const void* kv_lens, const void* q_pos, void* out, void* ws_acc, void* ws_ml,
            int B, int C, int H, int KV, int d, int N, int ps, int Pmax, int S, int L,
            float scale, int window, float softcap, void* stream) {
  const auto kernel = softcap > 0.f ? paged_attention_int8_kernel_f32<DP, true>
                                    : paged_attention_int8_kernel_f32<DP, false>;
  float* acc = static_cast<float*>(ws_acc);
  float* ml = static_cast<float*>(ws_ml);
  return paged_f32::launch(kernel, paged_attention_int8_decode_combine_kernel<float>,
                           smem_chunk_f32<DP>(), B, C, H, KV, d, S, acc, ml,
                           static_cast<float*>(out), stream, static_cast<const float*>(q),
                           static_cast<const int8_t*>(k_pages),
                           static_cast<const float*>(k_scales),
                           static_cast<const int8_t*>(v_pages),
                           static_cast<const float*>(v_scales),
                           static_cast<const int*>(block_table),
                           static_cast<const int*>(kv_lens), static_cast<const int*>(q_pos),
                           static_cast<float*>(out), acc, ml, C, H, KV, d, N, ps, Pmax, S, L,
                           scale, window, softcap);
}

template <int DP>
int f32_blocks_per_sm() {
  return paged_f32::blocks_per_sm(paged_attention_int8_kernel_f32<DP, false>,
                                  smem_chunk_f32<DP>());
}

}  // namespace

// f32 chunks (C > 1): q, out [B, C, H, d] f32.  The wrapper picks K1's
// key split (kernels/paged_attention.py::chunk_splits) and, when S > 1,
// allocates the f32 workspace ws_acc [B, C, H, S, d] and
// ws_ml [B, C, H, S, 2].
extern "C" int paged_attention_int8_f32(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* kv_lens, const void* q_pos, void* out, void* ws_acc, void* ws_ml, int B,
    int C, int H, int KV, int d, int N, int ps, int Pmax, int S, int L, float scale,
    int window, float softcap, void* stream) {
  if (C == 1) return int(cudaErrorInvalidValue);   // decode: paged_attention_int8_decode_f32
  if (paged_f32::bad_split(ps, Pmax, S, L, ws_acc, ws_ml)) return int(cudaErrorInvalidValue);
  auto* fn = &run_f32<256>;
  switch (tc::padded_dim(d)) {
    case 32: fn = &run_f32<32>; break;
    case 64: fn = &run_f32<64>; break;
    case 128: fn = &run_f32<128>; break;
  }
  return fn(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens, q_pos, out,
            ws_acc, ws_ml, B, C, H, KV, d, N, ps, Pmax, S, L, scale, window, softcap,
            stream);
}

// Dynamic shared memory, in bytes, of one block of an f32 chunk call at
// head dim d, and the blocks of it one SM holds (-1 on a CUDA error).
extern "C" int paged_attention_int8_f32_smem_bytes(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return int(smem_chunk_f32<32>());
    case 64: return int(smem_chunk_f32<64>());
    case 128: return int(smem_chunk_f32<128>());
  }
  return int(smem_chunk_f32<256>());
}

extern "C" int paged_attention_int8_f32_blocks_per_sm(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return f32_blocks_per_sm<32>();
    case 64: return f32_blocks_per_sm<64>();
    case 128: return f32_blocks_per_sm<128>();
  }
  return f32_blocks_per_sm<256>();
}

// Chunks (C > 1) on the tensor cores.
extern "C" int paged_attention_int8_bf16(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* kv_lens, const void* q_pos, void* out, int B, int C, int H,
    int KV, int d, int N, int ps, int Pmax, float scale, int window,
    float softcap, void* stream) {
  if (C == 1) return int(cudaErrorInvalidValue);   // decode: paged_attention_int8_decode_bf16
  auto* fn = &run_tc<256>;
  switch (tc::padded_dim(d)) {
    case 32: fn = &run_tc<32>; break;
    case 64: fn = &run_tc<64>; break;
    case 128: fn = &run_tc<128>; break;
  }
  return fn(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens, q_pos,
            out, B, C, H, KV, d, N, ps, Pmax, scale, window, softcap, stream);
}

// Dynamic shared memory, in bytes, of one block of a bf16 chunk call at
// head dim d (ptxas -v reports only static shared memory).
extern "C" int paged_attention_int8_bf16_smem_bytes(int d) {
  switch (tc::padded_dim(d)) {
    case 32: return int(smem_tc<32>());
    case 64: return int(smem_tc<64>());
    case 128: return int(smem_tc<128>());
  }
  return int(smem_tc<256>());
}

// Decode (C = 1): q, out [B, 1, H, d].  The wrapper picks the split
// (kernels/paged_attention.py::decode_splits) and, when S > 1, allocates
// the f32 workspace ws_acc [B, H, S, d] and ws_ml [B, H, S, 2].
extern "C" int paged_attention_int8_decode_f32(
    const void* q, const void* k_pages, const void* k_scales, const void* v_pages,
    const void* v_scales, const void* block_table, const void* kv_lens, const void* q_pos,
    void* out, void* ws_acc, void* ws_ml, int B, int H, int KV, int d, int N, int ps,
    int Pmax, int S, int L, float scale, int window, float softcap, void* stream) {
  return run_decode<float>(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens,
                           q_pos, out, ws_acc, ws_ml, B, H, KV, d, N, ps, Pmax, S, L,
                           scale, window, softcap, stream);
}

extern "C" int paged_attention_int8_decode_bf16(
    const void* q, const void* k_pages, const void* k_scales, const void* v_pages,
    const void* v_scales, const void* block_table, const void* kv_lens, const void* q_pos,
    void* out, void* ws_acc, void* ws_ml, int B, int H, int KV, int d, int N, int ps,
    int Pmax, int S, int L, float scale, int window, float softcap, void* stream) {
  return run_decode<__nv_bfloat16>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                                   kv_lens, q_pos, out, ws_acc, ws_ml, B, H, KV, d, N, ps,
                                   Pmax, S, L, scale, window, softcap, stream);
}
