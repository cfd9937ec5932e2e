// Shared body of the three attention kernels (paged_attention.cu,
// flash_attention.cu, paged_attention_int8.cu): one thread block walks
// the keys of one (sequence, kv head) in tiles of TILE_K, for a tile of
// WARPS query rows.
//
// Query rows fold the G query heads of a kv head, as the Pallas kernels
// do: flattened row r = c * G + g is query position c, head kvh * G + g.
// Layouts are the model's, so no transpose is needed around a launch:
//   q, out [B, C, H, d]   (H = KV * G)
//
// Keys and values come from a source (FpSrc over fp rows, Q8Src over int8
// codes with a per-(token, head) f32 scale) that loads 16 bytes of one
// K row and one V row into the f32 shared tiles; the tile loop and the
// online softmax below are the same for every source.
//
// Per tile:
//   1. all threads stage TILE_K keys and values in shared memory (16-byte
//      loads, converted — and for int8 codes dequantized, code * scale —
//      to f32; key rows padded to d + 1 floats so the score pass is free
//      of bank conflicts);
//   2. each warp owns one query row: lane j scores key j (a d-long dot
//      product against the row's scaled query, kept in shared memory),
//      the warp reduces the tile's max and sum with shuffles (online
//      softmax in f32), and lane i accumulates output dims i, i+32, ...
//
// Masks follow the Pallas kernels: key position t < kv_len, causal
// t <= q_pos (q_pos = first query position + c), window t > q_pos - window,
// optional tanh softcap.  The key range is clipped to the union of the
// block's rows' visible ranges, so tiles above the diagonal or outside
// the window are never loaded.  A row with no visible key writes zeros
// (acc / max(l, 1e-30)), never NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int WARPS = 4;            // query rows per block, one per warp
constexpr int THREADS = WARPS * 32;
constexpr int TILE_K = 32;          // keys per tile: one per lane when scoring
constexpr int MAX_D = 256;
constexpr int DPL = MAX_D / 32;     // output dims per lane, at most
constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T from global memory into f32 shared memory.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = to_f(e[i]);
}

// 16 int8 codes from global memory, times their row's scale, into f32
// shared memory: the dequant of the plain version (code.f32 * scale).
__device__ __forceinline__ void load16_q8(const int8_t* src, float s, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = float(e[i]) * s;
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

// The same over dense K/V [B, Tk, KV, d]: base = b * Tk * KV + kvh.
struct DenseRows {
  size_t base;
  int KV;
  __device__ __forceinline__ size_t row(int t) const {
    return base + size_t(t) * KV;
  }
};

// K/V rows of fp type T: 16 / sizeof(T) elements per load.
template <typename T, typename Rows>
struct FpSrc {
  static constexpr int VEC = 16 / sizeof(T);
  const T* k;
  const T* v;
  Rows rows;
  int d;
  __device__ __forceinline__ void load(int t, int i, float* kd, float* vd) const {
    const size_t off = rows.row(t) * d + i;
    load16(k + off, kd);
    load16(v + off, vd);
  }
};

// K/V rows of int8 codes with one f32 scale per row: 16 codes per load.
template <typename Rows>
struct Q8Src {
  static constexpr int VEC = 16;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  Rows rows;
  int d;
  __device__ __forceinline__ void load(int t, int i, float* kd, float* vd) const {
    const size_t r = rows.row(t);
    const size_t off = r * d + i;
    load16_q8(k + off, __ldg(ks + r), kd);
    load16_q8(v + off, __ldg(vs + r), vd);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Dynamic shared memory of one block, in bytes.
inline size_t smem_bytes(int d) {
  return sizeof(float) * (size_t(WARPS) * d + size_t(TILE_K) * (d + 1) +
                          size_t(TILE_K) * d);
}

// Attend the block's query rows [row0, row0 + WARPS) of sequence b, kv
// head kvh over keys [0, kv_len).  Src loads 16 bytes of key position t's
// K and V rows (FpSrc or Q8Src).
template <typename T, typename Src>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const Src& src, int b, int kvh, int C, int H,
                            int KV, int d, int row0, int q_pos0, int kv_len,
                            float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // [WARPS][d], scaled queries
  float* k_s = q_s + WARPS * d;            // [TILE_K][d + 1]
  float* v_s = k_s + TILE_K * (d + 1);     // [TILE_K][d]

  const int G = H / KV;
  const int n_rows = C * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = row0 + warp;
  const bool has_row = row < n_rows;
  const int c = has_row ? row / G : 0;
  const int qp = q_pos0 + c;
  const size_t q_off = ((size_t(b) * C + c) * H + kvh * G + row % G) * d;

  for (int i = lane; i < d; i += 32)
    q_s[warp * d + i] = has_row ? to_f(q[q_off + i]) * scale : 0.f;

  // keys any row of this block can see
  const int last_row = min(row0 + WARPS, n_rows) - 1;
  const int c_lo = row0 / G, c_hi = last_row / G;
  const int t_end = causal ? min(kv_len, q_pos0 + c_hi + 1) : kv_len;
  const int t_begin = max(0, q_pos0 + c_lo - window + 1);

  constexpr int V = Src::VEC;             // K/V elements per 16-byte load
  const int vecs = d / V;
  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) acc[k] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += TILE_K) {
    __syncthreads();                       // q_s written / last tile consumed
    for (int e = tid; e < TILE_K * vecs; e += THREADS) {
      const int j = e / vecs, i = (e - j * vecs) * V;
      if (t0 + j < t_end) src.load(t0 + j, i, &k_s[j * (d + 1) + i], &v_s[j * d + i]);
    }
    __syncthreads();
    if (!has_row) continue;

    const int t = t0 + lane;
    bool valid = false;
    float s = NEG_INF;
    if (t < t_end) {
      const float* qr = &q_s[warp * d];
      const float* kr = &k_s[lane * (d + 1)];
      float dot = 0.f;
      for (int i = 0; i < d; ++i) dot = fmaf(qr[i], kr[i], dot);
      if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
      valid = (!causal || t <= qp) && t > qp - window;
      s = valid ? dot : NEG_INF;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[k] *= corr;
    const int n_keys = min(TILE_K, t_end - t0);
    for (int j = 0; j < n_keys; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      const float* vr = &v_s[j * d];
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        const int i = lane + 32 * k;
        if (i < d) acc[k] = fmaf(pj, vr[i], acc[k]);
      }
    }
  }

  if (!has_row) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int i = lane + 32 * k;
    if (i < d) out[q_off + i] = from_f<T>(acc[k] / denom);
  }
}

// Launch helper: sets the dynamic shared-memory limit when a head dim
// needs more than the default 48 KB, launches on `stream`, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int d, void* stream, Args... args) {
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace attn
