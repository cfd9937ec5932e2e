// Split-KV decode (C = 1) of K1 and K3 for Hopper (sm_90a), with a
// combine pass (flash-decoding).
//
// Replaces the decode case of the Pallas TPU kernels
// src/repro/kernels/paged_attention.py and paged_attention_int8.py:
// one query token per sequence attends to its keys, followed through the
// block table page by page, with the G query heads of a kv head sharing
// every key (GQA).  Masks t < kv_len, causal t <= q_pos, window
// t > q_pos - window, optional tanh softcap; online softmax in f32; a row
// with no visible key writes 0.
//
// What bounds it: decode reads every visible K/V byte once and does about
// 4 flops per element read (2 for q.k, 2 for p.v per query head), far
// below the card's ~295 flops per byte, so it is bound by bytes
// (3.35 TB/s).  Tensor cores buy nothing; f32 pages run the same loop in
// full-f32 FMA.  Two things keep a bytes-bound kernel from the bound, and
// the design answers both:
//   - Too few blocks, and one block pinned to its sequence's longest walk.
//     The grid is (split, kv head, sequence): split s covers the absolute
//     keys [s * L, (s + 1) * L) of its sequence, clipped to the row's
//     visible range.  The host picks S and L from shapes alone
//     (kernels/paged_attention.py::decode_splits), so a small batch fills
//     the 132 SMs and a long sequence is walked by S blocks at once.  A
//     block whose range is empty writes an empty partial (m = -1e30,
//     l = 0) and exits.
//   - Too few bytes in flight.  A key is scored by the lanes that hold its
//     16-byte vectors (a lane group of next_pow2(d / EPV) lanes, at most
//     32; EPV = 4 f32, 8 bf16, 16 int8 elements; a lane holds 2 vectors
//     for f32 at d > 128), so a warp scores 32 / group keys at once and
//     the block's 4 warps share the split's keys.  Each lane issues the
//     loads of KEYS keys (KEYS / 2 at 2 vectors a lane; K, V and, for
//     int8, their scales) before it uses any, straight into registers:
//     no shared-memory staging and no barrier in the key loop.  The dot
//     product is reduced by shuffles inside the group.  The split's page
//     ids are staged once in shared memory, so a key's address costs no
//     dependent global load.
// All G query rows of the kv head live in every lane, q in registers, in
// row groups of GR rows (GR a compile-time cap).  For G <= GR each K/V
// byte is read once per block; for G > GR (G = 3 or 8 at GR = 4 or 2)
// the block walks its split once per row group, so each byte is read
// ceil(G / GR) times.  The port's models have G <= 2.  Each lane group keeps
// its own (m, l, acc) per row; at the end the groups of a warp merge by
// shuffles and the 4 warps through shared memory.
//
// With S == 1 the block normalises and writes out directly.  Otherwise it
// writes f32 partials (acc [B, H, S, d] and (m, l) [B, H, S, 2], in a
// workspace the wrapper allocates) and a combine kernel, one block per
// (sequence, head), rescales its row's S partials by exp(m_s - M), skips
// the empty ones (l == 0) and writes out.
//
// int8 codes: the dot product is taken on the codes and scaled once per
// key (k_scale * sum q * code), and p is scaled by the key's v_scale
// before p * code; each scale is read once per key row.  Codes become f32
// exactly by a byte permute into the mantissa of 2^23 (no I2F).
#pragma once

#include "attention_common.cuh"

namespace pdec {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KEYS = 4;                 // keys a lane loads before using any (VPL = 1)
constexpr int MAX_SPLIT_PAGES = 1024;   // page ids of one split staged in shared memory
constexpr int COMBINE_THREADS = 128;
constexpr float NEG_INF = attn::NEG_INF;
constexpr unsigned FULL = attn::FULL;

// 8 bf16 (or 4 f32) of one 16-byte vector into f32, exactly.
__device__ __forceinline__ void unpack(const uint4& r, float* x, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float* x, float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
// 16 int8 codes into f32, exactly: (code ^ 0x80) is code + 128 as a
// byte; placed in the mantissa of 2^23 it reads 2^23 + code + 128.
__device__ __forceinline__ void unpack(const uint4& r, float* x, int8_t) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[4 * i + k] = __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7540 + k)) - 8388736.f;
  }
}

// K/V rows of fp type T.
template <typename T>
struct FpRows {
  using Elem = T;
  static constexpr int EPV = 16 / sizeof(T);
  static constexpr bool SCALED = false;
  const T* k;
  const T* v;
  __device__ __forceinline__ uint4 k16(size_t off) const {
    return __ldg(reinterpret_cast<const uint4*>(k + off));
  }
  __device__ __forceinline__ uint4 v16(size_t off) const {
    return __ldg(reinterpret_cast<const uint4*>(v + off));
  }
  __device__ __forceinline__ float k_scale(size_t) const { return 1.f; }
  __device__ __forceinline__ float v_scale(size_t) const { return 1.f; }
};

// K/V rows of int8 codes with one f32 scale per (token, kv head) row.
struct Q8Rows {
  using Elem = int8_t;
  static constexpr int EPV = 16;
  static constexpr bool SCALED = true;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ uint4 k16(size_t off) const {
    return __ldg(reinterpret_cast<const uint4*>(k + off));
  }
  __device__ __forceinline__ uint4 v16(size_t off) const {
    return __ldg(reinterpret_cast<const uint4*>(v + off));
  }
  __device__ __forceinline__ float k_scale(size_t row) const { return __ldg(ks + row); }
  __device__ __forceinline__ float v_scale(size_t row) const { return __ldg(vs + row); }
};

// Host side: 16-byte vectors a lane holds (1, or 2 for f32 at d > 128),
// and query rows a block holds at once (GR) for G query heads a kv head.
inline int vectors_per_lane(int d, int epv) { return (d / epv + 31) / 32; }
inline int rows_per_pass(int G, int elems_per_lane) {
  const int cap = elems_per_lane > 8 ? 2 : 4;
  return G == 1 ? 1 : (G == 2 ? 2 : cap);
}
inline size_t merge_bytes(int GR, int d) {
  return sizeof(float) * WARPS * GR * (size_t(d) + 2);
}
// A split must be whole pages, cover the table's Pmax * ps keys, and span
// at most MAX_SPLIT_PAGES pages; S > 1 needs the workspace.
inline bool bad_split(int ps, int Pmax, int S, int L, const void* ws_acc,
                      const void* ws_ml) {
  return S < 1 || ps < 1 || L < ps || L % ps || L / ps > MAX_SPLIT_PAGES ||
         (long long)S * L < (long long)Pmax * ps ||
         (S > 1 && (ws_acc == nullptr || ws_ml == nullptr));
}

// One block: split blockIdx.x of kv head blockIdx.y of sequence
// blockIdx.z.  q, out [B, 1, H, d]; pages [N, ps, KV, d] read by `rows`;
// ws_acc [B, H, S, d], ws_ml [B, H, S, 2] f32 (unused when S == 1).
template <typename T, int VPL, int GR, typename Rows>
__device__ __forceinline__ void attend_split(
    const Rows& rows, const T* __restrict__ q, T* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    const int* __restrict__ block_table, const int* __restrict__ kv_lens,
    const int* __restrict__ q_pos, int H, int KV, int d, int N, int ps, int Pmax,
    int S, int L, float scale, int window, float softcap) {
  constexpr int EPV = Rows::EPV;
  constexpr int E = VPL * EPV;             // K/V elements a lane holds per key
  constexpr int U = KEYS / VPL;            // keys a lane group loads per step
  __shared__ int pages_s[MAX_SPLIT_PAGES];
  extern __shared__ float merge_s[];       // acc [WARPS][GR][d], then (m, l) [WARPS][GR]

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nvec = d / EPV;
  int lpk = 1;                             // lanes per key, a power of two
  while (lpk < nvec && lpk < 32) lpk <<= 1;
  const int gpw = 32 / lpk;                // lane groups (keys at once) per warp
  const int ng = WARPS * gpw;
  const int grp = warp * gpw + lane / lpk;
  const int j = lane & (lpk - 1);

  // keys past the table's last page do not exist (the reference gathers
  // exactly Pmax pages); at C = 1 every row sees the same range
  const int kv_len = max(0, min(kv_lens[b], Pmax * ps));
  const int qp = q_pos[b];
  const int t_begin = max(0, qp - window + 1);
  const int t_end = min(kv_len, qp + 1);
  const int k0 = max(t_begin, s * L), k1 = min(t_end, (s + 1) * L);
  const size_t row0 = size_t(b) * H + size_t(kvh) * G;   // (b, h = kvh * G)

  if (k0 >= k1) {                          // nothing visible in this split
    if (S == 1) {
      for (int i = tid; i < G * d; i += THREADS) out[row0 * d + i] = attn::from_f<T>(0.f);
    } else {
      for (int g = tid; g < G; g += THREADS) {
        ws_ml[((row0 + g) * S + s) * 2] = NEG_INF;
        ws_ml[((row0 + g) * S + s) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // page ids of the split's keys: only pages below ceil(kv_len / ps),
  // clamped into the pool
  const int p_lo = k0 / ps, n_pages = (k1 - 1) / ps + 1 - p_lo;
  const int* table = block_table + size_t(b) * Pmax;
  for (int i = tid; i < n_pages; i += THREADS)
    pages_s[i] = min(max(table[p_lo + i], 0), N - 1);
  __syncthreads();

  float* acc_s = merge_s;
  float* ml_s = merge_s + WARPS * GR * d;

  for (int g0 = 0; g0 < G; g0 += GR) {
    const int nr = min(GR, G - g0);
    float qr[GR][E], acc[GR][E], m[GR], l[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = j + lpk * v;
        const bool has = g < nr && vi < nvec;
        const T* qg = q + (row0 + g0 + g) * d + vi * EPV;
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          qr[g][v * EPV + e] = has ? attn::to_f(qg[e]) * scale : 0.f;
          acc[g][v * EPV + e] = 0.f;
        }
      }
    }

    for (int t0 = k0; t0 < k1; t0 += ng * U) {
      uint4 kr[U][VPL], vr[U][VPL];
      float ksc[U], vsc[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {        // every load of the step first
        const int t = t0 + u * ng + grp;
        ok[u] = t < k1;
        const size_t row =
            ok[u] ? (size_t(pages_s[t / ps - p_lo]) * ps + t % ps) * KV + kvh : 0;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vi = j + lpk * v;
          const bool has = ok[u] && vi < nvec;
          kr[u][v] = has ? rows.k16(row * d + vi * EPV) : make_uint4(0, 0, 0, 0);
          vr[u][v] = has ? rows.v16(row * d + vi * EPV) : make_uint4(0, 0, 0, 0);
        }
        ksc[u] = ok[u] ? rows.k_scale(row) : 0.f;
        vsc[u] = ok[u] ? rows.v_scale(row) : 0.f;
      }

      float sc[U][GR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[E];
#pragma unroll
        for (int v = 0; v < VPL; ++v) unpack(kr[u][v], kf + v * EPV, typename Rows::Elem());
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          sc[u][g] = dot;
        }
      }
      for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GR; ++g) sc[u][g] += __shfl_xor_sync(FULL, sc[u][g], o);
      }

      float p[U][GR];
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float x = Rows::SCALED ? sc[u][g] * ksc[u] : sc[u][g];
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          sc[u][g] = ok[u] ? x : NEG_INF;
          mx = fmaxf(mx, sc[u][g]);
        }
        const float corr = expf(m[g] - mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u][g] = ok[u] ? expf(sc[u][g] - mx) : 0.f;
          sum += p[u][g];
        }
        l[g] = l[g] * corr + sum;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[E];
#pragma unroll
        for (int v = 0; v < VPL; ++v) unpack(vr[u][v], vf + v * EPV, typename Rows::Elem());
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float pv = Rows::SCALED ? p[u][g] * vsc[u] : p[u][g];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
        }
      }
    }

    // merge the lane groups of a warp (lanes j, j + lpk, ...), then the warps
    for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float mo = __shfl_xor_sync(FULL, m[g], o);
        const float lo = __shfl_xor_sync(FULL, l[g], o);
        const float mx = fmaxf(m[g], mo);
        const float a = expf(m[g] - mx), c = expf(mo - mx);
        l[g] = l[g] * a + lo * c;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], o) * c;
      }
    }
    if (lane < lpk) {
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vi = j + lpk * v;
          if (vi < nvec) {
#pragma unroll
            for (int e = 0; e < EPV; ++e)
              acc_s[(warp * GR + g) * d + vi * EPV + e] = acc[g][v * EPV + e];
          }
        }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        ml_s[(warp * GR + g) * 2] = m[g];
        ml_s[(warp * GR + g) * 2 + 1] = l[g];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * d; idx += THREADS) {
      const int g = idx / d, i = idx - g * d;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ml_s[(w * GR + g) * 2]);
      float A = 0.f, Ls = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = expf(ml_s[(w * GR + g) * 2] - M);
        Ls += ml_s[(w * GR + g) * 2 + 1] * wt;
        A += acc_s[(w * GR + g) * d + i] * wt;
      }
      const size_t r = row0 + g0 + g;
      if (S == 1) {
        out[r * d + i] = attn::from_f<T>(A / fmaxf(Ls, 1e-30f));
      } else {
        ws_acc[(r * S + s) * d + i] = A;
        if (i == 0) {
          ws_ml[(r * S + s) * 2] = M;
          ws_ml[(r * S + s) * 2 + 1] = Ls;
        }
      }
    }
    __syncthreads();                       // merge_s is reused by the next row group
  }
}

// The combine: block (h, b) rescales row (b, h)'s S partials by
// exp(m_s - M), skips the empty ones (l == 0, whose acc is never
// written), and writes acc / max(l, 1e-30) in T.
template <typename T>
__device__ __forceinline__ void combine(const float* __restrict__ ws_acc,
                                        const float* __restrict__ ws_ml,
                                        T* __restrict__ out, int d, int S) {
  const size_t r = size_t(blockIdx.y) * gridDim.x + blockIdx.x;
  const float* ml = ws_ml + r * S * 2;
  float M = NEG_INF;
  for (int s = 0; s < S; ++s)
    if (__ldg(ml + 2 * s + 1) != 0.f) M = fmaxf(M, __ldg(ml + 2 * s));
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float A = 0.f, Ls = 0.f;
    for (int s = 0; s < S; ++s) {
      const float l = __ldg(ml + 2 * s + 1);
      if (l != 0.f) {
        const float wt = expf(__ldg(ml + 2 * s) - M);
        Ls += l * wt;
        A += __ldg(ws_acc + (r * S + s) * d + i) * wt;
      }
    }
    out[r * d + i] = attn::from_f<T>(A / fmaxf(Ls, 1e-30f));
  }
}

// Launch the split kernel on grid (S, KV, B) and, when S > 1, the combine
// on grid (H, B), both on `stream`; returns cudaGetLastError() after the
// last launch (or the first error).
template <typename Split, typename Combine, typename T, typename... Args>
int launch(Split split, Combine comb, int GR, int B, int H, int KV, int d, int S,
           const float* ws_acc, const float* ws_ml, T* out, void* stream,
           Args... args) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split<<<dim3(S, KV, B), THREADS, merge_bytes(GR, d), st>>>(args...);
  if (S == 1) return int(cudaGetLastError());
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  comb<<<dim3(H, B), COMBINE_THREADS, 0, st>>>(ws_acc, ws_ml, out, d, S);
  return int(cudaGetLastError());
}

}  // namespace pdec
