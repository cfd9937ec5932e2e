// K4: Mamba2 SSD chunk scan for Hopper (sm_90a) — the scan of every
// Mamba2 block of a zamba2 prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (`ssd_chunk_scan`, body `_kernel`).  It computes the same function and
// also takes what the model's oracle `mamba2_chunk_scan` takes: an initial
// state h0 and any T.  Per chunk of Q steps, with L the cumulative sum of
// the log-decay la over the chunk:
//   y[t]  = sum_{i<=t} exp(L_t - L_i) (C_t . B_i) x_i + exp(L_t) C_t . h
//   h'    = exp(L_last) h + sum_i exp(L_last - L_i) x_i B_i^T
// with the state h [P, N] carried in f32 from chunk to chunk.  The steps
// of a ragged last chunk are staged as x = 0, B = C = 0, la = 0: they add
// nothing to y (never written) and leave h exact.  exp(L_t - L_i) is
// evaluated only on the branch i <= t: above the diagonal it can overflow,
// and a 0/1 mask would turn inf into NaN.
//
// Both dtypes run on the tensor cores, one block of 4 warps per (head,
// batch row) walking 64-row chunk tiles with the state in f32 registers:
// bf16 (ssd_scan_bf16) the kernel of ssd_tiles.cuh (bf16 operands, G and
// x o dk as hi + lo pairs), f32 (ssd_scan_f32) the kernel of
// ssd_tiles_f32.cuh (every product in 3xTF32, so y and h_final keep f32's
// accuracy); each header gives its design.  The f32 kernel replaces a
// CUDA-core loop (16 x 16 threads a block, 4 x 4 register tiles of fmaf fed
// from shared memory) that ran at 18% of the CUDA cores' bound.
//
// What bounds the f32 kernel on an H100: at zamba2's prefill (B = 8, T =
// 1024, 112 heads, P = N = 64) a call moves ~0.49 GB, x and y dominating
// (0.147 ms at 3.35 TB/s), and its needed products are ~23 GFLOP, ~68 in
// 3xTF32 (0.135 ms at 494.7 TFLOP/s): the bytes and the products bound it
// about equally.  The design reaches neither.  With mma.sync (not wgmma)
// each product comes with its fragment loads from shared memory and its
// hi/lo splits; a block keeps one chunk in flight and waits at two
// barriers a chunk for the warp with the most of the causal triangle
// (warp 3's G.x takes 8 steps, warp 0's 2); 115,712 bytes of shared
// memory leave 2 blocks an SM, so the 896 blocks of a prefill fill the
// card's 264 slots in 3.4 waves.  PERF.md has its measurements.
//
// Layouts (the model's, no transposes around the launch):
//   x, y [B, T, H, P] (x's type)   la [B, T, H] f32 (<= 0)
//   Bc, Cc [B, T, N] (x's type, shared by all heads)
//   h0 [B, H, P, N] f32 or null (zeros)   h_out [B, H, P, N] f32
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_tiles.cuh"
#include "ssd_tiles_f32.cuh"

extern "C" int ssd_scan_f32(const void* x, const void* la, const void* Bc,
                            const void* Cc, const void* h0, void* y,
                            void* h_out, int B, int T, int H, int P, int N,
                            int Q, void* stream) {
  return ssd_f32::run(x, la, Bc, Cc, h0, y, h_out, B, T, H, P, N, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* la, const void* Bc,
                             const void* Cc, const void* h0, void* y,
                             void* h_out, int B, int T, int H, int P, int N,
                             int Q, void* stream) {
  return ssd::run_tc(x, la, Bc, Cc, h0, y, h_out, B, T, H, P, N, Q, stream);
}

// Dynamic shared memory, in bytes, of one block of the bf16 kernel
// (ptxas -v reports only static shared memory).
extern "C" int ssd_scan_bf16_smem_bytes() { return int(ssd::SMEM_BYTES); }

// Blocks of the bf16 kernel (P, N multiples of 8) resident on one SM of
// the current device, or -1 on a CUDA error.
extern "C" int ssd_scan_bf16_blocks_per_sm() { return ssd::blocks_per_sm(); }

// The same for the f32 kernel.
extern "C" int ssd_scan_f32_smem_bytes() { return int(ssd_f32::SMEM_BYTES); }

extern "C" int ssd_scan_f32_blocks_per_sm() { return ssd_f32::blocks_per_sm(); }
