// K4's backward: the gradient of the Mamba2 SSD chunk scan for Hopper
// (sm_90a), which the hybrid's training step runs once per Mamba2 block.
//
// The TPU kernel src/repro/kernels/ssd_scan.py (`ssd_chunk_scan`) has no
// backward: the reference trains through its jnp scan
// (src/repro/models/ssm.py::mamba2_chunk_scan), whose gradient XLA
// derives.  This kernel computes that gradient for the forward of
// ssd_scan.cu, which it leaves as it is.  Per chunk of Q steps, with L the
// cumulative sum of la within the chunk, E_ts = exp(L_t - L_s) for s <= t
// (else 0), dec_s = exp(L_last - L_s), G_ts = C_t . B_s, W_ts = dy_t . x_s,
// S_ts = E_ts G_ts W_ts, h the state entering the chunk and dh the
// gradient of the state leaving it:
//   dx_s = sum_{t>=s} E_ts G_ts dy_t + dec_s (dh B_s)
//   dB_s = sum_{t>=s} E_ts W_ts C_t + dec_s (dh^T x_s)       (this head's share)
//   dC_t = sum_{s<=t} E_ts W_ts B_s + exp(L_t) (h^T dy_t)    (this head's share)
//   dL_t = sum_{s<=t} S_ts - sum_{t'>=t} S_t't + exp(L_t) dy_t . (h C_t)
//          - dec_t x_t . (dh B_t), and at the chunk's last step also
//          + sum_s dec_s x_s . (dh B_s) + exp(L_last) <dh, h>
//   dla = the reverse cumulative sum of dL within the chunk
// The two states follow recurrences across chunks, independent of each
// other, and everything else is local to a chunk once it has them:
//   h  entering chunk c + 1 = exp(L_last) h + (dec o x)^T B   (from h0)
//   dh leaving chunk c - 1  = exp(L_last) dh + (exp(L) o dy)^T C
//                             (from dh_final; after chunk 0: dh0)
// The steps of a ragged last chunk are staged as zeros (la = 0 too, so
// L_last is the last real step's L) and their gradients are never written.
// exp(L_t - L_s) is evaluated only on the branch s <= t: above the
// diagonal it can overflow, and a 0/1 mask would turn inf into NaN.
//
// This replaces a CUDA-core kernel, one 16 x 16-thread block per (head,
// batch row) that walked the chunks twice: at the hybrid's
// training shape (B = 4, T = 1024, 112 heads, P = N = 64) 448 blocks, one
// an SM (151,584 B of shared memory), at 11% of its CUDA-core bound.
//
// What bounds it: ~27 GFLOP of needed products a call at that shape; on
// the tensor cores in 3xTF32 (three TF32 products an f32 one, for
// f32-grade results) ~0.165 ms at 494.7 TFLOP/s.  The bytes this design
// moves (inputs, outputs and the two state workspaces written and read
// once) are ~0.8 GB, ~0.24 ms at 3.35 TB/s.  With mma.sync (not wgmma) a
// warp runs three to four other instructions for each of its products
// here (fragment loads from shared memory and hi/lo splits: a step of 24
// mma.syncs loads 20 values and splits them), so instruction throughput
// and latency, not the tensor cores' peak, set the pace.  PERF.md has the
// measurements.
//
// Design (the kernels are in ssd_scan_bwd.cuh; this file builds the f32
// entry, ssd_scan_bwd_bf16.cu the bf16 one, so nvcc compiles the two in
// parallel): two kernels, every product on mma.sync.m16n8k8 in 3xTF32
// (tf32_common.cuh's split_fast and mma: hi rounded to nearest, lo passed
// whole and read truncated; a_lo b_hi + a_hi b_lo + a_hi b_hi), each
// accumulator chain at most CHAIN = 4 8-wide steps before the CUDA cores
// add it (mma.sync sums f32 less finely than an FADD).  warp_mma loops
// over the steps at run time, loading step k + 1's fragments while step
// k's products run, with every n fragment computed (tiles are zero-filled),
// so no run-time test separates the mma.syncs; fully unrolled, the ten
// products made a kernel too large for the instruction cache.
//   1. ssd_bwd_states_kernel, grid (H, B, 2), 8 warps, three blocks an SM:
//      direction 0 walks the chunks forward and writes the state h entering
//      each chunk but the first (h0) to ws_h; direction 1 walks them
//      backward and writes the dh leaving each chunk but the last
//      (dh_final) to ws_dh, then dh0.  Warp w keeps state rows
//      [16 (w % 4), + 16) and columns [32 (w / 4), + 32) in f32 registers;
//      each step is one [P, Q].[Q, N] product; the next chunk's two tiles
//      arrive by 16-byte cp.async into the second stage of a double buffer.
//   2. ssd_bwd_chunks_kernel, grid (n_chunks, H, B), 4 warps, two blocks an
//      SM: one chunk a block (7,168 blocks at the training shape), its x,
//      dy, B, C tiles and its h and dh in shared memory, in four cp.async
//      groups in the order the products read them.  First warp w takes the
//      rows t in [16w, 16w + 16): Z = dy h, G = C B^T and W = dy x^T, E o W
//      and S's row sums formed in the accumulators, dC = (E o W) B +
//      exp(L) o Z.  Then warp w takes the columns s in [16w, 16w + 16):
//      B dh^T and x dh (dx's and dB's state terms, then dh is free), G^T
//      and W^T again, transposed, so (E o G)^T dy (dx), (E o W)^T C (dB)
//      and S's column sums (the row sums of S^T) need no transpose through
//      shared memory and no reduction across warps; the rows' and the
//      columns' triangles are complementary, so the four warps do about
//      equal work.  An accumulator that becomes an A operand (E o W, E o
//      G^T, E o W^T) goes through its own thread's slots in shared memory,
//      in fragment order (one 16-byte load a step), so its k loop runs at
//      run time too.  Row and column sums by quad shuffles; dla by a
//      reverse scan in warp 0.  Shared rows are 68 floats (TILE + 4:
//      fragments read as rows g and columns tq, and as column pairs 2tq,
//      2tq + 1 on rows g, hit 32 distinct banks), h's 72 (read as rows tq,
//      columns g); the slots take h's and dh's places once they are read.
//      107,280 B.
// No float atomics: dB and dC are per-head partials [B, T, H, N] f32 that
// the wrapper sums over H, and every reduction has a fixed order, so the
// gradients do not depend on the order blocks run in.  Tiles are 64 rows,
// zero-filled past the chunk, past T, past P and past N; any chunk <= 64
// and any T.  P or N not a multiple of 8 take element copies.  bf16 inputs
// are widened to f32 on load (exact in TF32, so a product of two inputs
// takes one pass and of an input and a computed value two); dx is written
// in bf16, all arithmetic is f32.
//
// Layouts (the forward's):
//   x, dy, dx [B, T, H, P] (T = x's type)   la, dla [B, T, H] f32
//   Bc, Cc [B, T, N] (x's type)   dB_part, dC_part [B, T, H, N] f32
//   h0, dh_final, dh0 [B, H, P, N] f32 (each may be null: zeros / not
//   written)   ws [2 (h, dh)][B, H, n_chunks, P, N] f32
#include "ssd_scan_bwd.cuh"

// The backward for f32 inputs.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* la, const void* Bc, const void* Cc,
                                const void* h0, const void* dy, const void* dh_final, void* ws,
                                void* dx, void* dla, void* dB_part, void* dC_part, void* dh0,
                                int B, int T_len, int H, int P, int N, int Q, void* stream) {
  return ssd_bwd::run<float>(x, la, Bc, Cc, h0, dy, dh_final, ws, dx, dla, dB_part, dC_part,
                             dh0, B, T_len, H, P, N, Q, stream);
}

// Dynamic shared memory, in bytes, of one block of pass 1 (states) or 2
// (chunks); ptxas -v reports only static shared memory.
extern "C" int ssd_scan_bwd_smem_bytes(int pass) {
  return int(pass == 1 ? ssd_bwd::STATES_SMEM : ssd_bwd::CHUNKS_SMEM);
}

// Blocks of pass 1 or 2 (f32, P and N multiples of 8) resident on one SM of
// the current device, or -1 on a CUDA error.
extern "C" int ssd_scan_bwd_blocks_per_sm(int pass) {
  using namespace ssd_bwd;
  return pass == 1 ? occupancy(ssd_bwd_states_kernel<float, true>, STATES_THREADS, STATES_SMEM)
                   : occupancy(ssd_bwd_chunks_kernel<float, true>, THREADS, CHUNKS_SMEM);
}
