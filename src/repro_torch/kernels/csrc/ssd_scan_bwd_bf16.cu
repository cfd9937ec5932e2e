// K4's backward for bf16 inputs: the kernels of ssd_scan_bwd.cuh (whose
// recipe and design ssd_scan_bwd.cu's note gives) with x, dy, B and C
// widened to f32 on load and dx written in bf16; all arithmetic is f32.
// Layouts and arguments are ssd_scan_bwd_f32's.
#include "ssd_scan_bwd.cuh"

extern "C" int ssd_scan_bwd_bf16(const void* x, const void* la, const void* Bc, const void* Cc,
                                 const void* h0, const void* dy, const void* dh_final, void* ws,
                                 void* dx, void* dla, void* dB_part, void* dC_part, void* dh0,
                                 int B, int T_len, int H, int P, int N, int Q, void* stream) {
  return ssd_bwd::run<ssd_bwd::bf16>(x, la, Bc, Cc, h0, dy, dh_final, ws, dx, dla, dB_part,
                                     dC_part, dh0, B, T_len, H, P, N, Q, stream);
}
