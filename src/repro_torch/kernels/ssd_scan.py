"""K4: the Mamba2 SSD chunk scan — the scan of every Mamba2 block of a
zamba2 prefill.

Replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_chunk_scan``; the CUDA source is
``csrc/ssd_scan.cu`` (f32, on the CUDA cores) and ``csrc/ssd_tiles.cuh``
(bf16, on the tensor cores), whose header notes say what bounds them and
how.  It computes the Pallas kernel's function and also what the model's
oracle ``models/ssm.py::mamba2_chunk_scan`` takes: an initial state
``h0`` and any ``T`` (the steps of a ragged last chunk add nothing and
leave the state exact).

Layouts are the model's, so ``mamba2_block`` makes no transposed copies
(the Pallas kernel took heads before time):
  x      [B, T, H, P]   dt-scaled inputs, f32 or bf16
  la     [B, T, H]      log-decay (<= 0), f32
  Bc/Cc  [B, T, N]      x's dtype, shared by all heads
  h0     [B, H, P, N]   f32, or None for zeros
Returns (y [B, T, H, P] in x's dtype, h_final [B, H, P, N] f32).  The
f32 kernel and the plain version compute in f32; the bf16 kernel feeds
the tensor cores bf16 operands (C.B^T o decay and x o decay as hi + lo
pairs, the state as one bf16 for C.h^T) with f32 sums and an f32 state.

Dispatch: CPU tensors take :func:`ssd_chunk_scan_plain`; CUDA tensors
launch the kernel or raise.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0
MAX_DIM = 64            # the kernel's largest chunk, P and N

_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssd_chunk_scan_plain(x, la, Bc, Cc, h0=None, *, chunk: int = 64):
    """The plain PyTorch version: the oracle's chunk loop
    (``models/ssm.py::mamba2_chunk_scan`` of the reference) with every
    input upcast to f32 first, as the kernel computes (the oracle forms
    C.B^T in the input dtype)."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    xf, bf, cf, lf = x.float(), Bc.float(), Cc.float(), la.float()
    pad = (-T) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, 0, 0, pad))
    h = (torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    ys = []
    for t0 in range(0, T + pad, chunk):
        sl = slice(t0, t0 + chunk)
        xq, bq, cq = xf[:, sl], bf[:, sl], cf[:, sl]
        L = torch.cumsum(lf[:, sl], dim=1)                       # [B,Q,H]
        # intra-chunk: y[t] = sum_{i<=t} exp(L_t - L_i) (C_t.B_i) x_i
        M = torch.exp(L[:, :, None, :] - L[:, None, :, :])      # [B,Q(t),Q(i),H]
        M = torch.where(tri[None, :, :, None], M, 0.0)
        G = torch.einsum("btn,bin->bti", cq, bq)                # [B,Q,Q]
        y = torch.einsum("bti,btih,bihp->bthp", G, M, xq)
        # inter-chunk: y[t] += exp(L_t) C_t . h
        y = y + torch.einsum("btn,bhpn->bthp", cq, h) * torch.exp(L)[..., None]
        # state: h' = exp(L_last) h + sum_i exp(L_last - L_i) x_i B_i^T
        Llast = L[:, -1]                                         # [B,H]
        decay = torch.exp(Llast[:, None, :] - L)                 # [B,Q,H]
        h = torch.exp(Llast)[:, :, None, None] * h + torch.einsum(
            "bihp,bin,bih->bhpn", xq, bq, decay)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T] if ys else xf[:, :0]
    return y.to(x.dtype), h


def _check(x, la, Bc, Cc, h0, chunk):
    """The argument contract of the Pallas wrapper, in the model's
    layout; any T is accepted."""
    if x.ndim != 4:
        raise ValueError(f"x must be [B, T, H, P], got shape {tuple(x.shape)}")
    B, T, H, P = x.shape
    if la.shape != (B, T, H):
        raise ValueError(f"la must be [B, T, H] = {(B, T, H)}, got {tuple(la.shape)}")
    if Bc.shape != Cc.shape or Bc.ndim != 3 or Bc.shape[:2] != (B, T):
        raise ValueError(f"Bc/Cc must share shape [B={B}, T={T}, N], got "
                         f"{tuple(Bc.shape)} vs {tuple(Cc.shape)}")
    N = Bc.shape[-1]
    if h0 is not None and h0.shape != (B, H, P, N):
        raise ValueError(f"h0 must be [B, H, P, N] = {(B, H, P, N)}, got "
                         f"{tuple(h0.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    devs = {t.device for t in (x, la, Bc, Cc) + (() if h0 is None else (h0,))}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def ssd_chunk_scan(x, la, Bc, Cc, h0=None, *, chunk: int = 64):
    """The SSD chunk scan (see the module docstring for layouts)."""
    _check(x, la, Bc, Cc, h0, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, la, Bc, Cc, h0, chunk=chunk)
    build.refuse_grad("ssd_chunk_scan", (x, la, Bc, Cc, h0),
                      "no backward yet: train the hybrid on the CPU")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on cpu or cuda, got {x.device}")
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    if max(chunk, P, N) > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes chunk, P and N <= {MAX_DIM}, "
                         f"got chunk={chunk} P={P} N={N}")
    if not (Bc.dtype == Cc.dtype == x.dtype):
        raise TypeError(f"x/Bc/Cc dtypes must match, got {x.dtype}/{Bc.dtype}/{Cc.dtype}")
    for name, t in (("la", la), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    tensors = dict(x=x, la=la, Bc=Bc, Cc=Cc)
    if h0 is not None:
        tensors["h0"] = h0
    build.check_cuda_args(tensors, (), x.dtype)
    y = torch.empty_like(x)
    h = torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, h
    fn = build.kernel_fn("ssd_scan", _SYMBOLS[x.dtype], _ARGTYPES)
    rc = fn(x.data_ptr(), la.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            B, T, H, P, N, chunk, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return y, h
