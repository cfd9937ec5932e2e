"""K4: the Mamba2 SSD chunk scan — the scan of every Mamba2 block of a
zamba2 prefill.

Replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_chunk_scan``; the CUDA source is
``csrc/ssd_scan.cu`` (the C entries and what bounds the kernels), with
``csrc/ssd_tiles_f32.cuh`` (f32, 3xTF32 on the tensor cores) and
``csrc/ssd_tiles.cuh`` (bf16, on the tensor cores), whose header notes
give their designs.  It computes the Pallas kernel's function and also
what the model's oracle ``models/ssm.py::mamba2_chunk_scan`` takes: an
initial state ``h0`` and any ``T`` (the steps of a ragged last chunk add
nothing and leave the state exact).

Layouts are the model's, so ``mamba2_block`` makes no transposed copies
(the Pallas kernel took heads before time):
  x      [B, T, H, P]   dt-scaled inputs, f32 or bf16
  la     [B, T, H]      log-decay (<= 0), f32
  Bc/Cc  [B, T, N]      x's dtype, shared by all heads
  h0     [B, H, P, N]   f32, or None for zeros
Returns (y [B, T, H, P] in x's dtype, h_final [B, H, P, N] f32).  The
plain version computes in f32; the f32 kernel takes every product in
3xTF32 (each operand split into TF32 hi + lo, three products summed in
f32), which keeps f32's accuracy; the bf16 kernel feeds the tensor cores
bf16 operands (C.B^T o decay and x o decay as hi + lo pairs, the state as
one bf16 for C.h^T) with f32 sums and an f32 state.

The backward is K4's own pair of kernels, ``csrc/ssd_scan_bwd.cuh``
(built for f32 inputs by ``csrc/ssd_scan_bwd.cu``, for bf16 by
``csrc/ssd_scan_bwd_bf16.cu``; the Pallas kernel has none: the reference
differentiates its jnp scan),
bound by :class:`SSDScanFn`: a states kernel runs the two recurrences
across chunks (the state entering and the gradient leaving each chunk,
into an f32 workspace), then a chunks kernel takes every chunk alone,
all its products in 3xTF32 on the tensor cores.
:func:`ssd_chunk_scan_bwd_plain` is its plain version, and
``ssd_scan_bwd.cu``'s header gives the recipe and the design.

Dispatch: CPU tensors take :func:`ssd_chunk_scan_plain`, which autograd
differentiates.  CUDA tensors launch the kernel or raise: under grad
mode with an input that requires grad through :class:`SSDScanFn` (the
forward launch, the inputs saved, the backward kernel in the backward),
otherwise (serving, under ``torch.inference_mode``) the forward alone,
with nothing saved.  ``launches`` counts forward launches and
``launches_bwd`` backward ones.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0
launches_bwd = 0
MAX_DIM = 64            # the kernel's largest chunk, P and N

_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# library and C entry of the backward by input dtype
_BWD_ENTRIES = {torch.float32: ("ssd_scan_bwd", "ssd_scan_bwd_f32"),
                torch.bfloat16: ("ssd_scan_bwd_bf16", "ssd_scan_bwd_bf16")}
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
        # intra-chunk: y[t] = sum_{i<=t} exp(L_t - L_i) (C_t.B_i) x_i, the
        # exponent taken on i <= t only: above the diagonal it can overflow,
        # and inf there would turn the masked gradient (0 * inf) into NaN
        low = tri[None, :, :, None]
        M = torch.where(low, torch.exp(torch.where(
            low, L[:, :, None, :] - L[:, None, :, :], 0.0)), 0.0)  # [B,Q(t),Q(i),H]
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


def ssd_chunk_scan_bwd_plain(x, la, Bc, Cc, h0, dy, dh_final, *, chunk: int = 64):
    """The plain PyTorch version of K4's backward: the gradient of
    :func:`ssd_chunk_scan_plain` for the output gradients ``dy`` [B, T,
    H, P] and ``dh_final`` [B, H, P, N] (None: zeros), by the recipe of
    ``csrc/ssd_scan_bwd.cu`` — the states entering each chunk, then an
    explicit reverse chunk loop, in f32.  Returns (dx in x's dtype, dla
    f32, dB and dC in Bc's dtype, dh0 f32 or None when h0 is None)."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    pad = (-T) % chunk
    xf, bf, cf, gy = (F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
                      for t in (x, Bc, Cc, dy))
    lf = F.pad(la.float(), (0, 0, 0, pad))
    h = (torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    starts = range(0, T + pad, chunk)
    states = []                                              # h entering each chunk
    for t0 in starts:
        states.append(h)
        sl = slice(t0, t0 + chunk)
        L = torch.cumsum(lf[:, sl], dim=1)                   # [B,Q,H]
        dec = torch.exp(L[:, -1:] - L)
        h = torch.exp(L[:, -1])[:, :, None, None] * h + torch.einsum(
            "bihp,bin,bih->bhpn", xf[:, sl], bf[:, sl], dec)
    dh = (torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
          if dh_final is None else dh_final.float().clone())
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))[
        None, :, :, None]                                    # [1,Q(t),Q(s),1]
    dx, dB, dC, dla = (torch.empty_like(t) for t in (xf, bf, cf, lf))
    for t0, h in zip(reversed(starts), reversed(states)):
        sl = slice(t0, t0 + chunk)
        xq, bq, cq, gq = xf[:, sl], bf[:, sl], cf[:, sl], gy[:, sl]
        L = torch.cumsum(lf[:, sl], dim=1)                   # [B,Q,H]
        eL, Llast = torch.exp(L), L[:, -1]
        dec = torch.exp(Llast[:, None] - L)
        diff = L[:, :, None, :] - L[:, None, :, :]           # L_t - L_s
        E = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        G = torch.einsum("btn,bsn->bts", cq, bq)[..., None]  # [B,Q,Q,1]
        W = torch.einsum("bthp,bshp->btsh", gq, xq)          # [B,Q,Q,H]
        A, V = E * G, E * W
        S = A * W
        U = torch.einsum("bhpn,bsn->bshp", dh, bq)           # dh B_s
        Z = torch.einsum("bthp,bhpn->bthn", gq, h)           # h^T dy_t
        dx[:, sl] = torch.einsum("btsh,bthp->bshp", A, gq) + dec[..., None] * U
        dB[:, sl] = torch.einsum("btsh,btn->bsn", V, cq) + torch.einsum(
            "bsh,bshp,bhpn->bsn", dec, xq, dh)
        dC[:, sl] = torch.einsum("btsh,bsn->btn", V, bq) + torch.einsum(
            "bth,bthn->btn", eL, Z)
        term_a = dec * (xq * U).sum(-1)                      # dec_t x_t . (dh B_t)
        dL = (S.sum(2) - S.sum(1) + eL * torch.einsum("btn,bthn->bth", cq, Z)
              - term_a)
        dL[:, -1] += term_a.sum(1) + torch.exp(Llast) * (dh * h).sum((-2, -1))
        dla[:, sl] = torch.flip(torch.cumsum(torch.flip(dL, [1]), 1), [1])
        dh = torch.exp(Llast)[:, :, None, None] * dh + torch.einsum(
            "bth,bthp,btn->bhpn", eL, gq, cq)
    return (dx[:, :T].to(x.dtype), dla[:, :T], dB[:, :T].to(Bc.dtype),
            dC[:, :T].to(Bc.dtype), None if h0 is None else dh)


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


def _check_cuda(x, la, Bc, Cc, h0, chunk):
    """What the CUDA kernels take, beyond :func:`_check`."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan runs on cpu or cuda, got {x.device}")
    P, N = x.shape[-1], Bc.shape[-1]
    if max(chunk, P, N) > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes chunk, P and N <= {MAX_DIM}, "
                         f"got chunk={chunk} P={P} N={N}")
    if not (Bc.dtype == Cc.dtype == x.dtype):
        raise TypeError(f"x/Bc/Cc dtypes must match, got {x.dtype}/{Bc.dtype}/{Cc.dtype}")
    for name, t in (("la", la), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")


def _launch(x, la, Bc, Cc, h0, chunk):
    """K4's forward on checked CUDA tensors."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
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


class SSDScanFn(torch.autograd.Function):
    """The scan with a backward: :func:`ssd_chunk_scan`'s forward (K4's
    launch on the card; grad mode is off inside), saving its inputs, and
    :func:`ssd_chunk_scan_bwd` (the backward kernel on the card).  A CUDA
    input that requires grad under grad mode goes through it; on CPU
    tensors it runs the plain versions (the tests use that)."""

    @staticmethod
    def forward(ctx, x, la, Bc, Cc, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, la, Bc, Cc, h0)
        return ssd_chunk_scan(x, la, Bc, Cc, h0, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, la, Bc, Cc, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh_final is None else dh_final.contiguous()
        dx, dla, dB, dC, dh0 = ssd_chunk_scan_bwd(x, la, Bc, Cc, h0, dy, dh, chunk=ctx.chunk)
        return dx, dla, dB, dC, dh0, None


def ssd_chunk_scan(x, la, Bc, Cc, h0=None, *, chunk: int = 64):
    """The SSD chunk scan (see the module docstring for layouts)."""
    _check(x, la, Bc, Cc, h0, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, la, Bc, Cc, h0, chunk=chunk)
    _check_cuda(x, la, Bc, Cc, h0, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, la, Bc, Cc, h0)):
        return SSDScanFn.apply(x, la, Bc, Cc, h0, chunk)
    return _launch(x, la, Bc, Cc, h0, chunk)


def ssd_chunk_scan_bwd(x, la, Bc, Cc, h0, dy, dh_final, *, chunk: int = 64):
    """K4's backward: the gradients (dx, dla, dB, dC, dh0) of
    ``ssd_chunk_scan(x, la, Bc, Cc, h0)`` for the output gradients ``dy``
    (x's shape and dtype) and ``dh_final`` ([B, H, P, N] f32, or None for
    zeros), in the dtypes of :func:`ssd_chunk_scan_bwd_plain`, which CPU
    tensors take.  CUDA tensors launch ``csrc/ssd_scan_bwd.cuh``'s states
    and chunks kernels (one launch of the pair, counted once) or raise."""
    _check(x, la, Bc, Cc, h0, chunk)
    if dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}, got {tuple(dy.shape)}")
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    if dh_final is not None and dh_final.shape != (B, H, P, N):
        raise ValueError(f"dh_final must be [B, H, P, N] = {(B, H, P, N)}, got "
                         f"{tuple(dh_final.shape)}")
    if x.device.type == "cpu":
        return ssd_chunk_scan_bwd_plain(x, la, Bc, Cc, h0, dy, dh_final, chunk=chunk)
    _check_cuda(x, la, Bc, Cc, h0, chunk)
    if dy.dtype != x.dtype or (dh_final is not None and dh_final.dtype != torch.float32):
        raise TypeError(f"dy must be {x.dtype} and dh_final float32, got {dy.dtype} "
                        f"and {None if dh_final is None else dh_final.dtype}")
    tensors = dict(x=x, la=la, Bc=Bc, Cc=Cc, dy=dy)
    tensors.update((k, t) for k, t in (("h0", h0), ("dh_final", dh_final)) if t is not None)
    build.check_cuda_args(tensors, (), x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    ws = torch.empty(2, B, H, -(-T // chunk), P, N, **f32)   # the states h and dh
    dx = torch.empty_like(x)
    dla = torch.empty(B, T, H, **f32)
    dB_part = torch.empty(B, T, H, N, **f32)
    dC_part = torch.empty(B, T, H, N, **f32)
    dh0 = None if h0 is None else torch.empty(B, H, P, N, **f32)
    if B * H:                            # else every output is empty
        fn = build.kernel_fn(*_BWD_ENTRIES[x.dtype], _BWD_ARGTYPES)
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = fn(x.data_ptr(), la.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), ptr(h0),
                dy.data_ptr(), ptr(dh_final), ws.data_ptr(), dx.data_ptr(), dla.data_ptr(),
                dB_part.data_ptr(), dC_part.data_ptr(), ptr(dh0), B, T, H, P, N, chunk,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error {rc}")
        global launches_bwd
        launches_bwd += 1
    # B and C are shared by the heads: the kernel writes each head's share
    return dx, dla, dB_part.sum(2).to(Bc.dtype), dC_part.sum(2).to(Bc.dtype), dh0
