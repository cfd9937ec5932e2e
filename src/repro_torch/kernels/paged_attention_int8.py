"""K3: ragged paged attention over int8 KV pages.

K1's function (``kernels/paged_attention.py``) over int8 code pages and
their f32 per-(token, head) scale sidecars, which ride the same page
table; each key and value row is dequantized (``code * scale``, f32)
before both products.  It replaces the Pallas TPU kernel
``src/repro/kernels/paged_attention_int8.py::paged_attention_int8``; the
CUDA source is ``csrc/paged_attention_int8.cu``, whose header note says
what bounds it and how.

Layouts are the model's:
  q                  [B, C, H, d]      f32 or bf16
  k_pages / v_pages  [N, ps, KV, d]    int8 codes
  k_scales/v_scales  [N, ps, KV, 1]    f32
  block_table        [B, Pmax] int32   rows past ceil(kv_len/ps) unread
  kv_lens, q_pos     [B] int32
Returns o [B, C, H, d] in q's dtype.

Dispatch: CPU tensors take :func:`paged_attention_int8_plain`; CUDA tensors
launch a kernel or raise.  Decode (C = 1), f32 and bf16 q, runs K1's
split-KV kernel (``csrc/paged_decode.cuh``) over int8 rows, with K1's
split choice and workspace (``paged_attention.decode_plan``): it is
bound by the bytes of codes and scales it reads.  Chunks (C > 1) run on
the tensor cores: bf16 q in ``csrc/paged_tiles.cuh``, f32 q in
``csrc/paged_tiles_f32.cuh`` with two TF32 passes on the codes (exact in
TF32) and K1's key split and workspace (``paged_attention.chunk_plan``).
``launches`` counts wrapper calls that launch, ``launches_decode`` those
with C = 1 and ``launches_chunk`` those with C > 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as _k1
from repro_torch.models.layers import NO_WINDOW, flash_attention, gather_pages

launches = 0
launches_decode = 0
launches_chunk = 0

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_F32_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_DECODE_SYMBOLS = {torch.float32: "paged_attention_int8_decode_f32",
                   torch.bfloat16: "paged_attention_int8_decode_bf16"}
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def paged_attention_int8_plain(q, k_pages, k_scales, v_pages, v_scales,
                               block_table, kv_lens, q_pos, *, scale,
                               window=None, softcap=None):
    """The plain PyTorch version of K3 (the reference's
    ``kv_int8.paged_attention_int8``): gather codes and scales by the
    table, then flash attention with ``k_scale``/``v_scale`` so dequant
    happens inside the block loop.

    q [B, C, H, d] fp; codes [N, ps, KV, d] int8; scales [N, ps, KV, 1]
    f32; block_table [B, Pmax]; kv_lens, q_pos [B] (q_pos = position of
    query row 0).  Returns [B, C, H, d] in q's dtype.
    """
    B, Pmax = block_table.shape
    C = q.shape[1]
    ps = k_pages.shape[1]
    table = block_table.long()
    q_positions = q_pos.long()[:, None] + torch.arange(C, device=q.device)[None]
    kv_pos = torch.arange(Pmax * ps, device=q.device)[None].expand(B, Pmax * ps)
    return flash_attention(
        q, gather_pages(k_pages, table), gather_pages(v_pages, table),
        q_positions=q_positions, kv_positions=kv_pos,
        kv_valid_len=kv_lens.long(), scale=scale, causal=True, window=window,
        attn_softcap=softcap, block_kv=min(512, Pmax * ps),
        k_scale=gather_pages(k_scales, table),
        v_scale=gather_pages(v_scales, table))


def _check(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens, q_pos):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, C, H, d], got shape {tuple(q.shape)}")
    if not q.dtype.is_floating_point:
        raise ValueError(f"q must be floating-point, got {q.dtype}")
    B, C, H, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must share shape [N, ps, KV, d], got "
            f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"k_pages/v_pages must be int8 codes, got "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    N, ps, KV, _ = k_pages.shape
    if k_pages.shape[3] != d or H % KV:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} disagree with q {tuple(q.shape)}: "
            "need the same d and H a multiple of KV")
    if k_scales.shape != (N, ps, KV, 1) or v_scales.shape != (N, ps, KV, 1):
        raise ValueError(
            f"k_scales/v_scales must be [N={N}, ps={ps}, KV={KV}, 1], got "
            f"{tuple(k_scales.shape)} vs {tuple(v_scales.shape)}")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise ValueError(f"scale sidecars must be float32, got "
                         f"{k_scales.dtype}/{v_scales.dtype}")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, Pmax], got "
                         f"{tuple(block_table.shape)}")
    if kv_lens.shape != (B,) or q_pos.shape != (B,):
        raise ValueError(f"kv_lens/q_pos must be [B={B}], got "
                         f"{tuple(kv_lens.shape)} / {tuple(q_pos.shape)}")
    for name, t in (("block_table", block_table), ("kv_lens", kv_lens),
                    ("q_pos", q_pos)):
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"{name} must be integer-typed, got {t.dtype}")
    devs = {t.device for t in (q, k_pages, k_scales, v_pages, v_scales,
                               block_table, kv_lens, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def paged_attention_int8(q, k_pages, k_scales, v_pages, v_scales, block_table,
                         kv_lens, q_pos, *, scale: float, window=None,
                         softcap=None):
    """Ragged paged attention over int8 pages (see the module docstring)."""
    _check(q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens, q_pos)
    if q.device.type == "cpu":
        return paged_attention_int8_plain(
            q, k_pages, k_scales, v_pages, v_scales, block_table, kv_lens,
            q_pos, scale=scale, window=window, softcap=softcap)
    build.refuse_grad("paged_attention_int8", (q, k_pages, k_scales, v_pages, v_scales),
                      "it serves int8 pages only: " + build.TRAIN_ROUTE)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_int8 runs on cpu or cuda, got {q.device}")
    block_table, kv_lens, q_pos = (build.index_arg(t) for t in (block_table, kv_lens, q_pos))
    build.check_cuda_args(
        dict(q=q, k_pages=k_pages, k_scales=k_scales, v_pages=v_pages,
             v_scales=v_scales, block_table=block_table, kv_lens=kv_lens,
             q_pos=q_pos),
        ("block_table", "kv_lens", "q_pos"), q.dtype, q.shape[-1],
        kv_itemsize=1)
    out = torch.empty_like(q)
    if out.numel() == 0:        # e.g. the zero-row decode half of a
        return out              # phase-exclusive prefill step
    B, C, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    Pmax = block_table.shape[1]
    pointers = (q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
                v_pages.data_ptr(), v_scales.data_ptr(), block_table.data_ptr(),
                kv_lens.data_ptr(), q_pos.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rest = (float(scale), NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap), stream)
    if C == 1:
        S, L, acc, ml = _k1.decode_plan(B, H, KV, d, Pmax, ps, q.device, stream)
        fn = build.kernel_fn("paged_attention_int8", _DECODE_SYMBOLS[q.dtype],
                             _DECODE_ARGTYPES)
        rc = fn(*pointers, acc, ml, B, H, KV, d, N, ps, Pmax, S, L, *rest)
    elif q.dtype == torch.float32:
        S, L, acc, ml = _k1.chunk_plan("paged_attention_int8", B, C, H, KV, d, Pmax, ps,
                                       q.device, stream)
        fn = build.kernel_fn("paged_attention_int8", "paged_attention_int8_f32",
                             _F32_ARGTYPES)
        rc = fn(*pointers, acc, ml, B, C, H, KV, d, N, ps, Pmax, S, L, *rest)
    else:
        fn = build.kernel_fn("paged_attention_int8", "paged_attention_int8_bf16", _ARGTYPES)
        rc = fn(*pointers, B, C, H, KV, d, N, ps, Pmax, *rest)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_int8 kernel launch failed: CUDA error {rc}")
    global launches, launches_decode, launches_chunk
    launches += 1
    if C == 1:
        launches_decode += 1
    else:
        launches_chunk += 1
    return out
