"""K1: ragged paged attention — the Splitwiser serving kernel.

One kernel covers both inference phases: decode (C = 1 query token per
sequence) and chunked prefill (C query tokens attending to their paged
history and to their own freshly written keys).  It replaces the Pallas
TPU kernel ``src/repro/kernels/paged_attention.py::paged_attention``;
the CUDA source is ``csrc/paged_attention.cu``, whose header note says
what bounds it and how.

Layouts are the model's (no transposes around the launch):
  q            [B, C, H, d]      H = KV * G query heads
  k/v_pages    [N, ps, KV, d]    the page pool of one layer
  block_table  [B, Pmax] int32   page ids; rows past ceil(kv_len/ps) unread
  kv_lens      [B] int32         valid keys, incl. the freshly written ones
  q_pos        [B] int32         position of query row 0 (rows are consecutive)
Returns o [B, C, H, d] in q's dtype.

Dispatch: CPU tensors take :func:`paged_attention_plain`; CUDA tensors
launch a kernel or raise.  bf16 chunks (C > 1) run on the tensor cores
(``csrc/paged_tiles.cuh``); decode (C = 1) and f32 calls on the CUDA-core
loop (``csrc/attention_common.cuh``).  ``launches`` counts kernel
launches, ``launches_decode`` those with C = 1 and ``launches_chunk``
those with C > 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import NO_WINDOW, paged_attention_ref

launches = 0
launches_decode = 0
launches_chunk = 0

_SYMBOLS = {torch.float32: "paged_attention_f32",
            torch.bfloat16: "paged_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def paged_attention_plain(q, k_pages, v_pages, block_table, kv_lens, q_pos, *,
                          scale, window=None, softcap=None):
    """The plain PyTorch version: gather the table's pages, then flash
    attention over them (``models.layers.paged_attention_ref``)."""
    C = q.shape[1]
    q_positions = q_pos.long()[:, None] + torch.arange(C, device=q.device)[None]
    return paged_attention_ref(q, k_pages, v_pages, block_table.long(),
                               kv_lens.long(), q_positions, scale=scale,
                               window=window, attn_softcap=softcap)


def _check(q, k_pages, v_pages, block_table, kv_lens, q_pos):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, C, H, d], got shape {tuple(q.shape)}")
    B, C, H, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must share shape [N, ps, KV, d], got "
            f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    KV = k_pages.shape[2]
    if k_pages.shape[3] != d or H % KV:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} disagree with q {tuple(q.shape)}: "
            "need the same d and H a multiple of KV")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError(f"q/k_pages/v_pages dtypes must match, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
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
    devs = {t.device for t in (q, k_pages, v_pages, block_table, kv_lens, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def paged_attention(q, k_pages, v_pages, block_table, kv_lens, q_pos, *,
                    scale: float, window=None, softcap=None):
    """Ragged paged attention (see the module docstring for layouts)."""
    _check(q, k_pages, v_pages, block_table, kv_lens, q_pos)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     kv_lens, q_pos, scale=scale,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {q.device}")
    build.check_cuda_args(
        dict(q=q, k_pages=k_pages, v_pages=v_pages, block_table=block_table,
             kv_lens=kv_lens, q_pos=q_pos),
        ("block_table", "kv_lens", "q_pos"), q.dtype, q.shape[-1])
    out = torch.empty_like(q)
    if out.numel() == 0:        # e.g. the zero-row decode half of a
        return out              # phase-exclusive prefill step
    B, C, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    fn = build.kernel_fn("paged_attention", _SYMBOLS[q.dtype], _ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), kv_lens.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), B, C, H, KV, d, N, ps, block_table.shape[1],
            float(scale), NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    global launches, launches_decode, launches_chunk
    launches += 1
    if C == 1:
        launches_decode += 1
    else:
        launches_chunk += 1
    return out
