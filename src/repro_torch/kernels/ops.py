"""Model-layout entry points to the attention kernels.

Counterparts of the reference's ``src/repro/kernels/ops.py``
``paged_attention``, ``paged_attention_int8`` and ``flash_attention``,
with the same arguments
minus ``interpret`` (there is no interpret mode: CPU tensors take the
plain versions) and the Pallas block sizes.  They normalise what the
model hands over — any integer index dtype, ``NO_WINDOW`` for a global
layer — and call the kernel wrappers.  The reference padded ``d`` to the
128-lane TPU width; the CUDA kernels take ``d`` as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import paged_attention as _paged_mod
from repro_torch.kernels import paged_attention_int8 as _paged_i8_mod
from repro_torch.models.layers import NO_WINDOW


def _window(window):
    return None if window is None or int(window) >= NO_WINDOW else int(window)


def paged_attention(q, k_pages, v_pages, block_table, kv_lens, q_pos, *,
                    scale, window=None, softcap=None):
    """q [B, Tq, H_p, d]; pages [N, ps, KV_p, d]. Returns [B, Tq, H_p, d]."""
    i32 = torch.int32
    return _paged_mod.paged_attention(
        q.contiguous(), k_pages, v_pages, block_table.to(i32).contiguous(),
        kv_lens.to(i32).contiguous(), q_pos.to(i32).contiguous(),
        scale=scale, window=_window(window), softcap=softcap)


def paged_attention_int8(q, k_pages, k_scales, v_pages, v_scales,
                         block_table, kv_lens, q_pos, *, scale, window=None,
                         softcap=None):
    """q [B, Tq, H_p, d] fp; code pages [N, ps, KV_p, d] int8; scale
    sidecars [N, ps, KV_p, 1] f32.  Returns [B, Tq, H_p, d]."""
    i32 = torch.int32
    return _paged_i8_mod.paged_attention_int8(
        q.contiguous(), k_pages, k_scales, v_pages, v_scales,
        block_table.to(i32).contiguous(), kv_lens.to(i32).contiguous(),
        q_pos.to(i32).contiguous(), scale=scale, window=_window(window),
        softcap=softcap)


def flash_attention(q, k, v, kv_lens, *, scale, causal=True, window=None,
                    softcap=None):
    """q [B, T, H_p, d]; k/v [B, Tk, KV_p, d]. Returns [B, T, H_p, d]."""
    return _flash_mod.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        kv_lens.to(torch.int32).contiguous(), scale=scale, causal=causal,
        window=_window(window), softcap=softcap)
