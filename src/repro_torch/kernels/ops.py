"""Model-layout entry points to the attention and scan kernels.

Counterparts of the reference's ``src/repro/kernels/ops.py``
``paged_attention``, ``paged_attention_int8`` and ``flash_attention``,
with the same arguments
minus ``interpret`` (there is no interpret mode: CPU tensors take the
plain versions) and the Pallas block sizes.  They normalise what the
model hands over — any integer index dtype, ``NO_WINDOW`` for a global
layer — and call the kernel wrappers.  The reference padded ``d`` to the
128-lane TPU width; the CUDA kernels take ``d`` as it is.
``ssd_chunk_scan`` has no counterpart there: the reference's Mamba2 block
ran its jnp oracle, and the port's runs the scan kernel (K4) through it.

Training attention goes through ``flash_attention_ckpt``: K2's forward
with its log-normalizer inside a ``torch.autograd.Function`` whose
backward recomputes the logits per key block
(``models/layers.py::flash_attention_ckpt``).  ``ssd_chunk_scan``
differentiates on the card too: under grad mode an input that requires
grad takes ``ssd_scan.SSDScanFn``, whose backward is K4's backward
kernel.  The attention entry points here launch kernels that have no
backward: on the card they raise when grad mode is on and an input
requires grad (``build.refuse_grad``), rather than return a tensor cut
from autograd; serving runs under ``torch.inference_mode``, so it never
meets the guard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import paged_attention as _paged_mod
from repro_torch.kernels import paged_attention_int8 as _paged_i8_mod
from repro_torch.kernels import ssd_scan as _ssd_mod
from repro_torch.models import layers
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


def flash_attention_ckpt(q, k, v, kv_lens, *, scale, causal=True, window=None,
                         softcap=None):
    """:func:`flash_attention` with a backward: q [B, T, H_p, d]; k/v
    [B, Tk, KV_p, d]. Returns [B, T, H_p, d], differentiable in q, k, v."""
    return layers.flash_attention_ckpt(
        q.contiguous(), k.contiguous(), v.contiguous(),
        kv_lens.to(torch.int32).contiguous(), scale=scale, causal=causal,
        window=_window(window), attn_softcap=softcap)


def ssd_chunk_scan(x, la, Bc, Cc, h0=None, *, chunk=64):
    """x [B, T, H, P]; la [B, T, H]; Bc/Cc [B, T, N]; h0 [B, H, P, N] or
    None.  Returns (y [B, T, H, P] in x's dtype, h [B, H, P, N] f32)."""
    f32 = torch.float32
    return _ssd_mod.ssd_chunk_scan(
        x.contiguous(), la.to(f32).contiguous(), Bc.contiguous(),
        Cc.contiguous(), None if h0 is None else h0.to(f32).contiguous(),
        chunk=chunk)
