"""Core layer primitives in PyTorch: norms, RoPE, flash attention (online
softmax over KV blocks), paged attention reference, MLP variants.

These are the plain versions: the CPU path of the port and the oracles
the CUDA kernels in ``repro_torch.kernels`` are held against.  Math is in
float32 as in the reference package's ``models/layers.py``; results are
cast back to the activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.costs import kernel_region

NEG_INF = -1e30
POS_SENTINEL = 2**30      # kv position of block padding (never attended)
NO_WINDOW = 2**30         # attention window of a global layer


# ---------------------------------------------------------------- norms ----
def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def head_rms_norm(x, w, eps=1e-6):
    """Per-head RMS norm over the last (head_dim) axis (qwen3 qk-norm)."""
    return rms_norm(x, w, eps)


# ----------------------------------------------------------------- rope ----
def rope(x, positions, theta=10_000.0):
    """x: [..., T, H, d]; positions: [..., T] (broadcastable)."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv                      # [..., T, d/2]
    cos = torch.cos(ang)[..., None, :]                             # [..., T, 1, d/2]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits, cap):
    return torch.tanh(logits / cap) * cap


# ---------------------------------------------- flash attention (plain) ----
@kernel_region
def flash_attention(
    q,                      # [B, Tq, H, d]
    k,                      # [B, Tk, KV, d]
    v,                      # [B, Tk, KV, d]
    *,
    q_positions,            # [B, Tq] int
    kv_positions,           # [B, Tk] int
    kv_valid_len=None,      # [B] int (positions >= len masked); None = all
    scale: float,
    causal: bool = True,
    window=None,            # None | int
    attn_softcap: Optional[float] = None,
    block_kv: int = 512,
    k_scale=None,           # [B, Tk, KV, 1] f32 dequant scales (int8 KV pages)
    v_scale=None,
    _return_lse: bool = False,
):
    """Online-softmax attention over KV blocks.

    GQA folds query heads into groups of the KV heads: H must be a
    multiple of KV.  Rows with no visible key return zeros
    (``acc / max(l, 1e-30)``).  With ``k_scale``/``v_scale``, ``k``/``v``
    are int8 codes, dequantized inside the block loop (``code.f32 *
    scale``) as the reference does.  With ``_return_lse``, also returns
    the log-normalizer [B, KV, G, Tq] f32 (for ``flash_attention_ckpt``'s
    backward).
    """
    B, Tq, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"query heads H={H} must be a multiple of KV={KV}")
    G = H // KV
    pad = (-Tk) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=POS_SENTINEL)
        if k_scale is not None:
            k_scale = F.pad(k_scale, (0, 0, 0, 0, 0, pad))
            v_scale = F.pad(v_scale, (0, 0, 0, 0, 0, pad))
        Tk += pad
    nblk = Tk // block_kv

    qg = q.reshape(B, Tq, KV, G, d).float() * scale
    qp = q_positions[:, None, None, :, None]                   # [B,1,1,Tq,1]
    m = torch.full((B, KV, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Tq, d), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        kb, vb = k[:, sl].float(), v[:, sl].float()            # [B, blk, KV, d]
        if k_scale is not None:                                # dequant in the loop
            kb, vb = kb * k_scale[:, sl], vb * v_scale[:, sl]
        logits = torch.einsum("bqKgd,bkKd->bKgqk", qg, kb)
        if attn_softcap is not None:
            logits = softcap(logits, attn_softcap)
        pb = kv_positions[:, sl][:, None, None, None, :]        # [B,1,1,1,blk]
        mask = pb < POS_SENTINEL
        if causal:
            mask = mask & (pb <= qp)
        if window is not None:
            mask = mask & (pb > qp - window)
        if kv_valid_len is not None:
            mask = mask & (pb < kv_valid_len[:, None, None, None, None])
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bKgqk,bkKd->bKgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]           # [B, KV, G, Tq, d]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, d).to(q.dtype)
    if _return_lse:
        return out, m + torch.log(torch.clamp(l, min=1e-30))    # [B, KV, G, Tq]
    return out


# -------------------------------------- flash attention with a recompute --
# The training attention.  Differentiating through the block loop above
# would keep every block's logits for the backward; this forward keeps
# only (o, lse) and the backward recomputes the logits per block, as the
# reference's custom_vjp does.  Queries and keys sit at their indices
# (positions 0..T-1 and 0..Tk-1), as in K2.
def flash_attention_ckpt(q, k, v, kv_lens, *, scale, causal=True, window=None,
                         attn_softcap=None, block_kv=512):
    """q [B, T, H, d]; k/v [B, Tk, KV, d]; kv_lens [B] int (keys at or
    past it masked).  Returns o [B, T, H, d]; differentiable in q, k, v.

    The forward is ``kernels/flash_attention.py::flash_attention_lse``: K2
    on the card, its plain version for CPU tensors; the backward is
    :func:`flash_ckpt_bwd`, torch ops on either device."""
    return _FlashCkpt.apply(q, k, v, kv_lens, scale, causal, window,
                            attn_softcap, block_kv)


class _FlashCkpt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale, causal, window, attn_softcap,
                block_kv):
        from repro_torch.kernels import flash_attention as K2   # imports this module
        o, lse = K2.flash_attention_lse(q, k, v, kv_lens, scale=scale, causal=causal,
                                        window=window, softcap=attn_softcap)
        ctx.save_for_backward(q, k, v, kv_lens, o, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window,
                      attn_softcap=attn_softcap, block_kv=block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lens, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_ckpt_bwd(q, k, v, kv_lens, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


@kernel_region
def flash_ckpt_bwd(q, k, v, kv_lens, out, lse, do, *, scale, causal=True,
                   window=None, attn_softcap=None, block_kv=512):
    """The recompute backward of ``flash_attention_ckpt``: a port of the
    reference's ``_flash_ckpt_bwd``.  Per block of ``block_kv`` keys it
    recomputes the capped logits and p = exp(logits - lse), then
    ds = p (do.v - delta) (1 - tanh^2 under a softcap), with
    delta = sum(o * do); dq sums over blocks, dk/dv are written per block.
    Math in f32; returns (dq, dk, dv) in the inputs' dtypes."""
    B, Tq, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    pad = (-Tk) % block_kv
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    kv_pos = F.pad(torch.arange(Tk, device=q.device), (0, pad), value=POS_SENTINEL)
    q_pos = torch.arange(Tq, device=q.device)[None, None, None, :, None]
    lens = kv_lens.long()[:, None, None, None, None]

    qg = q.reshape(B, Tq, KV, G, d).float() * scale
    dog = do.reshape(B, Tq, KV, G, d).float()
    delta = (out.reshape(B, Tq, KV, G, d).float() * dog).sum(-1).permute(0, 2, 3, 1)
    dq = torch.zeros_like(qg)
    dk = torch.empty((B, Tk + pad, KV, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for i in range((Tk + pad) // block_kv):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        kb, vb = kp[:, sl].float(), vp[:, sl].float()          # [B, blk, KV, d]
        logits = torch.einsum("bqKgd,bkKd->bKgqk", qg, kb)
        dcap = None
        if attn_softcap is not None:
            t = torch.tanh(logits / attn_softcap)
            logits = t * attn_softcap
            dcap = 1.0 - t.square()                            # d capped / d logits
        pb = kv_pos[sl]                                        # [blk]
        mask = (pb < POS_SENTINEL) & (pb < lens)               # [B,1,1,1,blk]
        if causal:
            mask = mask & (pb <= q_pos)
        if window is not None:
            mask = mask & (pb > q_pos - window)
        p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
        dp = torch.einsum("bqKgd,bkKd->bKgqk", dog, vb)
        ds = p * (dp - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq += torch.einsum("bKgqk,bkKd->bqKgd", ds, kb)
        dk[:, sl] = torch.einsum("bKgqk,bqKgd->bkKd", ds, qg)
        dv[:, sl] = torch.einsum("bKgqk,bqKgd->bkKd", p, dog)
    dq = (dq * scale).reshape(B, Tq, H, d).to(q.dtype)
    return dq, dk[:, :Tk].to(k.dtype), dv[:, :Tk].to(v.dtype)


# ----------------------------------------------- paged attention (ref) -----
def gather_pages(pages, block_table):
    """pages [N, ps, KV, d], block_table [B, Pmax] -> [B, Pmax*ps, KV, d]."""
    B, Pmax = block_table.shape
    ps = pages.shape[1]
    g = pages[block_table.long()]                          # [B, Pmax, ps, KV, d]
    return g.reshape(B, Pmax * ps, *pages.shape[2:])


def paged_attention_ref(
    q,                 # [B, Tq, H, d] (Tq=1 decode, Tq=chunk prefill)
    k_pages, v_pages,  # [N, ps, KV, d]
    block_table,       # [B, Pmax] int (local page indices)
    kv_lens,           # [B] valid kv length (incl. freshly written tokens)
    q_positions,       # [B, Tq]
    *,
    scale, window=None, attn_softcap=None, block_kv=512,
):
    """Reference paged attention: gather pages then flash over them."""
    B, Pmax = block_table.shape
    ps = k_pages.shape[1]
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    kv_pos = torch.arange(Pmax * ps, device=q.device)[None].expand(B, Pmax * ps)
    return flash_attention(
        q, k, v, q_positions=q_positions, kv_positions=kv_pos,
        kv_valid_len=kv_lens, scale=scale, causal=True, window=window,
        attn_softcap=attn_softcap, block_kv=min(block_kv, Pmax * ps))


# ------------------------------------------------------------------ mlp ----
def act_fn(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_apply(p, x, act: str):
    """x [..., D]. Gated (SwiGLU/GeGLU) or classic 2-matrix MLP."""
    if act == "gelu_mlp":
        return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
    g = act_fn(act)(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def dense_init(generator, shape, in_axis_size, dtype, device, scale=1.0):
    """Normal(0, scale/sqrt(in_axis_size)) drawn in f32 from ``generator``
    on the generator's device, then cast and moved."""
    std = scale / math.sqrt(in_axis_size)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return w.to(device=device, dtype=dtype)


def mlp_init(generator, d_model, d_ff, act, dtype, device, n_layers_scale=1.0,
             stack=()):
    """The weights ``mlp_apply`` takes for ``act``, drawn in the
    reference's order: ``w_in``/``w_out`` for ``gelu_mlp``, else
    ``w_gate``/``w_up``/``w_down``; ``stack`` prepends layer axes."""
    s = tuple(stack)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, s + shape, fan_in, dtype, device, scale)

    if act == "gelu_mlp":
        return {"w_in": dense((d_model, d_ff), d_model),
                "w_out": dense((d_ff, d_model), d_ff, n_layers_scale)}
    return {"w_gate": dense((d_model, d_ff), d_model),
            "w_up": dense((d_model, d_ff), d_model),
            "w_down": dense((d_ff, d_model), d_ff, n_layers_scale)}
