"""Decoder-only transformer (dense / MoE / VLM families) in PyTorch.

The serving steps of the reference ``models/transformer.py``:
  - prefill / forward_hidden   (batched prompt -> KV + last logits)
  - decode                     (one token/seq over paged KV)
  - mixed                      (Splitwiser: prefill chunks + decode tokens
                                share every GEMM in one step)

Parameters are a plain dict with the reference's names and layouts
(``wq [L,D,H_p,hd]``, ``wo [L,H_p,hd,D]``, ``embed [Vp,D]``, pools
``[L,N,ps,KV_p,hd]``), per-layer weights stacked on a leading ``L``
axis.  The reference's ``lax.scan`` over layers is a Python loop over
that axis.  Page pools are updated **in place** (the reference donated
its buffers to the jitted step instead): ``decode``/``mixed`` write the
step's K/V into the pools they are given and return the same tensors.

Attention goes through ``repro_torch.kernels.ops``: the CUDA kernels on
the card, their plain versions for CPU tensors.  Page pools are fp
tensors or, for int8 KV pages, dicts ``{"q": int8 codes, "s": f32
scales}`` (``kernels/kv_int8.py``): ``decode``/``mixed`` quantize the
step's new K/V into them and attend with the int8 kernel (K3).

The family's features follow the reference: gemma2's post-attention
norms (``ln1b``/``ln2b``), ``sqrt(d_model)`` embedding scale, final-logit
and attention softcaps and local/global windows; the MoE FFN
(``models/moe.py``, olmoe and grok-1); the VLM's projected patch prefix
(``vision_prefix``, internvl2), which ``prefill`` takes as ``patches``.
Training is a later slice.  ``models/registry.py`` decides which
families this module serves.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.kv_int8 import q8_kv
from repro_torch.models.layers import (NEG_INF, NO_WINDOW, act_fn,
                                       dense_init, head_rms_norm, mlp_apply,
                                       mlp_init, rms_norm, rope, softcap)
from repro_torch.models.moe import moe_apply, moe_init

VOCAB_PAD = 256


def pad_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


# ------------------------------------------------------------ GQA layout ---
def gqa_layout(H: int, KV: int, tp: int = 1):
    """Padded head layout for tensor parallelism (numpy; a copy of the
    reference's).  Returns (H_p, KV_p, q_map, kv_map, head_mask)."""
    if KV % tp == 0:
        KV_p = KV
    else:
        if not KV < tp:
            raise ValueError(
                f"KV heads ({KV}) must divide or be smaller than tp={tp} "
                f"to replicate into padded slots (H={H})")
        KV_p = tp * math.ceil(KV / tp)
        if KV_p % KV:
            raise ValueError(
                f"padded KV heads {KV_p} not a multiple of KV={KV} (tp={tp})")
    R = KV_p // KV
    if H % KV:
        raise ValueError(f"query heads H={H} must be a multiple of KV={KV}")
    G = H // KV
    G_p = math.ceil(G / R)
    H_p = KV_p * G_p
    q_map = np.full(H_p, -1, np.int32)
    for r in range(KV):
        for i in range(R):
            for t in range(G_p):
                src = i * G_p + t
                if src < G:
                    q_map[(r * R + i) * G_p + t] = r * G + src
    kv_map = (np.arange(KV_p) // R).astype(np.int32)
    head_mask = (q_map >= 0).astype(np.float32)
    return H_p, KV_p, q_map, kv_map, head_mask


def layer_windows(cfg) -> np.ndarray:
    """Per-layer attention window (NO_WINDOW = global)."""
    L = cfg.n_layers
    if cfg.local_global_pattern and cfg.sliding_window:
        pat = cfg.local_global_pattern
        return np.array(
            [cfg.sliding_window if pat[i % len(pat)] == "local" else NO_WINDOW
             for i in range(L)], np.int32)
    return np.full(L, NO_WINDOW, np.int32)


# ----------------------------------------------------------------- init ----
def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Random parameters with the reference's shapes and init scales
    (``transformer.py::init_params``), drawn from ``generator`` (the
    numbers differ from JAX's; tests hand both packages the same weights
    through ``models.convert.params_from_jax``)."""
    device = resolve_device(device)
    D, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H_p, KV_p, q_map, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads)
    Vp = pad_vocab(cfg.vocab_size)
    out_scale = 1.0 / math.sqrt(2 * L)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, shape, fan_in, dtype, device, scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    wq = dense((L, D, H_p, hd), D)
    wq *= torch.as_tensor(q_map >= 0, dtype=dtype, device=device)[None, None, :, None]
    blocks = {
        "ln1": zeros(L, D),
        "ln2": zeros(L, D),
        "wq": wq,
        "wk": dense((L, D, cfg.n_kv_heads, hd), D),
        "wv": dense((L, D, cfg.n_kv_heads, hd), D),
        "wo": dense((L, H_p, hd, D), H_p * hd, out_scale),
    }
    if cfg.use_qk_norm:
        blocks["q_norm"] = zeros(L, hd)
        blocks["k_norm"] = zeros(L, hd)
    if cfg.post_attn_norm:
        blocks["ln1b"] = zeros(L, D)
        blocks["ln2b"] = zeros(L, D)
    if cfg.is_moe:
        blocks["moe"] = moe_init(generator, cfg, dtype, device, stack=(L,))
    else:
        blocks["mlp"] = mlp_init(generator, D, cfg.d_ff, cfg.mlp_act, dtype,
                                 device, out_scale, stack=(L,))
    params = {"embed": dense((Vp, D), 1, 0.02), "ln_f": zeros(D),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["head"] = dense((Vp, D), 1, 0.02)
    if cfg.family == "vlm":
        params["proj"] = {"ln": zeros(cfg.d_vision),
                          "w1": dense((cfg.d_vision, D), cfg.d_vision),
                          "w2": dense((D, D), D)}
    return params


def layer_params(blocks, l: int):
    """Views of layer ``l``'s weights out of the stacked ``blocks``."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


# ------------------------------------------------------------- embedding ---
def embed(params, cfg, tokens):
    x = params["embed"][tokens]
    if cfg.emb_scale_by_sqrt_dim:
        x = x * math.sqrt(cfg.d_model)
    return x


def vision_prefix(params, cfg, patches):
    """[B, Np, d_vision] precomputed patch embeds -> [B, Np, D] prefix."""
    p = params["proj"]
    h = rms_norm(patches, p["ln"], cfg.norm_eps)
    h = act_fn("gelu")(h @ p["w1"])
    return h @ p["w2"]


def unembed(params, cfg, x):
    """x [..., D] -> f32 logits [..., Vp]: the final softcap, if any, then
    the padded vocab columns set to NEG_INF.

    The reference asks XLA for f32 output from the product
    (``preferred_element_type``).  Here f32 weights multiply in f32; on
    the card bf16 weights go through ``torch.mm(..., out_dtype=float32)``
    (bf16 inputs, f32 accumulation and output); on the CPU they are
    upcast first."""
    table = params["head"] if "head" in params else params["embed"]
    x2 = x.reshape(-1, x.shape[-1])
    if table.dtype == torch.float32:
        logits = x2.float() @ table.t()
    elif x2.device.type == "cuda":
        logits = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ table.float().t()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    Vp = table.shape[0]
    if Vp != cfg.vocab_size:
        logits[:, cfg.vocab_size:] = NEG_INF
    return logits.reshape(*x.shape[:-1], Vp)


# ----------------------------------------------------------- block pieces --
def _qkv(cfg, lp, x):
    """x [..., D] -> q [..., H_p, hd], k/v [..., KV, hd]."""
    D, hd = x.shape[-1], cfg.head_dim
    lead = x.shape[:-1]
    q = (x @ lp["wq"].reshape(D, -1)).reshape(*lead, -1, hd)
    k = (x @ lp["wk"].reshape(D, -1)).reshape(*lead, -1, hd)
    v = (x @ lp["wv"].reshape(D, -1)).reshape(*lead, -1, hd)
    if cfg.use_qk_norm:
        q = head_rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_scale(cfg):
    return cfg.attn_scale_override or (1.0 / math.sqrt(cfg.head_dim))


def _head_mask(cfg, device, dtype):
    """[H_p] 0/1 mask of padded q heads, or None when no head is padded
    (always, at tp=1)."""
    mask = gqa_layout(cfg.n_heads, cfg.n_kv_heads)[4]
    return None if mask.all() else torch.as_tensor(mask, dtype=dtype, device=device)


def _o_proj(cfg, lp, o, head_mask):
    if head_mask is not None:
        o = o * head_mask[:, None]
    return o.flatten(-2) @ lp["wo"].reshape(-1, cfg.d_model)


def _ffn(cfg, lp, x2d):
    """x2d [T, D] -> y2d [T, D]: the MLP, or the MoE over all T tokens at
    once (expert capacity depends on T, as in the reference).  The MoE's
    aux loss belongs to training and is dropped."""
    if cfg.is_moe:
        act = act_fn("silu" if cfg.mlp_act == "silu" else "gelu")
        return moe_apply(lp["moe"], x2d, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, act=act,
                         capacity_factor=cfg.moe_capacity_factor)[0]
    return mlp_apply(lp["mlp"], x2d, cfg.mlp_act)


def _residuals(cfg, lp, x, attn_out):
    """The rest of a block after attention: x [..., D] plus the (post-
    normed) attention output, then plus the (post-normed) FFN."""
    if cfg.post_attn_norm:
        attn_out = rms_norm(attn_out, lp["ln1b"], cfg.norm_eps)
    x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = _ffn(cfg, lp, h2.reshape(-1, h2.shape[-1])).reshape(h2.shape)
    if cfg.post_attn_norm:
        y = rms_norm(y, lp["ln2b"], cfg.norm_eps)
    return x + y


# ------------------------------------------------------- full-seq forward --
def forward_hidden(params, cfg, x, positions, *, collect_kv=False,
                   kv_fake_quant=None):
    """Run the layer stack on full sequences. x [B, T, D]; positions
    [B, T] must be a per-row offset plus ``arange(T)`` (attention masks
    causally by sequence index, which is then the same as by position).

    kv_fake_quant: optional quantize-dequantize applied to K/V at the
    attention input only; the collected K/V stay fp (the int8 commit
    quantizes them to the same codes).  The int8 serving path uses it
    so the monolithic prefill attends to the values the chunked paths
    re-read from quantized pages.

    Returns (hidden [B, T, D], (k, v) each [L, B, T, KV_p, hd] or None).
    """
    B, T, _ = x.shape
    windows = layer_windows(cfg)
    head_mask = _head_mask(cfg, x.device, x.dtype)
    kv_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["blocks"], l)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ka, va = ((k, v) if kv_fake_quant is None
                  else (kv_fake_quant(k), kv_fake_quant(v)))
        o = ops.flash_attention(q, ka, va, kv_lens, scale=_attn_scale(cfg),
                                causal=True, window=int(windows[l]),
                                softcap=cfg.attn_logit_softcap)
        x = _residuals(cfg, lp, x, _o_proj(cfg, lp, o, head_mask))
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kv


def prefill(params, cfg, tokens, *, patches=None, kv_fake_quant=None):
    """Full-prompt prefill. tokens [B, S]; for the VLM family, optional
    ``patches`` [B, Np, d_vision] become a prefix of Np positions.

    Returns (last_logits [B, Vp], (k, v) each [L, B, S_tot, KV_p, hd]).
    """
    x = embed(params, cfg, tokens)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([vision_prefix(params, cfg, patches), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    hidden, kv = forward_hidden(params, cfg, x, positions, collect_kv=True,
                                kv_fake_quant=kv_fake_quant)
    return unembed(params, cfg, hidden[:, -1]), kv


# ------------------------------------------------------------ page writes --
def token_dest(block_table, seq_lens, active, page_size, trash):
    """(page, offset) int64 [B] where each sequence's next token lands;
    inactive rows go to the trash page (the pool's last page)."""
    slot = torch.clamp(seq_lens.long() // page_size, max=block_table.shape[1] - 1)
    pidx = block_table.gather(1, slot[:, None])[:, 0].long()
    if active is not None:
        pidx = torch.where(active, pidx, trash)
    return pidx, seq_lens.long() % page_size


def chunk_dest(block_table, start, lens, C, page_size, trash):
    """(page, offset) int64 [P*C] for a chunk of C tokens per row from
    ``start``; rows past ``lens`` go to the trash page.  Page lookups
    past the table's width are clamped to its last column first (JAX
    clamps gather indices; torch would raise), then discarded."""
    j = torch.arange(C, device=start.device)[None]                 # [1, C]
    gpos = start.long()[:, None] + j                               # [P, C]
    slot = torch.clamp(gpos // page_size, max=block_table.shape[1] - 1)
    pidx = block_table.gather(1, slot).long()
    pidx = torch.where(j < lens.long()[:, None], pidx, trash)
    return pidx.reshape(-1), (gpos % page_size).reshape(-1)


def _scatter(kpg, vpg, k, v, dest):
    """In-place write of k/v [M, KV_p, hd] to (page, offset) ``dest``.
    Duplicate trash-page slots are harmless: that page is never read."""
    kpg[dest] = k
    vpg[dest] = v


def _layer_pages(pages, l: int):
    """Layer ``l`` of a pool: a view of an fp pool, a dict of views of an
    int8 ``{"q", "s"}`` pool."""
    return ({n: t[l] for n, t in pages.items()} if isinstance(pages, dict)
            else pages[l])


def _pool_geometry(pages):
    """(page_size, trash page) of an fp or int8 pool [L, N, ps, ...]."""
    codes = pages["q"] if isinstance(pages, dict) else pages
    return codes.shape[2], codes.shape[1] - 1


def _write(kpg, vpg, k, v, dest):
    """In-place write of one layer's new fp K/V [M, KV_p, hd] to
    ``dest``; an int8 pool stores their ``q8_kv`` codes and scales."""
    if isinstance(kpg, dict):
        codes, scales = q8_kv(torch.stack([k, v]))
        _scatter(kpg["q"], vpg["q"], codes[0], codes[1], dest)
        _scatter(kpg["s"], vpg["s"], scales[0], scales[1], dest)
    else:
        _scatter(kpg, vpg, k, v, dest)


def _int8_paged_attention(q, kpg, vpg, block_table, kv_lens, q_pos, **kw):
    """``ops.paged_attention``'s signature over one layer of an int8 pool."""
    return ops.paged_attention_int8(q, kpg["q"], kpg["s"], vpg["q"], vpg["s"],
                                    block_table, kv_lens, q_pos, **kw)


def _paged_attention_for(pages):
    return (_int8_paged_attention if isinstance(pages, dict)
            else ops.paged_attention)


def write_kv_token(kpg, vpg, k, v, block_table, seq_lens, active=None):
    """Scatter one new token per sequence into the page pool, in place.

    kpg/vpg [N, ps, KV_p, hd]; k/v [B, KV_p, hd]. Returns (kpg, vpg).
    """
    dest = token_dest(block_table, seq_lens, active, kpg.shape[1],
                      kpg.shape[0] - 1)
    _scatter(kpg, vpg, k, v, dest)
    return kpg, vpg


def write_kv_chunk(kpg, vpg, k, v, block_table, start, lens):
    """Scatter a prefill chunk into pages, in place.

    kpg [N, ps, KV_p, hd]; k/v [P, C, KV_p, hd]; block_table [P, W];
    start [P] first position of chunk; lens [P] valid tokens (rest->trash).
    """
    P, C = k.shape[:2]
    dest = chunk_dest(block_table, start, lens, C, kpg.shape[1],
                       kpg.shape[0] - 1)
    _scatter(kpg, vpg, k.reshape(P * C, *k.shape[2:]),
             v.reshape(P * C, *v.shape[2:]), dest)
    return kpg, vpg


# ------------------------------------------------------------------ decode -
def decode(params, cfg, tokens, k_pages, v_pages, block_table, seq_lens, *,
           active=None, attn_fn=None):
    """One decode step. tokens [B]; pages [L, N, ps, KV_p, hd] fp or an
    int8 ``{"q", "s"}`` pool (written in place).

    attn_fn: a paged attention with ``ops.paged_attention``'s signature
    over one layer's pages (default: K1 for fp pools, K3 for int8 pools).
    Returns (logits [B, Vp], (k_pages, v_pages)).
    """
    attn_fn = attn_fn or _paged_attention_for(k_pages)
    windows = layer_windows(cfg)
    x = embed(params, cfg, tokens)                   # [B, D]
    head_mask = _head_mask(cfg, x.device, x.dtype)
    # per-step index work, shared by every layer
    bt = block_table.to(torch.int32)
    pos = seq_lens.to(torch.int32)                   # next position == current len
    kv_lens = pos + 1
    dest = token_dest(bt, pos, active, *_pool_geometry(k_pages))
    for l in range(cfg.n_layers):
        lp = layer_params(params["blocks"], l)
        kpg, vpg = _layer_pages(k_pages, l), _layer_pages(v_pages, l)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps))
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)       # [B,1,H_p,hd]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        _write(kpg, vpg, k, v, dest)
        o = attn_fn(q, kpg, vpg, bt, kv_lens, pos,
                    scale=_attn_scale(cfg), window=int(windows[l]),
                    softcap=cfg.attn_logit_softcap)
        x = _residuals(cfg, lp, x, _o_proj(cfg, lp, o[:, 0], head_mask))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x), (k_pages, v_pages)


# ------------------------------------------------------------------- mixed -
def mixed(params, cfg, mb, k_pages, v_pages, *, attn_fn=None):
    """Splitwiser fused step: prefill chunks + decode tokens in ONE step.

    mb keys (tensors on the pools' device):
      p_tokens [P, C]      prefill chunk tokens (pad id 0 beyond p_lens)
      p_table  [P, W]      page table rows for chunk sequences
      p_start  [P]         chunk start position (= history length)
      p_lens   [P]         valid tokens in chunk
      d_tokens [B]         decode tokens
      d_table  [B, Pmax]
      d_lens   [B]         current kv lens (before this step)
      d_active [B] bool

    Every GEMM (QKV/O/FFN/MoE/unembed) runs on the union of prefill and
    decode tokens; attention splits by phase.  ``attn_fn`` is an optional
    ``{"decode": fn, "chunk": fn}`` of paged attentions with
    ``ops.paged_attention``'s signature (default: K1 for fp pools, K3 for
    int8 ``{"q", "s"}`` pools).  Pages are written in place.

    Returns (p_logits [P, Vp] at each chunk's last valid token,
             d_logits [B, Vp], (k_pages, v_pages)).
    """
    attn_fn = attn_fn or {}
    decode_attn = attn_fn.get("decode") or _paged_attention_for(k_pages)
    chunk_attn = attn_fn.get("chunk") or _paged_attention_for(k_pages)
    windows = layer_windows(cfg)
    P, C = mb["p_tokens"].shape
    B = mb["d_tokens"].shape[0]
    D = cfg.d_model
    ps, trash = _pool_geometry(k_pages)

    x = torch.cat([embed(params, cfg, mb["p_tokens"]).reshape(P * C, D),
                   embed(params, cfg, mb["d_tokens"])], dim=0)   # [P*C+B, D]
    head_mask = _head_mask(cfg, x.device, x.dtype)
    # per-step index work, shared by every layer
    i32 = torch.int32
    p_table, d_table = mb["p_table"].to(i32), mb["d_table"].to(i32)
    p_start, p_lens = mb["p_start"].to(i32), mb["p_lens"].to(i32)
    d_lens = mb["d_lens"].to(i32)
    p_pos = p_start[:, None] + torch.arange(C, device=x.device, dtype=i32)[None]
    p_kv_lens, d_kv_lens = p_start + p_lens, d_lens + 1
    p_dest = chunk_dest(p_table, p_start, p_lens, C, ps, trash)
    d_dest = token_dest(d_table, d_lens, mb["d_active"], ps, trash)

    for l in range(cfg.n_layers):
        lp = layer_params(params["blocks"], l)
        kpg, vpg = _layer_pages(k_pages, l), _layer_pages(v_pages, l)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps))  # shared GEMM
        H_p, KV = q.shape[1], k.shape[1]
        qp, qd = q[: P * C].reshape(P, C, H_p, -1), q[P * C:][:, None]
        kp, kd = k[: P * C].reshape(P, C, KV, -1), k[P * C:]
        vp, vd = v[: P * C], v[P * C:]
        kw = dict(scale=_attn_scale(cfg), window=int(windows[l]),
                  softcap=cfg.attn_logit_softcap)

        # --- prefill-phase attention (write chunk KV + attend history) ---
        qp = rope(qp, p_pos, cfg.rope_theta)
        kp = rope(kp, p_pos, cfg.rope_theta).reshape(P * C, KV, -1)
        _write(kpg, vpg, kp, vp, p_dest)
        o_p = chunk_attn(qp, kpg, vpg, p_table, p_kv_lens, p_start, **kw)

        # --- decode-phase attention ---
        qd = rope(qd, d_lens[:, None], cfg.rope_theta)
        kd = rope(kd[:, None], d_lens[:, None], cfg.rope_theta)[:, 0]
        _write(kpg, vpg, kd, vd, d_dest)
        o_d = decode_attn(qd, kpg, vpg, d_table, d_kv_lens, d_lens, **kw)

        o = torch.cat([o_p.reshape(P * C, H_p, -1), o_d[:, 0]], dim=0)
        x = _residuals(cfg, lp, x, _o_proj(cfg, lp, o, head_mask))  # shared GEMMs
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)

    last = torch.clamp(p_lens.long() - 1, 0, C - 1)
    xp_last = x[: P * C].reshape(P, C, D)[torch.arange(P, device=x.device), last]
    p_logits = unembed(params, cfg, xp_last)
    d_logits = unembed(params, cfg, x[P * C:])
    return p_logits, d_logits, (k_pages, v_pages)


# -------------------------------------------------------------- page utils -
def init_pages(cfg, n_pages, page_size, dtype=torch.float32, device=None,
               n_layers=None):
    _, KV_p, _, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads)
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, n_pages, page_size, KV_p, cfg.head_dim)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_to_pages(kv, page_size):
    """Prefill output [L, B, S, KV_p, hd] -> pages [L, B*S/ps, ps, KV_p, hd]."""
    L, B, S, KVp, hd = kv.shape
    if S % page_size:
        raise ValueError(
            f"prefill length S={S} must be page-aligned (page_size="
            f"{page_size}); callers pad the token batch to whole pages")
    return kv.reshape(L, B * (S // page_size), page_size, KVp, hd)
