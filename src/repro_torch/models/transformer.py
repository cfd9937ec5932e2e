"""Decoder-only transformer (dense / MoE / VLM families) in PyTorch.

The steps of the reference ``models/transformer.py``:
  - train_hidden / train_logits (full-sequence causal, differentiable)
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
``models/registry.py`` decides which families this module serves.

Training (``train_hidden``) runs the same layer body with attention
through ``ops.flash_attention_ckpt`` (K2's forward with its
log-normalizer, a recompute backward) and carries the MoE aux loss; with
``remat`` each layer is a ``torch.utils.checkpoint`` region, recomputed
in the backward (K2 then launches twice a layer and step).

**On a mesh** (``prefill``, ``decode``, ``mixed`` and ``forward_hidden``
with a ``policy`` from ``models/sharding.py``) the same code runs on
this rank's local shards, Megatron-style: ``params`` are the rank's
slices (``launch/shardings.py::shard_params`` of the ``tp``-padded tree),
q/k/v and the pools hold its ``H_p/tp`` and ``KV_p/tp`` heads (k/v of a
model with fewer KV heads than ``tp`` replicated into padded slots, as
``gqa_layout`` says), ``wo`` and the FFN (``w_down``, or the MoE through
``moe_fn``, ``launch/spmd.py``) are row-parallel with one ``all_reduce``
over ``model`` each, ``embed`` is a masked lookup of the rank's vocab
rows plus an ``all_reduce`` and ``unembed`` its logits plus an
``all_gather``, so every rank returns the full ``Vp`` logits of its
data shard's rows.  Batch rows and pools are the rank's data shard; the
attention hooks (``attn_fn``) make block tables pool-local.  Nothing
crosses the data axis.  With ``policy=None`` nothing of this runs.

Weights the policy's placements (``Policy.params``) shard off the
tensor-parallel axis — ZeRO-3/FSDP over ``data``: grok-1-314b's serving
cells and every training cell, or over every axis in the ``fsdp``
training scheme — are gathered one layer at a time just before the
layer runs (``sharding.gather_weights``), inside the layer's remat
region in training, so a gathered layer dies with it and is gathered
again in the recompute; the embedding table just before the lookup and
the loss.  **Training on a mesh** differentiates through the collectives:
``copy_to`` at the input of each column-parallel product and on the
replicated weights used on the rank's heads (qk-norm scales, k/v of
fewer KV heads than ``tp``), ``reduce_from`` after each row-parallel
one, ``fsdp_gather``'s reduce-scatter for the FSDP'd gradients
(``models/sharding.py``).
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.kv_int8 import q8_kv
from repro_torch.models.layers import (NEG_INF, NO_WINDOW, act_fn,
                                       dense_init, head_rms_norm, mlp_apply,
                                       mlp_init, rms_norm, rope, softcap)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.sharding import (copy_to, copy_weights, gather_from, gather_weight,
                                         gather_weights, layer_specs, reduce_from)

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
                device=None, tp: int = 1):
    """Random parameters with the reference's shapes and init scales
    (``transformer.py::init_params``), drawn from ``generator`` (the
    numbers differ from JAX's; tests hand both packages the same weights
    through ``models.convert.params_from_jax``).  ``tp`` pads the q heads
    (``wq``/``wo``) as ``gqa_layout`` does; pad columns are zero."""
    device = resolve_device(device)
    D, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H_p, KV_p, q_map, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
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


def layer_list(blocks, n: int):
    """Every layer's weights out of the stacked ``blocks`` at once
    (``unbind``): under autograd one backward node per stacked tensor
    stacks the layers' gradients, where ``layer_params`` would add a
    full-size gradient per layer."""
    parts = {k: (layer_list(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in blocks.items()}
    return [{k: p[l] for k, p in parts.items()} for l in range(n)]


def maybe_remat(fn, x, remat: bool):
    """``fn(x)``, as a ``torch.utils.checkpoint`` region when ``remat``:
    its activations are recomputed in the backward instead of kept."""
    return checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


# ------------------------------------------------------------- embedding ---
def _vocab_start(table, policy):
    """First vocab id of this rank's rows of an embedding table."""
    return 0 if policy is None else policy.tp_index * table.shape[0]


def _table_spec(policy, name):
    """The placement of table ``name`` ("embed" or "head"), or None."""
    return None if policy is None or policy.params is None else policy.params.get(name)


def table_of(params, policy=None, name=None):
    """The unembedding table (``head``, else the tied ``embed``; ``name``
    picks one), its FSDP'd dims gathered: [Vp(/tp), D]."""
    name = name or ("head" if "head" in params else "embed")
    return gather_weight(params[name], _table_spec(policy, name), policy)


def embed_rows(table, tokens, policy=None):
    """Rows of ``table`` [V(/tp), D] for ``tokens``; on a mesh, the rank's
    vocab rows masked to the tokens they hold, summed over ``model``."""
    if policy is None:
        return table[tokens]
    local = tokens.long() - _vocab_start(table, policy)
    hit = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)]
    return reduce_from(torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                   device=x.device)), policy)


def embed(params, cfg, tokens, policy=None):
    """Token rows of ``embed`` (vocab-parallel on a mesh, ``embed_rows``),
    scaled by sqrt(d_model) where the config says so."""
    x = embed_rows(table_of(params, policy, "embed"), tokens, policy)
    if cfg.emb_scale_by_sqrt_dim:
        x = x * math.sqrt(cfg.d_model)
    return x


def vision_prefix(params, cfg, patches):
    """[B, Np, d_vision] precomputed patch embeds -> [B, Np, D] prefix."""
    p = params["proj"]
    h = rms_norm(patches, p["ln"], cfg.norm_eps)
    h = act_fn("gelu")(h @ p["w1"])
    return h @ p["w2"]


def unembed(params, cfg, x, policy=None, gather=True):
    """x [..., D] -> f32 logits [..., Vp]: the final softcap, if any, then
    the padded vocab columns set to NEG_INF.  On a mesh each rank computes
    its vocab columns, gathered over ``model`` in rank order (with
    ``gather=False`` its own columns [..., Vp / tp], for a vocab-parallel
    loss).

    The reference asks XLA for f32 output from the product
    (``preferred_element_type``).  Here f32 (and f64) weights multiply in
    their own dtype; on the card bf16 weights go through ``torch.mm(...,
    out_dtype=float32)`` (bf16 inputs, f32 accumulation and output); on
    the CPU they are upcast first."""
    table = table_of(params, policy)
    x2 = copy_to(x.reshape(-1, x.shape[-1]), policy)
    if table.dtype in (torch.float32, torch.float64):
        logits = x2.to(table.dtype) @ table.t()
    elif x2.device.type == "cuda":
        logits = torch.mm(x2, table.t(), out_dtype=torch.float32)
    else:
        logits = x2.float() @ table.float().t()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    pad = cfg.vocab_size - _vocab_start(table, policy)   # first padded local column
    if pad < table.shape[0]:
        logits[:, max(pad, 0):] = NEG_INF
    if gather:
        logits = gather_from(logits, policy, dim=-1)
    return logits.reshape(*x.shape[:-1], logits.shape[-1])


# ----------------------------------------------------------- block pieces --
def _qkv(cfg, lp, x):
    """x [..., D] -> q [..., H_p, hd], k/v [..., KV, hd] (on a mesh:
    ``x`` after ``copy_to``, ``lp`` after ``_tp_weights``)."""
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


def _rank_slice(a, tp, policy):
    """This rank's block of a per-head array (all of it without a policy)."""
    if policy is None:
        return a
    n = len(a) // tp
    return a[policy.tp_index * n:(policy.tp_index + 1) * n]


def _tp_weights(cfg, lp, policy):
    """Layer weights replicated over the tensor-parallel axis but used on
    the rank's heads, through ``copy_to`` so their gradients sum over it:
    the qk-norm scales, and ``wk``/``wv`` where the KV heads do not shard
    (fewer than ``tp``: each rank expands its own padded slots)."""
    if policy is None or policy.tp_axis is None:
        return lp
    names = ("q_norm", "k_norm") + (("wk", "wv") if cfg.n_kv_heads % policy.tp else ())
    return copy_weights(lp, names, policy)


def _head_mask(cfg, device, dtype, tp=1, policy=None):
    """[H_p] (this rank's [H_p / tp] on a mesh) 0/1 mask of padded q heads,
    or None when no head is padded (always, at tp=1)."""
    mask = _rank_slice(gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)[4], tp, policy)
    return None if mask.all() else torch.as_tensor(mask, dtype=dtype, device=device)


def _kv_index(cfg, device, tp=1, policy=None):
    """Indices into k/v's heads (``wk``/``wv``'s) of the padded KV heads
    (this rank's on a mesh), or None when they are those heads as they
    are: KV divides ``tp`` (then ``wk``/``wv`` shard along heads) or tp = 1."""
    if policy is not None and policy.tp != tp:
        raise ValueError(f"tp={tp} but the mesh's model axis has {policy.tp} ranks")
    if cfg.n_kv_heads % tp == 0:
        return None
    kv_map = _rank_slice(gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)[3], tp, policy)
    return torch.as_tensor(kv_map, dtype=torch.long, device=device)


def _expand_kv(t, kv_index):
    """k/v [..., KV, hd] -> the padded heads [..., KV_p(/tp), hd]."""
    return t if kv_index is None else t.index_select(-2, kv_index)


def _o_proj(cfg, lp, o, head_mask, policy=None):
    if head_mask is not None:
        o = o * head_mask[:, None]
    return reduce_from(o.flatten(-2) @ lp["wo"].reshape(-1, cfg.d_model), policy)


def _ffn(cfg, lp, x2d, policy=None, moe_fn=None):
    """x2d [T, D] -> (y2d [T, D], aux): the MLP (aux None), or the MoE
    over all T tokens at once (expert capacity depends on T, as in the
    reference) with its load-balancing aux loss.  On a mesh the MLP's
    partial sums are reduced over ``model`` and the MoE is ``moe_fn``
    (``launch/spmd.py::make_sharded_moe_fn``, which reduces them)."""
    if cfg.is_moe:
        if moe_fn is not None:
            return moe_fn(lp["moe"], x2d)
        if policy is not None:
            raise ValueError("an MoE model on a mesh needs moe_fn="
                             "launch.spmd.make_sharded_moe_fn(...)")
        act = act_fn("silu" if cfg.mlp_act == "silu" else "gelu")
        return moe_apply(lp["moe"], x2d, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, act=act,
                         capacity_factor=cfg.moe_capacity_factor)
    return reduce_from(mlp_apply(lp["mlp"], copy_to(x2d, policy), cfg.mlp_act), policy), None


def _residuals(cfg, lp, x, attn_out, return_aux=False, policy=None, moe_fn=None):
    """The rest of a block after attention: x [..., D] plus the (post-
    normed) attention output, then plus the (post-normed) FFN.  With
    ``return_aux``, (x, the FFN's aux loss or None); serving drops it."""
    if cfg.post_attn_norm:
        attn_out = rms_norm(attn_out, lp["ln1b"], cfg.norm_eps)
    x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h2.reshape(-1, h2.shape[-1]), policy, moe_fn)
    y = y.reshape(h2.shape)
    if cfg.post_attn_norm:
        y = rms_norm(y, lp["ln2b"], cfg.norm_eps)
    return (x + y, aux) if return_aux else x + y


# ------------------------------------------------------- full-seq forward --
def _seq_block(cfg, lp, window, positions, kv_lens, head_mask, x, *,
               attend=None, kv_fake_quant=None, kv_index=None, policy=None,
               moe_fn=None):
    """One layer on full sequences. x [B, T, D].  ``attend`` has
    ``ops.flash_attention``'s signature (None: that;
    ``ops.flash_attention_ckpt`` for training).  Returns (x, FFN aux or
    None, k, v) with k/v in the padded KV heads."""
    q, k, v = _qkv(cfg, _tp_weights(cfg, lp, policy),
                   copy_to(rms_norm(x, lp["ln1"], cfg.norm_eps), policy))
    q = rope(q, positions, cfg.rope_theta)
    k = _expand_kv(rope(k, positions, cfg.rope_theta), kv_index)
    v = _expand_kv(v, kv_index)
    ka, va = ((k, v) if kv_fake_quant is None
              else (kv_fake_quant(k), kv_fake_quant(v)))
    attend = attend or ops.flash_attention
    o = attend(q, ka, va, kv_lens, scale=_attn_scale(cfg), causal=True,
               window=window, softcap=cfg.attn_logit_softcap)
    x, aux = _residuals(cfg, lp, x, _o_proj(cfg, lp, o, head_mask, policy),
                        return_aux=True, policy=policy, moe_fn=moe_fn)
    return x, aux, k, v


def forward_hidden(params, cfg, x, positions, *, collect_kv=False,
                   kv_fake_quant=None, tp=1, policy=None, moe_fn=None):
    """Run the layer stack on full sequences. x [B, T, D]; positions
    [B, T] must be a per-row offset plus ``arange(T)`` (attention masks
    causally by sequence index, which is then the same as by position).

    kv_fake_quant: optional quantize-dequantize applied to K/V at the
    attention input only; the collected K/V stay fp (the int8 commit
    quantizes them to the same codes).  The int8 serving path uses it
    so the monolithic prefill attends to the values the chunked paths
    re-read from quantized pages.

    Returns (hidden [B, T, D], (k, v) each [L, B, T, KV_p, hd] or None;
    on a mesh this rank's [L, B, T, KV_p / tp, hd]).
    """
    B, T, _ = x.shape
    windows = layer_windows(cfg)
    head_mask = _head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = _kv_index(cfg, x.device, tp, policy)
    kv_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    wspecs = layer_specs(policy)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = gather_weights(layer_params(params["blocks"], l), wspecs, policy)
        x, _, k, v = _seq_block(cfg, lp, int(windows[l]), positions, kv_lens, head_mask, x,
                                kv_fake_quant=kv_fake_quant, kv_index=kv_index,
                                policy=policy, moe_fn=moe_fn)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kv


def _train_block(cfg, lp, window, positions, kv_lens, head_mask, kv_index, policy,
                 moe_fn, wspecs, x):
    lp = gather_weights(lp, wspecs, policy)
    x, aux, _, _ = _seq_block(cfg, lp, window, positions, kv_lens, head_mask, x,
                              attend=ops.flash_attention_ckpt, kv_index=kv_index,
                              policy=policy, moe_fn=moe_fn)
    return x, aux


def train_hidden(params, cfg, batch, *, tp=1, policy=None, moe_fn=None, remat=False):
    """batch: tokens [B, T] (+ patches [B, Np, d_vision] for vlm, a
    prefix of Np positions).  Returns (hidden [B, T_tot, D], aux: the
    MoE aux losses summed over layers, an f32 scalar (0 for dense)).
    Differentiable in ``params``; attention through
    ``ops.flash_attention_ckpt``; ``remat`` recomputes each layer in the
    backward (the reference's ``jax.checkpoint`` of its scan body).

    ``tp`` pads and masks the q heads as ``gqa_layout`` says (with no
    policy, one process runs the padded layout: the tp = 8 relayout of a
    checkpoint computes the tp = 1 function).  On a mesh (``policy``,
    ``moe_fn`` as for ``prefill``) the rank runs its heads, its data
    shard's rows and its gathered layers; the hidden state is replicated
    over the tensor-parallel axis."""
    x = embed(params, cfg, batch["tokens"], policy)
    if cfg.family == "vlm":
        x = torch.cat([vision_prefix(params, cfg, batch["patches"]), x], dim=1)
    B, Tn, _ = x.shape
    positions = torch.arange(Tn, device=x.device)[None].expand(B, Tn)
    kv_lens = torch.full((B,), Tn, dtype=torch.int32, device=x.device)
    head_mask = _head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = _kv_index(cfg, x.device, tp, policy)
    wspecs = layer_specs(policy)
    windows = layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, lp in enumerate(layer_list(params["blocks"], cfg.n_layers)):
        x, a = maybe_remat(partial(_train_block, cfg, lp, int(windows[l]), positions,
                                   kv_lens, head_mask, kv_index, policy, moe_fn,
                                   wspecs), x, remat)
        if a is not None:
            aux = aux + a
    return rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def train_logits(params, cfg, batch, *, tp=1, policy=None, moe_fn=None, remat=False):
    """(f32 logits [B, T_tot, Vp], aux) of :func:`train_hidden` (on a mesh
    every rank's logits whole, gathered over the tensor-parallel axis)."""
    hidden, aux = train_hidden(params, cfg, batch, tp=tp, policy=policy, moe_fn=moe_fn,
                               remat=remat)
    return unembed(params, cfg, hidden, policy), aux


def prefill(params, cfg, tokens, *, patches=None, kv_fake_quant=None, tp=1,
            policy=None, moe_fn=None):
    """Full-prompt prefill. tokens [B, S]; for the VLM family, optional
    ``patches`` [B, Np, d_vision] become a prefix of Np positions.

    Returns (last_logits [B, Vp], (k, v) each [L, B, S_tot, KV_p, hd]);
    on a mesh, the rank's rows and its KV heads.
    """
    x = embed(params, cfg, tokens, policy)
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([vision_prefix(params, cfg, patches), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    hidden, kv = forward_hidden(params, cfg, x, positions, collect_kv=True,
                                kv_fake_quant=kv_fake_quant, tp=tp,
                                policy=policy, moe_fn=moe_fn)
    return unembed(params, cfg, hidden[:, -1], policy), kv


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


def _pool_local(attn_fn, block_table, pages):
    """(The block table as ``attn_fn`` reads it, the batch rows it writes
    and attends): a mesh hook (``launch/spmd.py``) makes global page ids
    pool-local and keeps its rows (a data shard's in the decode ``2d``
    scheme); others read the table as it is, every row.  Page writes use
    the same table."""
    if not hasattr(attn_fn, "local_table"):
        return block_table, slice(None)
    return (attn_fn.local_table(block_table, pages),
            attn_fn.row_slice(block_table.shape[0]))


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
           active=None, attn_fn=None, tp=1, policy=None, moe_fn=None):
    """One decode step. tokens [B]; pages [L, N, ps, KV_p, hd] fp or an
    int8 ``{"q", "s"}`` pool (written in place).

    attn_fn: a paged attention with ``ops.paged_attention``'s signature
    over one layer's pages (default: K1 for fp pools, K3 for int8 pools;
    on a mesh ``launch/spmd.py::make_sharded_decode_attn``).
    Returns (logits [B, Vp], (k_pages, v_pages)).
    """
    attn_fn = attn_fn or _paged_attention_for(k_pages)
    windows = layer_windows(cfg)
    x = embed(params, cfg, tokens, policy)           # [B, D]
    head_mask = _head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = _kv_index(cfg, x.device, tp, policy)
    # per-step index work, shared by every layer; ``rows``: those the hook
    # writes and attends (the decode 2d scheme's data shard of a batch
    # replicated over data; else all)
    bt, rows = _pool_local(attn_fn, block_table.to(torch.int32), k_pages)
    pos = seq_lens.to(torch.int32)                   # next position == current len
    pos_r = pos[rows]
    kv_lens = pos_r + 1
    dest = token_dest(bt, pos_r, None if active is None else active[rows],
                      *_pool_geometry(k_pages))
    wspecs = layer_specs(policy)
    for l in range(cfg.n_layers):
        lp = gather_weights(layer_params(params["blocks"], l), wspecs, policy)
        kpg, vpg = _layer_pages(k_pages, l), _layer_pages(v_pages, l)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps))
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)       # [B,1,H_p,hd]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        _write(kpg, vpg, _expand_kv(k, kv_index)[rows], _expand_kv(v, kv_index)[rows], dest)
        o = attn_fn(q[rows], kpg, vpg, bt, kv_lens, pos_r,
                    scale=_attn_scale(cfg), window=int(windows[l]),
                    softcap=cfg.attn_logit_softcap)
        x = _residuals(cfg, lp, x, _o_proj(cfg, lp, o[:, 0], head_mask, policy),
                       policy=policy, moe_fn=moe_fn)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, cfg, x, policy), (k_pages, v_pages)


# ------------------------------------------------------------------- mixed -
def mixed(params, cfg, mb, k_pages, v_pages, *, attn_fn=None, tp=1,
          policy=None, moe_fn=None):
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
    int8 ``{"q", "s"}`` pools; on a mesh ``launch/spmd.py``'s hooks, and
    ``mb`` holds the rank's data shard's streams and decode rows, so the
    MoE's capacity comes from that shard's tokens).  Pages are written in
    place.

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

    x = torch.cat([embed(params, cfg, mb["p_tokens"], policy).reshape(P * C, D),
                   embed(params, cfg, mb["d_tokens"], policy)], dim=0)   # [P*C+B, D]
    head_mask = _head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = _kv_index(cfg, x.device, tp, policy)
    # per-step index work, shared by every layer
    i32 = torch.int32
    p_table, _ = _pool_local(chunk_attn, mb["p_table"].to(i32), k_pages)
    d_table, _ = _pool_local(decode_attn, mb["d_table"].to(i32), k_pages)
    p_start, p_lens = mb["p_start"].to(i32), mb["p_lens"].to(i32)
    d_lens = mb["d_lens"].to(i32)
    p_pos = p_start[:, None] + torch.arange(C, device=x.device, dtype=i32)[None]
    p_kv_lens, d_kv_lens = p_start + p_lens, d_lens + 1
    p_dest = chunk_dest(p_table, p_start, p_lens, C, ps, trash)
    d_dest = token_dest(d_table, d_lens, mb["d_active"], ps, trash)

    wspecs = layer_specs(policy)
    for l in range(cfg.n_layers):
        lp = gather_weights(layer_params(params["blocks"], l), wspecs, policy)
        kpg, vpg = _layer_pages(k_pages, l), _layer_pages(v_pages, l)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln1"], cfg.norm_eps))  # shared GEMM
        k, v = _expand_kv(k, kv_index), _expand_kv(v, kv_index)
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
        x = _residuals(cfg, lp, x, _o_proj(cfg, lp, o, head_mask, policy),  # shared GEMMs
                       policy=policy, moe_fn=moe_fn)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)

    last = torch.clamp(p_lens.long() - 1, 0, C - 1)
    xp_last = x[: P * C].reshape(P, C, D)[torch.arange(P, device=x.device), last]
    p_logits = unembed(params, cfg, xp_last, policy)
    d_logits = unembed(params, cfg, x[P * C:], policy)
    return p_logits, d_logits, (k_pages, v_pages)


# -------------------------------------------------------------- page utils -
def init_pages(cfg, n_pages, page_size, dtype=torch.float32, device=None,
               n_layers=None, tp=1):
    _, KV_p, _, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
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
