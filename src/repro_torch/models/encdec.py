"""Seamless-M4T-style encoder-decoder backbone in PyTorch.

The counterpart of the reference's ``models/encdec.py``, with its names,
layouts and parameter names (``embed``, ``enc_blocks``, ``enc_ln_f``,
``dec_blocks``, ``ln_f``; per-layer weights stacked on a leading axis,
``wq [L,D,H,hd]``, ``wo [L,H,hd,D]``; no ``head``: the unembedding is the
embedding).  The speech frontend is a stub: the encoder consumes
precomputed frame embeddings [B, S_enc, D] in the params' dtype.  Phases:
"prefill" = encoder pass + cross-KV build + decoder prompt prefill;
"decode" = decoder token steps (paged self-KV, written in place, + fixed
cross-KV).  The reference's engine serves only paged caches, so this
family is served at model level, as the zamba2 hybrid is.

Kernels, through ``kernels.ops``: flash attention (K2) for the encoder's
self-attention (non-causal, ``kv_lens`` = the valid frames), the
decoder's causal self-attention in prefill and every cross-attention
(non-causal, un-roped, T_q = the prompt in prefill and 1 in decode);
paged attention (K1) for the decoder's self-attention in decode.  K2
masks by index positions; that is exact here: the encoder and
cross-attention are non-causal with no window, so positions never enter
their masks, and the decoder's causal prefill numbers queries and keys
alike from 0.  The cross K/V are built once from the encoder output
(``build_cross_kv``) and read by every decoder pass.

On a mesh (``encode``, ``build_cross_kv``, ``prefill`` and ``decode``
with ``tp`` and a ``policy`` from ``models/sharding.py``) each rank runs
its shards of the ``tp``-padded tree (``init_params(..., tp=)``), as
``transformer.py`` does: its ``H_p / tp`` q heads and ``KV_p / tp`` KV
heads in every attention (k/v of fewer KV heads than ``tp`` expanded
into its padded slots), ``wo`` and the MLPs row-parallel with one
``all_reduce`` each, the embedding a vocab-parallel lookup (no scale, as
the reference's) and the logits gathered over ``model``.  Self-K/V, the
pools and the cross K/V ``[Ld, B, S_enc, KV_p / tp, hd]`` hold the rank's
rows and KV heads.  ``train_logits`` on a mesh gathers each layer's
FSDP'd weights as it runs (each decoder layer's cross K/V from its own),
under Megatron's ``copy_to``/``reduce_from``.  With ``policy=None``
nothing of this runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.layers import (dense_init, mlp_apply, mlp_init,
                                       rms_norm, rope)
from repro_torch.models.sharding import copy_to, gather_weights, layer_specs, reduce_from


def _attn_init(generator, cfg, L, dtype, device, out_scale, tp):
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    H_p, _, q_map, _, _ = T.gqa_layout(cfg.n_heads, KV, tp)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, (L,) + shape, fan_in, dtype, device, scale)

    wq = dense((D, H_p, hd), D)
    wq *= torch.as_tensor(q_map >= 0, dtype=dtype, device=device)[None, None, :, None]
    return {"wq": wq, "wk": dense((D, KV, hd), D),
            "wv": dense((D, KV, hd), D), "wo": dense((H_p, hd, D), H_p * hd, out_scale)}


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device=None, tp: int = 1):
    """Random parameters with the reference's shapes and init scales,
    drawn from ``generator`` in the reference's order (the numbers differ
    from JAX's; tests hand both packages the same weights through
    ``models.convert.params_from_jax``).  ``tp`` pads the q heads
    (``wq``/``wo``) as ``gqa_layout`` does; pad columns are zero."""
    device = resolve_device(device)
    D = cfg.d_model
    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    s_enc, s_dec = 1.0 / math.sqrt(2 * Le), 1.0 / math.sqrt(2 * Ld)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def mlp(L, scale):
        return mlp_init(generator, D, cfg.d_ff, cfg.mlp_act, dtype, device, scale,
                        stack=(L,))

    enc_attn = _attn_init(generator, cfg, Le, dtype, device, s_enc, tp)
    enc_blocks = {"ln1": zeros(Le, D), "attn": enc_attn, "ln2": zeros(Le, D),
                  "mlp": mlp(Le, s_enc)}
    dec_self = _attn_init(generator, cfg, Ld, dtype, device, s_dec, tp)
    dec_cross = _attn_init(generator, cfg, Ld, dtype, device, s_dec, tp)
    dec_blocks = {"ln1": zeros(Ld, D), "self": dec_self, "lnx": zeros(Ld, D),
                  "cross": dec_cross, "ln2": zeros(Ld, D), "mlp": mlp(Ld, s_dec)}
    return {
        "embed": dense_init(generator, (T.pad_vocab(cfg.vocab_size), D), 1, dtype,
                            device, 0.02),
        "enc_blocks": enc_blocks,
        "enc_ln_f": zeros(D),
        "dec_blocks": dec_blocks,
        "ln_f": zeros(D),
    }


def _scale(cfg):
    return 1.0 / math.sqrt(cfg.head_dim)


def _full_lens(x, n):
    return torch.full((x.shape[0],), n, dtype=torch.int32, device=x.device)


def _heads(cfg, x, tp, policy):
    """(head mask, KV index) of ``transformer.py`` for this rank."""
    return (T._head_mask(cfg, x.device, x.dtype, tp, policy),
            T._kv_index(cfg, x.device, tp, policy))


def _mlp(lp, x, cfg, policy):
    h = copy_to(rms_norm(x, lp["ln2"], cfg.norm_eps), policy)
    return reduce_from(mlp_apply(lp["mlp"], h, cfg.mlp_act), policy)


def _norm_qkv(cfg, ap, x, w, policy):
    """q/k/v of ``ap`` from x normed by ``w`` (under grad through
    ``copy_to``, and ``wk``/``wv`` of fewer KV heads than tp too)."""
    return T._qkv(cfg, T._tp_weights(cfg, ap, policy),
                  copy_to(rms_norm(x, w, cfg.norm_eps), policy))


def encode(params, cfg, frames, *, enc_valid_len=None, attend=None, tp=1,
           policy=None):
    """frames [B, S_enc, D] (stub frontend output) -> [B, S_enc, D].
    ``enc_valid_len`` [B]: keys at or past it are masked (None: all).
    ``attend``: ``ops.flash_attention`` (None) or, training,
    ``ops.flash_attention_ckpt``."""
    attend = attend or ops.flash_attention
    B, S, _ = frames.shape
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)
    kv_lens = _full_lens(frames, S) if enc_valid_len is None else enc_valid_len
    head_mask, kv_index = _heads(cfg, frames, tp, policy)
    specs = layer_specs(policy, "enc_blocks")
    x = frames
    for l in range(cfg.n_encoder_layers):
        lp = gather_weights(T.layer_params(params["enc_blocks"], l), specs, policy)
        q, k, v = _norm_qkv(cfg, lp["attn"], x, lp["ln1"], policy)
        q = rope(q, pos, cfg.rope_theta)
        k = T._expand_kv(rope(k, pos, cfg.rope_theta), kv_index)
        # non-causal, no window: K2's index positions mask only by kv_lens
        o = attend(q, k, T._expand_kv(v, kv_index), kv_lens, scale=_scale(cfg),
                   causal=False)
        x = x + T._o_proj(cfg, lp["attn"], o, head_mask, policy)
        x = x + _mlp(lp, x, cfg, policy)
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def build_cross_kv(params, cfg, enc_out, tp=1, policy=None):
    """Per-decoder-layer cross K/V from the encoder output.

    Returns (xk, xv) [Ld, B, S_enc, KV_p, hd] (on a mesh the rank's
    KV_p / tp; not roped: cross-attention uses raw keys; rope is
    self-attention only here).
    """
    cross = params["dec_blocks"]["cross"]
    kv_index = T._kv_index(cfg, enc_out.device, tp, policy)
    return tuple(T._expand_kv(torch.einsum("bsd,ldhk->lbshk", enc_out, cross[w]),
                              kv_index).contiguous() for w in ("wk", "wv"))


def _cross_kv_layer(cfg, ap, enc_out, kv_index, policy):
    """One decoder layer's cross K/V [B, S_enc, KV_p(/tp), hd] from the
    encoder output (``build_cross_kv``'s, a layer at a time: training
    gathers each layer's weights as it runs)."""
    ap = T._tp_weights(cfg, ap, policy)
    enc_out = copy_to(enc_out, policy)
    return tuple(T._expand_kv(torch.einsum("bsd,dhk->bshk", enc_out, ap[w]), kv_index)
                 for w in ("wk", "wv"))


def _cross_attention(cfg, ap, hx, xk, xv, kv_lens, attend=None, head_mask=None,
                     policy=None):
    """hx [B, T, D] against one layer's cross K/V [B, S_enc, KV, hd];
    non-causal, no window: K2's index positions mask only by kv_lens."""
    attend = attend or ops.flash_attention
    hx = copy_to(hx, policy)
    D = hx.shape[-1]
    qx = (hx @ ap["wq"].reshape(D, -1)).reshape(*hx.shape[:-1], -1, cfg.head_dim)
    o = attend(qx, xk, xv, kv_lens, scale=_scale(cfg), causal=False)
    return T._o_proj(cfg, ap, o, head_mask, policy)


def _decoder_seq(params, cfg, tokens, cross_kv=None, *, enc_out=None, collect_kv=False,
                 attend=None, tp=1, policy=None):
    """The decoder over whole prompts from position 0. tokens [B, T];
    cross_kv from ``build_cross_kv``, or None and each layer's from
    ``enc_out`` (training); ``attend`` as in :func:`encode`.
    Returns (hidden [B, T, D], (k, v) self-KV each [Ld, B, T, KV_p, hd] or
    None)."""
    attend = attend or ops.flash_attention
    x = T.embed_rows(T.table_of(params, policy, "embed"), tokens, policy)
    B, Tn, _ = x.shape
    pos = torch.arange(Tn, device=x.device)[None].expand(B, Tn)
    n_enc = enc_out.shape[1] if cross_kv is None else cross_kv[0].shape[2]
    self_lens, cross_lens = _full_lens(x, Tn), _full_lens(x, n_enc)
    head_mask, kv_index = _heads(cfg, x, tp, policy)
    specs = layer_specs(policy, "dec_blocks")
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = gather_weights(T.layer_params(params["dec_blocks"], l), specs, policy)
        xkv = (_cross_kv_layer(cfg, lp["cross"], enc_out, kv_index, policy)
               if cross_kv is None else (cross_kv[0][l], cross_kv[1][l]))
        q, k, v = _norm_qkv(cfg, lp["self"], x, lp["ln1"], policy)
        q = rope(q, pos, cfg.rope_theta)
        k = T._expand_kv(rope(k, pos, cfg.rope_theta), kv_index)
        v = T._expand_kv(v, kv_index)
        # causal, queries and keys both at positions 0..T-1: K2's index
        # positions are these positions
        o = attend(q, k, v, self_lens, scale=_scale(cfg), causal=True)
        x = x + T._o_proj(cfg, lp["self"], o, head_mask, policy)
        x = x + _cross_attention(cfg, lp["cross"], rms_norm(x, lp["lnx"], cfg.norm_eps),
                                 *xkv, cross_lens, attend, head_mask, policy)
        x = x + _mlp(lp, x, cfg, policy)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kv


def train_logits(params, cfg, batch, *, tp=1, policy=None, remat=False):
    """batch: frames [B, S_enc, D], tokens [B, T_dec].  Full-sequence
    logits [B, T_dec, Vp] (also the full-sequence oracle of the serving
    steps); the reference's (logits, aux loss) pair with aux 0.
    Differentiable in ``params``: every attention (the encoder's, the
    decoder's causal self-attention, the cross-attention) goes through
    ``ops.flash_attention_ckpt``.  ``remat`` is accepted and ignored, as
    in the reference.  On a mesh the rank's rows and heads, each layer's
    FSDP'd weights gathered as it runs (a decoder layer's cross K/V from
    its own gathered weights) and the rank's vocab columns [B, T_dec,
    Vp / tp] (the vocab-parallel loss's input)."""
    del remat
    ckpt = ops.flash_attention_ckpt
    enc_out = encode(params, cfg, batch["frames"], attend=ckpt, tp=tp, policy=policy)
    hidden, _ = _decoder_seq(params, cfg, batch["tokens"], enc_out=enc_out, attend=ckpt,
                             tp=tp, policy=policy)
    return (T.unembed(params, cfg, hidden, policy, gather=False),
            torch.zeros((), device=hidden.device))


def prefill(params, cfg, frames, tokens, *, tp=1, policy=None):
    """Encoder pass + decoder prompt prefill.

    Returns (last_logits, (k, v) self-KV [Ld,B,T,KV_p,hd],
             (xk, xv) cross-KV [Ld,B,S_enc,KV_p,hd]); on a mesh the
    rank's rows and KV heads.
    """
    cross = build_cross_kv(params, cfg, encode(params, cfg, frames, tp=tp, policy=policy),
                           tp, policy)
    hidden, kv = _decoder_seq(params, cfg, tokens, cross, collect_kv=True, tp=tp,
                              policy=policy)
    return T.unembed(params, cfg, hidden[:, -1], policy), kv, cross


def decode(params, cfg, tokens, k_pages, v_pages, cross_k, cross_v,
           block_table, seq_lens, *, attn_fn=None, enc_valid_len=None, tp=1,
           policy=None):
    """One decoder token step.

    tokens [B]; pages [Ld, N, ps, KV_p, hd], written in place; cross_k/v
    [Ld, B, S_enc, KV_p, hd]; ``enc_valid_len`` [B] masks cross keys at or
    past it (None: all).  ``attn_fn``: a paged attention with
    ``ops.paged_attention``'s signature over one layer's pages (default:
    K1; on a mesh ``launch/spmd.py::make_sharded_decode_attn``, whose
    pool-local table the page writes use too).
    Returns (logits [B, Vp], (k_pages, v_pages)).
    """
    attn_fn = attn_fn or ops.paged_attention
    x = T.embed_rows(params["embed"], tokens, policy)        # [B, D]
    head_mask, kv_index = _heads(cfg, x, tp, policy)
    # per-step index work, shared by every layer
    bt, _ = T._pool_local(attn_fn, block_table.to(torch.int32), k_pages)
    pos = seq_lens.to(torch.int32)                           # next position
    kv_lens = pos + 1
    dest = T.token_dest(bt, pos, None, *T._pool_geometry(k_pages))
    cross_lens = (_full_lens(x, cross_k.shape[2]) if enc_valid_len is None
                  else enc_valid_len)
    for l in range(cfg.n_layers):
        lp = T.layer_params(params["dec_blocks"], l)
        q, k, v = T._qkv(cfg, lp["self"], rms_norm(x, lp["ln1"], cfg.norm_eps))
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)   # [B,1,H,hd]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        kpg, vpg = k_pages[l], v_pages[l]
        T._scatter(kpg, vpg, T._expand_kv(k, kv_index), T._expand_kv(v, kv_index), dest)
        o = attn_fn(q, kpg, vpg, bt, kv_lens, pos, scale=_scale(cfg), window=None,
                    softcap=None)
        x = x + T._o_proj(cfg, lp["self"], o[:, 0], head_mask, policy)
        x = x + _cross_attention(cfg, lp["cross"],
                                 rms_norm(x, lp["lnx"], cfg.norm_eps)[:, None],
                                 cross_k[l], cross_v[l], cross_lens,
                                 head_mask=head_mask, policy=policy)[:, 0]
        x = x + _mlp(lp, x, cfg, policy)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return T.unembed(params, cfg, x, policy), (k_pages, v_pages)
