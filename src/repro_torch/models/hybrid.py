"""Zamba2-style hybrid in PyTorch: Mamba2 backbone + ONE shared attention
block applied every ``shared_attn_every``-th layer-unit with
per-invocation LoRA deltas.

The counterpart of the reference's ``models/hybrid.py``, with its names,
layouts and parameter names.  Layer-unit layout (cfg.n_layers = 81):
13 groups x (5 mamba + 1 shared attn) + 3 trailing mamba = 68 mamba units
+ 13 attn invocations.  The shared block takes concat(hidden,
initial_embedding) [2D] as input (Zamba's re-injection of the embedding
stream).  Mamba weights are stacked ``[n_mamba, ...]``, LoRA deltas
``[n_attn, ...]``; the reference's ``lax.scan`` over groups and units is
a Python loop over those axes.

Kernels, through ``kernels.ops``: the SSD scan (K4) in every Mamba2 block
of a prefill, flash attention (K2) in the shared block of a prefill,
paged attention (K1) in the shared block of a decode step; their plain
versions for CPU tensors. ``train_logits`` is differentiable on both
devices: the shared block attends through ``ops.flash_attention_ckpt``,
and on the card each scan's backward is K4's backward kernel
(``kernels/ssd_scan.py::SSDScanFn``); on the CPU autograd differentiates
the plain scan.  Page pools ``[n_attn, N, ps, KV_p, hd]`` and the
conv/SSM states are updated in place by ``decode``.

On a mesh (``forward_seq``/``prefill``/``decode`` with ``tp`` and a
``policy`` from ``models/sharding.py``) each rank runs its shards of the
``tp``-padded tree (``init_params(..., tp=)``): its Mamba2 heads
(``models/ssm.py``; conv and SSM states of its channels and heads, from
``ssm.mamba2_state_shapes(..., tp)``), and in the shared block its
``H_p / tp`` q heads (``wq``, LoRA ``qb``) and ``KV_p / tp`` KV heads
(``wk``/``wv`` and LoRA ``kb``/``vb`` sharded along heads, or with
fewer KV heads than ``tp`` whole and expanded into the rank's padded
slots, ``kb``/``vb`` then gathered over ``model``), while ``ln1`` over
2D and the LoRA ``qa``/``ka``/``va`` stay whole.  ``wo`` and the MLP are
row-parallel (one ``all_reduce`` each, ``transformer.py``'s), embed and
unembed vocab-parallel.  ``decode`` attends through ``attn_fn`` (on a mesh
``launch/spmd.py::make_sharded_decode_attn``, K1 over the rank's pool
with pool-local tables).  ``train_logits`` on a mesh runs K4's autograd
forward and backward on the rank's whole heads (no collective inside the
scan) and the shared block's K2 training forward on its heads, each
block's FSDP'd weights gathered in its remat region, under Megatron's
``copy_to``/``reduce_from`` (``models/sharding.py``).  With
``policy=None`` nothing of this runs.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_init, mlp_init, rms_norm, rope
from repro_torch.models.sharding import (copy_to, copy_weights, fsdp_gather, gather_weights,
                                         layer_specs)


def group_structure(cfg):
    """(n_attn, n_mamba, n_grouped, n_trailing, n_per_group).

    Every cfg.shared_attn_every-th layer-unit is the shared attn block;
    full zamba2-7b: 81 units -> 13 attn + 68 mamba (13x5 grouped + 3 trail).
    """
    n_per_group = cfg.shared_attn_every - 1
    n_attn = cfg.n_layers // cfg.shared_attn_every
    n_mamba = cfg.n_layers - n_attn
    n_grouped = n_attn * n_per_group
    n_trailing = n_mamba - n_grouped
    return n_attn, n_mamba, n_grouped, n_trailing, n_per_group


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device=None, tp: int = 1):
    """Random parameters with the reference's shapes and init scales
    (``hybrid.py::init_params``), drawn from ``generator`` in the
    reference's order (the numbers differ from JAX's; tests hand both
    packages the same weights through ``models.convert.params_from_jax``).
    ``tp`` pads the q heads (``wq``, ``wo``, LoRA ``qb``) as
    ``gqa_layout`` does; pad columns are zero."""
    device = resolve_device(device)
    D, hd, KV = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    H_p, _, q_map, _, _ = T.gqa_layout(cfg.n_heads, KV, tp)
    n_attn, n_mamba, _, _, _ = group_structure(cfg)
    r = cfg.shared_attn_lora_rank
    out_scale = 1.0 / math.sqrt(2 * n_attn)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, shape, fan_in, dtype, device, scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    wq = dense((2 * D, H_p, hd), 2 * D)
    wq *= torch.as_tensor(q_map >= 0, dtype=dtype, device=device)[None, :, None]
    shared = {
        "ln1": zeros(2 * D),
        "wq": wq,
        "wk": dense((2 * D, KV, hd), 2 * D),
        "wv": dense((2 * D, KV, hd), 2 * D),
        "wo": dense((H_p, hd, D), H_p * hd, out_scale),
        "ln2": zeros(D),
        "mlp": mlp_init(generator, D, cfg.d_ff, cfg.mlp_act, dtype, device,
                        out_scale),
    }
    lora = {
        "qa": dense((n_attn, 2 * D, r), 2 * D),
        "qb": zeros(n_attn, r, H_p * hd),
        "ka": dense((n_attn, 2 * D, r), 2 * D),
        "kb": zeros(n_attn, r, KV * hd),
        "va": dense((n_attn, 2 * D, r), 2 * D),
        "vb": zeros(n_attn, r, KV * hd),
    }
    return {
        "embed": dense((T.pad_vocab(cfg.vocab_size), D), 1, 0.02),
        "mamba": ssm.mamba2_init(generator, cfg, dtype, device, stack=(n_mamba,)),
        "shared": shared,
        "lora": lora,
        "ln_f": zeros(D),
    }


def _shared_qkv(cfg, shared, lora_i, h2, policy=None):
    """h2 [..., 2D] -> q [..., H_p, hd], k/v [..., KV, hd] with LoRA deltas
    (on a mesh the rank's q heads and ``wk``/``wv``'s heads; a LoRA
    ``kb``/``vb`` sharded finer than those, KV < tp, is gathered, and under
    grad its gradient reduce-scattered: each rank reads its own KV slots
    of the gathered delta).  Under grad the weights every rank holds
    whole (the LoRA ``qa``/``ka``/``va``, ``wk``/``wv`` of fewer KV heads
    than tp) pass ``copy_to``."""
    hd, D2 = cfg.head_dim, h2.shape[-1]
    lead = h2.shape[:-1]
    shared = T._tp_weights(cfg, shared, policy)
    lora_i = copy_weights(lora_i, ("qa", "ka", "va"), policy)

    def proj(w, a, b):
        base, delta = h2 @ w.reshape(D2, -1), (h2 @ a) @ b
        if delta.shape[-1] != base.shape[-1]:
            delta = fsdp_gather(delta, policy, policy.tp_axis, -1)
        return (base + delta).reshape(*lead, -1, hd)

    return (proj(shared["wq"], lora_i["qa"], lora_i["qb"]),
            proj(shared["wk"], lora_i["ka"], lora_i["kb"]),
            proj(shared["wv"], lora_i["va"], lora_i["vb"]))


def _attn_out(cfg, shared, x, o, head_mask=None, policy=None):
    """Residual output projection and MLP of the shared block."""
    return T._residuals(cfg, shared, x, T._o_proj(cfg, shared, o, head_mask, policy),
                        policy=policy)


def _shared_block_seq(cfg, shared, lora_i, x, x0, positions, *,
                      collect_kv=False, attend=None, head_mask=None,
                      kv_index=None, policy=None):
    """Full-seq shared attention block. x/x0 [B,T,D]; positions [B,T];
    ``attend``: ``ops.flash_attention`` (None) or, training,
    ``ops.flash_attention_ckpt``.  The k/v it attends to and collects
    are in the padded KV heads (``kv_index``, as ``transformer.py``)."""
    h2 = copy_to(rms_norm(torch.cat([x, x0], dim=-1), shared["ln1"], cfg.norm_eps), policy)
    q, k, v = _shared_qkv(cfg, shared, lora_i, h2, policy)
    q = rope(q, positions, cfg.rope_theta)
    k = T._expand_kv(rope(k, positions, cfg.rope_theta), kv_index)
    v = T._expand_kv(v, kv_index)
    kv_lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    attend = attend or ops.flash_attention
    o = attend(q, k, v, kv_lens, scale=1.0 / math.sqrt(cfg.head_dim), causal=True)
    return (_attn_out(cfg, shared, x, o, head_mask, policy),
            ((k, v) if collect_kv else None))


def forward_seq(params, cfg, tokens, *, collect_kv=False, chunk=64,
                train=False, remat=False, tp=1, policy=None):
    """Full-sequence forward (prefill / the full-sequence oracle) from
    zero conv and SSM states.

    Returns (hidden [B,T,D], (k, v) each [n_attn, B, T, KV_p, hd] or
    None, (conv_states, ssm_states)), the states stacked [n_mamba, ...];
    on a mesh the rank's heads and channels.
    With ``train`` only the hidden is returned (no KV, states None),
    attention goes through ``ops.flash_attention_ckpt``, and ``remat``
    recomputes each Mamba2 block and shared block in the backward; on a
    mesh each block gathers its FSDP'd weights (``policy.params``) inside
    its remat region, the shared block's at each of its uses.
    """
    n_attn, n_mamba, n_grouped, _, n_per_group = group_structure(cfg)
    x = T.embed(params, cfg, tokens, policy)
    x0 = x
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    head_mask = T._head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = T._kv_index(cfg, x.device, tp, policy)
    cs_shape, ss_shape = ssm.mamba2_state_shapes(cfg, B, 1 if policy is None else policy.tp)
    dt = params["embed"].dtype
    conv0 = {k: torch.zeros(v, dtype=dt, device=x.device) for k, v in cs_shape.items()}
    conv_out = {k: torch.empty((n_mamba,) + v, dtype=dt, device=x.device)
                for k, v in cs_shape.items()}
    ssm_out = torch.empty((n_mamba,) + ss_shape, dtype=torch.float32, device=x.device)

    if train:
        mambas = T.layer_list(params["mamba"], n_mamba)
        loras = T.layer_list(params["lora"], n_attn)
        specs = {k: layer_specs(policy, k, stacked=k != "shared")
                 for k in ("mamba", "shared", "lora")}

        def mamba_train(i, x):
            lp = gather_weights(mambas[i], specs["mamba"], policy)
            return ssm.mamba2_block(lp, cfg, x, conv0, None, chunk=chunk, policy=policy)[0]

        def shared_train(g, x):
            return _shared_block_seq(
                cfg, gather_weights(params["shared"], specs["shared"], policy),
                gather_weights(loras[g], specs["lora"], policy), x, x0, positions,
                attend=ops.flash_attention_ckpt, head_mask=head_mask, kv_index=kv_index,
                policy=policy)[0]

        def mamba(i, x):
            return T.maybe_remat(partial(mamba_train, i), x, remat)

        def shared(g, x):
            return T.maybe_remat(partial(shared_train, g), x, remat)
    else:
        def mamba(i, x):
            lp = T.layer_params(params["mamba"], i)
            x, c2, ssm_out[i] = ssm.mamba2_block(lp, cfg, x, conv0, None, chunk=chunk,
                                                 policy=policy)
            for k, t in c2.items():
                conv_out[k][i] = t
            return x

        def shared(g, x):
            x, kv = _shared_block_seq(cfg, params["shared"],
                                      T.layer_params(params["lora"], g), x, x0,
                                      positions, collect_kv=collect_kv,
                                      head_mask=head_mask, kv_index=kv_index,
                                      policy=policy)
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
            return x

    ks, vs = [], []
    for g in range(n_attn):
        for j in range(n_per_group):
            x = mamba(g * n_per_group + j, x)
        x = shared(g, x)
    for i in range(n_grouped, n_mamba):
        x = mamba(i, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if train:
        return x, None, None
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv, (conv_out, ssm_out)


def train_logits(params, cfg, batch, *, tp=1, policy=None, remat=False):
    """Full-sequence logits [B, T, Vp] (also the full-sequence oracle of
    the serving steps); the reference's (logits, aux loss) pair with aux
    0.  Differentiable in ``params`` (see the module docstring).  On a
    mesh the rank's rows and its vocab columns [B, T, Vp / tp] (the
    vocab-parallel loss's input)."""
    hidden, _, _ = forward_seq(params, cfg, batch["tokens"], train=True, remat=remat,
                               tp=tp, policy=policy)
    return (T.unembed(params, cfg, hidden, policy, gather=False),
            torch.zeros((), device=hidden.device))


def prefill(params, cfg, tokens, *, tp=1, policy=None):
    """Returns (last_logits, (k, v) [n_attn, B, S, KV_p, hd], (conv, ssm));
    on a mesh the rank's rows, KV heads, channels and heads."""
    hidden, kv, states = forward_seq(params, cfg, tokens, collect_kv=True, tp=tp,
                                     policy=policy)
    return T.unembed(params, cfg, hidden[:, -1], policy), kv, states


def decode(params, cfg, tokens, conv_states, ssm_states, k_pages, v_pages,
           block_table, seq_lens, *, active=None, attn_fn=None, tp=1, policy=None):
    """One token step. tokens [B]; pages [n_attn, N, ps, KV_p, hd].

    Writes each shared-attention invocation's new K/V into its pool and
    the new conv/SSM states over the old ones, in place.  ``attn_fn``: a
    paged attention with ``ops.paged_attention``'s signature over one
    invocation's pages (default: K1; on a mesh
    ``launch/spmd.py::make_sharded_decode_attn``, whose pool-local
    table the page writes use too).
    Returns (logits, (conv, ssm), (k_pages, v_pages)).
    """
    n_attn, n_mamba, n_grouped, _, n_per_group = group_structure(cfg)
    shared = params["shared"]
    attn_fn = attn_fn or ops.paged_attention
    x = T.embed(params, cfg, tokens, policy)                 # [B, D]
    x0 = x
    head_mask = T._head_mask(cfg, x.device, x.dtype, tp, policy)
    kv_index = T._kv_index(cfg, x.device, tp, policy)
    # per-step index work, shared by every attention invocation
    bt, _ = T._pool_local(attn_fn, block_table.to(torch.int32), k_pages)
    pos = seq_lens.to(torch.int32)                           # next position
    kv_lens = pos + 1
    dest = T.token_dest(bt, pos, active, *T._pool_geometry(k_pages))
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def mamba(i, x):
        lp = T.layer_params(params["mamba"], i)
        conv_i = {k: t[i] for k, t in conv_states.items()}
        x, c2, s2 = ssm.mamba2_decode(lp, cfg, x, conv_i, ssm_states[i], policy)
        for k, t in c2.items():
            conv_i[k].copy_(t)
        ssm_states[i].copy_(s2)
        return x

    for g in range(n_attn):
        for j in range(n_per_group):
            x = mamba(g * n_per_group + j, x)
        h2 = rms_norm(torch.cat([x, x0], dim=-1), shared["ln1"], cfg.norm_eps)
        q, k, v = _shared_qkv(cfg, shared, T.layer_params(params["lora"], g), h2, policy)
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)   # [B,1,H_p,hd]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        kpg, vpg = T._layer_pages(k_pages, g), T._layer_pages(v_pages, g)
        T._write(kpg, vpg, T._expand_kv(k, kv_index), T._expand_kv(v, kv_index), dest)
        o = attn_fn(q, kpg, vpg, bt, kv_lens, pos, scale=scale)
        x = _attn_out(cfg, shared, x, o[:, 0], head_mask, policy)
    for i in range(n_grouped, n_mamba):
        x = mamba(i, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (T.unembed(params, cfg, x, policy), (conv_states, ssm_states),
            (k_pages, v_pages))
