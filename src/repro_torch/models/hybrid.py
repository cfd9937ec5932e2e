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
the plain scan. There
is no tensor parallelism (the reference's ``tp``/``policy``): at tp = 1
the padded head layout is the identity, so no head is masked or
replicated. Page pools ``[n_attn, N, ps, KV_p, hd]`` and the conv/SSM
states are updated in place by ``decode``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_init, mlp_init, rms_norm, rope


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
                device=None):
    """Random parameters with the reference's shapes and init scales
    (``hybrid.py::init_params``), drawn from ``generator`` in the
    reference's order (the numbers differ from JAX's; tests hand both
    packages the same weights through ``models.convert.params_from_jax``)."""
    device = resolve_device(device)
    D, hd, KV = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    H_p, _, q_map, _, _ = T.gqa_layout(cfg.n_heads, KV)
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


def _shared_qkv(cfg, shared, lora_i, h2):
    """h2 [..., 2D] -> q [..., H_p, hd], k/v [..., KV, hd] with LoRA deltas."""
    hd, D2 = cfg.head_dim, h2.shape[-1]
    lead = h2.shape[:-1]

    def proj(w, a, b):
        return (h2 @ w.reshape(D2, -1) + (h2 @ a) @ b).reshape(*lead, -1, hd)

    return (proj(shared["wq"], lora_i["qa"], lora_i["qb"]),
            proj(shared["wk"], lora_i["ka"], lora_i["kb"]),
            proj(shared["wv"], lora_i["va"], lora_i["vb"]))


def _attn_out(cfg, shared, x, o):
    """Residual output projection and MLP of the shared block."""
    return T._residuals(cfg, shared, x, T._o_proj(
        cfg, shared, o, T._head_mask(cfg, x.device, x.dtype)))


def _shared_block_seq(cfg, shared, lora_i, x, x0, positions, *,
                      collect_kv=False, attend=None):
    """Full-seq shared attention block. x/x0 [B,T,D]; positions [B,T];
    ``attend``: ``ops.flash_attention`` (None) or, training,
    ``ops.flash_attention_ckpt``."""
    h2 = rms_norm(torch.cat([x, x0], dim=-1), shared["ln1"], cfg.norm_eps)
    q, k, v = _shared_qkv(cfg, shared, lora_i, h2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kv_lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                         device=x.device)
    attend = attend or ops.flash_attention
    o = attend(q, k, v, kv_lens, scale=1.0 / math.sqrt(cfg.head_dim), causal=True)
    return _attn_out(cfg, shared, x, o), ((k, v) if collect_kv else None)


def forward_seq(params, cfg, tokens, *, collect_kv=False, chunk=64,
                train=False, remat=False):
    """Full-sequence forward (prefill / the full-sequence oracle) from
    zero conv and SSM states.

    Returns (hidden [B,T,D], (k, v) each [n_attn, B, T, KV_p, hd] or
    None, (conv_states, ssm_states)), the states stacked [n_mamba, ...].
    With ``train`` only the hidden is returned (no KV, states None),
    attention goes through ``ops.flash_attention_ckpt``, and ``remat``
    recomputes each Mamba2 block and shared block in the backward.
    """
    n_attn, n_mamba, n_grouped, _, n_per_group = group_structure(cfg)
    x = T.embed(params, cfg, tokens)
    x0 = x
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cs_shape, ss_shape = ssm.mamba2_state_shapes(cfg, B)
    dt = params["embed"].dtype
    conv0 = {k: torch.zeros(v, dtype=dt, device=x.device) for k, v in cs_shape.items()}
    conv_out = {k: torch.empty((n_mamba,) + v, dtype=dt, device=x.device)
                for k, v in cs_shape.items()}
    ssm_out = torch.empty((n_mamba,) + ss_shape, dtype=torch.float32, device=x.device)

    if train:
        mambas = T.layer_list(params["mamba"], n_mamba)
        loras = T.layer_list(params["lora"], n_attn)

        def mamba(i, x):
            return T.maybe_remat(lambda x: ssm.mamba2_block(
                mambas[i], cfg, x, conv0, None, chunk=chunk)[0], x, remat)

        def shared(g, x):
            return T.maybe_remat(lambda x: _shared_block_seq(
                cfg, params["shared"], loras[g], x, x0, positions,
                attend=ops.flash_attention_ckpt)[0], x, remat)
    else:
        def mamba(i, x):
            lp = T.layer_params(params["mamba"], i)
            x, c2, ssm_out[i] = ssm.mamba2_block(lp, cfg, x, conv0, None, chunk=chunk)
            for k, t in c2.items():
                conv_out[k][i] = t
            return x

        def shared(g, x):
            x, kv = _shared_block_seq(cfg, params["shared"],
                                      T.layer_params(params["lora"], g), x, x0,
                                      positions, collect_kv=collect_kv)
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


def train_logits(params, cfg, batch, *, remat=False):
    """Full-sequence logits [B, T, Vp] (also the full-sequence oracle of
    the serving steps); the reference's (logits, aux loss) pair with aux
    0.  Differentiable in ``params`` (see the module docstring)."""
    hidden, _, _ = forward_seq(params, cfg, batch["tokens"], train=True, remat=remat)
    return T.unembed(params, cfg, hidden), torch.zeros((), device=hidden.device)


def prefill(params, cfg, tokens):
    """Returns (last_logits, (k, v) [n_attn, B, S, KV_p, hd], (conv, ssm))."""
    hidden, kv, states = forward_seq(params, cfg, tokens, collect_kv=True)
    return T.unembed(params, cfg, hidden[:, -1]), kv, states


def decode(params, cfg, tokens, conv_states, ssm_states, k_pages, v_pages,
           block_table, seq_lens, *, active=None):
    """One token step. tokens [B]; pages [n_attn, N, ps, KV_p, hd].

    Writes each shared-attention invocation's new K/V into its pool and
    the new conv/SSM states over the old ones, in place.
    Returns (logits, (conv, ssm), (k_pages, v_pages)).
    """
    n_attn, n_mamba, n_grouped, _, n_per_group = group_structure(cfg)
    shared = params["shared"]
    x = T.embed(params, cfg, tokens)                         # [B, D]
    x0 = x
    # per-step index work, shared by every attention invocation
    bt = block_table.to(torch.int32)
    pos = seq_lens.to(torch.int32)                           # next position
    kv_lens = pos + 1
    dest = T.token_dest(bt, pos, active, *T._pool_geometry(k_pages))
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def mamba(i, x):
        lp = T.layer_params(params["mamba"], i)
        conv_i = {k: t[i] for k, t in conv_states.items()}
        x, c2, s2 = ssm.mamba2_decode(lp, cfg, x, conv_i, ssm_states[i])
        for k, t in c2.items():
            conv_i[k].copy_(t)
        ssm_states[i].copy_(s2)
        return x

    for g in range(n_attn):
        for j in range(n_per_group):
            x = mamba(g * n_per_group + j, x)
        h2 = rms_norm(torch.cat([x, x0], dim=-1), shared["ln1"], cfg.norm_eps)
        q, k, v = _shared_qkv(cfg, shared, T.layer_params(params["lora"], g), h2)
        q = rope(q[:, None], pos[:, None], cfg.rope_theta)   # [B,1,H_p,hd]
        k = rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        kpg, vpg = T._layer_pages(k_pages, g), T._layer_pages(v_pages, g)
        T._write(kpg, vpg, k, v, dest)
        o = ops.paged_attention(q, kpg, vpg, bt, kv_lens, pos, scale=scale)
        x = _attn_out(cfg, shared, x, o[:, 0])
    for i in range(n_grouped, n_mamba):
        x = mamba(i, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (T.unembed(params, cfg, x), (conv_states, ssm_states),
            (k_pages, v_pages))
