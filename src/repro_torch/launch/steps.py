"""Dry-run cell builders: (architecture x input-shape) -> one card's step.

The counterpart of the reference's ``launch/steps.py`` on one device.
Each builder returns a dict:
  fn         — python callable (the step)
  args       — its arguments as fake tensors (shapes and dtypes, nothing
               allocated: the reference's ShapeDtypeStructs)
  make_args  — ``make_args(generator, device)``: the same arguments as
               real tensors, seeded from ``generator`` (``args`` is this
               run under ``launch/costs.py::fake_mode``)
  note       — human-readable cell description

Shapes (assignment): train_4k / prefill_32k / decode_32k / long_500k,
plus mixed_32k — the paper-representative Splitwiser fused step (16
prompt streams x 2048-token chunks + 128 decode slots @32k).

On one card there is nothing to shard: the reference's shardings,
donation, sharding policies, expert-parallel MoE and its sharding
schemes (``tp``, ``fsdp``, ``zero3``, ``2d``) have no counterpart.  The
two schemes that change the work stay: the vocab-tiled loss of the train
step (``loss_impl="vtiled"``, the reference's ``+vtiled``) and int8 KV
pages in the mixed step (``scheme="kv8"``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.costs import fake_mode
from repro_torch.models import encdec, hybrid, rwkv, ssm
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import init_state, make_train_step

PAGE = 64

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
    "mixed_32k": dict(kind="mixed", seq=32768, batch=128, chunk=2048,
                      streams=16),
}

# archs that train with int8 AdamW moments (the reference's SERVE_FSDP:
# weights too large for one chip's share)
INT8_MOMENTS = {"grok-1-314b"}

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


def cell_supported(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention KV residency at 524288 ctx; "
                       "needs context-streaming attention — skipped")
    if shape_name == "mixed_32k" and cfg.family not in ("dense", "moe", "vlm"):
        return False, "mixed fused step is transformer-family (paper cell)"
    return True, ""


def _cell(fn, make_args, note):
    with fake_mode():
        args = make_args(torch.Generator().manual_seed(0), "cpu")
    return dict(fn=fn, args=args, make_args=make_args, note=note)


def _tokens(g, cfg, shape, device):
    return torch.randint(0, cfg.vocab_size, shape, generator=g, dtype=I32,
                         device=device)


def _normal(g, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _text_len(cfg, seq):
    """vlm text tokens = seq - vision prefix so total context == seq."""
    return seq - cfg.n_vision_patches if cfg.family == "vlm" else seq


# ------------------------------------------------------------------ train --
def build_train(arch, loss_impl="chunked"):
    """The train step (remat, bf16 params) at train_4k; ``loss_impl``
    "vtiled" is the reference's "+vtiled" scheme (fused vocab-tiled CE)."""
    model = get_model(arch)
    cfg = model.cfg
    sh = SHAPES["train_4k"]
    B, S = sh["batch"], sh["seq"]
    tcfg = TrainConfig(global_batch=B, seq_len=S, remat=True,
                       int8_moments=(arch in INT8_MOMENTS), loss_impl=loss_impl)
    step = make_train_step(model, tcfg)

    def make_args(g, device):
        state = init_state(model, g, tcfg, BF16, device)
        n = _text_len(cfg, S)
        batch = {"tokens": _tokens(g, cfg, (B, n), device),
                 "labels": _tokens(g, cfg, (B, n), device)}
        if cfg.family == "encdec":
            batch["frames"] = _normal(g, (B, cfg.encoder_seq, cfg.d_model), BF16,
                                      device, 0.3)
        if cfg.family == "vlm":
            batch["patches"] = _normal(g, (B, cfg.n_vision_patches, cfg.d_vision),
                                       BF16, device)
        return state, batch

    return _cell(step, make_args,
                 f"train_step B={B} S={S} remat loss={loss_impl} "
                 f"int8_mom={tcfg.int8_moments}")


# ---------------------------------------------------------------- prefill --
def build_prefill(arch, shape_name="prefill_32k"):
    model = get_model(arch)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]

    def params(g, device):
        return model.init(g, BF16, device)

    if cfg.family in ("dense", "moe"):
        def fn(params, tokens):
            return T.prefill(params, cfg, tokens)

        def make_args(g, device):
            return params(g, device), _tokens(g, cfg, (B, S), device)
    elif cfg.family == "vlm":
        def fn(params, tokens, patches):
            return T.prefill(params, cfg, tokens, patches=patches)

        def make_args(g, device):
            return (params(g, device), _tokens(g, cfg, (B, _text_len(cfg, S)), device),
                    _normal(g, (B, cfg.n_vision_patches, cfg.d_vision), BF16, device))
    elif cfg.family == "encdec":
        def fn(params, frames, tokens):
            return encdec.prefill(params, cfg, frames, tokens)

        def make_args(g, device):
            return (params(g, device),
                    _normal(g, (B, cfg.encoder_seq, cfg.d_model), BF16, device, 0.3),
                    _tokens(g, cfg, (B, S), device))
    elif cfg.family == "hybrid":
        def fn(params, tokens):
            return hybrid.prefill(params, cfg, tokens)

        def make_args(g, device):
            return params(g, device), _tokens(g, cfg, (B, S), device)
    else:  # ssm
        def fn(params, tokens):
            state = rwkv.init_state(cfg, tokens.shape[0], params["embed"].dtype,
                                    tokens.device)
            return rwkv.forward(params, cfg, tokens, state, chunk=64)

        def make_args(g, device):
            return params(g, device), _tokens(g, cfg, (B, S), device)
    return _cell(fn, make_args, f"prefill B={B} S={S}")


# ----------------------------------------------------------------- decode --
def _page_pool_shapes(cfg, n_seqs, seq, n_layers=None, extra_seqs=0):
    """(pages shape [L,N,ps,KV_p,hd], Pmax) on one device: N holds every
    sequence's pages and the trash page."""
    _, KV_p, _, _, _ = T.gqa_layout(cfg.n_heads, cfg.n_kv_heads)
    L = n_layers if n_layers is not None else cfg.n_layers
    per_seq = seq // PAGE + 1
    N = (n_seqs + extra_seqs) * per_seq + 1
    return (L, N, PAGE, KV_p, cfg.head_dim), per_seq


def _tables(g, n_seqs, Pmax, N, device):
    """[n_seqs, Pmax] int32 page tables over distinct pages of a pool of
    N (the last, the trash page, in none)."""
    pages = torch.randperm(N - 1, generator=g, device=device)[: n_seqs * Pmax]
    return pages.reshape(n_seqs, Pmax).to(I32)


def _full(n, value, device):
    return torch.full((n,), value, dtype=I32, device=device)


def _fp_pages(g, shape, device):
    return _normal(g, shape, BF16, device), _normal(g, shape, BF16, device)


def build_decode(arch, shape_name="decode_32k"):
    """One decode step of B sequences, each ``seq`` tokens deep (its
    next token at position seq - 1)."""
    model = get_model(arch)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]

    def params(g, device):
        return model.init(g, BF16, device)

    if cfg.family == "ssm":                   # rwkv: state cache only
        def fn(params, tokens, state):
            return rwkv.decode(params, cfg, tokens, state)

        def make_args(g, device):
            return (params(g, device), _tokens(g, cfg, (B,), device),
                    rwkv.init_state(cfg, B, BF16, device))
        return _cell(fn, make_args, f"decode(state) B={B} ctx={S}")

    if cfg.family == "hybrid":
        n_attn, n_mamba, _, _, _ = hybrid.group_structure(cfg)
        pg_shape, Pmax = _page_pool_shapes(cfg, B, S, n_layers=n_attn)

        def fn(params, tokens, conv, ssm_st, kpg, vpg, bt, lens):
            return hybrid.decode(params, cfg, tokens, conv, ssm_st, kpg, vpg, bt, lens)

        def make_args(g, device):
            cs, ss = ssm.mamba2_state_shapes(cfg, B)
            conv = {k: _normal(g, (n_mamba,) + v, BF16, device) for k, v in cs.items()}
            return (params(g, device), _tokens(g, cfg, (B,), device), conv,
                    _normal(g, (n_mamba,) + ss, F32, device),
                    *_fp_pages(g, pg_shape, device),
                    _tables(g, B, Pmax, pg_shape[1], device), _full(B, S - 1, device))
        return _cell(fn, make_args, f"decode(hybrid) B={B} ctx={S} attn_layers={n_attn}")

    if cfg.family == "encdec":
        pg_shape, Pmax = _page_pool_shapes(cfg, B, S)
        cross_shape = (cfg.n_layers, B, cfg.encoder_seq) + pg_shape[3:]

        def fn(params, tokens, kpg, vpg, xk, xv, bt, lens):
            return encdec.decode(params, cfg, tokens, kpg, vpg, xk, xv, bt, lens)

        def make_args(g, device):
            return (params(g, device), _tokens(g, cfg, (B,), device),
                    *_fp_pages(g, pg_shape, device), *_fp_pages(g, cross_shape, device),
                    _tables(g, B, Pmax, pg_shape[1], device), _full(B, S - 1, device))
        return _cell(fn, make_args, f"decode(encdec) B={B} ctx={S}")

    # transformer family
    pg_shape, Pmax = _page_pool_shapes(cfg, B, S)

    def fn(params, tokens, kpg, vpg, bt, lens):
        return T.decode(params, cfg, tokens, kpg, vpg, bt, lens)

    def make_args(g, device):
        return (params(g, device), _tokens(g, cfg, (B,), device),
                *_fp_pages(g, pg_shape, device),
                _tables(g, B, Pmax, pg_shape[1], device), _full(B, S - 1, device))
    return _cell(fn, make_args, f"decode B={B} ctx={S} pool={pg_shape}")


# ------------------------------------------------------------------ mixed --
def build_mixed(arch, shape_name="mixed_32k", scheme="baseline"):
    """The paper-technique cell: fused chunked-prefill + decode.  Each
    prompt stream's chunk ends at position ``seq``; decode rows are
    ``seq`` tokens deep.  scheme "kv8": int8-quantized KV pages
    ({"q": codes, "s": scales}, halving KV traffic)."""
    model = get_model(arch)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S, C, Pstr = sh["batch"], sh["seq"], sh["chunk"], sh["streams"]
    pg_shape, Pmax = _page_pool_shapes(cfg, B, S, extra_seqs=Pstr)
    kv8 = scheme == "kv8"

    def fn(params, mb, kpg, vpg):
        return T.mixed(params, cfg, mb, kpg, vpg)

    def pages(g, device):
        if not kv8:
            return _normal(g, pg_shape, BF16, device)
        codes = torch.randint(-127, 128, pg_shape, generator=g, dtype=torch.int8,
                              device=device)
        scales = torch.rand(pg_shape[:-1] + (1,), generator=g, device=device) / 64
        return {"q": codes, "s": scales}

    def make_args(g, device):
        table = _tables(g, Pstr + B, Pmax, pg_shape[1], device)   # distinct pages
        mb = dict(p_tokens=_tokens(g, cfg, (Pstr, C), device), p_table=table[:Pstr].clone(),
                  p_start=_full(Pstr, S - C, device), p_lens=_full(Pstr, C, device),
                  d_tokens=_tokens(g, cfg, (B,), device), d_table=table[Pstr:].clone(),
                  d_lens=_full(B, S - 1, device),
                  d_active=torch.ones(B, dtype=torch.bool, device=device))
        return model.init(g, BF16, device), mb, pages(g, device), pages(g, device)

    return _cell(fn, make_args, f"mixed(Splitwiser) streams={Pstr}x{C} + decode B={B} "
                                f"@ctx={S} scheme={scheme}")


def build_cell(arch, shape_name):
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        return None, why
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train(arch), ""
    if kind == "prefill":
        return build_prefill(arch, shape_name), ""
    if kind == "decode":
        return build_decode(arch, shape_name), ""
    if kind == "mixed":
        return build_mixed(arch, shape_name), ""
    raise ValueError(kind)
