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

``build_prefill``, ``build_decode`` and ``build_mixed`` take a ``mesh``
(``launch/mesh.py``; ``None``: one card) for every family (``mixed``:
the transformer family's).  With one, ``fn`` is the rank's sharded step
(tensor parallel over `model`, data parallel over `data`, the MoE
expert-parallel, ``launch/spmd.py``'s hooks), ``make_args`` draws this
rank's arguments: its weight slices from the full ``tp``-padded draw,
its data shard's rows of the tokens, frames and patches (drawn whole on
every rank alike), and its local caches, drawn at their local shapes
(values alike on every rank): pools ``[L, N/n_data, ps, KV_p/tp, hd]`` of
the global pool of ``_page_pool_shapes`` (N holding a trash page per
data shard), and the hybrid's conv/SSM states, rwkv's state and the
decoder's cross K/V under ``CACHE_SPECS``, the reference's placements.
``args`` are this rank's fake arguments.  grok-1-314b's serving weights
are FSDP'd over `data` as well (``SERVE_FSDP``, the reference's
placements), and its layers gathered one at a time as they run
(``models/transformer.py``).

``build_train`` takes a mesh too, in the reference's two schemes:
``tp`` (tensor parallel over `model`, every weight's second dim and the
optimizer state ZeRO-3 over `data`) and ``fsdp`` (tp = 1: batch and
ZeRO-3 over both axes, heads/ff/vocab/experts whole), for every family;
``train_mesh`` gives the step's ``tp``, policy (its ``params`` the
placements) and MoE hook (``optim/adamw.py::opt_specs`` places the
moments), and ``make_args`` the rank's rows (``trainer.take_rows``:
with microbatches, its rows of each).  ``build_decode`` takes the
reference's decode ``2d`` scheme (the batch replicated over data, the
pages data-sharded, the MoE's expert d_ff over both axes) and a batch
that does not divide over data > 1 (replicated over data with its
caches).  Donation has no counterpart (pools are written in place).  The two schemes that change the work
stay: the vocab-tiled loss of the train step (``loss_impl="vtiled"``,
the reference's ``+vtiled``) and int8 KV pages in the mixed step
(``scheme="kv8"``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import spmd
from repro_torch.launch.costs import fake_mode
from repro_torch.launch.shardings import flat_f_pspecs, local_shape, param_pspecs, shard_params
from repro_torch.models import encdec, hybrid, rwkv, ssm
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.models.sharding import Policy, make_rules
from repro_torch.train.trainer import init_state, make_train_step, take_rows

PAGE = 64

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
    "mixed_32k": dict(kind="mixed", seq=32768, batch=128, chunk=2048,
                      streams=16),
}

# archs whose weights exceed one chip's share at TP=16: ZeRO-3 weight
# sharding over data even for serving, and int8 AdamW moments in training
SERVE_FSDP = {"grok-1-314b"}
INT8_MOMENTS = SERVE_FSDP

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32

# Placements of the serving caches on a mesh (the reference's decode
# in_shardings), one entry a leading dim, later dims whole: page pools
# [L, N, ps, KV_p, hd]; the hybrid's conv states [n_mamba, B, W-1, C]
# (x over model, B and C whole) and SSM states [n_mamba, B, H, P, N];
# rwkv's x_tm/x_cm [L, B, D] and S [L, B, H, K, K]; cross K/V
# [Ld, B, S_enc, KV_p, hd].
CACHE_SPECS = {
    "pages": (None, "data", None, "model", None),
    "conv": {"x": (None, "data", None, "model"), "B": (None, "data", None, None),
             "C": (None, "data", None, None)},
    "ssm": (None, "data", "model", None, None),
    "rwkv": {"x_tm": (None, "data", None), "x_cm": (None, "data", None),
             "S": (None, "data", "model", None)},
    "cross": (None, "data", None, "model", None),
}


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


class _Shard:
    """The mesh of a sharded cell as the cell functions use it (one card: all
    trivial).  A decode cell passes its ``batch`` and ``scheme``: a batch
    that does not divide over the data shards is replicated over data with
    its caches (the reference's ``shard_batch=False``), and the ``2d``
    scheme replicates the batch while the pages stay data-sharded, with
    every MoE expert's d_ff over both axes (``flat_f``)."""

    def __init__(self, model, mesh, batch=None, scheme="baseline"):
        self.mesh, self.model = mesh, model
        self.policy, self.specs = None, None
        self.batch_sharded = self.caches_sharded = True
        if mesh is not None:
            self.policy = Policy(make_rules(("data",), "model"), mesh)
            n_data = self.policy.size("data")
            if batch is not None and (scheme == "2d" or batch % n_data):
                self.batch_sharded = False
                # the 2d scheme keeps the transformer family's pages data-sharded
                self.caches_sharded = (scheme == "2d"
                                       and model.cfg.family in ("dense", "moe", "vlm"))
            if model.name in SERVE_FSDP and n_data > 1 and scheme != "2d":
                self.policy = Policy(self.policy.rules, mesh, params=_placements(
                    model, self.policy.tp, n_data, "data"))      # weights FSDP'd over data
            if scheme == "2d":
                self.specs = flat_f_pspecs(_placements(model, self.policy.tp),
                                           tuple(mesh.mesh_dim_names))
        self.tp = 1 if mesh is None else self.policy.tp
        self.n_data = 1 if mesh is None else self.policy.size("data")
        self.kw = {} if mesh is None else dict(tp=self.tp, policy=self.policy)
        if mesh is not None and model.cfg.is_moe:
            self.kw["moe_fn"] = spmd.make_sharded_moe_fn(mesh, model.cfg, tp=self.tp,
                                                         flat_f=scheme == "2d")

    def params(self, g, device):
        """The full ``tp``-padded draw, then this rank's slices of it."""
        if self.mesh is None:
            return self.model.init(g, BF16, device)
        return self.slice(self.model.init(g, BF16, device, tp=self.tp))

    def slice(self, full):
        """This rank's slices of the full ``tp``-padded tree ``full``."""
        specs = (self.specs or self.policy.params
                 or param_pspecs(full, self.model.cfg, tp=self.tp))
        return shard_params(full, specs, self.policy)

    def rows(self, t, n=None):
        """This rank's data shard of ``t``'s rows (all of them where the
        batch is replicated over data)."""
        n = t.shape[0] if n is None else n
        if not self.batch_sharded:
            return t
        if n % self.n_data:
            raise ValueError(f"{n} rows do not divide over {self.n_data} data shards")
        k = n // self.n_data
        return t[self.policy.index("data") * k:][:k] if self.n_data > 1 else t

    def n_rows(self, n):
        """The rows of a batch of ``n`` this rank holds."""
        return n if not self.batch_sharded else n // self.n_data

    @property
    def cache_data(self):
        """Data shards the caches split over (1: replicated over data)."""
        return self.n_data if self.caches_sharded else 1

    def local(self, shape, spec=CACHE_SPECS["pages"]):
        """This rank's shape of a global cache ``shape`` placed by ``spec``
        (a pool's: [L, N/n_data, ps, KV_p/tp, hd]); a cache replicated
        over data keeps that dim whole."""
        if self.mesh is None:
            return shape
        if not self.caches_sharded:
            spec = tuple(None if ax == "data" else ax for ax in spec)
        return local_shape(shape, spec, self.policy)

    def decode_attn(self, kv_int8=False):
        """The decode ``attn_fn`` (None on one card): the rank's rows on its
        pool; the 2d scheme's data shard of a replicated batch, gathered;
        or the replicated batch on its replicated pool."""
        if self.mesh is None:
            return None
        rows_over = "data" if self.caches_sharded and not self.batch_sharded else None
        return spmd.make_sharded_decode_attn(self.mesh, rows_over=rows_over, kv_int8=kv_int8)


def _tokens(g, cfg, shape, device):
    return torch.randint(0, cfg.vocab_size, shape, generator=g, dtype=I32,
                         device=device)


def _normal(g, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _text_len(cfg, seq):
    """vlm text tokens = seq - vision prefix so total context == seq."""
    return seq - cfg.n_vision_patches if cfg.family == "vlm" else seq


# ------------------------------------------------------------------ train --
def _placements(model, tp, fsdp_size=1, fsdp=None):
    """``param_pspecs`` of ``model``'s ``tp``-padded tree (shapes from a fake
    draw)."""
    with fake_mode():
        shapes = model.init(torch.Generator().manual_seed(0), F32, "cpu", tp=tp)
    return param_pspecs(shapes, model.cfg, tp=tp, fsdp_size=fsdp_size, fsdp=fsdp)


def train_mesh(model, mesh, scheme="tp"):
    """(tp, policy, moe_fn) of the reference's sharded train step on
    ``mesh`` (``build_train``): ``tp`` tensor parallel over `model`, FSDP
    over `data` (``make_rules(fsdp=True)``, weights placed by
    ``param_pspecs(fsdp_size=n_data, fsdp="data")``, the MoE's experts
    gathered with their layer, the reference's ``fsdp_gather=True``);
    ``fsdp`` tp = 1 with batch, tokens, pages and the FSDP dim over the
    flattened (data, model) axes and heads, kv heads, ff, vocab and
    experts whole (the MoE over the gathered global batch,
    ``spmd.make_gathered_moe_fn``).  The policy's ``params`` are the
    placements."""
    cfg = model.cfg
    if scheme not in ("tp", "fsdp"):
        raise ValueError(f"scheme {scheme!r}: tp or fsdp")
    names = mesh.mesh_dim_names
    if scheme == "fsdp":
        flat = tuple(names)
        rules = dict(make_rules(("data",), "model", fsdp=True))
        rules.update({k: flat for k in ("batch", "tokens", "pages", "fsdp")})
        rules.update({k: None for k in ("heads", "kv_heads", "ff", "vocab", "experts")})
        policy = Policy(rules, mesh)
        specs = _placements(model, 1, policy.size(flat), flat)
        policy = Policy(rules, mesh, params=specs)
        moe_fn = spmd.make_gathered_moe_fn(policy, cfg) if cfg.is_moe else None
        return 1, policy, moe_fn
    rules = make_rules(("data",), "model", fsdp=True)
    policy = Policy(rules, mesh)
    tp, n_data = policy.tp, policy.size("data")
    policy = Policy(rules, mesh, params=_placements(model, tp, n_data, "data"))
    moe_fn = spmd.make_sharded_moe_fn(mesh, cfg, tp=tp) if cfg.is_moe else None
    return tp, policy, moe_fn


def build_train(arch, mesh=None, scheme="tp", loss_impl="chunked"):
    """The train step (remat, bf16 params) at train_4k; ``loss_impl``
    "vtiled" is the reference's "+vtiled" scheme (fused vocab-tiled CE).
    With a ``mesh``, the rank's sharded step in ``scheme`` "tp" or "fsdp"
    (``train_mesh``): ``make_args`` draws the full ``tp``-padded state
    and keeps this rank's shards, and this rank's rows of the batch (its
    data shard's; the ``fsdp`` scheme's over both axes)."""
    model = get_model(arch)
    cfg = model.cfg
    sh = SHAPES["train_4k"]
    B, S = sh["batch"], sh["seq"]
    tcfg = TrainConfig(global_batch=B, seq_len=S, remat=True,
                       int8_moments=(arch in INT8_MOMENTS), loss_impl=loss_impl)
    tp, policy, moe_fn = (1, None, None) if mesh is None else train_mesh(model, mesh, scheme)
    step = make_train_step(model, tcfg, tp=tp, policy=policy, moe_fn=moe_fn)

    def make_args(g, device):
        state = init_state(model, g, tcfg, BF16, device, tp=tp, policy=policy)
        n = _text_len(cfg, S)
        batch = {"tokens": _tokens(g, cfg, (B, n), device),
                 "labels": _tokens(g, cfg, (B, n), device)}
        if cfg.family == "encdec":
            batch["frames"] = _normal(g, (B, cfg.encoder_seq, cfg.d_model), BF16,
                                      device, 0.3)
        if cfg.family == "vlm":
            batch["patches"] = _normal(g, (B, cfg.n_vision_patches, cfg.d_vision),
                                       BF16, device)
        return state, take_rows(batch, policy, tcfg.microbatch)

    return _cell(step, make_args,
                 f"train_step B={B} S={S} remat loss={loss_impl} "
                 f"int8_mom={tcfg.int8_moments}"
                 + (f" scheme={scheme} mesh {tuple(mesh.shape)}" if mesh is not None else ""))


# ---------------------------------------------------------------- prefill --
def build_prefill(arch, shape_name="prefill_32k", mesh=None, cfg=None):
    """``cfg``: a config of ``arch`` to build instead of its own (a cut
    depth).  The transformer family's ``fn`` passes keywords on to
    ``prefill`` (``kv_fake_quant``); rwkv6 prefills in chunks of 64, as
    the reference's cell does."""
    model = get_model(arch, cfg)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    shard = _Shard(model, mesh)
    kw = shard.kw

    if cfg.family in ("dense", "moe", "vlm"):
        def fn(params, tokens, patches=None, **kw2):
            return T.prefill(params, cfg, tokens, patches=patches, **kw, **kw2)

        def make_args(g, device):
            args = (shard.params(g, device),
                    shard.rows(_tokens(g, cfg, (B, _text_len(cfg, S)), device)))
            if cfg.family != "vlm":
                return args
            return args + (shard.rows(_normal(g, (B, cfg.n_vision_patches, cfg.d_vision),
                                              BF16, device)),)
    elif cfg.family == "encdec":
        def fn(params, frames, tokens):
            return encdec.prefill(params, cfg, frames, tokens, **kw)

        def make_args(g, device):
            frames = _normal(g, (B, cfg.encoder_seq, cfg.d_model), BF16, device, 0.3)
            return (shard.params(g, device), shard.rows(frames),
                    shard.rows(_tokens(g, cfg, (B, S), device)))
    elif cfg.family == "hybrid":
        def fn(params, tokens):
            return hybrid.prefill(params, cfg, tokens, **kw)

        def make_args(g, device):
            return shard.params(g, device), shard.rows(_tokens(g, cfg, (B, S), device))
    else:  # ssm
        def fn(params, tokens):
            return rwkv.prefill(params, cfg, tokens, chunk=64, **kw)

        def make_args(g, device):
            return shard.params(g, device), shard.rows(_tokens(g, cfg, (B, S), device))
    return _cell(fn, make_args, f"prefill B={B} S={S}"
                 + (f" mesh {tuple(mesh.shape)}" if mesh is not None else ""))


# ----------------------------------------------------------------- decode --
def _page_pool_shapes(cfg, n_seqs, seq, n_layers=None, extra_seqs=0, tp=1,
                      n_data=1):
    """(pages shape [L,N,ps,KV_p,hd], Pmax). N holds every sequence's
    pages and a trash page per data shard, and divides by n_data."""
    _, KV_p, _, _, _ = T.gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    L = n_layers if n_layers is not None else cfg.n_layers
    per_seq = seq // PAGE + 1
    n_raw = (n_seqs + extra_seqs) * per_seq + n_data
    N = -(-n_raw // n_data) * n_data
    return (L, N, PAGE, KV_p, cfg.head_dim), per_seq


def _tables(g, n_seqs, Pmax, N, device, n_data=1):
    """[n_seqs, Pmax] int32 page tables of global page ids: the rows of
    data shard d (the d-th of n_data row blocks) over distinct pages of
    that shard's N/n_data (its last, the trash page, in none)."""
    per, n_loc = n_seqs // n_data, N // n_data
    tabs = [torch.randperm(n_loc - 1, generator=g, device=device)[: per * Pmax] + d * n_loc
            for d in range(n_data)]
    return torch.cat(tabs).reshape(n_seqs, Pmax).to(I32)


def _full(n, value, device):
    return torch.full((n,), value, dtype=I32, device=device)


def _fp_pages(g, shape, device):
    return _normal(g, shape, BF16, device), _normal(g, shape, BF16, device)


def _pages(g, shape, kv8, device):
    """One pool of ``shape``: bf16 values, or int8 codes and f32 scales."""
    if not kv8:
        return _normal(g, shape, BF16, device)
    codes = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8, device=device)
    scales = torch.rand(shape[:-1] + (1,), generator=g, device=device) / 64
    return {"q": codes, "s": scales}


def build_decode(arch, shape_name="decode_32k", mesh=None, cfg=None, scheme="baseline"):
    """One decode step of B sequences, each ``seq`` tokens deep (its
    next token at position seq - 1).  scheme "kv8": the transformer
    family over int8 KV pages; "2d" (on a mesh): the reference's
    large-model decode, GEMM activations replicated over data, the
    transformer family's pages data-sharded (each rank writes and attends
    its data shard's rows, then gathers them) and the MoE's expert d_ff
    over both axes (``flat_f``); the hybrid and rwkv6 take it as the
    replicated batch, as the reference's step does.  A batch that does
    not divide over the data shards is replicated over data with its
    caches, but for seamless-m4t (the reference's encoder-decoder step
    shards its batch over data) and an MoE outside ``2d`` (its MoE
    island shards the tokens over data), which raise ``ValueError``.
    The note records the reference's cost-model factors of a replicated
    batch (``outer_mult``, ``flop_divisor``), which the one-card cost
    model does not price."""
    if scheme not in ("baseline", "kv8", "2d"):
        raise ValueError(f"scheme {scheme!r}: baseline, kv8 or 2d")
    kv8 = scheme == "kv8"
    model = get_model(arch, cfg)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    shard = _Shard(model, mesh, batch=B, scheme=scheme)
    mesh_note = ""
    if mesh is not None:
        replicated = not shard.batch_sharded and shard.n_data > 1
        if replicated and cfg.family == "encdec":
            raise ValueError(
                f"{arch}: a decode batch of {B} rows replicated over {shard.n_data} data "
                "shards: the reference's encoder-decoder step shards its batch (and "
                "scheme 2d's) over data")
        if replicated and cfg.is_moe and scheme != "2d":
            raise ValueError(
                f"{arch}: a decode batch of {B} rows over {shard.n_data} data shards: "
                "the reference's MoE island shards the tokens over data (scheme 2d "
                "replicates them)")
        flat_f = scheme == "2d" and cfg.family in ("dense", "moe", "vlm")
        divisor = None if shard.batch_sharded or flat_f else shard.tp
        mesh_note = (f" mesh {tuple(mesh.shape)}"
                     + (f" replicated over data (outer_mult={shard.n_data if flat_f else 1}"
                        f" flop_divisor={divisor})" if replicated else ""))
    attn = shard.decode_attn(kv8)
    kw = shard.kw

    def tables_lens(g, device, pg_shape, Pmax):
        return (shard.rows(_tables(g, B, Pmax, pg_shape[1], device, shard.cache_data)),
                shard.rows(_full(B, S - 1, device)))

    if cfg.family == "ssm":                   # rwkv: state cache only
        def fn(params, tokens, state):
            return rwkv.decode(params, cfg, tokens, state, **kw)

        def make_args(g, device):
            return (shard.params(g, device), shard.rows(_tokens(g, cfg, (B,), device)),
                    rwkv.init_state(cfg, shard.n_rows(B), BF16, device, shard.tp))
        return _cell(fn, make_args, f"decode(state) B={B} ctx={S}{mesh_note}")

    if cfg.family == "hybrid":
        n_attn, n_mamba, _, _, _ = hybrid.group_structure(cfg)
        pg_shape, Pmax = _page_pool_shapes(cfg, B, S, n_layers=n_attn, tp=shard.tp,
                                           n_data=shard.cache_data)

        def fn(params, tokens, conv, ssm_st, kpg, vpg, bt, lens):
            return hybrid.decode(params, cfg, tokens, conv, ssm_st, kpg, vpg, bt, lens,
                                 attn_fn=attn, **kw)

        def make_args(g, device):
            cs, ss = ssm.mamba2_state_shapes(cfg, B)
            conv = {k: _normal(g, shard.local((n_mamba,) + v, CACHE_SPECS["conv"][k]),
                               BF16, device) for k, v in cs.items()}
            return (shard.params(g, device), shard.rows(_tokens(g, cfg, (B,), device)), conv,
                    _normal(g, shard.local((n_mamba,) + ss, CACHE_SPECS["ssm"]), F32, device),
                    *_fp_pages(g, shard.local(pg_shape), device),
                    *tables_lens(g, device, pg_shape, Pmax))
        return _cell(fn, make_args, f"decode(hybrid) B={B} ctx={S} attn_layers={n_attn}"
                     + mesh_note)

    if cfg.family == "encdec":
        pg_shape, Pmax = _page_pool_shapes(cfg, B, S, tp=shard.tp, n_data=shard.cache_data)
        cross_shape = (cfg.n_layers, B, cfg.encoder_seq) + pg_shape[3:]

        def fn(params, tokens, kpg, vpg, xk, xv, bt, lens):
            return encdec.decode(params, cfg, tokens, kpg, vpg, xk, xv, bt, lens,
                                 attn_fn=attn, **kw)

        def make_args(g, device):
            return (shard.params(g, device), shard.rows(_tokens(g, cfg, (B,), device)),
                    *_fp_pages(g, shard.local(pg_shape), device),
                    *_fp_pages(g, shard.local(cross_shape, CACHE_SPECS["cross"]), device),
                    *tables_lens(g, device, pg_shape, Pmax))
        return _cell(fn, make_args, f"decode(encdec) B={B} ctx={S}{mesh_note}")

    # transformer family
    pg_shape, Pmax = _page_pool_shapes(cfg, B, S, tp=shard.tp, n_data=shard.cache_data)

    def fn(params, tokens, kpg, vpg, bt, lens):
        return T.decode(params, cfg, tokens, kpg, vpg, bt, lens, attn_fn=attn, **kw)

    def make_args(g, device):
        shape = shard.local(pg_shape)
        return (shard.params(g, device), shard.rows(_tokens(g, cfg, (B,), device)),
                _pages(g, shape, kv8, device), _pages(g, shape, kv8, device),
                *tables_lens(g, device, pg_shape, Pmax))
    return _cell(fn, make_args, f"decode B={B} ctx={S} pool={pg_shape} scheme={scheme}"
                 + mesh_note)


# ------------------------------------------------------------------ mixed --
def build_mixed(arch, shape_name="mixed_32k", scheme="baseline", mesh=None, cfg=None):
    """The paper-technique cell: fused chunked-prefill + decode.  Each
    prompt stream's chunk ends at position ``seq``; decode rows are
    ``seq`` tokens deep.  scheme "kv8": int8-quantized KV pages
    ({"q": codes, "s": scales}, halving KV traffic).  On a mesh the
    stream count is rounded up to a multiple of the data shards (one or
    more a shard: the paper's #processes knob scaled to the mesh)."""
    model = get_model(arch, cfg)
    cfg = model.cfg
    sh = SHAPES[shape_name]
    B, S, C = sh["batch"], sh["seq"], sh["chunk"]
    shard = _Shard(model, mesh)
    Pstr = -(-max(sh["streams"], shard.n_data) // shard.n_data) * shard.n_data
    pg_shape, Pmax = _page_pool_shapes(cfg, B, S, extra_seqs=Pstr, tp=shard.tp,
                                       n_data=shard.n_data)
    kv8 = scheme == "kv8"
    attn = None if mesh is None else {
        "decode": spmd.make_sharded_decode_attn(mesh, kv_int8=kv8),
        "chunk": spmd.make_sharded_chunk_attn(mesh, kv_int8=kv8)}

    def fn(params, mb, kpg, vpg):
        return T.mixed(params, cfg, mb, kpg, vpg, attn_fn=attn, **shard.kw)

    def pages(g, device):
        return _pages(g, shard.local(pg_shape), kv8, device)

    def make_args(g, device):
        # distinct pages; each data shard's rows: its streams, then its decode rows
        table = _tables(g, Pstr + B, Pmax, pg_shape[1], device, shard.n_data)
        table = table.reshape(shard.n_data, (Pstr + B) // shard.n_data, Pmax)
        p_table = table[:, : Pstr // shard.n_data].reshape(Pstr, Pmax)
        d_table = table[:, Pstr // shard.n_data:].reshape(B, Pmax)
        mb = dict(p_tokens=_tokens(g, cfg, (Pstr, C), device), p_table=p_table,
                  p_start=_full(Pstr, S - C, device), p_lens=_full(Pstr, C, device),
                  d_tokens=_tokens(g, cfg, (B,), device), d_table=d_table,
                  d_lens=_full(B, S - 1, device),
                  d_active=torch.ones(B, dtype=torch.bool, device=device))
        mb = {k: shard.rows(v).clone() for k, v in mb.items()}
        return shard.params(g, device), mb, pages(g, device), pages(g, device)

    return _cell(fn, make_args, f"mixed(Splitwiser) streams={Pstr}x{C} + decode B={B} "
                                f"@ctx={S} scheme={scheme}"
                 + (f" mesh {tuple(mesh.shape)}" if mesh is not None else ""))


def build_cell(arch, shape_name, mesh=None):
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        return None, why
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train(arch, mesh), ""
    if kind == "prefill":
        return build_prefill(arch, shape_name, mesh), ""
    if kind == "decode":
        return build_decode(arch, shape_name, mesh), ""
    if kind == "mixed":
        return build_mixed(arch, shape_name, mesh=mesh), ""
    raise ValueError(kind)
