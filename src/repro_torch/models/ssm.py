"""State-space primitives in PyTorch: the Mamba2 (SSD) block and the
RWKV-6 ("Finch") layer.

The counterpart of the reference's ``models/ssm.py``, with its names,
layouts and parameter names.  Mamba2:
  * chunkwise-parallel form (prefill), ``mamba2_block``, whose scan goes
    through ``kernels.ops.ssd_chunk_scan``: the CUDA kernel K4 on the
    card, its plain version for CPU tensors;
  * recurrent form (decode), ``mamba2_decode``: an O(1) state update.
RWKV-6: token-shift mixing, a data-dependent per-channel decay and the
chunkwise WKV scan ``rwkv6_wkv_chunk``, plain PyTorch on every device
(the reference's scan is jnp under ``lax.scan``, not a Pallas kernel);
decode is the same scan at ``chunk=1``.
All decay exponentials are exp(delta log P) with delta log P <= 0.

On a mesh (a ``policy`` from ``models/sharding.py``) both blocks run on
the rank's shards, as ``launch/shardings.py`` places them.  Mamba2: the
rank's ``d_in / tp`` channels of ``wz``/``wx``/``conv_x``/``norm``/
``out_proj`` are its ``ssm_heads / tp`` heads (a split head raises
``ValueError``); ``wB``/``wC``/``wdt`` and the per-head vectors stay
whole, and the rank takes its heads' slice of ``wdt``, ``A_log``,
``D_skip`` and ``dt_bias``; the gated norm sums its mean of squares over
``model`` and ``out_proj``'s partial sums are reduced.  RWKV-6: the
rank's ``D / tp`` channels of ``wr``/``wk``/``wv``/``wg`` are its heads
(``u``, ``w0``, ``w_b``, ``ln_x`` are its slices), the token-shift mixes
and ``w_a`` stay whole, and ``wo`` and the channel mix's ``wv`` are
row-parallel with one ``all_reduce`` each.  States hold the rank's heads
(``*_state_shapes(..., tp=)``).  Under grad (training on a mesh) the
block inputs of the column-parallel products pass ``copy_to``, the
row-parallel sums ``reduce_from``, and the weights a rank holds whole
but uses on its heads alone (``MAMBA_WHOLE``, RWKV-6's ``w_a``)
``copy_to``, so every gradient sums over `model`.  With ``policy=None``
nothing of this runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.costs import kernel_region
from repro_torch.models import sharding
from repro_torch.models.layers import dense_init, head_rms_norm, rms_norm
from repro_torch.models.sharding import copy_to, copy_weights, reduce_from


# Projections are stored separately (z/x/B/C/dt), as in the reference.
def mamba2_init(generator, cfg, dtype, device, stack=()):
    """Random Mamba2 weights with the reference's shapes and init scales,
    drawn from ``generator`` in the reference's order; ``stack``
    prepends layer axes."""
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    H, N, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    s = tuple(stack)

    def dense(shape, fan_in):
        return dense_init(generator, s + shape, fan_in, dtype, device)

    def full(vals):
        return vals.to(dtype).to(device).expand(*s, H).clone()

    def zeros(*shape):
        return torch.zeros(s + shape, dtype=dtype, device=device)

    p = {"ln": zeros(D)}
    for name, shape, fan_in in (("wz", (D, d_in), D), ("wx", (D, d_in), D),
                                ("wB", (D, N), D), ("wC", (D, N), D),
                                ("wdt", (D, H), D), ("conv_x", (W, d_in), W),
                                ("conv_B", (W, N), W), ("conv_C", (W, N), W)):
        p[name] = dense(shape, fan_in)
    lin = lambda lo, hi: torch.linspace(lo, hi, H, dtype=torch.float32)
    p.update({
        "conv_b_x": zeros(d_in), "conv_b_B": zeros(N), "conv_b_C": zeros(N),
        "A_log": full(torch.log(lin(1.0, 16.0))),
        "D_skip": torch.ones(s + (H,), dtype=dtype, device=device),
        "dt_bias": full(torch.log(torch.expm1(lin(1e-3, 1e-1)))),
        "norm": zeros(d_in),
        "out_proj": dense((d_in, D), d_in),
    })
    return p


def _mamba_proj(lp, x, cfg):
    """x [B,T,D] -> (z [B,T,d_in], x/B/C projections, dt [B,T,H])."""
    return x @ lp["wz"], (x @ lp["wx"], x @ lp["wB"], x @ lp["wC"]), x @ lp["wdt"]


def _causal_conv(xbc, conv_state, w, b):
    """Depthwise causal conv. xbc [B,T,Cc]; conv_state [B,W-1,Cc] history.

    Returns (y [B,T,Cc], new_state [B,W-1,Cc]).
    """
    W = w.shape[0]
    full = torch.cat([conv_state, xbc], dim=1)                 # [B, T+W-1, Cc]
    T = xbc.shape[1]
    y = sum(full[:, j: j + T] * w[j] for j in range(W)) + b    # y_t = sum_j w[j] full[t+j]
    new_state = full[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(y), new_state


@kernel_region
def mamba2_chunk_scan(xh, Bc, Cc, la, h0, chunk=64):
    """SSD chunkwise scan.

    xh [B,T,H,P] (already dt-scaled inputs dt_t*x_t), Bc/Cc [B,T,N],
    la [B,T,H] log-decay (<=0), h0 [B,H,P,N] (None: zeros).
    Returns (y [B,T,H,P] in xh's dtype, h_out [B,H,P,N] f32).
    """
    return ops.ssd_chunk_scan(xh, la, Bc, Cc, h0, chunk=chunk)


def mamba2_heads(cfg, tp=1, rank=0):
    """(first head, heads) of model rank ``rank`` of ``tp``: the Mamba2
    heads its ``d_in / tp`` channels hold.  Raises ``ValueError`` where
    those channels would split a head."""
    d_in, H = cfg.ssm_expand * cfg.d_model, cfg.ssm_heads
    if H % tp or d_in % tp:
        raise ValueError(
            f"Mamba2 over tp={tp}: d_in={d_in} channels in {H} heads of "
            f"{d_in // H} do not split into whole heads a rank")
    return rank * (H // tp), H // tp


# Mamba2 weights every model rank holds whole but uses on its own heads
# alone: under grad they enter through ``copy_to``, so their gradients sum
# over the tensor-parallel axis
MAMBA_WHOLE = ("wB", "wC", "wdt", "conv_B", "conv_C", "conv_b_B", "conv_b_C",
               "A_log", "D_skip", "dt_bias")


def _head_params(lp, cfg, policy):
    """``lp`` with ``wdt``, ``A_log``, ``D_skip`` and ``dt_bias`` cut to
    this rank's heads (``lp`` as it is without a policy), and that head
    count; under grad the weights of ``MAMBA_WHOLE`` pass ``copy_to``
    first."""
    if policy is None:
        return lp, cfg.ssm_heads
    # (the fsdp training scheme has no tensor-parallel axis: every head)
    h0, n = mamba2_heads(cfg, policy.tp, policy.index("model") if policy.tp > 1 else 0)
    if lp["wx"].shape[-1] * policy.tp != cfg.ssm_expand * cfg.d_model:
        raise ValueError(f"wx {tuple(lp['wx'].shape)} is not a 1/{policy.tp} "
                         "shard of d_in over model")
    lp = copy_weights(lp, MAMBA_WHOLE, policy)
    cut = {"wdt": lp["wdt"][..., h0:h0 + n]}
    cut.update({k: lp[k][h0:h0 + n] for k in ("A_log", "D_skip", "dt_bias")})
    return dict(lp, **cut), n


def _dt_decay(lp, dt):
    """softplus(dt + dt_bias) [.., H] f32 and A = exp(A_log) [H] f32.
    (torch's softplus is the identity above 20, JAX's is not: the two
    differ by less than 1e-8 there.)"""
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    return dt, torch.exp(lp["A_log"].float())


def mamba2_block(lp, cfg, x, conv_state, ssm_state, chunk=64, policy=None):
    """Full-sequence (chunked) Mamba2 block. x [B,T,D].

    conv_state: dict(x [B,W-1,d_in], B [B,W-1,N], C [B,W-1,N]);
    ssm_state [B,H,P,N] f32 or None (zeros); on a mesh d_in and H are
    the rank's.  Returns (y [B,T,D], new_conv_state, new_ssm_state).
    """
    lp, H = _head_params(lp, cfg, policy)
    h = copy_to(rms_norm(x, lp["ln"], cfg.norm_eps), policy)
    z, (xc, Bc, Cc), dt = _mamba_proj(lp, h, cfg)
    xc, sx = _causal_conv(xc, conv_state["x"], lp["conv_x"], lp["conv_b_x"])
    Bc, sB = _causal_conv(Bc, conv_state["B"], lp["conv_B"], lp["conv_b_B"])
    Cc, sC = _causal_conv(Cc, conv_state["C"], lp["conv_C"], lp["conv_b_C"])
    xh = xc.reshape(*xc.shape[:-1], H, -1)                     # [B,T,H,P]
    dt, A = _dt_decay(lp, dt)
    la = -dt * A                                               # [B,T,H] <= 0
    y, ssm_state = mamba2_chunk_scan(xh * dt[..., None].to(xh.dtype),
                                     Bc, Cc, la, ssm_state, chunk)
    y = y + xh * lp["D_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:-1], -1)                           # [B,T,d_in]
    y = sharding.rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps, policy)
    return (x + reduce_from(y @ lp["out_proj"], policy), {"x": sx, "B": sB, "C": sC},
            ssm_state)


def mamba2_decode(lp, cfg, x, conv_state, ssm_state, policy=None):
    """One-token recurrent Mamba2 step. x [B,D]; on a mesh the states
    hold the rank's channels and heads.

    Returns (y [B,D], new_conv_state, new_ssm_state).
    """
    lp, H = _head_params(lp, cfg, policy)
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    z, (xc, Bc, Cc), dt = _mamba_proj(lp, h, cfg)

    def conv1(t, s, w, b):
        full = torch.cat([s, t[:, None]], dim=1)               # [B,W,C]
        return F.silu(torch.einsum("bwc,wc->bc", full, w) + b), full[:, 1:]

    xc, sx = conv1(xc, conv_state["x"], lp["conv_x"], lp["conv_b_x"])
    Bc, sB = conv1(Bc, conv_state["B"], lp["conv_B"], lp["conv_b_B"])
    Cc, sC = conv1(Cc, conv_state["C"], lp["conv_C"], lp["conv_b_C"])
    xh = xc.reshape(x.shape[0], H, -1)                         # [B,H,P]
    dt, A = _dt_decay(lp, dt)
    a = torch.exp(-dt * A)                                     # [B,H]
    xdt = xh.float() * dt[..., None]
    h_new = a[..., None, None] * ssm_state.float() + torch.einsum(
        "bhp,bn->bhpn", xdt, Bc.float())
    y = torch.einsum("bhpn,bn->bhp", h_new, Cc.float())
    y = y + xh.float() * lp["D_skip"].float()[None, :, None]
    y = y.reshape(x.shape[0], -1).to(x.dtype)
    y = sharding.rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps, policy)
    return (x + reduce_from(y @ lp["out_proj"], policy), {"x": sx, "B": sB, "C": sC},
            h_new.to(ssm_state.dtype))


def mamba2_state_shapes(cfg, batch, tp=1):
    """(conv_state shape dict, ssm_state shape); with ``tp``, a model
    rank's: its d_in / tp channels of ``x`` and its heads (``B``/``C``
    whole)."""
    d_in = cfg.ssm_expand * cfg.d_model
    Pd = d_in // cfg.ssm_heads
    _, H = mamba2_heads(cfg, tp)
    W = cfg.ssm_conv_width
    conv = {"x": (batch, W - 1, d_in // tp), "B": (batch, W - 1, cfg.ssm_state),
            "C": (batch, W - 1, cfg.ssm_state)}
    return conv, (batch, H, Pd, cfg.ssm_state)


# ====================================================================== RWKV6
LORA_R = 32


def rwkv6_init(generator, cfg, dtype, device, stack=()):
    """Random RWKV-6 layer weights with the reference's shapes and init
    scales, drawn from ``generator`` in the reference's order; ``stack``
    prepends layer axes."""
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    F_ = cfg.d_ff
    s = tuple(stack)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, s + shape, fan_in, dtype, device, scale)

    def full(value, *shape):
        return torch.full(s + shape, value, dtype=dtype, device=device)

    tmix = {name: full(0.5, D) for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")}
    tmix["w0"] = full(-2.0, D)
    tmix.update({
        "w_a": dense((D, LORA_R), D), "w_b": dense((LORA_R, D), LORA_R),
        "wr": dense((D, D), D), "wk": dense((D, D), D), "wv": dense((D, D), D),
        "wg": dense((D, D), D), "wo": dense((D, D), D, out_scale),
        "u": full(0.0, H, hd), "ln_x": full(0.0, D),
    })
    cmix = {"mu_r": full(0.5, D), "mu_k": full(0.5, D),
            "wr": dense((D, D), D), "wk": dense((D, F_), D),
            "wv": dense((F_, D), F_, out_scale)}
    return {"ln1": full(0.0, D), "ln2": full(0.0, D), "tmix": tmix, "cmix": cmix}


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _shifted(x, x_last):
    """x [B,T,D]; x_last [B,D] (token before this span) -> x_{t-1} per t."""
    return torch.cat([x_last[:, None], x[:, :-1]], dim=1)


@kernel_region
def rwkv6_wkv_chunk(r, k, v, lw, u, S0, chunk=32):
    """Chunkwise WKV with per-channel data-dependent decay, in f32
    whatever the inputs' dtype.

    r/k/v [B,T,H,K]; lw [B,T,H,K] log-decay (<=0); u [H,K]; S0 [B,H,K,V].
    T is padded to a multiple of ``chunk`` (zero k and log-decay: the
    state passes the padding unchanged), which is cut off the output.
    Returns (o [B,T,H,V] f32, S_out [B,H,K,V] f32).  All exp args are
    <= 0 (safe).
    """
    B, T, H, K = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    nchunk = (T + pad) // chunk
    rc, kc, vc, lwc = (t.reshape(B, nchunk, chunk, H, -1) for t in (r, k, v, lw))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    tri = tri[None, :, :, None, None]
    uf = u.float()
    S = S0.float()
    outs = []
    for c in range(nchunk):
        rq, kq, vq, lq = (t[:, c].float() for t in (rc, kc, vc, lwc))   # [B,Q,H,K]
        L = torch.cumsum(lq, dim=1)
        Lm1 = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
        # intra: A[t,i] = sum_c r_t k_i exp(Lm1_t - L_i), i < t; diag: r.(u*k)
        diff = Lm1[:, :, None] - L[:, None]                              # [B,Q(t),Q(i),H,K]
        E = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        A = (rq[:, :, None] * kq[:, None] * E).sum(-1)                   # [B,Q(t),Q(i),H]
        o = torch.einsum("btih,bihv->bthv", A, vq)
        o = o + (rq * uf * kq).sum(-1)[..., None] * vq
        # inter: o_t += (r_t * exp(Lm1_t)) @ S
        o = o + torch.einsum("bthk,bhkv->bthv", rq * torch.exp(Lm1), S)
        # state: S' = diag(exp(L_last)) S + sum_i exp(L_last - L_i) k_i v_i
        Llast = L[:, -1]                                                 # [B,H,K]
        S = torch.exp(Llast)[..., None] * S + torch.einsum(
            "bihk,bihv->bhkv", kq * torch.exp(Llast[:, None] - L), vq)
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :T]
    return o, S


def _rwkv_heads(lp, cfg, policy):
    """This rank's WKV heads: ``wr``'s output columns over the head dim."""
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    tp = 1 if policy is None else policy.tp
    if (D // hd) % tp or lp["wr"].shape[-1] * tp != D:
        raise ValueError(f"RWKV-6 over tp={tp}: wr {tuple(lp['wr'].shape)} is not "
                         f"the rank's whole heads of {D // hd} heads of {hd}")
    return lp["wr"].shape[-1] // hd


def rwkv6_tmix(lp, cfg, x, x_last, S0, chunk=32, policy=None):
    """Time-mix over a span. x [B,T,D]; x_last [B,D]; S0 [B,H,K,V]
    (on a mesh the rank's heads).

    Returns (out [B,T,D], new_x_last [B,D], S_out f32).
    """
    hd = cfg.rwkv_head_dim
    H = _rwkv_heads(lp, cfg, policy)
    xp = _shifted(x, x_last)
    # each mix feeds a product on the rank's heads: its gradient sums over them
    rx, kx, vx, gx, wx = (copy_to(_lerp(x, xp, lp[m]), policy)
                          for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    lp = copy_weights(lp, ("w_a",), policy)
    shp = (*x.shape[:-1], H, hd)
    r = (rx @ lp["wr"]).reshape(shp)
    k = (kx @ lp["wk"]).reshape(shp)
    v = (vx @ lp["wv"]).reshape(shp)
    g = F.silu(gx @ lp["wg"])
    # data-dependent per-channel decay (the Finch hallmark)
    dw = torch.tanh(wx @ lp["w_a"]) @ lp["w_b"]
    lw = -torch.exp((lp["w0"] + dw).float()).reshape(shp)
    o, S_out = rwkv6_wkv_chunk(r, k, v, lw, lp["u"], S0, chunk)
    # per-head RMS norm (RWKV's GroupNorm over heads)
    o = head_rms_norm(o.to(x.dtype), lp["ln_x"].reshape(H, hd), cfg.norm_eps)
    o = o.reshape(*x.shape[:-1], H * hd) * g.to(x.dtype)
    return reduce_from(o @ lp["wo"], policy), x[:, -1], S_out


def rwkv6_cmix(lp, cfg, x, x_last, policy=None):
    """Channel-mix. Returns (out [B,T,D], new_x_last)."""
    xp = _shifted(x, x_last)
    rx, kx = _lerp(x, xp, lp["mu_r"]), _lerp(x, xp, lp["mu_k"])
    r = torch.sigmoid(rx @ lp["wr"])          # wr whole: the same on every rank
    kk = torch.square(F.relu(copy_to(kx, policy) @ lp["wk"]))
    return r * reduce_from(kk @ lp["wv"], policy), x[:, -1]


def rwkv6_layer(lp, cfg, x, state, chunk=32, policy=None):
    """One RWKV6 layer over a span. state = dict(x_tm, x_cm [B,D], S [B,H,K,V])."""
    o, x_tm, S = rwkv6_tmix(lp["tmix"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                            state["x_tm"], state["S"], chunk, policy)
    x = x + o
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    o2, x_cm = rwkv6_cmix(lp["cmix"], cfg, h, state["x_cm"], policy)
    x = x + o2
    return x, {"x_tm": x_tm, "x_cm": x_cm, "S": S}


def rwkv6_state_shapes(cfg, batch, tp=1):
    """State shapes; with ``tp``, a model rank's (its heads of ``S``)."""
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    if H % tp:
        raise ValueError(f"RWKV-6 over tp={tp}: {H} heads do not split evenly")
    return {"x_tm": (batch, D), "x_cm": (batch, D), "S": (batch, H // tp, hd, hd)}
