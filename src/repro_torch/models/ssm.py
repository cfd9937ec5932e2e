"""State-space primitives in PyTorch: the Mamba2 (SSD) block.

The counterpart of the Mamba2 half of the reference's ``models/ssm.py``,
with its names, layouts and parameter names:
  * chunkwise-parallel form (prefill), ``mamba2_block``, whose scan goes
    through ``kernels.ops.ssd_chunk_scan``: the CUDA kernel K4 on the
    card, its plain version for CPU tensors;
  * recurrent form (decode), ``mamba2_decode``: an O(1) state update.
All decay exponentials are exp(delta log P) with delta log P <= 0.  The
RWKV-6 half comes with a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


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


def mamba2_chunk_scan(xh, Bc, Cc, la, h0, chunk=64):
    """SSD chunkwise scan.

    xh [B,T,H,P] (already dt-scaled inputs dt_t*x_t), Bc/Cc [B,T,N],
    la [B,T,H] log-decay (<=0), h0 [B,H,P,N] (None: zeros).
    Returns (y [B,T,H,P] in xh's dtype, h_out [B,H,P,N] f32).
    """
    return ops.ssd_chunk_scan(xh, la, Bc, Cc, h0, chunk=chunk)


def _dt_decay(lp, dt):
    """softplus(dt + dt_bias) [.., H] f32 and A = exp(A_log) [H] f32.
    (torch's softplus is the identity above 20, JAX's is not: the two
    differ by less than 1e-8 there.)"""
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    return dt, torch.exp(lp["A_log"].float())


def mamba2_block(lp, cfg, x, conv_state, ssm_state, chunk=64):
    """Full-sequence (chunked) Mamba2 block. x [B,T,D].

    conv_state: dict(x [B,W-1,d_in], B [B,W-1,N], C [B,W-1,N]);
    ssm_state [B,H,P,N] f32 or None (zeros).
    Returns (y [B,T,D], new_conv_state, new_ssm_state).
    """
    H = cfg.ssm_heads
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
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
    y = rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    return x + y @ lp["out_proj"], {"x": sx, "B": sB, "C": sC}, ssm_state


def mamba2_decode(lp, cfg, x, conv_state, ssm_state):
    """One-token recurrent Mamba2 step. x [B,D].

    Returns (y [B,D], new_conv_state, new_ssm_state).
    """
    H = cfg.ssm_heads
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
    y = rms_norm(y * F.silu(z), lp["norm"], cfg.norm_eps)
    return x + y @ lp["out_proj"], {"x": sx, "B": sB, "C": sC}, h_new.to(ssm_state.dtype)


def mamba2_state_shapes(cfg, batch):
    """(conv_state shape dict, ssm_state shape)."""
    d_in = cfg.ssm_expand * cfg.d_model
    Pd = d_in // cfg.ssm_heads
    W = cfg.ssm_conv_width
    conv = {"x": (batch, W - 1, d_in), "B": (batch, W - 1, cfg.ssm_state),
            "C": (batch, W - 1, cfg.ssm_state)}
    return conv, (batch, cfg.ssm_heads, Pd, cfg.ssm_state)
