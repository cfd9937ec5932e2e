"""Cross-entropy LM losses, counterparts of the reference's
``train/losses.py``.

``lm_loss_from_hidden`` never materializes [B, T, V] logits: it loops
over sequence chunks computing logsumexp + the label logit via an iota
mask (no gather, so its backward has no scatter: deterministic on the
card).  ``lm_loss_from_hidden_vtiled`` loops over vocabulary tiles with
an online logsumexp instead, inside a ``torch.autograd.Function`` whose
backward is another vocab-tiled loop (the reference's ``custom_vjp``).
Logits are f32: f32 weights multiply in f32, others are upcast first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.costs import kernel_region

IGNORE = -100
NEG_INF = -1e30


def _logits(h, table):
    """h [..., D] @ table [V, D]^T in f32."""
    return h.float() @ table.float().t()


def _chunk_ce(hidden_c, labels_c, table, softcap, v_real):
    """hidden_c [B, c, D]; labels_c [B, c] -> per-token loss [B, c]."""
    logits = _logits(hidden_c, table)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    Vp = table.shape[0]
    iota = torch.arange(Vp, device=logits.device)
    if Vp != v_real:
        logits = torch.where(iota < v_real, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.where(labels_c[..., None] == iota, logits, 0.0).sum(-1)
    return lse - lab


def lm_loss_from_hidden(hidden, labels, table, *, softcap=None, v_real=None,
                        chunk=512):
    """hidden [B, T, D]; labels [B, T] (IGNORE = masked).

    Returns (mean_loss, n_tokens), both f32 scalars.
    """
    B, T, D = hidden.shape
    v_real = v_real or table.shape[0]
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range((T + pad) // c):
        h, l = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        mask = l != IGNORE
        ce = _chunk_ce(h, torch.where(mask, l, 0), table, softcap, v_real)
        tot = tot + torch.sum(ce * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0), cnt


# ------------------------------------------------- vocab-tiled fused CE ----
def _tiles(table, vtile):
    Vp, D = table.shape
    if Vp % vtile:
        raise ValueError(f"padded vocab {Vp} must be a multiple of vtile={vtile}")
    return table.reshape(Vp // vtile, vtile, D)


@kernel_region
def _vtiled_ce_fwd(hidden2d, labels1d, table, softcap, v_real, vtile):
    """(per-token lse - label logit [N], lse [N]) of hidden2d [N, D]
    against table [Vp, D], one vocabulary tile at a time with an online
    logsumexp."""
    N, _ = hidden2d.shape
    h = hidden2d.float()
    m = torch.full((N,), NEG_INF, dtype=torch.float32, device=h.device)
    s = torch.zeros((N,), dtype=torch.float32, device=h.device)
    lab = torch.zeros((N,), dtype=torch.float32, device=h.device)
    iota = torch.arange(vtile, device=h.device)
    for ti, tbl in enumerate(_tiles(table, vtile)):
        logits = _logits(h, tbl)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        ids = ti * vtile + iota
        logits = torch.where(ids < v_real, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        lab = lab + torch.where(ids == labels1d[:, None], logits, 0.0).sum(-1)
        m = m_new
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    return lse - lab, lse


@kernel_region
def _vtiled_ce_bwd(hidden2d, labels1d, table, lse, g, softcap, v_real, vtile):
    """(d hidden2d, d table) of the per-token loss for its cotangent g
    [N], recomputing each tile's logits."""
    h = hidden2d.float()
    gf = g.float()
    dh = torch.zeros_like(h)
    dtiles = []
    iota = torch.arange(vtile, device=h.device)
    for ti, tbl in enumerate(_tiles(table, vtile)):
        tblf = tbl.float()
        logits = h @ tblf.t()
        dcap = None
        if softcap:
            t = torch.tanh(logits / softcap)
            logits = t * softcap
            dcap = 1.0 - t.square()                   # d capped / d logits
        ids = ti * vtile + iota
        p = torch.where(ids < v_real, torch.exp(logits - lse[:, None]), 0.0)
        onehot = (ids == labels1d[:, None]).float()
        dlogits = gf[:, None] * (p - onehot)          # [N, vtile]
        if dcap is not None:
            dlogits = dlogits * dcap
        dh = dh + dlogits @ tblf
        dtiles.append((dlogits.t() @ h).to(table.dtype))
    return dh.to(hidden2d.dtype), torch.cat(dtiles).reshape(table.shape)


class _VtiledCE(torch.autograd.Function):
    """Per-token (lse - label logit) [N] of hidden2d [N, D] against table
    [Vp, D], one vocabulary tile at a time; the backward recomputes each
    tile's logits (``_vtiled_ce_bwd`` of the reference).  Both loops are
    kernel regions for ``launch/costs.py``, as the reference's scans are."""

    @staticmethod
    def forward(ctx, hidden2d, labels1d, table, softcap, v_real, vtile):
        out, lse = _vtiled_ce_fwd(hidden2d, labels1d, table, softcap, v_real, vtile)
        ctx.save_for_backward(hidden2d, labels1d, table, lse)
        ctx.kw = (softcap, v_real, vtile)
        return out

    @staticmethod
    def backward(ctx, g):
        hidden2d, labels1d, table, lse = ctx.saved_tensors
        dh, dtable = _vtiled_ce_bwd(hidden2d, labels1d, table, lse, g, *ctx.kw)
        return dh, None, dtable, None, None, None


def lm_loss_from_hidden_vtiled(hidden, labels, table, *, softcap=None,
                               v_real=None, vtile=8192):
    """Drop-in for :func:`lm_loss_from_hidden` with vocab-tiled fused CE;
    ``vtile`` is halved until it divides the padded vocabulary."""
    B, T, D = hidden.shape
    v_real = v_real or table.shape[0]
    vtile = min(vtile, table.shape[0])
    while table.shape[0] % vtile:
        vtile //= 2
    mask = labels != IGNORE
    lab = torch.where(mask, labels, 0).reshape(-1)
    ce = _VtiledCE.apply(hidden.reshape(B * T, D), lab, table,
                         float(softcap) if softcap else 0.0, int(v_real), int(vtile))
    ce = ce.reshape(B, T)
    n = torch.sum(mask).float()
    return torch.sum(ce * mask) / torch.clamp(n, min=1.0), n


def lm_loss(logits, labels, *, v_real=None):
    """Full-logit CE (small models / non-transformer families)."""
    v_real = v_real or logits.shape[-1]
    mask = labels != IGNORE
    lab = torch.where(mask, labels, 0)
    logits = logits.float()
    Vp = logits.shape[-1]
    if Vp != v_real:
        logits = torch.where(torch.arange(Vp, device=logits.device) < v_real,
                             logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    n = torch.sum(mask).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(n, min=1.0), n
