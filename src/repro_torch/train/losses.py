"""Cross-entropy LM losses, counterparts of the reference's
``train/losses.py``.

``lm_loss_from_hidden`` never materializes [B, T, V] logits: it loops
over sequence chunks computing logsumexp + the label logit via an iota
mask (no gather, so its backward has no scatter: deterministic on the
card).  ``lm_loss_from_hidden_vtiled`` loops over vocabulary tiles with
an online logsumexp instead, inside a ``torch.autograd.Function`` whose
backward is another vocab-tiled loop (the reference's ``custom_vjp``).
Logits are f32: f32 weights multiply in f32, others are upcast first.

**On a mesh** (``policy``, ``models/sharding.py``) both are vocab-parallel
cross-entropies, Megatron's: the rank holds its ``Vp/tp`` rows of the
table (gathered whole along D first where FSDP'd), ``hidden`` enters
through ``copy_to``, and each token's logsumexp and label logit come from
three all-reduces over the tensor-parallel axis of ``[tokens]``-sized
vectors: the max (no gradient: the logsumexp does not depend on it), the
sum of exps and the label logit (``reduce_from``, whose identity backward
leaves each rank the gradient of its own columns).  The other choice, to
gather each chunk's logits, would move ``(tp - 1)/tp`` of a ``[B, c, Vp]``
f32 block a chunk (qwen3-0.6b at B = 4, c = 512: 1.2 GB) where these move
``3 x B x c`` floats, and would hold the whole block on every rank.  The
loss is the global mean: each rank divides its tokens' summed loss by
the token count summed over the batch axes, and ``reduce_from`` over
them gives every rank the global value with its own tokens' gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.costs import kernel_region
from repro_torch.models.sharding import all_reduce, copy_to, reduce_from

IGNORE = -100
NEG_INF = -1e30


def _logits(h, table):
    """h [..., D] @ table [V, D]^T in f32."""
    return h.float() @ table.float().t()


def _vocab_parallel(policy):
    """(the policy, if its tensor-parallel axis splits the vocab; this
    rank's first vocab id is then ``tp_index * Vp/tp``)."""
    return policy if policy is not None and policy.tp_axis is not None else None


def _ce(logits, labels, v_real, policy=None):
    """Per-token (logsumexp - label logit) of f32 ``logits`` [..., Vl]
    against ``labels`` [...]; with a vocab-parallel ``policy`` the logits
    are this rank's columns from vocab id ``tp_index * Vl`` on."""
    Vl = logits.shape[-1]
    v0 = 0 if policy is None else policy.tp_index * Vl
    iota = torch.arange(Vl, device=logits.device) + v0
    if v0 + Vl > v_real:
        logits = torch.where(iota < v_real, logits, NEG_INF)
    lab = torch.where(labels[..., None] == iota, logits, 0.0).sum(-1)
    if policy is None:
        return torch.logsumexp(logits, dim=-1) - lab
    m = all_reduce(logits.detach().amax(-1), policy, op="max")
    s = reduce_from(torch.exp(logits - m[..., None]).sum(-1), policy)
    return m + torch.log(s) - reduce_from(lab, policy)


def _chunk_ce(hidden_c, labels_c, table, softcap, v_real, policy=None):
    """hidden_c [B, c, D]; labels_c [B, c] -> per-token loss [B, c]; on a
    mesh ``table`` is the rank's vocab rows."""
    logits = _logits(hidden_c, table)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return _ce(logits, labels_c, v_real, policy)


def _global_mean(tot, cnt, policy):
    """(tot / the token count summed over the batch axes, that count): each
    rank's share of the global mean, summed over the batch axes by
    ``reduce_from``; (tot / cnt, cnt) without a policy."""
    if policy is None:
        return tot / torch.clamp(cnt, min=1.0), cnt
    n = all_reduce(cnt.detach().clone(), policy, policy.batch_axis)
    return reduce_from(tot / torch.clamp(n, min=1.0), policy, policy.batch_axis), n


def lm_loss_from_hidden(hidden, labels, table, *, softcap=None, v_real=None,
                        chunk=512, policy=None):
    """hidden [B, T, D]; labels [B, T] (IGNORE = masked).

    Returns (mean_loss, n_tokens), both f32 scalars.  On a mesh: the
    rank's rows and vocab rows of ``table``; the global mean and count.
    """
    B, T, D = hidden.shape
    v_real = v_real or table.shape[0]
    vp = _vocab_parallel(policy)
    hidden = copy_to(hidden, vp)
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
        ce = _chunk_ce(h, torch.where(mask, l, 0), table, softcap, v_real, vp)
        tot = tot + torch.sum(ce * mask)
        cnt = cnt + torch.sum(mask)
    return _global_mean(tot, cnt, policy)


# ------------------------------------------------- vocab-tiled fused CE ----
def _tiles(table, vtile):
    Vp, D = table.shape
    if Vp % vtile:
        raise ValueError(f"padded vocab {Vp} must be a multiple of vtile={vtile}")
    return table.reshape(Vp // vtile, vtile, D)


@kernel_region
def _vtiled_ce_fwd(hidden2d, labels1d, table, softcap, v_real, vtile, v0=0):
    """(running max, sum of exps under it, label logit), each [N], of
    hidden2d [N, D] against table [Vl, D] (vocab ids ``v0`` on), one
    vocabulary tile at a time with an online logsumexp."""
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
        ids = v0 + ti * vtile + iota
        logits = torch.where(ids < v_real, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        lab = lab + torch.where(ids == labels1d[:, None], logits, 0.0).sum(-1)
        m = m_new
    return m, s, lab


@kernel_region
def _vtiled_ce_bwd(hidden2d, labels1d, table, lse, g, softcap, v_real, vtile, v0=0):
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
        ids = v0 + ti * vtile + iota
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
    [Vl, D], one vocabulary tile at a time; the backward recomputes each
    tile's logits (``_vtiled_ce_bwd`` of the reference).  Both loops are
    kernel regions for ``launch/costs.py``, as the reference's scans are.
    With a ``policy`` the table is the rank's vocab rows: the forward
    combines the ranks' (max, sum of exps, label logit) over the
    tensor-parallel axis, and the backward gives the hidden state's
    gradient from the rank's columns alone (``copy_to`` sums it)."""

    @staticmethod
    def forward(ctx, hidden2d, labels1d, table, softcap, v_real, vtile, policy):
        v0 = 0 if policy is None else policy.tp_index * table.shape[0]
        m, s, lab = _vtiled_ce_fwd(hidden2d, labels1d, table, softcap, v_real, vtile, v0)
        if policy is not None:
            m_all = all_reduce(m.clone(), policy, op="max")
            s = all_reduce(s * torch.exp(m - m_all), policy)
            lab, m = all_reduce(lab, policy), m_all
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        ctx.save_for_backward(hidden2d, labels1d, table, lse)
        ctx.kw = (softcap, v_real, vtile, v0)
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        hidden2d, labels1d, table, lse = ctx.saved_tensors
        dh, dtable = _vtiled_ce_bwd(hidden2d, labels1d, table, lse, g, *ctx.kw)
        return dh, None, dtable, None, None, None, None


def lm_loss_from_hidden_vtiled(hidden, labels, table, *, softcap=None,
                               v_real=None, vtile=8192, policy=None):
    """Drop-in for :func:`lm_loss_from_hidden` with vocab-tiled fused CE;
    ``vtile`` is halved until it divides the (rank's) padded vocabulary."""
    B, T, D = hidden.shape
    v_real = v_real or table.shape[0]
    vtile = min(vtile, table.shape[0])
    while table.shape[0] % vtile:
        vtile //= 2
    vp = _vocab_parallel(policy)
    mask = labels != IGNORE
    lab = torch.where(mask, labels, 0).reshape(-1)
    ce = _VtiledCE.apply(copy_to(hidden, vp).reshape(B * T, D), lab, table,
                         float(softcap) if softcap else 0.0, int(v_real), int(vtile), vp)
    ce = ce.reshape(B, T)
    return _global_mean(torch.sum(ce * mask), torch.sum(mask).float(), policy)


def lm_loss(logits, labels, *, v_real=None, policy=None):
    """Full-logit CE (small models / non-transformer families).  On a mesh
    (``policy``) ``logits`` are the rank's rows and, where the policy has a
    tensor-parallel axis, its vocab columns [B, T, Vp / tp] (the logits
    are never gathered: seamless-m4t's 256,206-token vocab makes them
    ~1 GB of f32 a rank at B = 4, T = 256); the loss is then
    ``_chunk_ce``'s vocab-parallel cross-entropy, and the global mean
    over the batch axes."""
    mask = labels != IGNORE
    lab = torch.where(mask, labels, 0)
    logits = logits.float()
    if policy is not None:
        vp = _vocab_parallel(policy)
        ce = _ce(logits, lab, v_real or logits.shape[-1] * (1 if vp is None else vp.tp), vp)
        return _global_mean(torch.sum(ce * mask), torch.sum(mask).float(), policy)
    v_real = v_real or logits.shape[-1]
    Vp = logits.shape[-1]
    if Vp != v_real:
        logits = torch.where(torch.arange(Vp, device=logits.device) < v_real,
                             logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    n = torch.sum(mask).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(n, min=1.0), n
