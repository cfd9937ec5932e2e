"""AdamW on nested dicts of tensors, a counterpart of the reference's
``optim/adamw.py``, with optional int8 block-quantized moments.

Master math is f32 whatever the parameters' dtype.  Int8 moments are
:class:`Q8` pairs with the reference's encoding: codes shaped like the
parameter (int8), one f32 scale per block of ``QBLOCK`` along the last
axis (a last axis shorter than ``QBLOCK`` is one block), codes rounded
half to even (``torch.round``, as ``jnp.round``).  Parameters whose last
axis is shorter than 2 (and scalars) keep f32 moments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common.tree import tree_leaves, tree_zip_map

QBLOCK = 256


def _q8_encode(x):
    """x [..., n] f32 -> (int8 codes shaped like x, f32 scales [..., nblk])."""
    n = x.shape[-1] if x.ndim else 1
    x2 = x if x.ndim else x.reshape(1)
    pad = (-n) % QBLOCK if n >= QBLOCK else 0
    blk = QBLOCK if n >= QBLOCK else n
    xp = F.pad(x2, (0, pad))
    nblk = xp.shape[-1] // blk
    blocks = xp.reshape(*xp.shape[:-1], nblk, blk)
    scale = blocks.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)).to(torch.int8)
    q = q.reshape(xp.shape)[..., :n]
    return q, scale[..., 0]


def _q8_decode(q, scale, shape):
    shape = tuple(shape)
    n = shape[-1] if shape else 1
    blk = QBLOCK if n >= QBLOCK else max(n, 1)
    pad = (-n) % blk
    qp = F.pad(q, (0, pad))
    nblk = qp.shape[-1] // blk
    blocks = qp.reshape(*qp.shape[:-1], nblk, blk).float()
    out = (blocks * scale[..., None]).reshape(qp.shape)[..., :n]
    return out.reshape(shape)


class Q8(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


def adamw_init(params, int8_moments: bool = False):
    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if int8_moments and p.ndim >= 1 and p.shape[-1] >= 2:
            return Q8(*_q8_encode(z))
        return z
    leaf = next(iter(tree_leaves(params)))
    return {"mu": tree_zip_map(zeros_like_moment, params),
            "nu": tree_zip_map(zeros_like_moment, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before scaling, an f32 scalar)."""
    gn = torch.sqrt(sum(torch.sum(g.float().square()) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_zip_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """Returns (new_params, new_opt_state). Master math in f32."""
    count = opt_state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, mu, nu):
        g = g.float()
        int8 = isinstance(mu, Q8)
        mu_f = _q8_decode(mu.q, mu.scale, p.shape) if int8 else mu
        nu_f = _q8_decode(nu.q, nu.scale, p.shape) if int8 else nu
        mu_f = b1 * mu_f + (1 - b1) * g
        nu_f = b2 * nu_f + (1 - b2) * torch.square(g)
        step = (mu_f / c1) / (torch.sqrt(nu_f / c2) + eps)
        step = step + weight_decay * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        if int8:
            return p_new, Q8(*_q8_encode(mu_f)), Q8(*_q8_encode(nu_f))
        return p_new, mu_f, nu_f

    out = tree_zip_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    pick = lambda i: tree_zip_map(lambda o: o[i], out)
    return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}
