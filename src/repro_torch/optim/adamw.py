"""AdamW on nested dicts of tensors, a counterpart of the reference's
``optim/adamw.py``, with optional int8 block-quantized moments.

Master math is f32 whatever the parameters' dtype.  Int8 moments are
:class:`Q8` pairs with the reference's encoding: codes shaped like the
parameter (int8), one f32 scale per block of ``QBLOCK`` along the last
axis (a last axis shorter than ``QBLOCK`` is one block), codes rounded
half to even (``torch.round``, as ``jnp.round``).  Parameters whose last
axis is shorter than 2 (and scalars) keep f32 moments.

**On a mesh** (``specs``: the parameters' placements, ``policy``:
``models/sharding.py``) every rank holds its parameters' local shards and
updates them elementwise.  ``clip_by_global_norm`` sums each element's
square once over the mesh: a leaf's local sum over the axes it is
sharded on, a replicated leaf's once.  Int8 moments keep the global
encoding: a rank's codes are its parameter's shard, and where its last
axis is split over an axis so that a shard boundary cuts a block (a shard
shorter than a block, or not a whole number of blocks: grok-1-314b's D =
6144 over 16 data ranks is 384 a shard), each block's scale is the
maximum over the ranks that share it (an ``all_reduce`` max over that
axis) and every rank of it holds all the blocks' scales ``[..., nblk]``;
where shards hold whole blocks the rank's blocks are its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common.tree import tree_leaves, tree_zip_map
from repro_torch.models.sharding import all_reduce, placed_axes

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


class _Split(NamedTuple):
    """A last axis split over mesh axis ``axis`` (``n`` shards): this
    rank's first element ``offset`` of ``length`` (the global size), and
    the block size ``blk``; ``cut`` when a shard boundary cuts a block."""
    axis: object
    offset: int
    length: int
    blk: int
    cut: bool


def _last_split(shape, spec, policy):
    """The :class:`_Split` of a local shard's last axis, or None when it is
    whole (no policy, no placement, or not placed)."""
    if policy is None or spec is None or not shape or spec[len(shape) - 1] is None:
        return None
    axis, n_loc = spec[len(shape) - 1], shape[-1]
    length = n_loc * policy.size(axis)
    blk = QBLOCK if length >= QBLOCK else length
    return _Split(axis, policy.index(axis) * n_loc, length, blk, n_loc % blk != 0)


def _q8_encode_split(x, sp, policy):
    """x's local shard [..., n_loc] -> (its codes, the scales of every
    global block [..., nblk]): each block's max |x| over the ranks of
    ``sp.axis`` (zeros outside a rank's elements do not move a max)."""
    bid = (sp.offset + torch.arange(x.shape[-1], device=x.device)) // sp.blk
    nblk = -(-sp.length // sp.blk)
    amax = torch.zeros(x.shape[:-1] + (nblk,), dtype=torch.float32, device=x.device)
    amax = amax.scatter_reduce(-1, bid.expand(x.shape), x.abs(), "amax")
    scale = all_reduce(amax, policy, sp.axis, op="max") / 127.0
    q = torch.round(x / torch.clamp(scale[..., bid], min=1e-20)).to(torch.int8)
    return q, scale


def _q8_decode_split(q, scale, sp):
    bid = (sp.offset + torch.arange(q.shape[-1], device=q.device)) // sp.blk
    return q.float() * scale[..., bid]


def _encode(x, sp, policy):
    return Q8(*(_q8_encode_split(x, sp, policy) if sp is not None and sp.cut
                else _q8_encode(x)))


def _decode(m, shape, sp):
    return (_q8_decode_split(m.q, m.scale, sp) if sp is not None and sp.cut
            else _q8_decode(m.q, m.scale, shape))


def _specs_like(params, specs):
    """``specs`` zipped leaf for leaf with ``params`` (None leaves without)."""
    return specs if specs is not None else tree_zip_map(lambda p: None, params)


def adamw_init(params, int8_moments: bool = False, specs=None, policy=None):
    """Zero moments for ``params`` (a rank's shards on a mesh, placed by
    ``specs``); the int8 condition reads the global last axis."""
    def zeros_like_moment(p, spec):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        sp = _last_split(tuple(p.shape), spec, policy)
        n = sp.length if sp is not None else (p.shape[-1] if p.ndim else 0)
        if not (int8_moments and p.ndim >= 1 and n >= 2):
            return z
        if sp is not None and sp.cut:           # every global block's scale
            return Q8(z.to(torch.int8), z.new_zeros(p.shape[:-1] + (-(-n // sp.blk),)))
        return Q8(*_q8_encode(z))
    specs = _specs_like(params, specs)
    leaf = next(iter(tree_leaves(params)))
    return {"mu": tree_zip_map(zeros_like_moment, params, specs),
            "nu": tree_zip_map(zeros_like_moment, params, specs),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def opt_specs(opt, specs, policy):
    """The placements of ``adamw_init``'s state (the reference's
    ``_opt_specs``): a moment is its parameter's local shard, so it takes
    the parameter's placement ``specs``; an int8 moment's codes too, and
    its scales too but with their block dim whole where a shard boundary
    cuts a block (every global block's scale on each rank of the axis).
    ``count`` is replicated.  The reference keeps a placed dim only where
    it divides by 16, the production axis size, and GSPMD reshards the
    rest; here the rule is the mesh's own."""
    def moment(m, spec):
        if not isinstance(m, Q8):
            return spec
        sp = _last_split(tuple(m.q.shape), spec, policy)
        return Q8(spec, spec[:-1] + (None,) if sp is not None and sp.cut else spec)
    return {"mu": tree_zip_map(moment, opt["mu"], specs),
            "nu": tree_zip_map(moment, opt["nu"], specs), "count": ()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, specs=None, policy=None):
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before scaling, an f32 scalar).  On a mesh (``specs``,
    ``policy``) the grads are the rank's shards: the local sums of
    squares of the leaves sharded on each set of axes are summed over
    those axes."""
    if policy is None:
        gn = torch.sqrt(sum(torch.sum(g.float().square()) for g in tree_leaves(grads)))
    else:
        groups = {}

        def add(g, spec):
            names = placed_axes(spec)
            axes = tuple(a for a in policy.mesh.mesh_dim_names if a in names)
            groups[axes] = groups.get(axes, 0.0) + torch.sum(g.float().square())
        tree_zip_map(add, grads, specs)
        gn = torch.sqrt(sum(all_reduce(v, policy, axes) if axes else v
                            for axes, v in groups.items()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_zip_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, specs=None, policy=None):
    """Returns (new_params, new_opt_state). Master math in f32.  On a mesh
    the rank's shards, int8 moments encoded as the global arrays' are."""
    count = opt_state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, mu, nu, spec):
        g = g.float()
        int8 = isinstance(mu, Q8)
        sp = _last_split(tuple(p.shape), spec, policy) if int8 else None
        mu_f = _decode(mu, p.shape, sp) if int8 else mu
        nu_f = _decode(nu, p.shape, sp) if int8 else nu
        mu_f = b1 * mu_f + (1 - b1) * g
        nu_f = b2 * nu_f + (1 - b2) * torch.square(g)
        step = (mu_f / c1) / (torch.sqrt(nu_f / c2) + eps)
        step = step + weight_decay * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        if int8:
            return p_new, _encode(mu_f, sp, policy), _encode(nu_f, sp, policy)
        return p_new, mu_f, nu_f

    out = tree_zip_map(upd, params, grads, opt_state["mu"], opt_state["nu"],
                       _specs_like(params, specs))
    pick = lambda i: tree_zip_map(lambda o: o[i], out)
    return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}
