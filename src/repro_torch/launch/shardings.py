"""Placements of every parameter tensor, per architecture, and this
rank's slices of them.

The counterpart of the reference's ``launch/shardings.py``.  Rules are
path+shape driven and cover all six families, leaf for leaf the
reference's.  Two profiles:
  * train: TP over `model`, FSDP (ZeRO) over the data axis for the second
    weight dim + optimizer state.
  * serve: TP over `model`; FSDP only for archs whose weights exceed
    per-chip HBM at TP=16 (grok-1) — ZeRO-3-style per-layer gather.
Axes that don't divide a dim are dropped (with the padding layouts in the
models, this only happens for genuinely tiny tensors).

A placement is a tuple with one entry per dim: ``None`` (replicated), a
mesh axis name or a tuple of them (the reference's ``PartitionSpec``
entries).  ``shard_params`` cuts a full tree, in the reference's tp-padded
layout (``init_params(..., tp=k)``, or ``models/convert.py::
params_from_jax`` of the reference's ``tp=k`` tree), into this rank's
contiguous slices: the port's local-shard weights.
"""
from __future__ import annotations

import torch


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _map(fn, tree, path=()):
    return {k: (_map(fn, v, path + (str(k),)) if isinstance(v, dict)
                else fn(path + (str(k),), v)) for k, v in tree.items()}


def param_pspecs(shapes_tree, cfg, *, tp: int, fsdp_size: int = 1,
                 model="model", fsdp=None):
    """Nested dict of placements matching the params tree (leaves need
    only ``.shape``)."""
    M = model if tp > 1 else None      # tp=1: pure-FSDP scheme, no TP axes
    F = fsdp if (fsdp and fsdp_size > 1) else None

    def spec_for(parts, leaf):
        name = parts[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        s: list = [None] * nd
        in_tmix = "tmix" in parts
        in_cmix = "cmix" in parts
        in_moe = "moe" in parts

        if name in ("embed", "head"):
            s = [M, F]
        elif in_tmix:
            if name in ("wr", "wk", "wv", "wg"):
                s[-2], s[-1] = F, M
            elif name == "wo":
                s[-2], s[-1] = M, F
            elif name == "u":
                s[-2] = M
            elif name in ("ln_x", "w0", "w_b"):
                s[-1] = M
            elif name == "w_a":
                s[-2] = F
        elif in_cmix:
            if name == "wk":
                s[-2], s[-1] = F, M
            elif name == "wv":
                s[-2], s[-1] = M, F
            elif name == "wr":
                s[-2] = F
        elif in_moe:
            E = shape[1] if nd == 4 else 0
            if name == "router":
                s[-2] = F
            elif name in ("w_gate", "w_up"):
                if E % tp == 0:
                    s[1], s[2] = M, F          # EP: experts over model
                else:
                    s[2], s[3] = F, M          # expert-TP: d_ff over model
            elif name == "w_down":
                if E % tp == 0:
                    s[1], s[3] = M, F
                else:
                    s[2], s[3] = M, F
        elif name == "wq":                     # [.., D, H_p, hd]
            s[-2], s[-3] = M, F
        elif name in ("wk", "wv"):             # [.., D, KV, hd]
            if shape[-2] % tp == 0:
                s[-2] = M
            s[-3] = F
        elif name == "wo":                     # [.., H_p, hd, D]
            s[-3], s[-1] = M, F
        elif name in ("w_gate", "w_up", "w_in"):   # [.., D, F]
            s[-2], s[-1] = F, M
        elif name in ("w_down", "w_out"):      # [.., F, D]
            s[-2], s[-1] = M, F
        elif name in ("wz", "wx"):             # mamba [., D, d_in]
            s[-2], s[-1] = F, M
        elif name in ("wB", "wC", "wdt"):
            s[-2] = F
        elif name == "out_proj":               # mamba [., d_in, D]
            s[-2], s[-1] = M, F
        elif name in ("conv_x", "conv_b_x", "norm",
                      "qb", "kb", "vb"):       # + zamba lora [13, r, H*hd]
            s[-1] = M
        elif name in ("qa", "ka", "va"):       # [13, 2D, r]
            s[-2] = F
        # everything else (norm scales, mixes, small biases) replicated

        # drop axes that don't divide
        for i, ax in enumerate(s):
            if ax is None:
                continue
            size = tp if ax == M else fsdp_size
            if shape[i] % size != 0:
                s[i] = None
        return tuple(s)

    return _map(spec_for, shapes_tree)


def flat_f_pspecs(param_specs, flat):
    """The decode ``2d`` scheme's placements (the reference's
    ``build_decode._2d_overrides``): every MoE expert weight's d_ff dim
    over the ``flat`` axes (data and model), ``w_gate``/``w_up``'s last
    dim and ``w_down``'s third, the rest of each left whole; every other
    leaf as ``param_specs`` places it.  Nothing big sits on a contraction
    dim, so no weight is ever gathered."""
    def fix(parts, spec):
        if "moe" in parts and parts[-1] in ("w_gate", "w_up"):
            return (None, None, None, flat)
        if "moe" in parts and parts[-1] == "w_down":
            return (None, None, flat, None)
        return spec
    return _map(fix, param_specs)


def opt_pspecs(param_specs):
    """Optimizer state specs: moments mirror params; count replicated."""
    return {"mu": param_specs, "nu": param_specs, "count": ()}


def local_shape(shape, spec, policy, name="tensor"):
    """This rank's block of a global ``shape`` under placement ``spec``
    (dims past the spec's entries whole)."""
    out = list(shape)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = policy.size(ax)
        if shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does not divide "
                             f"over {ax!r} ({n})")
        out[dim] = shape[dim] // n
    return tuple(out)


def shard_tensor(t, spec, policy, name="tensor"):
    """This rank's contiguous block of the full tensor ``t`` under
    placement ``spec``, copied; ``t`` itself without a policy."""
    if policy is None:
        return t
    local = local_shape(t.shape, spec, policy, name)
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = t.narrow(dim, policy.index(ax) * local[dim], local[dim])
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params, specs, policy):
    """This rank's slice of every leaf of ``params`` (full tensors) under
    ``specs``: along each placed dim, the ``policy``'s rank's contiguous
    block, copied so the full tensor can be freed.  Without a policy the
    tree is returned as it is."""
    if policy is None:
        return params
    flat = dict(_leaves(specs))
    return _map(lambda parts, t: shard_tensor(t, flat[parts], policy, "/".join(parts)),
                params)
