"""Logical-axis sharding policy and the collectives of the mesh path.

The counterpart of the reference's ``models/sharding.py``.  The
reference annotates activations with logical axis names and GSPMD
places them (``constrain``) and inserts the collectives.  The port runs
in the local-shard idiom instead, in Megatron's manner: each rank of a
``("data", "model")`` mesh (``launch/mesh.py``) holds its slice of every
weight (``launch/shardings.py::shard_params``) and its own page pool,
the model code works on those local slices, and nothing moves between
ranks except through the explicit collectives below, each called through
the policy's process group.  So ``constrain`` has no counterpart.

``policy=None`` is the one-card path: every collective is then the
identity, and model code never depends on a mesh.  With a policy, the
collectives run even over an axis of size 1 (one rank over NCCL checks
the backend), and ``counts`` tallies each kind and its bytes.

The tensor-parallel axis is the one the rules give ``heads`` ("model"
under ``make_rules``; none in the training ``fsdp`` scheme, which puts
the batch over every axis): ``all_reduce`` and ``all_gather`` default
to it and are identities where the policy has none.

**Training** (``models/transformer.py::train_hidden``, the losses, the
optimizer) differentiates through the collectives, so the forward-only
ones above get autograd-aware forms, Megatron's pair plus ZeRO's gather:

- ``copy_to``: identity forward, ``all_reduce`` of the gradient
  backward, at the input of every column-parallel product (q/k/v,
  gate/up, the MoE, the vocab-parallel table) and on a weight that is
  replicated over the tensor-parallel axis but used on the rank's heads
  (qk-norm scales, k/v of fewer KV heads than ``tp``, the router);
- ``reduce_from``: ``all_reduce`` forward, identity backward, after every
  row-parallel product (o, down, the embedding rows);
- ``fsdp_gather``: ``all_gather`` of a weight's data-placed dim forward
  (ZeRO-3), a sum ``reduce_scatter`` of its gradient backward;
- ``grad_mean``: identity forward, the gradient over an axis' size
  backward, for a value every rank of the axis counts in its loss;
- ``sync_grads``: the data-parallel sum of every gradient leaf whose
  placement does not cover the batch axes (the others were summed by
  their gather's reduce-scatter).

The policy's ``params`` are the placements of the parameter tree
(``launch/shardings.py::param_pspecs``), which FSDP'd weights need:
``gather_weights`` gathers a weight on each dim placed on an axis other
than the tensor-parallel one, just before it is used.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models import layers

Axis = Union[None, str, Tuple[str, ...]]

# collectives issued in this process: "<kind>" calls and "<kind>_bytes"
counts: Counter = Counter()


@dataclass(frozen=True)
class Policy:
    """logical name -> mesh axis (or tuple of axes), plus this rank's place
    on the mesh: ``coords`` (axis -> this rank's index along it),
    ``sizes`` (axis -> size) and ``groups`` (axis -> process group), all
    read from ``mesh`` (a ``DeviceMesh``; empty without one).  ``params``:
    the placements of the parameter tree, where weights are FSDP'd or the
    optimizer needs them (None: every placed dim is tensor parallel)."""
    rules: dict = field(default_factory=dict)
    mesh: Optional[object] = None
    params: Optional[dict] = None
    coords: dict = field(default_factory=dict, init=False)
    sizes: dict = field(default_factory=dict, init=False)
    groups: dict = field(default_factory=dict, init=False)

    def __post_init__(self):
        if self.mesh is None:
            return
        names = self.mesh.mesh_dim_names
        object.__setattr__(self, "coords",
                           {a: self.mesh.get_local_rank(a) for a in names})
        object.__setattr__(self, "sizes", {a: self.mesh.size(i) for i, a in enumerate(names)})
        object.__setattr__(self, "groups", {a: self.mesh.get_group(a) for a in names})

    def spec(self, *names: Optional[str]) -> tuple:
        return tuple(self.rules.get(n) if n else None for n in names)

    @property
    def tp_axis(self) -> Optional[str]:
        """The tensor-parallel axis (the rules' ``heads``), or None."""
        return self.rules.get("heads")

    @property
    def tp(self) -> int:
        return self.size(self.tp_axis) if self.tp_axis else 1

    @property
    def tp_index(self) -> int:
        return self.index(self.tp_axis) if self.tp_axis else 0

    @property
    def batch_axis(self) -> Axis:
        """The axis (or axes) batch rows are split over."""
        return self.rules.get("batch")

    def size(self, axis: Axis) -> int:
        """Ranks along ``axis`` (a tuple: their product)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        n = 1
        for a in axes:
            n *= self.sizes.get(a, 1)
        return n

    def index(self, axis: Axis) -> int:
        """This rank's index along ``axis`` (a tuple: row-major over it)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axis: Axis):
        """The process group of ``axis``; a tuple of every mesh axis in the
        mesh's order is the whole mesh (``make_mesh`` spans the world, rank
        ``index(axes)``)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes != tuple(self.mesh.mesh_dim_names) or dist.get_world_size() != self.size(axes):
            raise ValueError(f"no process group over {axes}: a tuple of axes must be "
                             f"every axis of the mesh {self.mesh.mesh_dim_names} in order")
        return dist.group.WORLD


# Standard rules for the production mesh. "batch"-like dims shard over the
# data axis (and pod in the multi-pod mesh); "heads"/"ff"/"vocab"/"experts"
# shard over the model (tensor) axis; "fsdp" optionally shards a weight dim
# over data for ZeRO-style training.
def make_rules(data_axes=("data",), model_axis="model", fsdp: bool = False):
    return {
        "batch": data_axes if len(data_axes) > 1 else data_axes[0],
        "tokens": data_axes if len(data_axes) > 1 else data_axes[0],  # token-slot dim
        "pages": data_axes if len(data_axes) > 1 else data_axes[0],
        "heads": model_axis,
        "kv_heads": model_axis,
        "ff": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "embed": None,
        "fsdp": (data_axes if len(data_axes) > 1 else data_axes[0]) if fsdp else None,
        "seq": None,
    }


def _axes(axis: Axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def placed_axes(spec) -> set:
    """The mesh axes a placement ``spec`` shards along."""
    return {a for entry in spec if entry for a in _axes(entry)}


def _tp(policy, axis):
    """The axis a collective runs over: ``axis``, or the policy's
    tensor-parallel axis when None; None (the collective is the identity)
    without a policy."""
    if policy is None:
        return None
    return policy.tp_axis if axis is None else axis


def _count(kind, t, n=1):
    counts[kind] += 1
    counts[f"{kind}_bytes"] += t.numel() * t.element_size() * n


def all_reduce(x, policy: Optional[Policy], axis: Axis = None, op: str = "sum"):
    """Sum (``op="max"``: maximum) of ``x`` over ``axis`` (default: the
    tensor-parallel axis), in place (``x`` must be a tensor this rank
    owns); the identity without a policy or an axis."""
    if (axis := _tp(policy, axis)) is None:
        return x
    _count("all_reduce", x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=policy.group(axis))
    return x


def rms_norm(x, w, eps, policy: Optional[Policy]):
    """``layers.rms_norm`` over a last dim sharded over `model` (each rank
    holds its ``x`` and ``w`` columns): the mean of squares adds the
    ranks' partial sums, one ``all_reduce`` of a ``[..., 1]`` tensor.
    Under grad that sum is differentiable: every rank's columns read the
    total, so its gradient is the sum of the ranks' gradients too
    (``reduce_from`` then ``copy_to``: an ``all_reduce`` each way).
    Without a policy it is ``layers.rms_norm`` itself."""
    if policy is None:
        return layers.rms_norm(x, w, eps)
    xf = x.float()
    ss = copy_to(reduce_from(xf.square().sum(-1, keepdim=True), policy), policy)
    y = xf * torch.rsqrt(ss / (x.shape[-1] * policy.tp) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def all_gather(x, policy: Optional[Policy], axis: Axis = None, dim: int = -1):
    """The ranks' ``x`` along ``axis`` (default: the tensor-parallel
    axis), concatenated on ``dim`` in rank order; the identity without a
    policy or an axis."""
    if (axis := _tp(policy, axis)) is None:
        return x
    x = x.contiguous()
    _count("all_gather", x, policy.size(axis))
    parts = [torch.empty_like(x) for _ in range(policy.size(axis))]
    dist.all_gather(parts, x, group=policy.group(axis))
    return torch.cat(parts, dim=dim)


def reduce_scatter(x, policy: Policy, axis: Axis, dim: int):
    """The sum of the ranks' ``x`` over ``axis``, this rank's block of it
    along ``dim`` (block ``index(axis)`` of ``size(axis)``); counted with
    its input's bytes.  NCCL and gloo (CPU and CUDA tensors) both take
    ``reduce_scatter_tensor``."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // policy.size(axis),) + xt.shape[1:], dtype=xt.dtype,
                      device=xt.device)
    _count("reduce_scatter", xt)
    dist.reduce_scatter_tensor(out, xt, group=policy.group(axis))
    return out.movedim(0, dim)


# ------------------------------------------- collectives with gradients ---
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, policy, axis):
        ctx.policy, ctx.axis = policy, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the same gradient tensor can feed several branches: reduce a copy
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.policy,
                          ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, policy, axis):
        ctx.mark_dirty(x)
        return all_reduce(x, policy, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, policy, axis, dim):
        ctx.policy, ctx.axis, ctx.dim, ctx.k = policy, axis, dim, x.shape[dim]
        return all_gather(x, policy, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the whole gathered tensor alike
        return g.narrow(ctx.dim, ctx.policy.index(ctx.axis) * ctx.k, ctx.k), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, policy, axis, dim):
        ctx.policy, ctx.axis, ctx.dim = policy, axis, dim
        return all_gather(w, policy, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.policy, ctx.axis, ctx.dim), None, None, None


class _GradMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def copy_to(x, policy: Optional[Policy], axis: Axis = None):
    """``x`` as the input of a column-parallel product over ``axis``
    (default: tensor parallel): identity forward, ``all_reduce`` of its
    gradient backward.  Free without grad."""
    axis = _tp(policy, axis)
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, policy, axis)


def reduce_from(x, policy: Optional[Policy], axis: Axis = None):
    """The sum over ``axis`` (default: tensor parallel) of a row-parallel
    product's partial ``x``, in place: ``all_reduce`` forward, identity
    backward (without grad, ``all_reduce`` itself)."""
    axis = _tp(policy, axis)
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce(x, policy, axis)
    return _ReduceFrom.apply(x, policy, axis)


def gather_from(x, policy: Optional[Policy], axis: Axis = None, dim: int = -1):
    """``all_gather`` of ``x`` along ``dim``; backward, this rank's block of
    the gradient (every rank reads the gathered tensor alike)."""
    axis = _tp(policy, axis)
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return all_gather(x, policy, axis, dim)
    return _GatherFrom.apply(x, policy, axis, dim)


def fsdp_gather(w, policy: Optional[Policy], axis: Axis, dim: int):
    """The whole of weight ``w`` along ``dim`` from its FSDP shards over
    ``axis`` (ZeRO-3): ``all_gather`` forward, a sum ``reduce_scatter``
    of its gradient backward, so the shard's gradient is summed over
    ``axis`` as it leaves."""
    if policy is None:
        return w
    if not (torch.is_grad_enabled() and w.requires_grad):
        return all_gather(w, policy, axis, dim)
    return _FsdpGather.apply(w, policy, axis, dim)


def grad_mean(x, policy: Optional[Policy], axis: Axis):
    """``x`` forward; backward its gradient over ``size(axis)``: for a
    value that every rank of ``axis`` adds to its loss (equal on them, or
    each rank's own, the MoE's aux loss), so that the sum of the ranks'
    gradients is that of their mean."""
    if policy is None or axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradMean.apply(x, policy.size(axis))


def copy_weights(lp: dict, names, policy: Optional[Policy]):
    """``lp`` with each weight of ``names`` through ``copy_to``: weights
    replicated over the tensor-parallel axis that a rank uses on its own
    heads or columns alone, so that their gradients sum over it.  ``lp``
    as it is without grad or a tensor-parallel axis."""
    if _tp(policy, None) is None or not torch.is_grad_enabled():
        return lp
    return {k: copy_to(v, policy) if k in names else v for k, v in lp.items()}


# ------------------------------------------------------ FSDP'd weights ---
def _fsdp_dims(spec, policy):
    """[(dim, axis)] of a placement's entries off the tensor-parallel axis."""
    return [(d, ax) for d, ax in enumerate(spec) if ax is not None and ax != policy.tp_axis]


def gather_weight(w, spec, policy: Optional[Policy]):
    """``w`` with each dim its placement ``spec`` puts off the tensor-
    parallel axis gathered (``fsdp_gather``); ``w`` itself when none is."""
    if policy is None or spec is None:
        return w
    for dim, ax in _fsdp_dims(spec, policy):
        w = fsdp_gather(w, policy, ax, dim)
    return w


def layer_specs(policy: Optional[Policy], key: str = "blocks", stacked: bool = True):
    """The placements of one layer's weights: those of the stacked tree
    ``key`` of the parameters (``blocks``; the hybrid's ``mamba`` and
    ``lora``, the encoder-decoder's ``enc_blocks`` and ``dec_blocks``)
    with the layer dim dropped, or of the unstacked ``key`` as they are
    (``stacked=False``: the hybrid's ``shared`` block); None where no
    weight of a layer is FSDP'd."""
    if policy is None or policy.params is None or key not in policy.params:
        return None

    def drop(tree):
        return {k: drop(v) if isinstance(v, dict) else tuple(v[1:] if stacked else v)
                for k, v in tree.items()}

    specs = drop(policy.params[key])

    def any_fsdp(tree):
        return any(any_fsdp(v) if isinstance(v, dict) else _fsdp_dims(v, policy)
                   for v in tree.values())
    return specs if any_fsdp(specs) else None


def gather_weights(tree, specs, policy: Optional[Policy]):
    """``tree`` (one layer's weights) with every FSDP'd leaf gathered, leaf
    by leaf in the tree's order (the MoE's experts too, before its hook
    runs)."""
    if specs is None:
        return tree
    return {k: (gather_weights(v, specs.get(k), policy) if isinstance(v, dict)
                else gather_weight(v, specs.get(k), policy))
            for k, v in tree.items()}


def sync_grads(grads, policy: Optional[Policy]):
    """The data-parallel sum, in place, of every gradient leaf whose
    placement (``policy.params``) does not cover the batch axes: an
    ``all_reduce`` over them each (the others left their gathers summed
    over the batch axes already).  ``grads`` as it is without a policy."""
    if policy is None:
        return grads
    batch = set(_axes(policy.batch_axis))
    specs = policy.params

    def walk(g, s):
        for k, v in g.items():
            sk = None if s is None else s[k]
            if isinstance(v, dict):
                walk(v, sk)
            elif sk is None or not batch <= placed_axes(sk):
                all_reduce(v, policy, policy.batch_axis)
    walk(grads, specs)
    return grads
