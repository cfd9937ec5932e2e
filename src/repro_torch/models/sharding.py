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
    read from ``mesh`` (a ``DeviceMesh``; empty without one)."""
    rules: dict = field(default_factory=dict)
    mesh: Optional[object] = None
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
    def tp(self) -> int:
        return self.sizes.get("model", 1)

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


def all_reduce(x, policy: Optional[Policy], axis: str = "model"):
    """Sum of ``x`` over ``axis``, in place (``x`` must be a tensor this
    rank owns); the identity without a policy."""
    if policy is None:
        return x
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, group=policy.groups[axis])
    return x


def rms_norm(x, w, eps, policy: Optional[Policy]):
    """``layers.rms_norm`` over a last dim sharded over `model` (each rank
    holds its ``x`` and ``w`` columns): the mean of squares adds the
    ranks' partial sums, one ``all_reduce`` of a ``[..., 1]`` tensor.
    Without a policy it is ``layers.rms_norm`` itself."""
    if policy is None:
        return layers.rms_norm(x, w, eps)
    xf = x.float()
    ss = all_reduce(xf.square().sum(-1, keepdim=True), policy)
    y = xf * torch.rsqrt(ss / (x.shape[-1] * policy.tp) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def all_gather(x, policy: Optional[Policy], axis: str = "model", dim: int = -1):
    """The ranks' ``x`` along ``axis``, concatenated on ``dim`` in rank
    order; the identity without a policy."""
    if policy is None:
        return x
    x = x.contiguous()
    counts["all_gather"] += 1
    counts["all_gather_bytes"] += x.numel() * x.element_size() * policy.size(axis)
    parts = [torch.empty_like(x) for _ in range(policy.size(axis))]
    dist.all_gather(parts, x, group=policy.groups[axis])
    return torch.cat(parts, dim=dim)
