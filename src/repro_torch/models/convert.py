"""Parameter and training-state bridge from the reference package.

``params_from_jax`` takes the reference's parameter pytree (a nested dict
of arrays, converted to numpy by the caller, e.g. with
``jax.tree.map(np.asarray, params)``) and returns the port's parameter
dict: the same names, shapes and layouts, as torch tensors.  The tests
hand both packages the same weights this way.  ``train_state_from_jax``
does the same for a whole training state, optimizer moments included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree, device=None):
    device = resolve_device(device)
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(device))   # a writable copy
            for k, v in tree.items()}


def train_state_from_jax(state, device=None):
    """The reference's training state ``{"params", "opt": {"mu", "nu",
    "count"}}`` as numpy (int8 moments as ``Q8`` pairs, or as their
    ``{"q", "scale"}`` dicts, as a reference checkpoint loads them)
    -> the port's state, moments as :class:`repro_torch.optim.Q8`."""
    from repro_torch.optim.adamw import Q8
    device = resolve_device(device)

    def moments(node):
        if isinstance(node, dict) and set(node) != {"q", "scale"}:
            return {k: moments(v) for k, v in node.items()}
        if isinstance(node, dict) or hasattr(node, "scale"):
            q, s = (node["q"], node["scale"]) if isinstance(node, dict) else node
            return Q8(tensor(q), tensor(s))
        return tensor(node)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    opt = state["opt"]
    return {"params": params_from_jax(state["params"], device),
            "opt": {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
                    "count": tensor(opt["count"]).to(torch.int32)}}
