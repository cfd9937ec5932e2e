"""Parameter bridge from the reference package.

``params_from_jax`` takes the reference's parameter pytree (a nested dict
of arrays, converted to numpy by the caller, e.g. with
``jax.tree.map(np.asarray, params)``) and returns the port's parameter
dict: the same names, shapes and layouts, as torch tensors.  The tests
hand both packages the same weights this way.
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
