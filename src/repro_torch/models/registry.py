"""Model registry: maps an architecture to its module.

The port serves the transformer family, dense, MoE and VLM, with paged
KV (``cache_kind="paged"``), and the zamba2 hybrid (``"paged+state"``:
paged KV for the shared attention plus conv/SSM states; served at model
level through ``hybrid.prefill``/``decode``, as the reference's engine
refuses it too).  The reference registry's encdec and ssm (rwkv6)
families come with later slices.
"""
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.models import hybrid, transformer

FAMILY_MODULE = {"dense": transformer, "moe": transformer, "vlm": transformer,
                 "hybrid": hybrid}
CACHE_KIND = {"dense": "paged", "moe": "paged", "vlm": "paged",
              "hybrid": "paged+state"}


@dataclass(frozen=True)
class Model:
    name: str
    cfg: Any
    module: Any
    cache_kind: str

    def init(self, generator: torch.Generator, dtype=None, device=None):
        return self.module.init_params(self.cfg, generator,
                                       dtype or torch.float32, device)


def get_model(arch: str, cfg=None) -> Model:
    cfg = cfg if cfg is not None else get_config(arch)
    if cfg.family not in FAMILY_MODULE:
        raise NotImplementedError(
            f"{arch}: family {cfg.family!r} is not ported yet; the port "
            f"serves {sorted(FAMILY_MODULE)}")
    return Model(name=arch, cfg=cfg, module=FAMILY_MODULE[cfg.family],
                 cache_kind=CACHE_KIND[cfg.family])
