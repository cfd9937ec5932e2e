"""Model registry: maps each architecture family to its module.

Families expose ``init_params``, ``train_logits``, ``prefill`` and
``decode`` (+ ``mixed`` for the transformer family and rwkv6).  ``cache_kind`` says what a family's serving path keeps:
  paged        — transformer (dense/moe/vlm): paged KV
  paged+cross  — encdec: paged self-KV + dense cross-KV
  paged+state  — hybrid: paged KV (shared attn) + SSM/conv states
  state        — ssm (rwkv6): recurrent state slots only
The ``Engine`` serves ``paged`` only, as the reference's does; the other
three are served at model level through their modules' steps.
"""
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.models import encdec, hybrid, rwkv, transformer

FAMILY_MODULE = {"dense": transformer, "moe": transformer, "vlm": transformer,
                 "encdec": encdec, "hybrid": hybrid, "ssm": rwkv}
CACHE_KIND = {"dense": "paged", "moe": "paged", "vlm": "paged",
              "encdec": "paged+cross", "hybrid": "paged+state", "ssm": "state"}


@dataclass(frozen=True)
class Model:
    name: str
    cfg: Any
    module: Any
    cache_kind: str

    def init(self, generator: torch.Generator, dtype=None, device=None, **kw):
        """The family's ``init_params``; ``kw`` (``tp``, which pads every
        family's heads for a mesh, unused by rwkv6) is passed on."""
        return self.module.init_params(self.cfg, generator,
                                       dtype or torch.float32, device, **kw)

    def train_logits(self, params, batch, **kw):
        return self.module.train_logits(params, self.cfg, batch, **kw)


def get_model(arch: str, cfg=None) -> Model:
    cfg = cfg if cfg is not None else get_config(arch)
    return Model(name=arch, cfg=cfg, module=FAMILY_MODULE[cfg.family],
                 cache_kind=CACHE_KIND[cfg.family])
