"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Both packages get the same model configuration, the same weights (the
reference's JAX init, converted with ``params_from_jax``) and the same
requests; JAX stays on the CPU and the port runs with ``device="cpu"``.
Every helper takes the architecture (default: qwen3-0.6b, the arch of
the engine tests).
"""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.registry import CACHE_KIND, FAMILY_MODULE, Model
from repro_torch.configs.base import ModelConfig as PortModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as port_get_model

ARCH = "qwen3-0.6b"


def jax_model(cfg, arch=ARCH):
    return Model(arch, cfg, FAMILY_MODULE[cfg.family], CACHE_KIND[cfg.family])


def port_model(cfg, arch=ARCH):
    """The port's Model for the reference config ``cfg`` (same fields)."""
    return port_get_model(arch, PortModelConfig(**dataclasses.asdict(cfg)))


def reduced_cfg(arch=ARCH, **overrides):
    return dataclasses.replace(jax_get_config(arch).reduced(), **overrides)


def both_models(cfg, seed=0, arch=ARCH):
    """(jax_model, jax_params, port_model, port_params) on shared weights."""
    jm = jax_model(cfg, arch)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = port_model(cfg, arch)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp


@functools.lru_cache(maxsize=None)
def reduced_models(arch=ARCH):
    """``both_models`` on ``arch``'s reduced config, built once a process."""
    return both_models(reduced_cfg(arch), arch=arch)
