"""Roofline terms of a traced step on one card.

  compute term    = FLOPs / peak FLOP/s (bf16, the spec's matrix rate)
  memory term     = bytes / HBM bandwidth
  collective term = 0: the port runs on one card

The counterpart of the reference's ``launch/roofline.py``: the same
``Roofline`` fields, properties and ``row()``, with the hardware an
argument (default: ``H100_SXM``).  FLOPs, bytes and peak live bytes come
from ``launch/costs.py::traced_costs`` (the reference's loop-aware walk
and ``memory_analysis()``); there is no partitioned program, so no
collective parse.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.common.hw import H100_SXM, HardwareSpec


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, int]
    peak_mem_per_dev: float
    model_flops: float = 0.0
    hw: HardwareSpec = field(default=H100_SXM)

    @property
    def t_compute(self):
        return self.flops_per_dev / self.hw.peak_flops_bf16

    @property
    def t_memory(self):
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def t_collective(self):
        return self.coll_bytes_per_dev / self.hw.ici_bw_per_link

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self):
        total = self.flops_per_dev * self.n_devices
        return self.model_flops / total if total else 0.0

    def row(self):
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            n_devices=self.n_devices,
            t_compute_s=self.t_compute, t_memory_s=self.t_memory,
            t_collective_s=self.t_collective, bottleneck=self.bottleneck,
            flops_per_dev=self.flops_per_dev, bytes_per_dev=self.bytes_per_dev,
            coll_bytes_per_dev=self.coll_bytes_per_dev,
            peak_mem_GiB=self.peak_mem_per_dev / 2**30,
            model_flops=self.model_flops,
            useful_ratio=self.useful_flops_ratio,
            coll_breakdown=self.coll_breakdown,
        )


def _named_leaves(tree, prefix=""):
    """(path "a/b/c", leaf) of a nested dict of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def model_flops_estimate(cfg, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N_active·D per forward token (dense
    counting; attention excluded by convention)."""
    import torch

    from repro_torch.common.tree import tree_count
    from repro_torch.launch.costs import fake_mode
    from repro_torch.launch.steps import SHAPES
    from repro_torch.models.registry import get_model

    model = get_model(cfg.name)
    with fake_mode():
        params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                            device="cpu")
    n_params = tree_count(params)
    if cfg.is_moe:
        # active = non-expert + top_k/n_experts of expert params
        expert = sum(x.numel() for k, x in _named_leaves(params)
                     if "/moe/" in k and "router" not in k)
        n_active = n_params - expert + expert * cfg.top_k / cfg.n_experts
    else:
        n_active = n_params
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        tokens = sh["batch"] * sh["seq"]
        return 6.0 * n_active * tokens
    if sh["kind"] == "prefill":
        return 2.0 * n_active * sh["batch"] * sh["seq"]
    if sh["kind"] == "decode":
        return 2.0 * n_active * sh["batch"]          # one token per seq
    if sh["kind"] == "mixed":
        toks = sh["streams"] * sh["chunk"] + sh["batch"]
        return 2.0 * n_active * toks
    return 0.0


def analyze(cell, *, arch, shape, hw: HardwareSpec = H100_SXM) -> Roofline:
    """Roofline terms of a ``launch/steps.py`` cell on one card of ``hw``:
    FLOPs, bytes and peak live bytes from ``traced_costs`` over the
    cell's fake arguments (nothing is allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.costs import traced_costs
    c = traced_costs(cell["fn"], *cell["args"])
    return Roofline(
        arch=arch, shape=shape, mesh="h100", n_devices=1,
        flops_per_dev=c["flops"], bytes_per_dev=c["bytes"],
        coll_bytes_per_dev=0.0, coll_breakdown={},
        peak_mem_per_dev=c["peak_bytes"],
        model_flops=model_flops_estimate(get_config(arch), shape), hw=hw,
    )
