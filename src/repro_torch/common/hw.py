"""Target-hardware constants used by the roofline analysis.

A copy of the reference's ``common/hw.py`` (``HardwareSpec``,
``TPU_V5E``) with the port's own card beside it: ``H100_SXM``, from
NVIDIA's data sheet (SXM part, dense rates without sparsity, at the full
700 W power limit).  On the H100 the ``ici_*`` fields describe NVLink 4.
"""
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float   # FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw_per_link: float   # bytes/s per link (one direction)
    ici_links: int           # links per chip in the 2D torus
    hbm_bytes: int           # HBM capacity per chip
    vmem_bytes: int          # VMEM per core
    peak_flops_f32: Optional[float] = None   # FLOP/s per chip outside matrix units
    peak_flops_tf32: Optional[float] = None  # FLOP/s per chip, TF32 on the matrix units


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
    ici_links=4,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
)

H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,      # dense, tensor cores
    hbm_bw=3.35e12,
    ici_bw_per_link=25e9,        # NVLink 4: 25 GB/s per link each way
    ici_links=18,
    hbm_bytes=80 * 10**9,
    vmem_bytes=228 * 2**10,      # shared memory per SM
    peak_flops_f32=67e12,        # CUDA cores (no tensor cores)
    peak_flops_tf32=494.7e12,    # dense, tensor cores
)
