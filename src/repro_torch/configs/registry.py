"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port serves the transformer family (dense, MoE, VLM) and the zamba2
hybrid; later slices add the reference registry's other architectures
(seamless-m4t-medium, rwkv6-7b).
"""
from repro_torch.configs import (gemma2_2b, grok_1_314b, internvl2_2b,
                                 olmoe_1b_7b, opt_125m, phi4_mini_3_8b,
                                 qwen3_0_6b, starcoder2_3b, zamba2_7b)

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "phi4-mini-3.8b": phi4_mini_3_8b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "opt-125m": opt_125m.CONFIG,   # the paper's own model
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
