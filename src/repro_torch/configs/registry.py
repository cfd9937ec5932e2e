"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The reference registry's eleven architectures: the transformer family
(dense, MoE, VLM), the zamba2 hybrid, the rwkv6 state-space model and the
seamless-m4t encoder-decoder.
"""
from repro_torch.configs import (gemma2_2b, grok_1_314b, internvl2_2b,
                                 olmoe_1b_7b, opt_125m, phi4_mini_3_8b,
                                 qwen3_0_6b, rwkv6_7b, seamless_m4t_medium,
                                 starcoder2_3b, zamba2_7b)

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "gemma2-2b": gemma2_2b.CONFIG,
    "phi4-mini-3.8b": phi4_mini_3_8b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "opt-125m": opt_125m.CONFIG,   # the paper's own model
}

# The ten assigned architectures (dry-run / roofline cells).
ASSIGNED = [a for a in ARCHS if a != "opt-125m"]


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
