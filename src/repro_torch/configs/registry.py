"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port serves the dense transformer family and the zamba2 hybrid;
later slices add the other architectures of the reference registry.
"""
from repro_torch.configs import qwen3_0_6b, zamba2_7b

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs():
    return sorted(ARCHS)
