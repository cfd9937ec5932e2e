"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000.

Mamba2 backbone + SHARED attention blocks (one weight set, reused), applied
every 6th layer-unit with per-invocation LoRA deltas. ssm_state=64.
[arXiv:2411.15242; unverified]

Layer-unit layout used here: 81 units = 13 groups x (5 mamba2 + 1 shared
attn) + 3 trailing mamba2 units (68 mamba + 13 shared-attn invocations).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,               # total layer-units (see module docstring)
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    rope_theta=10_000.0,
    mlp_act="gelu",
    ssm_state=64,
    ssm_heads=112,             # d_inner(7168) / mamba head dim(64)
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_every=6,
    shared_attn_lora_rank=128,
    supports_long_context=True,   # bounded state + 13 attn invocations
)
