"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]. The scale stressor of
the assigned set (~314B params): exercises expert tensor-parallelism
(8 experts < 16-way model axis -> TP inside experts), FSDP optimizer
sharding and int8 moments for the training shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    rope_theta=10_000.0,
    mlp_act="gelu",            # grok uses gated GeLU
    n_experts=8,
    top_k=2,
    attn_logit_softcap=30.0,   # grok-1 attn logit cap
    final_logit_softcap=30.0,
)
