"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304.

MoE 64 experts top-8, qk-norm. [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert FFN width
    vocab_size=50_304,
    rope_theta=10_000.0,
    use_qk_norm=True,
    mlp_act="silu",
    n_experts=64,
    top_k=8,
)
