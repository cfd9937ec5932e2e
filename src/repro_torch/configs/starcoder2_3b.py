"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA (kv=2 — the most bandwidth-skewed decode of the assigned set), RoPE,
classic 2-matrix GELU MLP. [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49_152,
    rope_theta=100_000.0,
    mlp_act="gelu_mlp",        # non-gated 2-matrix MLP
)
