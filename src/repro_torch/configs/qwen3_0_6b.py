"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]. Qwen3 uses an explicit head_dim=128
(H*hd != d_model) and per-head RMS q/k norms.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    mlp_act="silu",
    tie_embeddings=True,
)
