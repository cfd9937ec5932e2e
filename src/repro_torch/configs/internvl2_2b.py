"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

InternViT + InternLM2. [arXiv:2404.16821; hf]. The vision frontend
(InternViT-300M) is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, n_patches, d_vision]; a learned MLP
projector maps them into the LM embedding space, prepended as prefix
tokens. The InternLM2 backbone is fully implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    n_vision_patches=256,      # 448x448 / 28x28 patches per tile
    d_vision=1024,             # InternViT-300M width
)
