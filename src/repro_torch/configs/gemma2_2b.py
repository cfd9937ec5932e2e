"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention, attn/final logit softcaps, pre+post
norms, sqrt(d_model)-scaled embeddings. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=("local", "global"),
    mlp_act="gelu",            # GeGLU
    tie_embeddings=True,
    post_attn_norm=True,
    emb_scale_by_sqrt_dim=True,
    attn_scale_override=1.0 / (256 ** 0.5),
)
