"""opt-125m — the paper's own experiment model (facebook/opt-125m dims).

Used by the paper-reproduction benchmarks (Figs. 6-11). Dimensionally
matched stand-in inside our stack (RoPE instead of learned positions;
position-encoding flavor is irrelevant to the
phase-splitting results being reproduced).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-125m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50_272,
    mlp_act="gelu_mlp",
)
