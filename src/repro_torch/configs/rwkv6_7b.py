"""rwkv6-7b [ssm] — 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.

RWKV-6 "Finch" — linear attention with data-dependent per-channel decay,
token-shift mixing, O(1) recurrent state. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65_536,
    rwkv_head_dim=64,          # 64 wkv heads of dim 64
    supports_long_context=True,
)
