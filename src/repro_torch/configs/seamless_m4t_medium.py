"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.

Encoder-decoder, multimodal. [arXiv:2308.11596; hf]. The speech frontend is
a STUB per the assignment: input_specs() provides precomputed frame
embeddings [B, encoder_seq, d_model]; the transformer backbone (12L encoder
+ 12L decoder with cross-attention) is fully implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    n_encoder_layers=12,
    encoder_seq=1024,          # stub frontend frames per utterance
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    rope_theta=10_000.0,
    mlp_act="gelu_mlp",
)
