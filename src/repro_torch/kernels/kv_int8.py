"""KV page byte accounting.

Only :func:`kv_page_bytes` is ported so far: the engine's
byte-denominated page pool needs it for fp pages.  The int8 page path
(quantization, int8 paged attention) comes with a later slice.
"""
from __future__ import annotations

import torch


def kv_page_bytes(cfg, page_size, fp_dtype, *, kv_dtype="fp", tp=1):
    """Bytes ONE page costs in device memory (K + V, all layers).

    fp pages: ``2 * L * ps * KV_p * hd * itemsize``; int8 pages add the
    f32 scale sidecar per (token, head): ``2 * L * ps * KV_p * (hd + 4)``.
    This is the denominator for the byte-denominated pool: at equal pool
    bytes the int8 path yields ``hd*itemsize / (hd+4)`` times the pages.
    """
    from repro_torch.models.transformer import gqa_layout
    _, KV_p, _, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    per_tok_head = (cfg.head_dim + 4 if kv_dtype == "int8"
                    else cfg.head_dim * torch.empty((), dtype=fp_dtype).element_size())
    return 2 * cfg.n_layers * page_size * KV_p * per_tok_head
