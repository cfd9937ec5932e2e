"""int8 KV pages: codes plus a per-(token, head) f32 scale sidecar.

The port of the reference's ``kernels/kv_int8.py``.  KV pages are stored
as int8 codes and one f32 scale per (token, kv head), and dequantized on
the fly inside attention.  Page bytes drop from ``hd * itemsize`` to
``hd + 4`` per (token, head), so at equal pool bytes the allocator
carves out about twice the pages (bf16) — the Splitwiser lever: KV
capacity, not FLOPs, is what forces preemptions on a constrained device.

Pools are dicts ``{"q": int8 codes [L, N, ps, KV_p, hd], "s": f32 scales
[L, N, ps, KV_p, 1]}``, as in the reference, so one pool can be fed to
both packages.  The int8 paged attention itself (the reference's
``paged_attention_int8`` here) is kernel K3 and lives, with its plain
version, in ``kernels/paged_attention_int8.py``.

  * :func:`q8_kv`, :func:`quant_kv`, :func:`fake_quant_kv` — the
    quantizer (bit-equal to the reference's on the same inputs);
  * :func:`init_pages_int8`, :func:`kv_page_bytes` — pools and their
    byte accounting.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

# Floor on the stored scale: an all-zero (token, head) row — zero-init
# pool pages, padding tokens — must carry a positive finite scale so
# dequant is exactly 0.0, never 0/0 = NaN, and the sanitizer's sidecar
# checks can treat scale > 0 as "this entry is live".
SCALE_FLOOR = 1e-20


def q8_kv(t):
    """t [..., hd] -> (int8 codes, f32 scale [..., 1]).

    Symmetric per-(token, head) quantization: scale = maxabs/127, floored
    at :data:`SCALE_FLOOR`; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.
    """
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(-1, keepdim=True) / 127.0,
                        min=SCALE_FLOOR)
    return torch.round(t32 / scale).to(torch.int8), scale


def quant_kv(k, v):
    """fp K/V rows -> ({"q", "s"}, {"q", "s"}) int8 code+scale dicts."""
    kq, ks = q8_kv(k)
    vq, vs = q8_kv(v)
    return {"q": kq, "s": ks}, {"q": vq, "s": vs}


def fake_quant_kv(t):
    """Quantize-dequantize ``t`` through the page representation.

    Applied to K/V at the attention input of the monolithic prefill
    (``sequential`` computes the whole prompt in one shot) so it attends
    to the values the chunked paths re-read from quantized pages.  The
    dequantized value is computed in f32, then cast to ``t.dtype``.
    """
    q, s = q8_kv(t)
    return (q.float() * s).to(t.dtype)


def init_pages_int8(cfg, n_pages, page_size, device=None, n_layers=None):
    """int8 page pools ``({"q", "s"}, {"q", "s"})``: zero codes, scales
    at :data:`SCALE_FLOOR` (a zero scale plane would make the all-zero
    pool rows unrepresentable)."""
    from repro_torch.models.transformer import gqa_layout
    _, KV_p, _, _, _ = gqa_layout(cfg.n_heads, cfg.n_kv_heads)
    L = n_layers if n_layers is not None else cfg.n_layers
    shape = (L, n_pages, page_size, KV_p)
    device = resolve_device(device)

    def pool():
        return {"q": torch.zeros(shape + (cfg.head_dim,), dtype=torch.int8,
                                 device=device),
                "s": torch.full(shape + (1,), SCALE_FLOOR, dtype=torch.float32,
                                device=device)}
    return pool(), pool()


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
