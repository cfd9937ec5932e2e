"""Greedy serving of the port's model-level families, for the tests
(``test_torch_{hybrid,rwkv,encdec}.py`` on the CPU,
``test_torch_kernels_gpu.py`` on the card): prefill, then decode steps —
for the hybrid and the encoder-decoder over the prefill's K/V as pages
with room to grow, for rwkv6 over its recurrent state.  Imports no JAX.
"""
import numpy as np
import torch

from repro_torch.models import encdec as PE
from repro_torch.models import hybrid as PH
from repro_torch.models import rwkv as PR
from repro_torch.models import transformer as PT


def pool_from_prefill(k, v, ps, extra):
    """Prefill K/V [n_attn, B, S, KV, hd] as pages, ``extra`` free pages
    appended (the last one is the trash page); returns (k, v, N0)."""
    kpg, vpg = PT.kv_to_pages(k, ps), PT.kv_to_pages(v, ps)
    pad = torch.zeros((kpg.shape[0], extra) + kpg.shape[2:], dtype=kpg.dtype,
                      device=kpg.device)
    return torch.cat([kpg, pad], 1), torch.cat([vpg, pad], 1), kpg.shape[1]


def tables(B, S, ps, N0, new_pages, width=8):
    """[B, width] int32: each row's prefill pages, then ``new_pages`` fresh
    pages per row after the first N0."""
    per = S // ps
    bt = np.zeros((B, width), np.int32)
    for b in range(B):
        bt[b, :per] = np.arange(per) + b * per
        bt[b, per: per + new_pages] = N0 + b * new_pages + np.arange(new_pages)
    return bt


def greedy_stream(params, cfg, toks, steps, ps):
    """Prefill ``toks`` [B, S] (S a multiple of ``ps``), then ``steps``
    greedy tokens per row (the first from the prefill's logits) through
    paged decode, on the params' device.  Returns [B, steps] numpy."""
    dev = params["embed"].device
    toks = torch.as_tensor(toks, device=dev)
    B, S = toks.shape
    last, (k, v), (conv, sst) = PH.prefill(params, cfg, toks)
    new = -(-steps // ps)
    kpg, vpg, N0 = pool_from_prefill(k, v, ps, B * new + 1)
    bt = torch.from_numpy(tables(B, S, ps, N0, new, width=S // ps + new)).to(dev)
    out, nxt = [], last.argmax(-1)
    for i in range(steps):
        out.append(nxt.cpu().numpy())
        lens = torch.full((B,), S + i, device=dev)
        logits, _, _ = PH.decode(params, cfg, nxt, conv, sst, kpg, vpg, bt, lens)
        nxt = logits.argmax(-1)
    return np.stack(out, 1)


def rwkv_greedy_stream(params, cfg, toks, steps):
    """The port's rwkv6: prefill ``toks`` [B, S], then ``steps`` greedy
    tokens per row (the first from the prefill's logits) through
    recurrent decode steps, on the params' device.  Returns [B, steps]
    numpy."""
    dev = params["embed"].device
    logits, state = PR.prefill(params, cfg, torch.as_tensor(toks, device=dev))
    out = []
    for _ in range(steps):
        nxt = logits.argmax(-1)
        out.append(nxt.cpu().numpy())
        logits, state = PR.decode(params, cfg, nxt, state)
    return np.stack(out, 1)


def encdec_greedy_stream(params, cfg, frames, toks, steps, ps, enc_valid_len=None):
    """The port's encoder-decoder: prefill ``frames`` [B, S_enc, D] and
    decoder prompts ``toks`` [B, S] (S a multiple of ``ps``), the
    self-K/V as pages with room to grow, then ``steps`` greedy tokens per
    row through paged decode (cross keys masked past ``enc_valid_len``),
    on the params' device.  Returns [B, steps] numpy."""
    dev = params["embed"].device
    toks = torch.as_tensor(toks, device=dev)
    B, S = toks.shape
    last, (k, v), (xk, xv) = PE.prefill(params, cfg, torch.as_tensor(frames, device=dev),
                                        toks)
    new = -(-steps // ps)
    kpg, vpg, N0 = pool_from_prefill(k, v, ps, B * new + 1)
    bt = torch.from_numpy(tables(B, S, ps, N0, new, width=S // ps + new)).to(dev)
    evl = None if enc_valid_len is None else torch.as_tensor(enc_valid_len, device=dev)
    out, nxt = [], last.argmax(-1)
    for i in range(steps):
        out.append(nxt.cpu().numpy())
        lens = torch.full((B,), S + i, device=dev)
        logits, _ = PE.decode(params, cfg, nxt, kpg, vpg, xk, xv, bt, lens,
                              enc_valid_len=evl)
        nxt = logits.argmax(-1)
    return np.stack(out, 1)
