"""The numeric recipe of the paged tensor-core tile loop that K1 and K3
run on bf16 chunks (``src/repro_torch/kernels/csrc/paged_tiles.cuh``),
emulated in PyTorch on the CPU, against the reference's paged attention
(``repro.models.layers.paged_attention_ref`` for fp pages,
``repro.kernels.kv_int8.paged_attention_int8`` for int8 pages) and the
port's plain versions.

The emulation follows the kernel tile by tile: blocks of 64 folded query
rows (r = c * G + g, query position q_pos + c), the block's key range
clipped to its rows' causal and window union, key tiles of 64 from its
first key, each key row gathered through the block table on its own
(page ids clamped into the pool, only pages below ceil(kv_len / ps) looked
up, rows past the range zero-filled), bf16 Q/K/V with the head dim
zero-padded to 32/64/128/256 (for int8 pages code * scale in f32, rounded
to bf16), S in f32 scaled into log2 units (then softcap and masks), an
online softmax with exp2 and f32 row sums, P rounded to bf16 before P·V,
f32 accumulation, normalization by max(l, 1e-30) and one rounding to
bf16.  It runs through the stale tables of the card tests, while the
reference and the plain versions read the clean ones; the pool's last
page, onto which a stale slot would clamp, holds NaN.  It shows on the
CPU that this recipe fits the bf16 tolerance (2e-2) on the cases the card
tests run; that the kernels follow it is checked on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_kernels_gpu import (CHUNK_KWARGS, PAGED_CASES, PAGED_CHUNK_CASES, TOL,
                                    _paged, paged_chunk_inputs, poison_last_page)
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.kernels import kv_int8 as JQ
from repro.models import layers as JL
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels.kv_int8 import q8_kv
from repro_torch.models.layers import NO_WINDOW

BLOCK_M = BLOCK_N = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
KW_IDS = ["plain", "window+softcap"]


def tc_paged_recipe(q, k_pages, v_pages, table, kv_lens, q_pos, *, scale, window=None,
                    softcap=None, k_scales=None, v_scales=None):
    """The paged tile loop, tile by tile: q [B, C, H, d] bf16; pages
    [N, ps, KV, d] bf16, or int8 codes with f32 scales [N, ps, KV, 1];
    table [B, Pmax]; kv_lens, q_pos [B].  Returns o [B, C, H, d] bf16."""
    B, C, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    Pmax = table.shape[1]
    G, n_rows = H // KV, C * H // KV
    DP = next(p for p in (32, 64, 128, 256) if d <= p)
    win = NO_WINDOW if window is None else int(window)
    qf = F.pad(q.float(), (0, DP - d)).reshape(B, C, KV, G, DP).transpose(1, 2)
    qf = F.pad(qf.reshape(B, KV, n_rows, DP), (0, 0, 0, -n_rows % BLOCK_M))
    out = torch.zeros(B, KV, qf.shape[2], DP)

    def tile(pages, scales, b, t, t_end):
        """Key rows t [64] of sequence b as the loader stages them: each
        through its own table slot, rows at or past t_end zero."""
        ok = t < t_end
        tt = torch.where(ok, t, 0)
        page = table[b, tt // ps].long().clamp(0, N - 1)
        rows = pages[page, tt % ps].float()                       # [64, KV, d]
        if scales is not None:
            rows = (rows * scales[page, tt % ps]).bfloat16().float()
        rows = torch.where(ok[:, None, None], rows, 0.0)
        return F.pad(rows, (0, DP - d)).transpose(0, 1)            # [KV, 64, DP]

    for b in range(B):
        kv_len = max(0, min(int(kv_lens[b]), Pmax * ps))
        p0 = int(q_pos[b])
        for r0 in range(0, n_rows, BLOCK_M):
            c = p0 + torch.arange(r0, r0 + BLOCK_M) // G           # query positions
            c_lo, c_hi = p0 + r0 // G, p0 + (min(r0 + BLOCK_M, n_rows) - 1) // G
            t_begin = max(0, c_lo - win + 1)
            t_end = max(0, min(kv_len, c_hi + 1))
            row_lo = (c - win + 1).clamp(min=0)[:, None]
            row_hi = (c + 1).clamp(max=kv_len)[:, None]
            Q = qf[b, :, r0:r0 + BLOCK_M]
            m = torch.full((KV, BLOCK_M), NEG_INF)
            l = torch.zeros(KV, BLOCK_M)
            acc = torch.zeros(KV, BLOCK_M, DP)
            for t0 in range(t_begin, t_end, BLOCK_N):
                t = torch.arange(t0, t0 + BLOCK_N)
                K = tile(k_pages, k_scales, b, t, t_end)
                V = tile(v_pages, v_scales, b, t, t_end)
                s = Q @ K.transpose(1, 2)
                if softcap:
                    x = torch.tanh(s * (scale / softcap)) * (softcap * LOG2E)
                else:
                    x = s * (scale * LOG2E)
                x = torch.where((t >= row_lo) & (t < row_hi), x, NEG_INF)
                mx = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - mx)
                base = torch.where(mx == NEG_INF, 0.0, mx)
                p = torch.exp2(x - base[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p.bfloat16().float() @ V
                m = mx
            out[b, :, r0:r0 + BLOCK_M] = acc / l.clamp(min=1e-30)[..., None]
    out = out[:, :, :n_rows].reshape(B, KV, C, G, DP).transpose(1, 2)
    return out.reshape(B, C, H, DP)[..., :d].bfloat16()


def _np(x):
    return x.float().numpy() if x.is_floating_point() else x.numpy()


def _positions(q_pos, C):
    return jnp.asarray(q_pos.numpy())[:, None] + jnp.arange(C, dtype=jnp.int32)[None]


def _close(got, want):
    return (got.float() - want.float()).abs().max().item() <= TOL["bfloat16"]


def check_fp(q, kpg, vpg, table, stale, lens, q_pos, kw):
    """K1: the recipe on the stale table against paged_attention_ref and
    the plain version on the clean one, all on the same bf16 inputs."""
    q, kpg, vpg = (x.bfloat16() for x in (q, kpg, vpg))
    poison_last_page(kpg, vpg)
    got = tc_paged_recipe(q, kpg, vpg, stale, lens, q_pos, scale=0.2, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    bf = lambda x: jnp.asarray(_np(x), jnp.bfloat16)
    ref = JL.paged_attention_ref(
        bf(q), bf(kpg), bf(vpg), jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()),
        _positions(q_pos, q.shape[1]), scale=0.2, window=kw.get("window"),
        attn_softcap=kw.get("softcap"))
    assert _close(got, torch.from_numpy(np.array(ref.astype(jnp.float32))))
    assert _close(got, K1.paged_attention_plain(q, kpg, vpg, table, lens, q_pos, scale=0.2,
                                                **kw))
    return got


def check_int8(q, kpg, vpg, table, stale, lens, q_pos, kw):
    """K3: the same over int8 codes and f32 scales of the f32 pages,
    against kv_int8.paged_attention_int8 and the plain version."""
    q = q.bfloat16()
    (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
    poison_last_page(ks, vs)
    got = tc_paged_recipe(q, kq, vq, stale, lens, q_pos, scale=0.2, k_scales=ks,
                          v_scales=vs, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    j = lambda x: jnp.asarray(_np(x))
    ref = JQ.paged_attention_int8(
        jnp.asarray(_np(q), jnp.bfloat16), j(kq), j(ks), j(vq), j(vs), j(table), j(lens),
        _positions(q_pos, q.shape[1]), scale=0.2, window=kw.get("window"),
        attn_softcap=kw.get("softcap"))
    assert _close(got, torch.from_numpy(np.array(ref.astype(jnp.float32))))
    assert _close(got, K3.paged_attention_int8_plain(q, kq, ks, vq, vs, table, lens, q_pos,
                                                     scale=0.2, **kw))
    return got


CHECKS = {"fp": check_fp, "int8": check_int8}


@pytest.mark.parametrize("kw", CHUNK_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", PAGED_CHUNK_CASES)
def test_paged_tile_recipe_matches_reference(case, pages, kw):
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    got = CHECKS[pages](q, kpg, vpg, table, stale, lens, q_pos, kw)
    for b in range(len(lens)):
        if int(lens[b]) == 0:                   # an empty sequence writes exact zeros
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("kw", CHUNK_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", [c for c in PAGED_CASES if c[1] > 1])
def test_paged_tile_recipe_on_paged_cases(case, pages, kw):
    """The chunk entries of the card tests' PAGED_CASES (clean tables)."""
    q, kpg, vpg, table, lens, q_pos = _paged(0, *case, torch.float32, device="cpu")
    CHECKS[pages](q, kpg, vpg, table, table, lens, q_pos, kw)


def test_stale_slots_clamp_onto_the_poisoned_page():
    """The inputs' own premise: a stale slot, read, would clamp onto the
    pool's last page, which no sequence owns and which holds NaN."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(PAGED_CHUNK_CASES[0])
    N = kpg.shape[0]
    assert not bool((table == N - 1).any())
    assert bool((stale.clamp(0, N - 1) == N - 1).any())
    poison_last_page(kpg)
    assert bool(torch.isnan(kpg[-1]).all()) and bool(torch.isfinite(kpg[:-1]).all())
