"""The split-KV recipe of the decode kernel that K1 and K3 run at C = 1
(``src/repro_torch/kernels/csrc/paged_decode.cuh``), emulated in PyTorch
on the CPU, against the reference's paged attention
(``repro.models.layers.paged_attention_ref`` for fp pages,
``repro.kernels.kv_int8.paged_attention_int8`` for int8 pages) and the
port's plain versions.

The emulation follows the kernel's split: a row's keys are cut into S
splits of L keys (``paged_attention.decode_splits``, or a split length
forced small so that every case crosses several splits); split s covers
the absolute keys [s * L, (s + 1) * L) clipped to the row's visible range
(t < kv_len, t <= q_pos, t > q_pos - window), each key row gathered
through the block table on its own (page ids clamped into the pool, only
pages below ceil(kv_len / ps) looked up).  Each split yields f32 partials
(m, l, acc) for the G query heads of each kv head — the scores of scaled
f32 queries (for int8 pages the dot product on the codes times the key's
scale, and p times the value's scale before p * codes), then the softcap —
or, when its range is empty, the empty partial (m = -1e30, l = 0) that the
combine skips.  The combine rescales the partials by exp(m_s - M) and
writes acc / max(l, 1e-30) in q's type.  It runs through the stale tables
of the card tests, while the reference and the plain versions read the
clean ones; the pool's last page, onto which a stale slot would clamp,
holds NaN.  That the kernels follow the recipe is checked on the card.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (DECODE_KWARGS, PAGED_CASES, PAGED_DECODE_CASES, TOL,
                                    _err, _paged, _row_rel_err, paged_chunk_inputs,
                                    poison_last_page)
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.kernels import kv_int8 as JQ
from repro.models import layers as JL
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels.kv_int8 import q8_kv
from repro_torch.models.layers import NO_WINDOW

NEG_INF = -1e30
KW_IDS = ["plain", "window+softcap"]
H100_SMS = 132


def split_decode_recipe(q, k_pages, v_pages, table, kv_lens, q_pos, *, scale, S, L,
                        window=None, softcap=None, k_scales=None, v_scales=None):
    """q [B, 1, H, d]; pages [N, ps, KV, d] fp, or int8 codes with f32
    scales [N, ps, KV, 1]; table [B, Pmax]; kv_lens, q_pos [B].  Returns
    (o [B, 1, H, d] in q's dtype, the partials' (m, l) [B, S, KV, G])."""
    B, _, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    Pmax, G = table.shape[1], H // KV
    win = NO_WINDOW if window is None else int(window)
    out = torch.zeros(B, KV, G, d)
    ml = torch.zeros(B, S, KV, G, 2)
    for b in range(B):
        kv_len = max(0, min(int(kv_lens[b]), Pmax * ps))
        qp = int(q_pos[b])
        t_begin, t_end = max(0, qp - win + 1), min(kv_len, qp + 1)
        qf = q[b, 0].float().reshape(KV, G, d) * scale
        parts = []
        for s in range(S):
            k0, k1 = max(t_begin, s * L), min(t_end, (s + 1) * L)
            if k0 >= k1:
                parts.append((torch.full((KV, G), NEG_INF), torch.zeros(KV, G), None))
                continue
            t = torch.arange(k0, k1)
            page = table[b, t // ps].long().clamp(0, N - 1)
            K, V = k_pages[page, t % ps].float(), v_pages[page, t % ps].float()  # [n, KV, d]
            x = torch.einsum("kgd,nkd->kgn", qf, K)
            if k_scales is not None:
                x = x * k_scales[page, t % ps, :, 0].T[:, None, :]
            if softcap:
                x = torch.tanh(x / softcap) * softcap
            m = x.amax(-1)
            p = torch.exp(x - m[..., None])
            pv = p if v_scales is None else p * v_scales[page, t % ps, :, 0].T[:, None, :]
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", pv, V)))
        M = torch.stack([m for m, l, _ in parts if l.ne(0).any()] or [torch.full((KV, G), NEG_INF)]
                        ).amax(0)
        acc, lsum = torch.zeros(KV, G, d), torch.zeros(KV, G)
        for s, (m, l, a) in enumerate(parts):
            ml[b, s, ..., 0], ml[b, s, ..., 1] = m, l
            if a is None:                       # the empty partial: skipped
                continue
            w = torch.exp(m - M)
            acc, lsum = acc + a * w[..., None], lsum + l * w
        out[b] = acc / lsum.clamp(min=1e-30)[..., None]
    return out.reshape(B, 1, H, d).to(q.dtype), ml


def forced_split(case):
    """A split of two pages: every case's longest row crosses several."""
    ps, lens = case[4], case[6]
    Pmax = -(-max(lens) // ps) + 2
    return -(-Pmax // 2), 2 * ps


def natural_split(case):
    """decode_splits at a card tests' shape, on the H100's 132 SMs."""
    KV, ps, lens = case[2], case[4], case[6]
    return K1.decode_splits(len(lens), KV, -(-max(lens) // ps) + 2, ps, H100_SMS)


def _np(x):
    return x.float().numpy() if x.is_floating_point() else x.numpy()


def _close(got, want, dtype):
    """Within TOL, absolutely and relative to each sequence's max |want|
    (a long row's |o| is small: an average over many keys)."""
    return (_err(got, want) <= TOL[dtype]) and _row_rel_err(got, want) <= TOL[dtype]


def check_fp(dtype, q, kpg, vpg, table, stale, lens, q_pos, split, kw):
    """K1: the recipe on the stale table against paged_attention_ref and
    the plain version on the clean one, all on the same inputs."""
    dt = getattr(torch, dtype)
    q, kpg, vpg = (x.to(dt) for x in (q, kpg, vpg))
    poison_last_page(kpg, vpg)
    S, L = split
    got, ml = split_decode_recipe(q, kpg, vpg, stale, lens, q_pos, scale=0.2, S=S, L=L, **kw)
    assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
    j = lambda x: jnp.asarray(_np(x), jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    ref = JL.paged_attention_ref(
        j(q), j(kpg), j(vpg), jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(q_pos.numpy())[:, None], scale=0.2, window=kw.get("window"),
        attn_softcap=kw.get("softcap"))
    assert _close(got, torch.from_numpy(np.array(ref.astype(jnp.float32))), dtype)
    assert _close(got, K1.paged_attention_plain(q, kpg, vpg, table, lens, q_pos, scale=0.2, **kw),
                  dtype)
    return got, ml


def check_int8(dtype, q, kpg, vpg, table, stale, lens, q_pos, split, kw):
    """K3: the same over int8 codes and f32 scales of the f32 pages,
    against kv_int8.paged_attention_int8 and the plain version."""
    dt = getattr(torch, dtype)
    q = q.to(dt)
    (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
    poison_last_page(ks, vs)
    S, L = split
    got, ml = split_decode_recipe(q, kq, vq, stale, lens, q_pos, scale=0.2, S=S, L=L,
                                  k_scales=ks, v_scales=vs, **kw)
    assert got.dtype == dt and bool(torch.isfinite(got.float()).all())
    j = lambda x: jnp.asarray(_np(x))
    ref = JQ.paged_attention_int8(
        jnp.asarray(_np(q), jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32), j(kq),
        j(ks), j(vq), j(vs), j(table), j(lens), jnp.asarray(q_pos.numpy())[:, None],
        scale=0.2, window=kw.get("window"), attn_softcap=kw.get("softcap"))
    assert _close(got, torch.from_numpy(np.array(ref.astype(jnp.float32))), dtype)
    assert _close(got, K3.paged_attention_int8_plain(q, kq, ks, vq, vs, table, lens, q_pos,
                                                     scale=0.2, **kw), dtype)
    return got, ml


CHECKS = {"fp": check_fp, "int8": check_int8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", DECODE_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_split_decode_recipe_matches_reference(case, pages, kw, dtype):
    """Splits of two pages: the longest row of every case crosses several,
    the window empties some, and rows shorter than a split leave empty
    partials that the combine skips."""
    split = forced_split(case)
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    got, ml = CHECKS[pages](dtype, q, kpg, vpg, table, stale, lens, q_pos, split, kw)
    assert int(((ml[..., 1] != 0).sum(1) > 1).any(-1).any(-1).sum()) >= 1   # several splits
    for b in range(len(lens)):
        if int(lens[b]) == 0:                   # an empty row writes exact zeros
            assert bool((got[b] == 0).all()) and bool((ml[b, ..., 1] == 0).all())


@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_split_decode_recipe_at_decode_splits(case, pages):
    """The split the card would take on 132 SMs, with the window."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    CHECKS[pages]("float32", q, kpg, vpg, table, stale, lens, q_pos, natural_split(case),
                  DECODE_KWARGS[1])


@pytest.mark.parametrize("kw", DECODE_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", [c for c in PAGED_CASES if c[1] == 1])
def test_split_decode_recipe_on_paged_cases(case, pages, kw):
    """The decode entries of the card tests' PAGED_CASES (clean tables),
    at a split of one page."""
    q, kpg, vpg, table, lens, q_pos = _paged(0, *case, torch.float32, device="cpu")
    ps, Pmax = case[5], case[7]
    CHECKS[pages]("float32", q, kpg, vpg, table, table, lens, q_pos, (Pmax, ps), kw)


def test_decode_window_crosses_a_split_boundary():
    """The cases' premise: DECODE_KWARGS' window crosses a boundary of
    decode_splits' split on every row longer than it that is split."""
    window = DECODE_KWARGS[1]["window"]
    crossed = 0
    for case in PAGED_DECODE_CASES:
        S, L = natural_split(case)
        for qp, n in zip(case[5], case[6]):
            if S > 1 and n > window:
                assert (qp - window + 1) // L < qp // L
                crossed += 1
    assert crossed >= 4


@pytest.mark.parametrize("B,KV,Pmax,ps", [(1, 8, 256, 16), (16, 8, 72, 16), (8, 32, 65, 16),
                                          (64, 8, 64, 16), (40, 16, 27, 8), (3, 2, 0, 4),
                                          (1, 1, 100000, 4), (2, 4, 77, 4)])
def test_decode_splits_cover_the_keys_in_whole_pages(B, KV, Pmax, ps):
    S, L = K1.decode_splits(B, KV, Pmax, ps, H100_SMS)
    assert S >= 1 and L >= ps and L % ps == 0 and L // ps <= K1.MAX_SPLIT_PAGES
    assert S * L >= Pmax * ps and (S - 1) * L < max(Pmax * ps, 1)   # no split past the table
    # no more splits than fill the card, unless a split would pass its page cap
    assert S <= max(-(-K1.BLOCKS_PER_SM * H100_SMS // (B * KV)),
                    -(-Pmax // K1.MAX_SPLIT_PAGES))


def test_decode_splits_depend_on_shapes_only():
    """Only ints go in (no kv_lens or q_pos, which live on the card): one
    sequence of 4096 keys is cut into many splits, a large batch into one."""
    assert list(inspect.signature(K1.decode_splits).parameters) == ["B", "KV", "Pmax", "ps",
                                                                    "sms"]
    assert K1.decode_splits(1, 8, 256, 16, H100_SMS) == (32, 128)
    assert K1.decode_splits(128, 8, 64, 16, H100_SMS)[0] == 1
    assert K1.decode_splits(40, 16, 27, 8, H100_SMS)[0] == 1          # PAGED_DECODE_CASES[6]
    assert K1.decode_splits(16, 8, 72, 16, H100_SMS)[0] > 1           # qwen3's main path
    splits = [K1.decode_splits(B, 8, 64, 16, H100_SMS)[0] for B in (1, 2, 4, 8, 16, 32, 64)]
    assert splits == sorted(splits, reverse=True)      # fewer splits as the batch grows
