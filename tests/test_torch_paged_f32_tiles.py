"""The numeric recipe of the f32 chunk loop that K1 and K3 run at C > 1
(``src/repro_torch/kernels/csrc/paged_tiles_f32.cuh``), emulated in
PyTorch on the CPU, against the reference's paged attention
(``repro.models.layers.paged_attention_ref`` for fp pages,
``repro.kernels.kv_int8.paged_attention_int8`` for int8 pages) and the
port's plain versions.

The emulation follows the kernel tile by tile: blocks of 64 folded query
rows (r = c * G + g, query position q_pos + c) and one key split each
(S splits of L keys from ``paged_attention.chunk_splits`` at an H100's
132 SMs, two blocks an SM up to padded head dim 128 and one above; split
s covers the absolute keys [s L, (s + 1) L)), the block's key range the
union of its rows' causal and window ranges cut to its split, key tiles
of 64 keys (32 at padded head dims 128 and 256) from its first key, each
key row gathered through the block table on its own (page ids clamped
into the pool, only pages below ceil(kv_len / ps) looked up, rows past the
range zero-filled), the head dim zero-padded to whole 8-wide steps.  The
products are K2's f32 recipe (``test_torch_flash_f32_tiles.py``) but
for lo: fp pages in 3xTF32 (hi = x rounded to nearest TF32, lo = x - hi
truncated to TF32, as the tensor cores read an operand whose low 13 bits
are not zero; a_lo b_hi + a_hi b_lo + a_hi b_hi); int8 pages in two passes
on the codes, which are exact in
TF32: S_t = k_scale[t] ((q_hi + q_lo) code_t) and o = sum_t (p_t
v_scale[t]) code_t with the folded P split hi/lo, while l sums the
unscaled p_t.  S is scaled into log2 units (then softcap and masks), an
online softmax with exp2 and f32 row sums, P permuted inside each 8-key
fragment as the kernel feeds it.  With S == 1 a row is normalized by
max(l, 1e-30); else each split leaves f32 partials (acc, m in natural-log
units, l; a split that sees no key l = 0) that the combine of
``paged_decode.cuh`` merges: M over the splits with l != 0, weights
exp(m_s - M), acc / max(l, 1e-30).  It runs through the stale tables of
the card tests, while the reference and the plain versions read the clean
ones; the pool's last page, onto which a stale slot would clamp, holds
NaN.  A single TF32 pass misses f32's 1e-4 on large scores.  That the
kernels follow the recipe is checked on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_flash_f32_tiles import PERM, _mma_m16n8k8, tf32
from test_torch_kernels_gpu import (CHUNK_KWARGS, PAGED_CASES, PAGED_CHUNK_CASES,
                                    PAGED_F32_SPLIT_CASES, TOL, _err, _paged, _row_rel_err,
                                    paged_chunk_inputs, poison_last_page)
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.kernels import kv_int8 as JQ
from repro.models import layers as JL
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels.kv_int8 import SCALE_FLOOR, q8_kv
from repro_torch.models.layers import NO_WINDOW

BLOCK_M = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
H100_SMS = 132
KW_IDS = ["plain", "window+softcap"]


def h100_slots(d):
    """Blocks of the f32 chunk kernel an H100 runs at once at head dim d."""
    return H100_SMS * (2 if d <= 128 else 1)


def tf32_trunc(x):
    """x as mma.sync reads a .tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, passes, b_exact=False):
    """a @ b as the kernel's mma.sync computes it: 3xTF32 (a_lo b_hi +
    a_hi b_lo + a_hi b_hi, hi = x rounded to nearest TF32 and lo = x - hi
    read truncated), two passes when b is exact in TF32 (a_lo b + a_hi b),
    or one (a_hi b_hi); products of TF32 values are exact in f32."""
    a_hi = tf32(a)
    if passes == 1:
        return a_hi @ (b if b_exact else tf32(b))
    a_lo = tf32_trunc(a - a_hi)
    if b_exact:
        return torch.cat([a_lo, a_hi], -1) @ torch.cat([b, b], -2)
    b_hi = tf32(b)
    b_lo = tf32_trunc(b - b_hi)
    return torch.cat([a_lo, a_hi, a_hi], -1) @ torch.cat([b_hi, b_lo, b_hi], -2)


def f32_paged_recipe(q, k_pages, v_pages, table, kv_lens, q_pos, *, scale, window=None,
                     softcap=None, k_scales=None, v_scales=None, slots=None, passes=None):
    """The f32 chunk loop, tile by tile and split by split: q [B, C, H, d]
    f32; pages [N, ps, KV, d] f32, or int8 codes with f32 scales
    [N, ps, KV, 1]; table [B, Pmax]; kv_lens, q_pos [B].  ``slots``
    (default: an H100's) picks the split.  Returns (o [B, C, H, d] f32,
    stats): the split (S, L), the (row tile, split) blocks that saw no key,
    and the rows whose window edge falls strictly inside a split."""
    B, C, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    Pmax = table.shape[1]
    G, n_rows = H // KV, C * H // KV
    DP = next(p for p in (32, 64, 128, 256) if d <= p)
    BN, D8 = (64 if DP <= 64 else 32), -(-d // 8) * 8
    codes = k_scales is not None
    passes = passes or (2 if codes else 3)
    S, L = K1.chunk_splits(B, C, G, KV, Pmax, ps, slots or h100_slots(d))
    win = NO_WINDOW if window is None else int(window)
    qf = F.pad(q, (0, D8 - d)).reshape(B, C, KV, G, D8).transpose(1, 2)
    qf = F.pad(qf.reshape(B, KV, n_rows, D8), (0, 0, 0, -n_rows % BLOCK_M))
    rows_p = qf.shape[2]
    perm = torch.tensor(PERM).repeat(BN // 8) + torch.arange(BN) // 8 * 8
    acc_s = torch.zeros(S, B, KV, rows_p, D8)
    m_s = torch.full((S, B, KV, rows_p), NEG_INF)
    l_s = torch.zeros(S, B, KV, rows_p)
    stats = dict(S=S, L=L, empty_blocks=0, edges_inside=0)

    def tile(pages, b, t, t_end, width):
        """Key rows t [BN] of sequence b as the loader stages them: each
        through its own table slot, rows at or past t_end zero;
        [KV, BN, width]."""
        ok = t < t_end
        tt = torch.where(ok, t, 0)
        page = table[b, tt // ps].long().clamp(0, N - 1)
        rows = torch.where(ok[:, None, None], pages[page, tt % ps].float(), 0.0)
        return F.pad(rows, (0, width - rows.shape[-1])).transpose(0, 1)

    for b in range(B):
        kv_len = max(0, min(int(kv_lens[b]), Pmax * ps))
        p0 = int(q_pos[b])
        for r0 in range(0, n_rows, BLOCK_M):
            c = p0 + torch.arange(r0, r0 + BLOCK_M) // G           # query positions
            c_lo, c_hi = p0 + r0 // G, p0 + (min(r0 + BLOCK_M, n_rows) - 1) // G
            first = (c - win + 1).clamp(min=0)
            Q = qf[b, :, r0:r0 + BLOCK_M]
            for s in range(S):
                sp_lo, sp_hi = s * L, (s + 1) * L
                t_begin = max(max(0, c_lo - win + 1), sp_lo)
                t_end = min(max(0, min(kv_len, c_hi + 1)), sp_hi)
                if t_begin >= t_end:
                    stats["empty_blocks"] += 1
                    continue                                 # l = 0: the combine skips it
                real = torch.arange(r0, r0 + BLOCK_M) < n_rows
                stats["edges_inside"] += int(((first > sp_lo) & (first < sp_hi) & real).sum())
                row_lo = first.clamp(min=sp_lo)[:, None]
                row_hi = (c + 1).clamp(max=kv_len).clamp(max=sp_hi)[:, None]
                m = torch.full((KV, BLOCK_M), NEG_INF)
                l = torch.zeros(KV, BLOCK_M)
                acc = torch.zeros(KV, BLOCK_M, D8)
                for t0 in range(t_begin, t_end, BN):
                    t = torch.arange(t0, t0 + BN)
                    K = tile(k_pages, b, t, t_end, D8)
                    V = tile(v_pages, b, t, t_end, D8)
                    s_ = product(Q, K.transpose(1, 2), passes, b_exact=codes)
                    if codes:
                        s_ = s_ * tile(k_scales, b, t, t_end, 1)[..., 0][:, None, :]
                    if softcap:
                        x = torch.tanh(s_ * (scale / softcap)) * (softcap * LOG2E)
                    else:
                        x = s_ * (scale * LOG2E)
                    x = torch.where((t >= row_lo) & (t < row_hi), x, NEG_INF)
                    mx = torch.maximum(m, x.amax(-1))
                    corr = torch.exp2(m - mx)
                    base = torch.where(mx == NEG_INF, 0.0, mx)
                    p = torch.exp2(x - base[..., None])
                    l = l * corr + p.sum(-1)
                    if codes:
                        p = p * tile(v_scales, b, t, t_end, 1)[..., 0][:, None, :]
                    acc = acc * corr[..., None] + product(p[..., perm], V[:, perm], passes,
                                                          b_exact=codes)
                    m = mx
                acc_s[s, b, :, r0:r0 + BLOCK_M] = acc
                m_s[s, b, :, r0:r0 + BLOCK_M] = m
                l_s[s, b, :, r0:r0 + BLOCK_M] = l
    if S == 1:
        out = acc_s[0] / l_s[0].clamp(min=1e-30)[..., None]
    else:                                        # the combine, m in natural-log units
        m_nat = m_s * LN2
        live = l_s != 0
        M = torch.where(live, m_nat, NEG_INF).amax(0)
        wt = torch.where(live, torch.exp(m_nat - M), 0.0)
        out = (acc_s * wt[..., None]).sum(0) / (l_s * wt).sum(0).clamp(min=1e-30)[..., None]
    out = out[:, :, :n_rows].reshape(B, KV, C, G, D8).transpose(1, 2)
    return out.reshape(B, C, H, D8)[..., :d].contiguous(), stats


def _positions(q_pos, C):
    return jnp.asarray(q_pos.numpy())[:, None] + jnp.arange(C, dtype=jnp.int32)[None]


def check_fp(q, kpg, vpg, table, stale, lens, q_pos, kw, scale=0.2):
    """K1: the recipe on the stale table against paged_attention_ref and
    the plain version on the clean table, all on the same f32 inputs."""
    poison_last_page(kpg, vpg)
    got, stats = f32_paged_recipe(q, kpg, vpg, stale, lens, q_pos, scale=scale, **kw)
    assert bool(torch.isfinite(got).all())
    j = lambda x: jnp.asarray(x.numpy())
    ref = JL.paged_attention_ref(j(q), j(kpg), j(vpg), j(table), j(lens),
                                 _positions(q_pos, q.shape[1]), scale=scale,
                                 window=kw.get("window"), attn_softcap=kw.get("softcap"))
    for want in (torch.from_numpy(np.array(ref)),
                 K1.paged_attention_plain(q, kpg, vpg, table, lens, q_pos, scale=scale, **kw)):
        assert _err(got, want) <= TOL["float32"] and _row_rel_err(got, want) <= TOL["float32"]
    return got, stats


def check_int8(q, kpg, vpg, table, stale, lens, q_pos, kw, scale=0.2, zero_pages=()):
    """K3: the same over int8 codes and f32 scales of the f32 pages
    (``zero_pages``: page ids made all-zero codes with floored scales),
    against kv_int8.paged_attention_int8 and the plain version."""
    (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
    if zero_pages:
        for codes, scales in ((kq, ks), (vq, vs)):
            codes[list(zero_pages)], scales[list(zero_pages)] = 0, SCALE_FLOOR
    poison_last_page(ks, vs)
    got, stats = f32_paged_recipe(q, kq, vq, stale, lens, q_pos, scale=scale, k_scales=ks,
                                  v_scales=vs, **kw)
    assert bool(torch.isfinite(got).all())
    j = lambda x: jnp.asarray(x.numpy())
    ref = JQ.paged_attention_int8(j(q), j(kq), j(ks), j(vq), j(vs), j(table), j(lens),
                                  _positions(q_pos, q.shape[1]), scale=scale,
                                  window=kw.get("window"), attn_softcap=kw.get("softcap"))
    for want in (torch.from_numpy(np.array(ref)),
                 K3.paged_attention_int8_plain(q, kq, ks, vq, vs, table, lens, q_pos,
                                               scale=scale, **kw)):
        assert _err(got, want) <= TOL["float32"] and _row_rel_err(got, want) <= TOL["float32"]
    return got, stats


CHECKS = {"fp": check_fp, "int8": check_int8}


@pytest.mark.parametrize("kw", CHUNK_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", PAGED_CHUNK_CASES)
def test_f32_paged_recipe_matches_reference(case, pages, kw):
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    got, _ = CHECKS[pages](q, kpg, vpg, table, stale, lens, q_pos, kw)
    for b in range(len(lens)):
        if int(lens[b]) == 0:                   # an empty sequence writes exact zeros
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("kw", CHUNK_KWARGS, ids=KW_IDS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case", [c for c in PAGED_CASES if c[1] > 1])
def test_f32_paged_recipe_on_paged_cases(case, pages, kw):
    """The chunk entries of the card tests' PAGED_CASES (clean tables)."""
    q, kpg, vpg, table, lens, q_pos = _paged(0, *case, torch.float32, device="cpu")
    CHECKS[pages](q, kpg, vpg, table, table, lens, q_pos, kw)


@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("case,kw", PAGED_F32_SPLIT_CASES)
def test_f32_paged_recipe_at_split_edges(case, kw, pages):
    """The card tests' split edges at each model's scale 1/sqrt(d) (int8:
    the first sequence's last two pages all-zero): every case splits on
    an H100, and the recipe holds 1e-4 across the split boundaries."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    ps = case[4]
    last = -(-int(lens[0]) // ps)
    extra = dict(zero_pages=table[0, last - 2:last].tolist()) if pages == "int8" else {}
    _, stats = CHECKS[pages](q, kpg, vpg, table, stale, lens, q_pos, kw,
                             scale=1.0 / np.sqrt(case[3]), **extra)
    assert stats["S"] > 1


def test_window_edge_inside_a_split_and_an_empty_split():
    """PAGED_F32_SPLIT_CASES' first case has what its comment claims: rows
    whose window edge falls strictly inside a split, and (row tile,
    split) blocks that see no key, which the combine must skip."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(PAGED_F32_SPLIT_CASES[0][0])
    _, stats = check_fp(q, kpg, vpg, table, stale, lens, q_pos, PAGED_F32_SPLIT_CASES[0][1],
                        scale=1.0 / np.sqrt(128))
    assert stats["S"] > 1 and stats["edges_inside"] > 0 and stats["empty_blocks"] > 0


@pytest.mark.parametrize("pages", ["fp", "int8"])
def test_single_tf32_pass_misses_f32_tolerance(pages):
    """With q and the pages at 4x (scores 16x larger; d = 128) one TF32
    pass misses 1e-4 against the plain version while the kernel's passes
    (3 on fp pages, 2 on int8 codes) hold it, more than two orders closer:
    the recipes are told apart."""
    q, kpg, vpg, table, _, lens, q_pos = paged_chunk_inputs(
        (128, 4, 2, 128, 16, (300, 45), (428, 173)))
    q, kpg = q * 4, kpg * 4
    kw = {}
    if pages == "int8":
        (kpg, ks), (vpg, vs) = q8_kv(kpg), q8_kv(vpg)
        kw = dict(k_scales=ks, v_scales=vs)
        want = K3.paged_attention_int8_plain(q, kpg, ks, vpg, vs, table, lens, q_pos, scale=0.2)
    else:
        want = K1.paged_attention_plain(q, kpg, vpg, table, lens, q_pos, scale=0.2)
    one = _err(f32_paged_recipe(q, kpg, vpg, table, lens, q_pos, scale=0.2, passes=1,
                                **kw)[0], want)
    full = _err(f32_paged_recipe(q, kpg, vpg, table, lens, q_pos, scale=0.2, **kw)[0], want)
    assert one > TOL["float32"] >= full and full * 100 < one, (one, full)


@pytest.mark.parametrize("B,C,G,KV,Pmax,ps,slots,want", [
    (2, 128, 2, 8, 64, 16, 264, (8, 128)),        # qwen3's chunk of 128: 64 blocks
    (2, 256, 2, 8, 64, 16, 264, (4, 256)),        # of 256: 128 blocks
    (2, 256, 2, 4, 313, 16, 132, (2, 2512)),      # gemma2's, one block an SM
    (16, 256, 2, 8, 72, 16, 264, (1, 1152)),      # 256 blocks already fill 264 slots
    (1, 4, 1, 1, 3, 4, 264, (1, 12)),             # fewer keys than a split keeps
    (1, 64, 8, 1, 2000, 16, 264, (33, 976))])     # 8 blocks, a 32,000-key table
def test_chunk_splits_cover_the_table_in_whole_pages(B, C, G, KV, Pmax, ps, slots, want):
    """chunk_splits at the phase-3 and edge shapes: S splits of L keys,
    L whole pages, cover the table's Pmax * ps keys with no split wholly
    past them, keep at least MIN_SPLIT_KEYS keys a split when they split,
    and minimise waves x pages a split, the most splits on a tie (a grid
    that fills the card stays whole)."""
    S, L = K1.chunk_splits(B, C, G, KV, Pmax, ps, slots)
    assert (S, L) == want
    assert L % ps == 0 and S * L >= Pmax * ps > (S - 1) * L
    assert S == 1 or L >= K1.MIN_SPLIT_KEYS


def test_stale_slots_clamp_onto_the_poisoned_page():
    """The inputs' own premise: a stale slot, read, would clamp onto the
    pool's last page, which no sequence owns and which holds NaN."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(PAGED_F32_SPLIT_CASES[0][0])
    N = kpg.shape[0]
    assert not bool((table == N - 1).any())
    assert bool((stale.clamp(0, N - 1) == N - 1).any())
    poison_last_page(kpg)
    assert bool(torch.isnan(kpg[-1]).all()) and bool(torch.isfinite(kpg[:-1]).all())


def test_qk_fragments_read_two_adjacent_dims():
    """Q·K^T's operands as the kernel reads them, 8 bytes a lane: A column
    tq is Q[g | g + 8][dim 2 tq] and column tq + 4 dim 2 tq + 1, B row tq
    is K[key g][dim 2 tq] and row tq + 4 dim 2 tq + 1; fed to mma.m16n8k8
    as the PTX ISA lays it out, they give S = Q K^T (the contraction
    index is a bijection of the step's 8 dims)."""
    rng = np.random.RandomState(0)
    Q, K = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))   # K: [key, dim]
    lanes = [divmod(lane, 4) for lane in range(32)]
    s = _mma_m16n8k8([[Q[g, 2 * t], Q[g + 8, 2 * t], Q[g, 2 * t + 1], Q[g + 8, 2 * t + 1]]
                      for g, t in lanes],
                     [[K[g, 2 * t], K[g, 2 * t + 1]] for g, t in lanes],
                     [[0.0] * 4 for _ in range(32)])
    S = Q @ K.T
    assert np.allclose(s, [[S[g, 2 * t], S[g, 2 * t + 1], S[g + 8, 2 * t], S[g + 8, 2 * t + 1]]
                           for g, t in lanes])


@pytest.mark.parametrize("DP", [32, 64, 128, 256])
def test_fragment_loads_hit_distinct_banks(DP):
    """With Q and K rows of DP + 8 floats and V rows of DP + 4, each of the
    kernel's fragment loads is free of bank conflicts: the 8-byte Q and K
    loads (rows g and g + 8, dims 2 tq and 2 tq + 1) cover the 32 banks
    once in each half-warp, the 4-byte V loads (V[key 2 tq | 2 tq + 1][dim
    g]) once in the warp."""
    KS, VS = DP + 8, DP + 4
    lanes = [divmod(lane, 4) for lane in range(32)]
    for row0 in (0, 8):                          # Q rows g and g + 8; K's key g
        for half in (lanes[:16], lanes[16:]):
            words = [(row0 + g) * KS + 2 * t + e for g, t in half for e in (0, 1)]
            assert len({w % 32 for w in words}) == 32
    for e in (0, 1):
        words = [(2 * t + e) * VS + g for g, t in lanes]
        assert len({w % 32 for w in words}) == 32


def test_integer_rounding_is_cvt_rna_and_lo_keeps_f32():
    """The kernel's split_fast: hi = (bits + 0x1000) & ~0x1fff is ``tf32``'s
    round to nearest, ties away from zero (cvt.rna), on normal values of
    both signs and at the ties; lo = x - hi read truncated keeps x to
    2^-21 relative."""
    ulp = 2.0 ** -10
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096),
        [1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp, 1 + ulp / 2 - 2 ** -23]]).astype(np.float32))
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    assert torch.equal(hi, tf32(x))
    lo = tf32_trunc(x - hi)
    assert ((hi + lo - x).abs() / x.abs()).max().item() <= 2.0 ** -21
