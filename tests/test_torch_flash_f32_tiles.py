"""The numeric recipe of K2's f32 tensor-core kernel
(``flash_attention_kernel_f32`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``, helpers in
``csrc/tf32_common.cuh``), emulated in PyTorch on the CPU, against the
reference's flash attention (``repro.models.layers.flash_attention``)
and the port's plain version.

The emulation follows the kernel tile by tile: blocks of 64 folded query
rows (r = c * G + g), the block's key range clipped to its rows' causal
and window union, key tiles of 64 keys (32 at padded head dims 128 and
256) with rows past the range zero-filled, a call of at most 16 rows
splitting each tile's 8-key fragments over 4 partial softmaxes merged at
the end (the forward-only kernel's SPLIT; the lse it returns then is
the merged one), the head dim zero-padded to whole 8-wide
steps, both products in 3xTF32 (each operand split into hi =
tf32(x) and lo = tf32(x - hi), rounded to nearest as ``cvt.rna`` does, and
a_lo b_hi + a_hi b_lo + a_hi b_hi: products of TF32 values are exact in
f32, accumulated in f32), S scaled into log2 units (then softcap and
masks), an online softmax with exp2 and f32 row sums, P kept in f32 and
split for P·V with the key order permuted inside each 8-key fragment as
the kernel feeds it, normalization by max(l, 1e-30), and lse = m ln 2 +
log(max(l, 1e-30)).  The tensor cores' own rounding of their f32 sums is
not emulated (the kernel adds every 4 steps' sums to S and O on the CUDA
cores to bound it); the card's checks hold it.  The same recipe with a single TF32 pass (a_hi b_hi)
misses f32's 1e-4 on large scores, which is why the kernel takes three.

The fragment algebra the kernel rests on (P's accumulators reused as the
A operand of P·V; K's and V's B fragments) is checked against the PTX
layouts of ``mma.m16n8k8`` lane by lane, and its shared-memory loads for
bank conflicts.  That the kernel follows the recipe is checked on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import FLASH_CASES, FLASH_F32_CASES, TOL, flash_inputs
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as K2
from repro_torch.models.layers import NO_WINDOW

BLOCK_M = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KWARGS = [dict(), dict(window=8, softcap=25.0), dict(causal=False)]
# Inside each 8-key fragment of P·V, A column c holds key PERM[c]: the
# accumulator of S holds keys (2 t, 2 t + 1) where A wants columns (t, t + 4).
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to nearest, ties away from zero, to
    10 mantissa bits (the low 13 bits of the word cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a, b, passes=3):
    """a @ b as the kernel's mma.sync computes it: 3xTF32 (a_lo b_hi +
    a_hi b_lo + a_hi b_hi, one f32 sum of exact products) or one pass."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return torch.cat([a_lo, a_hi, a_hi], -1) @ torch.cat([b_hi, b_lo, b_hi], -2)


def block_n(d):
    """Keys a tile at head dim d: 64 up to padded head dim 64, else 32."""
    return 64 if d <= 64 else 32


def f32_recipe(q, k, v, kv_lens, *, scale, causal=True, window=None, softcap=None,
               passes=3):
    """K2's f32 kernel, tile by tile: q [B, T, H, d], k/v [B, Tk, KV, d]
    (f32), kv_lens [B]; returns (o [B, T, H, d], lse [B, KV, G, T])."""
    B, T, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, n_rows = H // KV, T * H // KV
    BN, D8 = block_n(d), -(-d // 8) * 8
    win = NO_WINDOW if window is None else int(window)
    pad = lambda x, n: torch.nn.functional.pad(x, (0, D8 - d, 0, 0, 0, n))
    # folded rows [B, KV, rows, D8], padded to whole row and key tiles
    qf = pad(q, 0).reshape(B, T, KV, G, D8).transpose(1, 2).reshape(B, KV, n_rows, D8)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, -n_rows % BLOCK_M))
    kf, vf = (pad(x, BN).transpose(1, 2) for x in (k, v))      # [B, KV, Tk + BN, D8]
    perm = torch.tensor(PERM).repeat(BN // 8) + torch.arange(BN) // 8 * 8
    out = torch.zeros(B, KV, qf.shape[2], D8)
    lse = torch.full((B, KV, qf.shape[2]), NEG_INF)
    for b in range(B):
        kv_len = max(0, min(int(kv_lens[b]), Tk))
        for r0 in range(0, n_rows, BLOCK_M):
            c = torch.arange(r0, r0 + BLOCK_M) // G
            c_lo, c_hi = r0 // G, (min(r0 + BLOCK_M, n_rows) - 1) // G
            t_begin = max(0, c_lo - win + 1)
            t_end = min(kv_len, c_hi + 1) if causal else kv_len
            row_lo = (c - win + 1).clamp(min=0)[:, None]
            row_hi = (torch.clamp(c + 1, max=kv_len) if causal
                      else torch.full_like(c, kv_len))[:, None]
            Q = qf[b, :, r0:r0 + BLOCK_M]
            # a call of at most 16 rows splits each key tile over the 4
            # warps (8-key fragment j to warp j % 4), as the forward-only
            # kernel does; else one state a row
            W = 4 if n_rows <= 16 else 1
            own = (torch.arange(BN) // 8 % W == torch.arange(W)[:, None])[:, None, None]
            m = torch.full((W, KV, BLOCK_M), NEG_INF)
            l = torch.zeros(W, KV, BLOCK_M)
            acc = torch.zeros(W, KV, BLOCK_M, D8)
            for t0 in range(t_begin, t_end, BN):
                t = torch.arange(t0, t0 + BN)
                loaded = (t < t_end)[:, None].float()                  # zero-filled past it
                K = kf[b, :, t0:t0 + BN] * loaded
                V = vf[b, :, t0:t0 + BN] * loaded
                s = product(Q, K.transpose(1, 2), passes)
                if softcap:
                    x = torch.tanh(s * (scale / softcap)) * (softcap * LOG2E)
                else:
                    x = s * (scale * LOG2E)
                x = torch.where((t >= row_lo) & (t < row_hi) & own, x, NEG_INF)
                mx = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - mx)
                base = torch.where(mx == NEG_INF, 0.0, mx)
                p = torch.exp2(x - base[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + product(p[..., perm], V[:, perm], passes)
                m = mx
            if W > 1:                            # warp 0 merges the partial softmaxes
                corr = torch.exp2(m - m.amax(0))
                acc, l, m = (acc * corr[..., None]).sum(0), (l * corr).sum(0), m.amax(0)
            else:
                acc, l, m = acc[0], l[0], m[0]
            denom = l.clamp(min=1e-30)
            out[b, :, r0:r0 + BLOCK_M] = acc / denom[..., None]
            lse[b, :, r0:r0 + BLOCK_M] = torch.where(m == NEG_INF, NEG_INF,
                                                     m * LN2 + torch.log(denom))
    out = out[:, :, :n_rows].reshape(B, KV, T, G, D8).transpose(1, 2)
    lse = lse[:, :, :n_rows].reshape(B, KV, T, G).transpose(2, 3)
    return out.reshape(B, T, H, D8)[..., :d], lse.contiguous()


@partial(jax.jit, static_argnames=("scale", "causal", "window", "softcap"))
def _reference(q, k, v, kv_lens, *, scale, causal, window, softcap):
    B, T = q.shape[:2]
    Tk = k.shape[1]
    return JL.flash_attention(
        q, k, v, q_positions=jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T)),
        kv_positions=jnp.broadcast_to(jnp.arange(Tk, dtype=jnp.int32), (B, Tk)),
        kv_valid_len=kv_lens, scale=scale, causal=causal, window=window,
        attn_softcap=softcap, _return_lse=True)


def reference(q, k, v, kv_lens, *, scale, causal=True, window=None, softcap=None):
    """repro.models.layers.flash_attention on the same f32 inputs: (o, lse).
    Jitted whole: one compile a call shape, a third of eager's."""
    out = _reference(*(jnp.asarray(x.numpy()) for x in (q, k, v, kv_lens)), scale=scale,
                     causal=causal, window=window, softcap=softcap)
    return tuple(torch.from_numpy(np.array(x)) for x in out)


def _errs(got, want):
    """(max abs error of o, max relative error of lse: |a - b| / max(|b|, 1))."""
    o_err = (got[0] - want[0]).abs().max().item()
    lse_err = ((got[1] - want[1]).abs() / want[1].abs().clamp(min=1.0)).max().item()
    return o_err, lse_err


def _check(q, k, v, lens, scale, kw, against_reference=True):
    got = f32_recipe(q, k, v, lens, scale=scale, **kw)
    assert bool(torch.isfinite(got[0]).all())
    wants = [K2.flash_attention_lse_plain(q, k, v, lens, scale=scale, **kw)]
    if against_reference:
        wants.append(reference(q, k, v, lens, scale=scale, **kw))
    for want in wants:
        o_err, lse_err = _errs(got, want)
        assert o_err <= TOL["float32"] and lse_err <= 1e-4, (o_err, lse_err)
    return got


@pytest.mark.parametrize("kw", KWARGS, ids=["causal", "window+softcap", "non-causal"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_f32_recipe_matches_reference(case, kw):
    o, lse = _check(*flash_inputs(case), 0.2, kw)
    if case[6] == 0:                            # an empty row: o = 0, lse = -1e30
        assert bool((o[0] == 0).all()) and bool((lse[0] == NEG_INF).all())


@pytest.mark.parametrize("case", FLASH_F32_CASES)
def test_f32_recipe_at_the_card_tests_edges(case):
    """The f32 kernel's own edge cases on the card, held to the plain
    version under a window wider than a key tile with softcap."""
    _check(*flash_inputs(case), 0.2, dict(window=100, softcap=25.0), against_reference=False)


def test_single_tf32_pass_misses_f32_tolerance():
    """On FLASH_F32_CASES' large-score case (q/k at 4x, d = 128) one TF32
    pass misses 1e-4 on o while 3xTF32 holds it, more than two orders
    closer to the plain version: the two recipes are told apart."""
    case = FLASH_F32_CASES[-1]
    assert case[5] == 128 and case[7] == 4
    q, k, v, lens = flash_inputs(case)
    want = K2.flash_attention_lse_plain(q, k, v, lens, scale=0.2)
    one = _errs(f32_recipe(q, k, v, lens, scale=0.2, passes=1), want)[0]
    three = _errs(f32_recipe(q, k, v, lens, scale=0.2), want)[0]
    assert one > TOL["float32"] >= three and three * 100 < one, (one, three)


def test_tf32_rounding_is_round_to_nearest_away():
    """``tf32`` keeps 10 mantissa bits, rounds half away from zero, and
    hi + lo reproduces x to ~2^-22 relative."""
    ulp = 2.0 ** -10                                      # of a value in [1, 2)
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp])
    assert tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    r = torch.from_numpy(np.random.RandomState(0).standard_normal(4096).astype(np.float32))
    hi = tf32(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert ((hi + tf32(r - hi) - r).abs() / r.abs()).max().item() <= 2.0 ** -21


def _mma_m16n8k8(a, b, c):
    """``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` lane by lane,
    as the PTX ISA lays out the fragments (g = lane / 4, t = lane % 4):
    a0..a3 = A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4];
    b0, b1 = B[t, g], B[t + 4, g]; c0..c3 = C[g, 2t], C[g, 2t + 1],
    C[g + 8, 2t], C[g + 8, 2t + 1].  a [32, 4], b [32, 2], c [32, 4]."""
    A, Bm, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (r, col) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            A[r, col] = a[lane][i]
        Bm[t, g], Bm[t + 4, g] = b[lane]
        for i, (r, col) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                      (g + 8, 2 * t + 1))):
            C[r, col] = c[lane][i]
    D = C + A @ Bm
    return [[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_fragment_algebra_of_both_products():
    """The kernel's fragments, fed to mma.m16n8k8 as the PTX ISA lays it
    out, give S = Q K^T (A = Q[g | g + 8][t | t + 4], B = K[key g][t |
    t + 4]) and O = P V with P's accumulators as A in the order (c0, c2,
    c1, c3) and V's B fragment V[key 2t | 2t + 1][dim g]: no shuffles."""
    rng = np.random.RandomState(0)
    Q, K = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))   # K: [key, dim]
    P, V = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))   # V: [key, dim]
    lanes = [divmod(lane, 4) for lane in range(32)]
    zero = [[0.0] * 4 for _ in range(32)]
    s = _mma_m16n8k8([[Q[g, t], Q[g + 8, t], Q[g, t + 4], Q[g + 8, t + 4]] for g, t in lanes],
                     [[K[g, t], K[g, t + 4]] for g, t in lanes], zero)
    S = Q @ K.T
    assert np.allclose(s, [[S[g, 2 * t], S[g, 2 * t + 1], S[g + 8, 2 * t], S[g + 8, 2 * t + 1]]
                           for g, t in lanes])
    acc = [[P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t], P[g + 8, 2 * t + 1]]
           for g, t in lanes]                                         # P in S's layout
    o = _mma_m16n8k8([[c[0], c[2], c[1], c[3]] for c in acc],
                     [[V[2 * t, g], V[2 * t + 1, g]] for g, t in lanes], zero)
    O = P @ V
    assert np.allclose(o, [[O[g, 2 * t], O[g, 2 * t + 1], O[g + 8, 2 * t], O[g + 8, 2 * t + 1]]
                           for g, t in lanes])
    # the same permutation as f32_recipe applies: A column c is key PERM[c]
    assert [2 * t for t in range(4)] + [2 * t + 1 for t in range(4)] == list(PERM)


@pytest.mark.parametrize("DP", [32, 64, 128, 256])
def test_fragment_loads_hit_distinct_banks(DP):
    """With shared rows of DP + 4 floats, each of the kernel's fragment
    loads (Q's A fragment at rows g and g + 8, dims t and t + 4; K's B
    fragment K[key g][t | t + 4]; V's V[key 2t | 2t + 1][dim g]) reads 32
    distinct banks of 4 bytes: no conflict."""
    S = DP + 4
    lanes = [divmod(lane, 4) for lane in range(32)]
    loads = {
        "Q/K rows g, dim t": [g * S + t for g, t in lanes],
        "Q/K rows g, dim t + 4": [g * S + t + 4 for g, t in lanes],
        "Q rows g + 8, dim t": [(g + 8) * S + t for g, t in lanes],
        "V key 2t, dim g": [2 * t * S + g for g, t in lanes],
        "V key 2t + 1, dim g": [(2 * t + 1) * S + g for g, t in lanes],
    }
    for name, words in loads.items():
        assert len({w % 32 for w in words}) == 32, name
