"""The numeric recipe of K4's f32 tensor-core kernel
(``src/repro_torch/kernels/csrc/ssd_tiles_f32.cuh``), emulated in PyTorch
on the CPU, against the reference's oracle
(``repro.models.ssm.mamba2_chunk_scan``), the Pallas kernel in interpret
mode (``repro.kernels.ssd_scan.ssd_chunk_scan``) and the port's plain
version.

The emulation follows the kernel chunk by chunk: every chunk a 64-row
tile, rows past the chunk or past T and columns past P or N zero-filled
(x = B = C = 0, la = 0); L the cumulative log-decay in log2 units, every
exponential an exp2, exp(L_t - L_i) taken only where i <= t.  Every
product is mma.sync's 3xTF32 (``test_torch_paged_f32_tiles.product``: hi =
x rounded to nearest TF32, lo = x - hi read truncated, a_lo b_hi + a_hi
b_lo + a_hi b_hi), summed over k in chains of 4 8-wide steps added in f32,
in the kernel's order: y = 2^(L_t) (C.h^T), the state h = 2^(L_last) h +
(x o dk)^T.B with dk = 2^(L_last - L_i), S = C.B^T, G = S o 2^(L_t - L_i),
y += G.x; the state carried in f32.  It shows on the CPU that this recipe
holds y and h_final to f32's 1e-4 on the cases the card tests run
(``SSD_CASES``, among them a strong decay whose exponentials underflow)
and that one TF32 pass would not.  The kernel's fragment loads (its
swizzled shared tiles, k in pair order) are checked against the PTX
layouts too.  That the kernel follows the recipe is checked on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_f32_tiles import _mma_m16n8k8
from test_torch_kernels_gpu import SSD_CASES, ssd_inputs
from test_torch_paged_f32_tiles import product
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.kernels.ssd_scan import ssd_chunk_scan as pallas_ssd_chunk_scan
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as K4

TILE = 64
CHAIN = 32              # k elements an mma.sync chain sums (4 steps of 8)
LOG2E = 1.4426950408889634
TOL = 1e-4              # y and h_final


def chained(a, b, passes):
    """a @ b as ``tf32::warp_mma`` sums it: each chain of 4 8-wide k steps
    a 3xTF32 product (one TF32 pass with ``passes`` = 1) from zero, the
    chains added in f32 in order."""
    out = None
    for k0 in range(0, a.shape[-1], CHAIN):
        part = product(a[..., k0:k0 + CHAIN], b[..., k0:k0 + CHAIN, :], passes)
        out = part if out is None else out + part
    return out


def f32_recipe(x, la, Bc, Cc, h0=None, *, chunk=64, passes=3):
    """K4's f32 kernel, chunk by chunk: x [B, T, H, P], Bc/Cc [B, T, N],
    la [B, T, H], h0 [B, H, P, N] or None, all f32.  Returns (y [B, T, H,
    P], h_final [B, H, P, N])."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    mm = lambda a, b: chained(a, b, passes)
    h = torch.zeros(B, H, TILE, TILE)                       # [p, n]
    if h0 is not None:
        h[:, :, :P, :N] = h0
    y = torch.zeros(B, T, H, P)
    tri = torch.tril(torch.ones(TILE, TILE, dtype=torch.bool))
    for t0 in range(0, T, chunk):
        qv = min(chunk, T - t0)
        X = torch.zeros(B, H, TILE, TILE)                   # [i, p]
        X[:, :, :qv, :P] = x[:, t0:t0 + qv].transpose(1, 2)
        Bt, Ct = torch.zeros(B, 1, TILE, TILE), torch.zeros(B, 1, TILE, TILE)
        Bt[:, 0, :qv, :N], Ct[:, 0, :qv, :N] = Bc[:, t0:t0 + qv], Cc[:, t0:t0 + qv]
        lt = torch.zeros(B, H, TILE)
        lt[:, :, :qv] = la[:, t0:t0 + qv].transpose(1, 2)
        L = torch.cumsum(lt * LOG2E, dim=-1)                # [B, H, 64], log2
        yc = torch.zeros(B, H, TILE, TILE)                  # [t, p]
        if t0 > 0 or h0 is not None:
            yc = mm(Ct, h.transpose(-1, -2)) * torch.exp2(L)[..., None]
        dk = torch.exp2(L[..., -1:] - L)                    # [B, H, 64]
        h = torch.exp2(L[..., -1])[..., None, None] * h + mm(
            (X * dk[..., None]).transpose(-1, -2), Bt)
        S = mm(Ct, Bt.transpose(-1, -2))                    # [B, 1, t, i]
        diff = L[..., :, None] - L[..., None, :]
        G = torch.where(tri, S * torch.exp2(torch.where(tri, diff, 0.0)), 0.0)
        yc = yc + mm(G, X)
        y[:, t0:t0 + qv] = yc[:, :, :qv, :P].transpose(1, 2)
    return y, h[:, :, :P, :N]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_f32_recipe_matches_references(case, h0):
    """The recipe against the plain version and the jnp oracle on the same
    f32 inputs (and, with h0 = 0 and whole chunks, the Pallas kernel in
    interpret mode): y and h_final within 1e-4, all finite."""
    B, H, T, P, N, chunk, _ = case
    x, la, Bc, Cc, h = ssd_inputs(case, h0)
    y, hf = f32_recipe(x, la, Bc, Cc, h, chunk=chunk)
    assert y.shape == (B, T, H, P) and hf.shape == (B, H, P, N)
    assert bool(torch.isfinite(y).all() and torch.isfinite(hf).all())

    py, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=chunk)
    assert (y - py).abs().max() <= TOL
    assert (hf - ph).abs().max() <= TOL

    h_in = np.zeros((B, H, P, N), np.float32) if h is None else h.numpy()
    oy, oh = JS.mamba2_chunk_scan(*(jnp.asarray(a) for a in (
        _np(x), _np(Bc), _np(Cc), la.numpy(), h_in)), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(oy), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(hf), np.asarray(oh), atol=TOL, rtol=0)

    if h is None and T % chunk == 0:
        ky, kh = pallas_ssd_chunk_scan(
            jnp.asarray(_np(x).transpose(0, 2, 1, 3)), jnp.asarray(la.numpy().transpose(0, 2, 1)),
            jnp.asarray(_np(Bc)), jnp.asarray(_np(Cc)), chunk=chunk, interpret=True)
        np.testing.assert_allclose(_np(y), np.asarray(ky).transpose(0, 2, 1, 3), atol=TOL, rtol=0)
        np.testing.assert_allclose(_np(hf), np.asarray(kh), atol=TOL, rtol=0)


def test_single_tf32_pass_would_miss():
    """Why every product takes three TF32 passes: with one, y or h_final
    at zamba2's geometry (cut to one batch row of 16 heads and 1024 steps)
    drifts past 1e-4 of the plain version, which the recipe holds."""
    case = (1, 16, 1024, 64, 64, 64, 0.1)
    x, la, Bc, Cc, h = ssd_inputs(case, "random")
    py, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h)
    err = lambda got: max((got[0] - py).abs().max().item(), (got[1] - ph).abs().max().item())
    assert err(f32_recipe(x, la, Bc, Cc, h)) <= TOL
    assert err(f32_recipe(x, la, Bc, Cc, h, passes=1)) > TOL


# --- the kernel's fragment loads, as ssd_tiles_f32.cuh writes them -------

LANES = [divmod(lane, 4) for lane in range(32)]          # (g, tq)


def sw(r, c):
    """Where element (r, c) of a swizzled 64 x 64 tile lies."""
    return r * TILE + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3))


def swizzled(M):
    flat = np.zeros(TILE * TILE)
    for r in range(TILE):
        for c in range(TILE):
            flat[sw(r, c)] = M[r, c]
    return flat


def a_rows(r0, kk, g, tq):
    """A from a row-major [m][k] tile: rows r0 + g, + 8; columns 8 kk + tq, + 4."""
    c0 = (((2 * kk) ^ g) << 2) + tq
    p = (r0 + g) * TILE
    return [p + c0, p + 8 * TILE + c0, p + (c0 ^ 4), p + 8 * TILE + (c0 ^ 4)]


def b_rows(kk, i, g, tq):
    """B from an [n][k] tile: row 8 i + g, columns 8 kk + tq, + 4."""
    c0 = (((2 * kk) ^ g) << 2) + tq
    p = (8 * i + g) * TILE
    return [p + c0, p + (c0 ^ 4)]


def b_pairs(kk, i, g, tq):
    """B from a [k][n] tile, k in pair order: rows 8 kk + 2tq, + 1; column 8 i + g."""
    p = (8 * kk + 2 * tq) * TILE + 8 * (i ^ tq)
    return [p + g, p + TILE + (g ^ 4)]


def a_xt(w, kk, g, tq):
    """A = x^T for the warp's state rows p = 16w + g, + 8, k in pair order:
    x rows 8 kk + 2tq, + 1 (each scaled by its dk), columns p."""
    p = (8 * kk + 2 * tq) * TILE
    q0, q1 = 8 * ((2 * w) ^ tq), 8 * ((2 * w + 1) ^ tq)
    return [p + q0 + g, p + q1 + g, p + TILE + q0 + (g ^ 4), p + TILE + q1 + (g ^ 4)]


def _warp_product(fa, fb):
    """The warp's 16 x 64 accumulators over 8 k steps and 8 n fragments."""
    acc = [[[0.0] * 4 for _ in range(32)] for _ in range(8)]
    for kk in range(8):
        for i in range(8):
            acc[i] = _mma_m16n8k8(fa(kk), fb(kk, i), acc[i])
    return acc


def _layout(M, r0):
    """Rows r0 + g, + 8 of M [*, 64] as the warp's 8 accumulator fragments."""
    return [[[M[r0 + g, 8 * i + 2 * t], M[r0 + g, 8 * i + 2 * t + 1],
              M[r0 + g + 8, 8 * i + 2 * t], M[r0 + g + 8, 8 * i + 2 * t + 1]]
             for g, t in LANES] for i in range(8)]


@pytest.mark.parametrize("w", range(4))
def test_fragment_loads_give_the_four_products(w):
    """Warp w's fragments, read from swizzled tiles and fed to mma.m16n8k8
    as the PTX ISA lays it out, give its rows of S = C.B^T and of C.h^T,
    its state rows of (x o dk)^T.B, and (with S's accumulators kept in the
    order c0, c2, c1, c3 as A) its rows of S.x."""
    rng = np.random.RandomState(w)
    C, Bm, Hm, X = (rng.standard_normal((TILE, TILE)) for _ in range(4))
    dk = rng.uniform(0.1, 1.0, TILE)
    Cs, Bs, Hs, Xs = (swizzled(M) for M in (C, Bm, Hm, X))
    r0 = 16 * w
    rows = lambda T: (lambda kk: [[T[a] for a in a_rows(r0, kk, g, t)] for g, t in LANES])
    s = _warp_product(rows(Cs), lambda kk, i: [[Bs[a] for a in b_rows(kk, i, g, t)]
                                               for g, t in LANES])
    assert np.allclose(s, _layout(C @ Bm.T, r0))
    yh = _warp_product(rows(Cs), lambda kk, i: [[Hs[a] for a in b_rows(kk, i, g, t)]
                                                for g, t in LANES])
    assert np.allclose(yh, _layout(C @ Hm.T, r0))

    def xt(kk):
        d = [dk[8 * kk + 2 * t] for g, t in LANES], [dk[8 * kk + 2 * t + 1] for g, t in LANES]
        return [[d[e >> 1][l] * Xs[a] for e, a in enumerate(a_xt(w, kk, g, t))]
                for l, (g, t) in enumerate(LANES)]
    h = _warp_product(xt, lambda kk, i: [[Bs[a] for a in b_pairs(kk, i, g, t)]
                                         for g, t in LANES])
    assert np.allclose(h, _layout((X * dk[:, None]).T @ Bm, r0))
    gx = _warp_product(lambda kk: [[c[0], c[2], c[1], c[3]] for c in s[kk]],
                       lambda kk, i: [[Xs[a] for a in b_pairs(kk, i, g, t)] for g, t in LANES])
    assert np.allclose(gx, _layout(C @ Bm.T @ X, r0))


def test_fragment_loads_hit_distinct_banks():
    """Each fragment load of every warp and step reads 32 distinct banks of
    4 bytes from the swizzled, unpadded tiles: no conflict."""
    for w in range(4):
        for kk in range(8):
            loads = [[a_rows(16 * w, kk, g, t)[e] for g, t in LANES] for e in range(4)]
            loads += [[a_xt(w, kk, g, t)[e] for g, t in LANES] for e in range(4)]
            for i in range(8):
                loads += [[b_rows(kk, i, g, t)[e] for g, t in LANES] for e in range(2)]
                loads += [[b_pairs(kk, i, g, t)[e] for g, t in LANES] for e in range(2)]
            for words in loads:
                assert len({a % 32 for a in words}) == 32
