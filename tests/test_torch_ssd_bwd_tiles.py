"""The numeric recipe of K4's backward kernel
(``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``), emulated in PyTorch
on the CPU, against ``jax.vjp`` of the reference's scan
(``repro.models.ssm.mamba2_chunk_scan``) and the port's plain version
(``ssd_chunk_scan_bwd_plain``).

The emulation follows the kernel pass by pass.  Every chunk is a 64-row
tile, rows past the chunk or past T zero-filled (x = dy = B = C = 0,
la = 0); L is the cumulative log-decay within the chunk.  Every product
is mma.sync's 3xTF32: hi = x rounded to nearest TF32, lo = x - hi read
truncated to TF32, a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32.

- Pass 1, "states", the two recurrences across chunks, each on its own
  (the kernel runs them in blocks of their own): h entering chunk c + 1 =
  exp(L_last) h + (dec o x)^T B, from h0 (zeros when absent) forward; dh
  leaving chunk c - 1 = exp(L_last) dh + (exp(L) o dy)^T C, from dh_final
  (zeros when absent) backward, ending with dh0.  Both are kept as f32
  workspaces [B, H, n_chunks, P, N].
- Pass 2, "chunks", every chunk alone from its entering h and leaving dh:
  the rows' products G = C B^T, W = dy x^T, dC = (E o W) B +
  exp(L) o (dy h) and S's row sums, then the columns' products G^T, W^T
  (computed again, transposed), dx = (E o G)^T dy + dec o (B dh^T) and
  dB = (E o W)^T C + dec o (x dh), and S's column sums as the row sums of
  S^T; dL from the four terms and dla as its reverse cumulative sum
  within the chunk.  E_ts = exp(L_t - L_s) is taken for s <= t only.

It shows on the CPU that this recipe holds every gradient within 1e-4 of
its max |g| on the cases the card tests run (``SSD_CASES``), and that one
TF32 pass would not.  That the kernels follow the recipe is checked on
the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_kernels_gpu import SSD_CASES, _rand, ssd_inputs
from test_torch_paged_f32_tiles import product
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as K4

TILE = 64
REL = 1e-4              # each gradient, relative to its own max |g|
NAMES = ("dx", "dla", "dB", "dC", "dh0")


def _tiles(t, T, chunk):
    """[B, T, ...] -> [B, n_chunks, TILE, ...]: each chunk in a 64-row tile,
    rows past the chunk or past T zero."""
    nc = -(-T // chunk)
    t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, nc * chunk - T))
    t = t.reshape(t.shape[0], nc, chunk, *t.shape[2:])
    return F.pad(t, (0, 0) * (t.ndim - 3) + (0, TILE - chunk))


def _untile(t, T, chunk):
    """The inverse of ``_tiles`` for [B, n_chunks, TILE, ...]."""
    return t[:, :, :chunk].reshape(t.shape[0], -1, *t.shape[3:])[:, :T]


def bwd_recipe(x, la, Bc, Cc, h0, dy, dh_final, *, chunk, passes=3):
    """K4's backward kernels pass by pass, f32: x, dy [B, T, H, P], la
    [B, T, H], Bc, Cc [B, T, N], h0, dh_final [B, H, P, N] or None.
    Returns (dx, dla, dB, dC, dh0 or None when h0 is None)."""
    mm = lambda a, b: product(a, b, passes)
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    X, DY = (_tiles(t, T, chunk).transpose(2, 3) for t in (x, dy))   # [B, nc, H, 64, P]
    Bt, Ct = (_tiles(t, T, chunk)[:, :, None] for t in (Bc, Cc))      # [B, nc, 1, 64, N]
    L = torch.cumsum(_tiles(la, T, chunk), dim=2).transpose(2, 3)     # [B, nc, H, 64]
    nc = L.shape[1]
    last = L[..., -1:]                                                 # padded la = 0
    eL, dec = torch.exp(L), torch.exp(last - L)
    e_last = torch.exp(last)[..., None]                                # [B, nc, H, 1, 1]

    # pass 1: the states entering and the gradients leaving each chunk
    zero = torch.zeros(B, H, P, N)
    hs = [zero if h0 is None else h0.float()]
    for c in range(nc - 1):
        hs.append(e_last[:, c] * hs[-1]
                  + mm((dec[:, c, ..., None] * X[:, c]).transpose(-1, -2), Bt[:, c]))
    dhs = [zero if dh_final is None else dh_final.float()]
    for c in range(nc - 1, -1, -1):
        dhs.append(e_last[:, c] * dhs[-1]
                   + mm((eL[:, c, ..., None] * DY[:, c]).transpose(-1, -2), Ct[:, c]))
    h, dh, dh0 = torch.stack(hs, 1), torch.stack(dhs[-2::-1], 1), dhs[-1]  # [B, nc, H, P, N]

    # pass 2, the rows t of each chunk
    tri = torch.tril(torch.ones(TILE, TILE, dtype=torch.bool))
    diff = L[..., :, None] - L[..., None, :]                           # L_t - L_s
    E = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    Z = mm(DY, h)                                                      # dy h [t, n]
    G, W = mm(Ct, Bt.transpose(-1, -2)), mm(DY, X.transpose(-1, -2))
    rS = (E * G * W).sum(-1)
    dC = mm(E * W, Bt) + eL[..., None] * Z
    tC = eL * (Ct * Z).sum(-1)
    # the columns s: G and W again, transposed
    Et = E.transpose(-1, -2)
    Gt, Wt = mm(Bt, Ct.transpose(-1, -2)), mm(X, DY.transpose(-1, -2))
    cS = (Et * Gt * Wt).sum(-1)
    U = mm(Bt, dh.transpose(-1, -2))                                   # B dh^T [s, p]
    tA = dec * (X * U).sum(-1)
    dx = dec[..., None] * U + mm(Et * Gt, DY)
    dB = dec[..., None] * mm(X, dh) + mm(Et * Wt, Ct)
    dL = rS - cS + tC - tA
    dL[..., -1] += tA.sum(-1) + torch.exp(last[..., 0]) * (dh * h).sum((-2, -1))
    dla = torch.flip(torch.cumsum(torch.flip(dL, [-1]), -1), [-1])

    back = lambda t: _untile(t.transpose(2, 3), T, chunk)             # [B, T, H, ...]
    return (back(dx), back(dla), back(dB).sum(2), back(dC).sum(2),
            None if h0 is None else dh0)


def _case_inputs(case, given):
    x, la, Bc, Cc, h = ssd_inputs(case, "random" if given else "zero")
    rng = np.random.RandomState(1)
    dy = _rand(rng, *x.shape)
    dh = _rand(rng, *h.shape) if given else None
    return x, la, Bc, Cc, h, dy, dh


_VJP = {}


def _reference(x, la, Bc, Cc, h, dy, dh, chunk):
    """``jax.vjp`` of the reference's scan (h0 and dh_final as zeros when
    absent), jitted once per shape: (dx, dla, dB, dC, dh0)."""
    fn = _VJP.get(chunk)
    if fn is None:
        def vjp(x, Bc, Cc, la, h0, dy, dh):
            _, pull = jax.vjp(lambda *a: JS.mamba2_chunk_scan(*a, chunk), x, Bc, Cc, la, h0)
            gx, gB, gC, gla, gh0 = pull((dy, dh))
            return gx, gla, gB, gC, gh0
        fn = _VJP[chunk] = jax.jit(vjp)
    B, T, H, P = x.shape
    zeros = np.zeros((B, H, P, Bc.shape[-1]), np.float32)
    args = (x, Bc, Cc, la, zeros if h is None else h, dy, zeros if dh is None else dh)
    return [np.asarray(g) for g in fn(*(jnp.asarray(np.asarray(a)) for a in args))]


def _rel_errs(got, want):
    """Each gradient's max abs difference over its own max |want|."""
    out = {}
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        out[name] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    return out


@pytest.mark.parametrize("given", [False, True], ids=["h0=dh_final=None", "h0,dh_final"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_bwd_recipe_matches_references(case, given):
    """The recipe against the plain version and ``jax.vjp`` of the
    reference's scan on the same f32 inputs: every gradient finite and
    within 1e-4 of its max |g| of each.  Where the reference's own
    gradient is not finite (its scan takes exp(L_t - L_s) above the
    diagonal too: the strong decay overflows it, ROADMAP queue 3), it is
    held to the plain version alone."""
    chunk = case[5]
    args = _case_inputs(case, given)
    got = bwd_recipe(*args, chunk=chunk)
    assert (got[4] is None) == (not given)
    assert all(bool(torch.isfinite(g).all()) for g in got if g is not None)
    want = K4.ssd_chunk_scan_bwd_plain(*args, chunk=chunk)
    for name, err in _rel_errs(got, want).items():
        assert err <= REL, (name, err)
    ref = _reference(*args, chunk)
    if not given:
        ref[4] = None
    if all(np.isfinite(g).all() for g in ref if g is not None):
        for name, err in _rel_errs(got, ref).items():
            assert err <= REL, (name, err)
    else:
        assert case[6] > 1, "the reference's gradient is finite at the models' decay"


def test_single_tf32_pass_would_miss():
    """Why every product takes three TF32 passes: with one, some gradient
    of zamba2's head geometry (cut to one batch row of 16 heads, a ragged
    last chunk, h0 and dh_final given) misses 1e-4 of its max |g| of the
    plain version, which the recipe holds."""
    case = (1, 16, 200, 64, 64, 64, 0.1)
    args = _case_inputs(case, True)
    want = K4.ssd_chunk_scan_bwd_plain(*args, chunk=64)
    assert max(_rel_errs(bwd_recipe(*args, chunk=64), want).values()) <= REL
    assert max(_rel_errs(bwd_recipe(*args, chunk=64, passes=1), want).values()) > REL
