"""The numeric recipe of K4's bf16 tensor-core kernel
(``src/repro_torch/kernels/csrc/ssd_tiles.cuh``), emulated in PyTorch on
the CPU, against the Pallas kernel in interpret mode
(``repro.kernels.ssd_scan.ssd_chunk_scan``), the reference's oracle
(``repro.models.ssm.mamba2_chunk_scan``) and the port's plain version.

The emulation follows the kernel chunk by chunk: every chunk a 64-row
tile, rows past the chunk or past T and columns past P or N zero-filled
(x = B = C = 0, la = 0); L the cumulative log-decay in log2 units, every
exponential an exp2; C.B^T, C.h^T, G.x and (x o dk)^T.B on bf16 operands
with f32 sums, where G = C.B^T o 2^(L_t - L_i) (i <= t, else 0) and
x o dk = x o 2^(L_last - L_i) each go in as a hi + lo bf16 pair and h as
one bf16 for C.h^T; the state carried in f32; y rounded once to bf16.
It shows on the CPU that this recipe holds y to bf16's 2e-2 and h_final
to 1e-4 on the cases the card tests run (``SSD_CASES``, among them a
strong decay whose exponentials underflow); that the kernel follows the
recipe is checked on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import SSD_CASES, TOL, ssd_inputs
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.kernels.ssd_scan import ssd_chunk_scan as pallas_ssd_chunk_scan
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as K4

TILE = 64
LOG2E = 1.4426950408889634
H_TOL = 1e-4            # h_final, both dtypes


def _bf(t):
    return t.bfloat16().float()


def _hi_lo(t):
    hi = _bf(t)
    return hi, _bf(t - hi)


def tc_recipe(x, la, Bc, Cc, h0=None, *, chunk=64, split=_hi_lo):
    """K4's bf16 kernel, chunk by chunk: x [B, T, H, P], Bc/Cc [B, T, N]
    (bf16), la [B, T, H] f32, h0 [B, H, P, N] f32 or None.  ``split``
    turns an f32 operand into the bf16 terms it enters the tensor cores
    as.  Returns (y [B, T, H, P] bf16, h_final [B, H, P, N] f32)."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    h = torch.zeros(B, H, TILE, TILE)
    if h0 is not None:
        h[:, :, :P, :N] = h0.float()
    y = torch.zeros(B, T, H, P)
    tri = torch.tril(torch.ones(TILE, TILE, dtype=torch.bool))[None, :, :, None]
    for t0 in range(0, T, chunk):
        qv = min(chunk, T - t0)
        X = torch.zeros(B, TILE, H, TILE)
        X[:, :qv, :, :P] = x[:, t0:t0 + qv].float()
        Bt, Ct = torch.zeros(B, TILE, TILE), torch.zeros(B, TILE, TILE)
        Bt[:, :qv, :N], Ct[:, :qv, :N] = Bc[:, t0:t0 + qv].float(), Cc[:, t0:t0 + qv].float()
        lt = torch.zeros(B, TILE, H)
        lt[:, :qv] = la[:, t0:t0 + qv].float()
        L = torch.cumsum(lt * LOG2E, dim=1)                          # [B, 64, H], log2
        yc = torch.einsum("btn,bhpn->bthp", Ct, _bf(h)) * torch.exp2(L)[..., None]
        S = torch.einsum("btn,bin->bti", Ct, Bt)
        decay = torch.where(tri, torch.exp2(L[:, :, None] - L[:, None]), 0.0)
        for g in split(S[..., None] * decay):                         # [B, t, i, H]
            yc = yc + torch.einsum("btih,bihp->bthp", g, X)
        y[:, t0:t0 + qv] = yc[:, :qv, :, :P]
        dk = torch.exp2(L[:, -1:] - L)                                 # [B, 64, H]
        h = torch.exp2(L[:, -1])[..., None, None] * h
        for xw in split(X * dk[..., None]):
            h = h + torch.einsum("bihp,bin->bhpn", xw, Bt)
    return y.bfloat16(), h[:, :, :P, :N]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_tile_recipe_matches_references(case, h0):
    """The recipe against the plain version and the jnp oracle on the same
    bf16 inputs (and, with h0 = 0 and whole chunks, the Pallas kernel in
    interpret mode): y within 2e-2, h_final within 1e-4, all finite."""
    B, H, T, P, N, chunk, _ = case
    x, la, Bc, Cc, h = ssd_inputs(case, h0)
    x, Bc, Cc = (a.bfloat16() for a in (x, Bc, Cc))
    y, hf = tc_recipe(x, la, Bc, Cc, h, chunk=chunk)
    assert y.shape == (B, T, H, P) and hf.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(hf).all())
    ytol = TOL["bfloat16"]

    py, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=chunk)
    assert (y.float() - py.float()).abs().max() <= ytol
    assert (hf - ph).abs().max() <= H_TOL

    h_in = np.zeros((B, H, P, N), np.float32) if h is None else h.numpy()
    oy, oh = JS.mamba2_chunk_scan(*(jnp.asarray(a) for a in (
        _np(x), _np(Bc), _np(Cc), la.numpy(), h_in)), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(oy), atol=ytol, rtol=0)
    np.testing.assert_allclose(_np(hf), np.asarray(oh), atol=H_TOL, rtol=0)

    if h is None and T % chunk == 0:
        ky, kh = pallas_ssd_chunk_scan(
            jnp.asarray(_np(x).transpose(0, 2, 1, 3)), jnp.asarray(la.numpy().transpose(0, 2, 1)),
            jnp.asarray(_np(Bc)), jnp.asarray(_np(Cc)), chunk=chunk, interpret=True)
        np.testing.assert_allclose(_np(y), np.asarray(ky).transpose(0, 2, 1, 3), atol=ytol,
                                   rtol=0)
        np.testing.assert_allclose(_np(hf), np.asarray(kh), atol=H_TOL, rtol=0)


def test_single_rounding_would_break_h_final():
    """Why G and x o dk go in as hi + lo pairs: rounded once to bf16, the
    state drifts past h_final's 1e-4 at zamba2's geometry (cut to one row
    of 16 heads and 1024 steps), while the recipe stays inside it."""
    case = (1, 16, 1024, 64, 64, 64, 0.1)
    x, la, Bc, Cc, h = ssd_inputs(case, "random")
    x, Bc, Cc = (a.bfloat16() for a in (x, Bc, Cc))
    _, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h)
    _, hf = tc_recipe(x, la, Bc, Cc, h)
    assert (hf - ph).abs().max() <= H_TOL
    _, once = tc_recipe(x, la, Bc, Cc, h, split=lambda t: (_bf(t),))
    assert (once - ph).abs().max() > H_TOL
