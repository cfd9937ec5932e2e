"""The numeric recipe of K2's bf16 tensor-core kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``), emulated in
PyTorch on the CPU, against the reference's flash attention
(``repro.models.layers.flash_attention``) and the port's plain version.

The emulation follows the kernel tile by tile: blocks of 64 folded query
rows (r = c * G + g), the block's key range clipped to its rows' causal
and window union, key tiles of 64 from there with rows past the range
zero-filled, bf16 Q/K/V with the head dim zero-padded to 32/64/128/256,
S in f32 scaled into log2 units (then softcap and masks), an online
softmax with exp2 and f32 row sums, P rounded to bf16 before P·V, f32
accumulation, normalization by max(l, 1e-30) and one rounding to bf16.
It shows on the CPU that this recipe fits K2's bf16 tolerance (2e-2) on
the cases the card tests run (``FLASH_CASES``); that the kernel follows
the recipe is checked on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import FLASH_CASES, TOL, flash_inputs
from torch_parity import one_torch_thread  # noqa: F401  (autouse, module scope)

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as K2
from repro_torch.models.layers import NO_WINDOW

BLOCK_M = BLOCK_N = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
KWARGS = [dict(), dict(window=8, softcap=25.0), dict(causal=False)]


def tc_recipe(q, k, v, kv_lens, *, scale, causal=True, window=None, softcap=None):
    """K2's bf16 kernel, tile by tile: q [B, T, H, d], k/v [B, Tk, KV, d]
    (bf16), kv_lens [B]; returns o [B, T, H, d] in bf16."""
    B, T, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G, n_rows = H // KV, T * H // KV
    DP = next(p for p in (32, 64, 128, 256) if d <= p)
    win = NO_WINDOW if window is None else int(window)
    pad = lambda x, n: torch.nn.functional.pad(x.float(), (0, DP - d, 0, 0, 0, n))
    # folded rows [B, KV, rows, DP], padded to whole row and key tiles
    qf = pad(q, 0).reshape(B, T, KV, G, DP).transpose(1, 2).reshape(B, KV, n_rows, DP)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, -n_rows % BLOCK_M))
    kf, vf = (pad(x, BLOCK_N).transpose(1, 2) for x in (k, v))     # [B, KV, Tk + 64, DP]
    out = torch.zeros(B, KV, qf.shape[2], DP)
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
            m = torch.full((KV, BLOCK_M), NEG_INF)
            l = torch.zeros(KV, BLOCK_M)
            acc = torch.zeros(KV, BLOCK_M, DP)
            for t0 in range(t_begin, t_end, BLOCK_N):
                t = torch.arange(t0, t0 + BLOCK_N)
                loaded = (t < t_end)[:, None].float()                   # zero-filled past it
                K = kf[b, :, t0:t0 + BLOCK_N] * loaded
                V = vf[b, :, t0:t0 + BLOCK_N] * loaded
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
    out = out[:, :, :n_rows].reshape(B, KV, T, G, DP).transpose(1, 2)
    return out.reshape(B, T, H, DP)[..., :d].bfloat16()


def reference(q, k, v, kv_lens, *, scale, causal=True, window=None, softcap=None):
    """repro.models.layers.flash_attention on the same bf16 inputs."""
    B, T = q.shape[:2]
    Tk = k.shape[1]
    as_jnp = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)
    out = JL.flash_attention(
        as_jnp(q), as_jnp(k), as_jnp(v),
        q_positions=jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T)),
        kv_positions=jnp.broadcast_to(jnp.arange(Tk, dtype=jnp.int32), (B, Tk)),
        kv_valid_len=jnp.asarray(kv_lens.numpy()), scale=scale, causal=causal,
        window=window, attn_softcap=softcap)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _check(q, k, v, lens, scale, kw):
    q, k, v = (x.bfloat16() for x in (q, k, v))
    got = tc_recipe(q, k, v, lens, scale=scale, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    tol = TOL["bfloat16"]
    assert (got.float() - reference(q, k, v, lens, scale=scale, **kw)).abs().max() <= tol
    plain = K2.flash_attention_plain(q, k, v, lens, scale=scale, **kw)
    assert (got.float() - plain.float()).abs().max() <= tol
    return got


@pytest.mark.parametrize("kw", KWARGS, ids=["causal", "window+softcap", "non-causal"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_tile_recipe_matches_reference(case, kw):
    got = _check(*flash_inputs(case), 0.2, kw)
    if case[6] == 0:                            # an empty row writes exact zeros
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("kw", KWARGS, ids=["causal", "window+softcap", "non-causal"])
def test_tile_recipe_at_hybrid_geometry(kw):
    """The zamba2 shared attention's geometry (d = 112, G = 1, scale
    1/sqrt(112), normal inputs at scale 1 as chip_smoke's phase 3 makes
    them), cut to 1 x 256 tokens and 4 heads."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 4, 112)).astype(np.float32))
               for _ in range(3))
    _check(q, k, v, torch.tensor([256], dtype=torch.int32), 112 ** -0.5, kw)

