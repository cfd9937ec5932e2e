"""The port's dense transformer against the reference, on the CPU, f32.

prefill / decode / mixed logits on identical weights and pools, the
port's counterparts of tests/test_serve_consistency.py's decode and
chunked-prefill equivalences, and one case at qwen3-0.6b's real head
geometry (hd 128, 16 q / 8 kv heads) with a small depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import both_models, reduced_cfg

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.models import transformer as PT

ATOL = 1e-4


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pools(cfg, n_pages, ps, seed):
    """Random page pools, the same numbers for both packages."""
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    k = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return k, v


CFGS = {
    "reduced": lambda: reduced_cfg(),
    # qwen3-0.6b's real head geometry at a small depth and vocab
    "real-heads": lambda: dataclasses.replace(jax_get_config("qwen3-0.6b"),
                                              n_layers=2, vocab_size=512),
}


@pytest.fixture(scope="module", params=sorted(CFGS))
def models(request):
    return both_models(CFGS[request.param]())


def test_prefill_matches_reference(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, (jk, jv) = JT.prefill(jp, cfg, jnp.asarray(toks))
    pl, (pk, pv) = PT.prefill(pp, pm.cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(pl), _np(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk), _np(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv), _np(jv), atol=ATOL, rtol=0)


def test_decode_matches_reference_on_same_pools(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    B, ps, N, W = 3, 4, 20, 5
    k, v = _pools(cfg, N, ps, seed=2)
    rng = np.random.RandomState(3)
    bt = rng.permutation(N - 1)[: B * W].reshape(B, W).astype(np.int32)
    lens = np.asarray([5, 0, 13], np.int32)
    active = np.asarray([True, False, True])
    toks = rng.randint(0, cfg.vocab_size, size=B).astype(np.int32)
    jl, (jk, jv) = JT.decode(jp, cfg, jnp.asarray(toks), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lens), active=jnp.asarray(active))
    pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    pl, (pk2, pv2) = PT.decode(pp, pm.cfg, torch.from_numpy(toks), pk, pv,
                               torch.from_numpy(bt), torch.from_numpy(lens),
                               active=torch.from_numpy(active))
    assert pk2 is pk and pv2 is pv                  # pools written in place
    np.testing.assert_allclose(_np(pl), _np(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk), _np(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv), _np(jv), atol=ATOL, rtol=0)


def test_mixed_matches_reference_on_same_pools(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    P, C, B, ps, N, W = 2, 4, 3, 4, 40, 6
    k, v = _pools(cfg, N, ps, seed=4)
    rng = np.random.RandomState(5)
    perm = rng.permutation(N - 1)
    mb = dict(
        p_tokens=rng.randint(0, cfg.vocab_size, size=(P, C)).astype(np.int32),
        # one spare column, as the engine's suffix prefill gives it
        p_table=perm[: P * (W + 1)].reshape(P, W + 1).astype(np.int32),
        p_start=np.asarray([6, 0], np.int32),
        p_lens=np.asarray([3, 0], np.int32),       # a padded and an empty stream
        d_tokens=rng.randint(0, cfg.vocab_size, size=B).astype(np.int32),
        d_table=perm[P * (W + 1):][: B * W].reshape(B, W).astype(np.int32),
        d_lens=np.asarray([9, 0, 2], np.int32),
        d_active=np.asarray([True, False, True]),
    )
    jpl, jdl, (jk, jv), _ = JT.mixed(jp, cfg, {a: jnp.asarray(b) for a, b in mb.items()},
                                     jnp.asarray(k), jnp.asarray(v))
    pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ppl, pdl, _ = PT.mixed(pp, pm.cfg, {a: torch.from_numpy(b) for a, b in mb.items()},
                           pk, pv)
    np.testing.assert_allclose(_np(ppl)[0], _np(jpl)[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pdl)[[0, 2]], _np(jdl)[[0, 2]], atol=ATOL, rtol=0)
    # every page but the trash page (where padded rows land) matches
    np.testing.assert_allclose(_np(pk)[:, :-1], _np(jk)[:, :-1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv)[:, :-1], _np(jv)[:, :-1], atol=ATOL, rtol=0)


def _pool_from_prefill(k, v, ps, extra=6):
    kpg, vpg = PT.kv_to_pages(k, ps), PT.kv_to_pages(v, ps)
    L, N0 = kpg.shape[:2]
    pad = torch.zeros((L, extra) + tuple(kpg.shape[2:]), dtype=kpg.dtype)
    return torch.cat([kpg, pad], 1), torch.cat([vpg, pad], 1), N0


def test_decode_matches_full_forward(models):
    """Port of test_serve_consistency::test_decode_matches_full_forward."""
    _, _, pm, pp = models
    cfg = pm.cfg
    B, S, ps = 2, 16, 8
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, size=(B, S)))
    last, (k, v) = PT.prefill(pp, cfg, toks)
    kpg, vpg, N0 = _pool_from_prefill(k, v, ps)
    per = S // ps
    bt = torch.zeros((B, 8), dtype=torch.int32)
    for b in range(B):
        bt[b, :per] = torch.arange(per) + b * per
        bt[b, per] = N0 + b
    nxt = last.argmax(-1)
    dl, _ = PT.decode(pp, cfg, nxt, kpg, vpg, bt, torch.full((B,), S))
    fl, _ = PT.prefill(pp, cfg, torch.cat([toks, nxt[:, None]], 1))
    assert float((dl - fl).abs().max()) < 2e-3


def test_mixed_chunked_prefill_matches_full(models):
    """Port of test_serve_consistency::test_mixed_chunked_prefill_matches_full."""
    _, _, pm, pp = models
    cfg = pm.cfg
    S, ps, C = 16, 4, 4
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, size=(1, S)))
    full_last, _ = PT.prefill(pp, cfg, toks)
    kpg, vpg = PT.init_pages(cfg, 16, ps, device="cpu")
    bt = torch.tensor([[0, 1, 2, 3, 4, 5]], dtype=torch.int32)
    for i in range(S // C):
        mb = dict(p_tokens=toks[:, i * C:(i + 1) * C], p_table=bt,
                  p_start=torch.tensor([i * C]), p_lens=torch.tensor([C]),
                  d_tokens=torch.zeros(2, dtype=torch.int32),
                  d_table=torch.zeros((2, 6), dtype=torch.int32),
                  d_lens=torch.zeros(2, dtype=torch.int32),
                  d_active=torch.zeros(2, dtype=torch.bool))
        out, _, _ = PT.mixed(pp, cfg, mb, kpg, vpg)
    assert float((out[0] - full_last[0]).abs().max()) < 2e-3


def test_write_kv_chunk_clamps_past_the_table_like_jax():
    """Padded chunk rows may look up a page column past the table; JAX
    clamps the gather, the port clamps before it, and both route the row
    to the trash page."""
    rng = np.random.RandomState(6)
    N, ps, KV, d, P, C = 10, 4, 2, 8, 2, 8
    kpg = np.zeros((N, ps, KV, d), np.float32)
    k = rng.standard_normal((P, C, KV, d)).astype(np.float32)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)           # 8 positions per row
    start, lens = np.asarray([5, 0], np.int32), np.asarray([3, 8], np.int32)
    jk, _ = JT.write_kv_chunk(*map(jnp.asarray, (kpg, kpg, k, k, bt, start, lens)))
    pk, _ = PT.write_kv_chunk(*map(torch.from_numpy, (kpg.copy(), kpg.copy(), k, k,
                                                      bt, start, lens)))
    np.testing.assert_array_equal(_np(pk)[:-1], _np(jk)[:-1])


def test_init_params_shapes_match_reference():
    cfg = reduced_cfg()
    jp = jax.tree.map(np.shape, JT.init_params(cfg, jax.random.PRNGKey(0)))
    from torch_parity import port_model
    pp = PT.init_params(port_model(cfg).cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert shapes == jax.tree.map(tuple, jp, is_leaf=lambda x: isinstance(x, tuple))
