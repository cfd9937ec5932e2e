"""The rest of the transformer family in the port against the reference,
on the CPU, f32, on each arch's reduced config: opt-125m and
starcoder2-3b (2-matrix GELU MLP), phi4-mini-3.8b, gemma2-2b (post-
attention norms, embedding scale, softcaps, local/global windows),
olmoe-1b-7b and grok-1-314b (MoE), internvl2-2b (projected patch prefix).

Prefill, decode and mixed against the reference on the same weights and
pools; the first decode step against the full forward (the port's
counterpart of tests/test_serve_consistency.py's
``test_decode_matches_full_forward``); gemma2's window on the port's
attention; ``moe_apply`` and ``vision_prefix`` on their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import both_models, reduced_cfg

from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.layers import act_fn as jax_act_fn
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models.layers import act_fn
from repro_torch.models.registry import get_model

ATOL = 1e-4
ARCHS = ["opt-125m", "starcoder2-3b", "phi4-mini-3.8b", "gemma2-2b",
         "olmoe-1b-7b", "internvl2-2b", "grok-1-314b"]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return both_models(reduced_cfg(request.param), arch=request.param)


def _patches(cfg, B, seed=2):
    """Seeded patch embeds [B, Np, d_vision] for the VLM, else None."""
    if cfg.family != "vlm":
        return None
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, cfg.n_vision_patches, cfg.d_vision)) * 0.3
            ).astype(np.float32)


def _maybe(fn, a):
    return None if a is None else fn(a)


def test_every_arch_is_served_by_the_transformer(models):
    _, _, pm, _ = models
    assert pm.module is PT and pm.cache_kind == "paged"
    assert get_model(pm.name).cfg == get_config(pm.name)


def test_prefill_matches_reference(models):
    """Last logits and K/V of a 12-token prefill (past gemma2's reduced
    window of 8), the VLM with its 8-patch prefix."""
    jm, jp, pm, pp = models
    cfg = jm.cfg
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    patches = _patches(cfg, 2)
    jl, (jk, jv) = JT.prefill(jp, cfg, jnp.asarray(toks),
                              patches=_maybe(jnp.asarray, patches))
    pl, (pk, pv) = PT.prefill(pp, pm.cfg, torch.from_numpy(toks),
                              patches=_maybe(torch.from_numpy, patches))
    assert pk.shape[2] == 12 + (cfg.n_vision_patches if patches is not None else 0)
    np.testing.assert_allclose(_np(pl), _np(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk), _np(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv), _np(jv), atol=ATOL, rtol=0)


def _pools(cfg, n_pages, ps, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    return ((rng.standard_normal(shape) * 0.5).astype(np.float32),
            (rng.standard_normal(shape) * 0.5).astype(np.float32))


def test_decode_and_mixed_match_reference_on_same_pools(models):
    """One decode step and one mixed step (a padded chunk, an empty
    stream, an inactive decode row) on random pools, with histories past
    gemma2's reduced window."""
    jm, jp, pm, pp = models
    cfg = jm.cfg
    N, ps, W = 40, 4, 6
    k, v = _pools(cfg, N, ps, seed=2)
    rng = np.random.RandomState(3)
    perm = rng.permutation(N - 1)
    toks = rng.randint(0, cfg.vocab_size, size=3).astype(np.int32)
    bt = perm[:18].reshape(3, W).astype(np.int32)
    lens = np.asarray([5, 0, 19], np.int32)
    active = np.asarray([True, False, True])
    jl, (jk, jv) = JT.decode(jp, cfg, jnp.asarray(toks), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(bt), jnp.asarray(lens), active=jnp.asarray(active))
    pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    pl, _ = PT.decode(pp, pm.cfg, torch.from_numpy(toks), pk, pv, torch.from_numpy(bt),
                      torch.from_numpy(lens), active=torch.from_numpy(active))
    np.testing.assert_allclose(_np(pl), _np(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk), _np(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv), _np(jv), atol=ATOL, rtol=0)

    mb = dict(p_tokens=rng.randint(0, cfg.vocab_size, size=(2, 4)).astype(np.int32),
              p_table=perm[18:32].reshape(2, W + 1).astype(np.int32),
              p_start=np.asarray([14, 0], np.int32), p_lens=np.asarray([3, 0], np.int32),
              d_tokens=toks, d_table=bt, d_lens=np.asarray([9, 0, 2], np.int32),
              d_active=active)
    jpl, jdl, (jk, jv), _ = JT.mixed(jp, cfg, {a: jnp.asarray(b) for a, b in mb.items()},
                                     jnp.asarray(k), jnp.asarray(v))
    pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ppl, pdl, _ = PT.mixed(pp, pm.cfg, {a: torch.from_numpy(b) for a, b in mb.items()},
                           pk, pv)
    np.testing.assert_allclose(_np(ppl)[0], _np(jpl)[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pdl)[[0, 2]], _np(jdl)[[0, 2]], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk)[:, :-1], _np(jk)[:, :-1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(pv)[:, :-1], _np(jv)[:, :-1], atol=ATOL, rtol=0)


def test_decode_matches_full_forward(models):
    """Prefill 16 tokens (plus the VLM's prefix), lay the K/V out as pages,
    decode the greedy next token: its logits equal the prefill's over the
    17 tokens (the full forward)."""
    _, _, pm, pp = models
    cfg = pm.cfg
    B, S, ps = 2, 16, 8
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, size=(B, S)))
    patches = _maybe(torch.from_numpy, _patches(cfg, B))
    last, (k, v) = PT.prefill(pp, cfg, toks, patches=patches)
    S_tot, per = k.shape[2], k.shape[2] // ps
    kpg, vpg = PT.kv_to_pages(k, ps), PT.kv_to_pages(v, ps)
    pad = torch.zeros((cfg.n_layers, B) + tuple(kpg.shape[2:]))
    kpg, vpg = torch.cat([kpg, pad, pad[:, :1]], 1), torch.cat([vpg, pad, pad[:, :1]], 1)
    bt = torch.zeros((B, per + 1), dtype=torch.int32)
    for b in range(B):
        bt[b, :per] = torch.arange(per) + b * per
        bt[b, per] = B * per + b
    nxt = last.argmax(-1)
    dl, _ = PT.decode(pp, cfg, nxt, kpg, vpg, bt, torch.full((B,), S_tot))
    fl, _ = PT.prefill(pp, cfg, torch.cat([toks, nxt[:, None]], 1), patches=patches)
    assert float((dl - fl).abs().max()) < 2e-3


def test_gemma2_sliding_window_masks_old_tokens():
    """Port of test_serve_consistency::test_gemma2_sliding_window_masks_old_tokens
    on the port's attention: a key outside every late query's window does
    not move those queries' outputs, and does move an early one's."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 12, 2, 8)).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([12], dtype=torch.int32)
    o_w = ops.flash_attention(q, k, v, lens, scale=1.0, window=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 10.0
    v2[:, 0] += 10.0
    o_w2 = ops.flash_attention(q, k2, v2, lens, scale=1.0, window=4)
    assert torch.allclose(o_w[:, 11], o_w2[:, 11], atol=1e-5)
    assert not torch.allclose(o_w[:, 2], o_w2[:, 2], atol=1e-5)


def test_gemma2_windows_alternate_local_global():
    cfg = get_config("gemma2-2b")
    w = PT.layer_windows(cfg)
    assert list(w[:4]) == [4096, PT.NO_WINDOW, 4096, PT.NO_WINDOW] and len(w) == 26


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_apply_matches_reference(capacity_factor, act):
    """Output and aux loss at no-drop capacity (E / K) and at a capacity
    that drops tokens (overflow to the trash slot, token-major priority);
    a repeated token row ties its router scores across rows, and an
    all-zero row ties every expert (top-k to the lower ids)."""
    T, D, F, E, K = 24, 16, 32, 4, 2
    rng = np.random.RandomState(0)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[5] = x[4]
    x[7] = 0.0
    lp = {"router": rng.standard_normal((D, E)).astype(np.float32) / 4,
          "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
          "w_up": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
          "w_down": rng.standard_normal((E, F, D)).astype(np.float32) / 6}
    kw = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor)
    jy, jaux = JM.moe_apply({n: jnp.asarray(a) for n, a in lp.items()}, jnp.asarray(x),
                            act=jax_act_fn(act), **kw)
    py, paux = PM.moe_apply({n: torch.from_numpy(a) for n, a in lp.items()},
                            torch.from_numpy(x), act=act_fn(act), **kw)
    np.testing.assert_allclose(_np(py), _np(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), atol=1e-6, rtol=0)
    if capacity_factor < 1:                        # some token-expert pairs dropped
        full, _ = PM.moe_apply({n: torch.from_numpy(a) for n, a in lp.items()},
                               torch.from_numpy(x), act=act_fn(act), n_experts=E,
                               top_k=K, capacity_factor=E / K)
        assert float((full - py).abs().max()) > 1e-3
        # the first tokens claim capacity first: token 0 is never dropped
        np.testing.assert_allclose(_np(py)[0], _np(full)[0], atol=1e-6)


def test_vision_prefix_matches_reference():
    cfg = reduced_cfg("internvl2-2b")
    jm, jp, pm, pp = both_models(cfg, arch="internvl2-2b")
    patches = _patches(cfg, 3)
    want = JT.vision_prefix(jp, cfg, jnp.asarray(patches))
    got = PT.vision_prefix(pp, pm.cfg, torch.from_numpy(patches))
    assert got.shape == (3, cfg.n_vision_patches, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,path", [("gemma2-2b", ("blocks", "ln1b")),
                                       ("gemma2-2b", ("blocks", "ln2b")),
                                       ("olmoe-1b-7b", ("blocks", "moe")),
                                       ("internvl2-2b", ("proj",))])
def test_params_from_jax_carries_every_family_tree(arch, path):
    """The converted tree holds the reference's post-norm, moe and proj
    subtrees unchanged (names, shapes, values), and the port's own init
    draws the same tree."""
    _, jp, pm, pp = both_models(reduced_cfg(arch), arch=arch)
    want = jax.tree.map(np.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), pp) == want
    own = pm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == want
    jsub, psub = jp, pp
    for key in path:
        jsub, psub = jsub[key], psub[key]
    jax.tree.map(lambda j, p: np.testing.assert_array_equal(_np(p), np.asarray(j)),
                 jsub, psub)
