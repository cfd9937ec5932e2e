"""The port's zamba2 hybrid against the reference, on the CPU, f32.

On ``zamba2-7b.reduced()`` (one group: 1 Mamba2 block + the shared
attention) and on a 5-unit variant (2 attention invocations, 3 Mamba2
blocks, the last one trailing): parameter layout, prefill logits, K/V
and states, decode on identical pools and states, the counterpart of
``tests/test_serve_consistency.py::test_hybrid_decode_matches_full``,
and greedy streams.  LoRA ``b`` matrices (zeros at init) are drawn at
random so the per-invocation deltas are exercised.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_serving import greedy_stream, pool_from_prefill, tables
from torch_parity import both_models, reduced_cfg

from repro.models import hybrid as JH
from repro.models import transformer as JT
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine
from repro_torch.models import hybrid as PH
from repro_torch.models.registry import get_model

ARCH = "zamba2-7b"
ATOL = 1e-4

CFGS = {
    "reduced": lambda: reduced_cfg(ARCH),
    # 5 units at every 2nd: 2 attention invocations, 3 Mamba2 (1 trailing)
    "5-unit": lambda: reduced_cfg(ARCH, n_layers=5, shared_attn_every=2),
}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module", params=sorted(CFGS))
def models(request):
    jm, jp, pm, pp = both_models(CFGS[request.param](), arch=ARCH)
    rng = np.random.RandomState(0)
    for k in ("qb", "kb", "vb"):
        b = (rng.standard_normal(jp["lora"][k].shape) * 0.1).astype(np.float32)
        jp["lora"][k] = jnp.asarray(b)
        pp["lora"][k] = torch.from_numpy(b.copy())
    return jm, jp, pm, pp


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = tuple(v.shape)
    return out


def test_group_structure_counts():
    assert PH.group_structure(get_config(ARCH)) == (13, 68, 65, 3, 5)
    assert PH.group_structure(CFGS["5-unit"]()) == (2, 3, 2, 1, 1)


def test_params_match_reference_layout(models):
    jm, jp, pm, pp = models
    want = _flat(jp)
    assert _flat(pp) == want
    own = pm.init(torch.Generator().manual_seed(0), device="cpu")
    assert _flat(own) == want


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_prefill_matches_reference(models):
    jm, jp, pm, pp = models
    toks = _tokens(jm.cfg, 2, 12, 1)
    jl, (jk, jv), (jc, js) = JH.prefill(jp, jm.cfg, jnp.asarray(toks))
    pl, (pk, pv), (pc, ps) = PH.prefill(pp, pm.cfg, torch.from_numpy(toks))
    for got, want in [(pl, jl), (pk, jk), (pv, jv), (ps, js)] + [(pc[k], jc[k]) for k in jc]:
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def _decode_inputs(cfg, seed):
    """Random pools, states, table, lens and active rows, as numpy."""
    n_attn, n_mamba = JH.group_structure(cfg)[:2]
    rng = np.random.RandomState(seed)
    B, ps, N, W = 3, 4, 20, 5
    pool = (n_attn, N, ps, cfg.n_kv_heads, cfg.head_dim)
    k, v = ((rng.standard_normal(pool) * 0.5).astype(np.float32) for _ in range(2))
    conv_s, ssm_s = JH.ssm.mamba2_state_shapes(cfg, B)
    conv = {n: (rng.standard_normal((n_mamba,) + s) * 0.5).astype(np.float32)
            for n, s in conv_s.items()}
    sst = (rng.standard_normal((n_mamba,) + ssm_s) * 0.1).astype(np.float32)
    bt = rng.permutation(N - 1)[: B * W].reshape(B, W).astype(np.int32)
    lens = np.asarray([5, 0, 13], np.int32)
    active = np.asarray([True, False, True])
    toks = rng.randint(0, cfg.vocab_size, size=B).astype(np.int32)
    return toks, conv, sst, k, v, bt, lens, active


def test_decode_matches_reference_on_same_pools(models):
    jm, jp, pm, pp = models
    toks, conv, sst, k, v, bt, lens, active = _decode_inputs(jm.cfg, 2)
    jl, (jc, js), (jk, jv) = JH.decode(
        jp, jm.cfg, jnp.asarray(toks), {n: jnp.asarray(a) for n, a in conv.items()},
        jnp.asarray(sst), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lens), active=jnp.asarray(active))
    t = lambda a: torch.from_numpy(a.copy())
    pconv, psst, pk, pv = {n: t(a) for n, a in conv.items()}, t(sst), t(k), t(v)
    pl, (pc, ps), (pk2, pv2) = PH.decode(
        pp, pm.cfg, t(toks), pconv, psst, pk, pv, t(bt), t(lens), active=t(active))
    assert pk2 is pk and pv2 is pv and ps is psst and pc is pconv   # in place
    pairs = [(pl, jl), (pk, jk), (pv, jv), (ps, js)] + [(pc[n], jc[n]) for n in jc]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_decode_matches_full_forward(models):
    """test_hybrid_decode_matches_full, port-side: one decode step after a
    prefill equals the full forward's last position, < 2e-3."""
    _, _, pm, pp = models
    cfg = pm.cfg
    B, S, ps = 2, 8, 4
    toks = torch.from_numpy(_tokens(cfg, B, S, 1))
    last, (k, v), (conv, sst) = PH.prefill(pp, cfg, toks)
    kpg, vpg, N0 = pool_from_prefill(k, v, ps, extra=6)
    bt = torch.from_numpy(tables(B, S, ps, N0, new_pages=1))
    nxt = last.argmax(-1)
    dl, _, _ = PH.decode(pp, cfg, nxt, conv, sst, kpg, vpg, bt, torch.full((B,), S))
    fl, _ = PH.train_logits(pp, cfg, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    assert float((dl - fl[:, -1]).abs().max()) < 2e-3


def _jax_greedy(jp, cfg, toks, steps, ps):
    last, (k, v), (conv, sst) = JH.prefill(jp, cfg, jnp.asarray(toks))
    kpg, vpg = JT.kv_to_pages(k, ps), JT.kv_to_pages(v, ps)
    N0 = kpg.shape[1]
    new = -(-steps // ps)
    pad = jnp.zeros((kpg.shape[0], toks.shape[0] * new + 1) + kpg.shape[2:], kpg.dtype)
    kpg, vpg = jnp.concatenate([kpg, pad], 1), jnp.concatenate([vpg, pad], 1)
    bt = jnp.asarray(tables(*toks.shape, ps, N0, new, width=toks.shape[1] // ps + new))
    out, nxt = [], last.argmax(-1).astype(jnp.int32)
    for i in range(steps):
        out.append(np.asarray(nxt))
        lens = jnp.full((toks.shape[0],), toks.shape[1] + i, jnp.int32)
        logits, (conv, sst), (kpg, vpg) = JH.decode(jp, cfg, nxt, conv, sst, kpg, vpg, bt, lens)
        nxt = logits.argmax(-1).astype(jnp.int32)
    return np.stack(out, 1)


def test_greedy_decode_matches_reference(models):
    jm, jp, pm, pp = models
    toks = _tokens(jm.cfg, 2, 8, 3)
    want = _jax_greedy(jp, jm.cfg, toks, 8, ps=4)
    got = greedy_stream(pp, pm.cfg, toks, 8, ps=4)
    np.testing.assert_array_equal(got, want)


def test_registry_serves_zamba2_with_paged_state_cache():
    model = get_model(ARCH)
    assert model.cache_kind == "paged+state" and model.module is PH
    small = get_model(ARCH, get_config(ARCH).reduced())
    params = small.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert params["mamba"]["wz"].shape[0] == PH.group_structure(small.cfg)[1]


def test_engine_refuses_hybrid_models():
    """As the reference's Engine does: the hybrid is served at model level."""
    model = get_model(ARCH, get_config(ARCH).reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    serve = ServeConfig(mode="sequential", max_batch=2, page_size=4, n_pages=16,
                        max_pages_per_seq=4, sanitize_level="off", dispatch_sentinel=False)
    with pytest.raises(TypeError, match="paged"):
        Engine(model, params, serve, device="cpu")

