"""The port's RWKV-6 model against the reference, on the CPU, f32.

On ``rwkv6-7b.reduced()`` (2 layers, d_model 64, 4 heads of 16) with the
reference's weights: the chunkwise WKV scan on seeded inputs over T and
chunk sizes that do and do not divide, one layer, prefill (logits and
the stacked states), a prefill in two spans, decode and ``mixed``, decode
against the port's own full forward (the counterpart of
``tests/test_serve_consistency.py::test_rwkv_decode_matches_full``),
greedy streams, and the state dtypes in bf16.  The ``u`` bonus and the
``ln_x`` weights (zeros at init) are drawn at random so they are
exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_serving import rwkv_greedy_stream
from torch_parity import both_models, reduced_cfg

from repro.models import rwkv as JR
from repro.models import ssm as JS
from repro_torch.models import rwkv as PR
from repro_torch.models import ssm as PS
from repro_torch.models.transformer import layer_params

ARCH = "rwkv6-7b"
ATOL = 1e-4
WKV_ATOL = 1e-5
# the reference's steps jitted, as its engine runs them (cfg is static)
j_prefill = jax.jit(JR.prefill, static_argnums=1)
j_decode = jax.jit(JR.decode, static_argnums=1)
j_mixed = jax.jit(JR.mixed, static_argnums=1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def models():
    jm, jp, pm, pp = both_models(reduced_cfg(ARCH), arch=ARCH)
    rng = np.random.RandomState(0)
    for k in ("u", "ln_x"):
        w = (rng.standard_normal(jp["blocks"]["tmix"][k].shape) * 0.3).astype(np.float32)
        jp["blocks"]["tmix"][k] = jnp.asarray(w)
        pp["blocks"]["tmix"][k] = torch.from_numpy(w.copy())
    return jm, jp, pm, pp


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = tuple(v.shape)
    return out


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _states_close(ps, js, atol=ATOL):
    assert sorted(ps) == sorted(js)
    for k in js:
        assert tuple(ps[k].shape) == tuple(js[k].shape), k
        _close(ps[k], js[k], atol)


def test_params_match_reference_layout(models):
    jm, jp, pm, pp = models
    want = _flat(jp)
    assert _flat(pp) == want
    assert _flat(pm.init(torch.Generator().manual_seed(0), device="cpu")) == want


@pytest.mark.parametrize("s0", ["zero", "random"])
@pytest.mark.parametrize("chunk", [1, 8, 32])
@pytest.mark.parametrize("T", [1, 13, 64])
def test_wkv_chunk_matches_reference(T, chunk, s0):
    """o and the final state within 1e-5, f32, whether or not ``chunk``
    divides T."""
    B, H, K = 2, 4, 16
    rng = np.random.RandomState(T * 100 + chunk)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5 - 1.0)
    u = rng.standard_normal((H, K)).astype(np.float32) * 0.3
    S0 = (rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.5 if s0 == "random"
          else np.zeros((B, H, K, K), np.float32))
    jo, jS = JS.rwkv6_wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, lw, u, S0)), chunk=chunk)
    po, pS = PS.rwkv6_wkv_chunk(*(torch.from_numpy(a) for a in (r, k, v, lw, u, S0)),
                                chunk=chunk)
    assert po.dtype == pS.dtype == torch.float32
    assert tuple(po.shape) == (B, T, H, K) and tuple(pS.shape) == (B, H, K, K)
    _close(po, jo, WKV_ATOL)
    _close(pS, jS, WKV_ATOL)


def test_layer_matches_reference(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    shapes = PS.rwkv6_state_shapes(cfg, 2)
    st = {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()}
    jx, js = jax.jit(JS.rwkv6_layer, static_argnums=1, static_argnames="chunk")(
        jax.tree.map(lambda a: a[1], jp["blocks"]), cfg, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()}, chunk=8)
    px, ps = PS.rwkv6_layer(layer_params(pp["blocks"], 1), cfg, torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in st.items()}, chunk=8)
    _close(px, jx)
    _states_close(ps, js)


def test_prefill_matches_reference(models):
    jm, jp, pm, pp = models
    toks = _tokens(jm.cfg, 2, 40, 2)
    jl, js = j_prefill(jp, jm.cfg, jnp.asarray(toks))
    pl, ps = PR.prefill(pp, pm.cfg, torch.from_numpy(toks))
    V = jm.cfg.vocab_size
    _close(pl[:, :V], jl[:, :V])
    _states_close(ps, js)


def test_prefill_in_two_spans_equals_one(models):
    """The state carries across spans: 13 then 27 tokens (neither a
    multiple of the chunk) give the logits and state of 40 at once."""
    _, _, pm, pp = models
    toks = torch.from_numpy(_tokens(pm.cfg, 2, 40, 3))
    whole, st_whole = PR.prefill(pp, pm.cfg, toks)
    _, st = PR.prefill(pp, pm.cfg, toks[:, :13])
    split, st_split = PR.prefill(pp, pm.cfg, toks[:, 13:], state=st)
    _close(split, whole)
    _states_close(st_split, st_whole)


def test_decode_and_mixed_match_reference(models):
    """A decode step and a mixed step (prefill chunks of 12 beside two
    decode rows) from the same prefilled states in both packages."""
    jm, jp, pm, pp = models
    cfg, V = jm.cfg, jm.cfg.vocab_size
    toks = _tokens(cfg, 2, 20, 4)
    jl, js = j_prefill(jp, cfg, jnp.asarray(toks))
    pl, ps = PR.prefill(pp, cfg, torch.from_numpy(toks))
    nxt = np.asarray(jl.argmax(-1)).astype(np.int32)
    assert np.array_equal(nxt, _np(pl.argmax(-1)))
    jd, jds = j_decode(jp, cfg, jnp.asarray(nxt), js)
    pd, pds = PR.decode(pp, cfg, torch.from_numpy(nxt), ps)
    _close(pd[:, :V], jd[:, :V])
    _states_close(pds, jds)

    p_toks = _tokens(cfg, 3, 12, 5)
    jmb = {"p_tokens": jnp.asarray(p_toks), "d_tokens": jnp.asarray(nxt)}
    pmb = {"p_tokens": torch.from_numpy(p_toks), "d_tokens": torch.from_numpy(nxt)}
    jp_l, jd_l, jps, jds2 = j_mixed(jp, cfg, jmb, JR.init_state(cfg, 3), js)
    pp_l, pd_l, pps, pds2 = PR.mixed(pp, cfg, pmb, PR.init_state(cfg, 3, device="cpu"), ps)
    _close(pp_l[:, :V], jp_l[:, :V])
    _close(pd_l[:, :V], jd_l[:, :V])
    _states_close(pps, jps)
    _states_close(pds2, jds2)


def test_decode_matches_full_forward(models):
    _, _, pm, pp = models
    cfg = pm.cfg
    toks = torch.from_numpy(_tokens(cfg, 2, 8, 1))
    last, st = PR.prefill(pp, cfg, toks)
    nxt = last.argmax(-1)
    dl, _ = PR.decode(pp, cfg, nxt, st)
    fl, aux = PR.train_logits(pp, cfg, {"tokens": torch.cat([toks, nxt[:, None]], 1)})
    assert float(aux) == 0.0
    assert float((dl - fl[:, -1]).abs().max()) < 2e-3


def test_greedy_tokens_match_reference(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    toks = _tokens(cfg, 3, 16, 6)
    want, (logits, st) = [], j_prefill(jp, cfg, jnp.asarray(toks))
    for _ in range(8):
        nxt = logits.argmax(-1).astype(jnp.int32)
        want.append(np.asarray(nxt))
        logits, st = j_decode(jp, cfg, nxt, st)
    np.testing.assert_array_equal(rwkv_greedy_stream(pp, cfg, toks, 8), np.stack(want, 1))


def test_state_dtypes_match_reference_bf16(models):
    """bf16 params: S turns f32 after the first step, x_tm/x_cm stay in
    the activations' dtype, as in the reference."""
    jm, jp, pm, pp = models
    cfg = jm.cfg
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    pb = jax.tree.map(lambda t: t.to(torch.bfloat16), pp)
    toks = _tokens(cfg, 2, 10, 7)
    js0, ps0 = JR.init_state(cfg, 2, jnp.bfloat16), PR.init_state(cfg, 2, torch.bfloat16, "cpu")
    jl, js = j_prefill(jb, cfg, jnp.asarray(toks))
    pl, ps = PR.prefill(pb, cfg, torch.from_numpy(toks))
    jd, jds = j_decode(jb, cfg, jl.argmax(-1).astype(jnp.int32), js)
    pd, pds = PR.decode(pb, cfg, pl.argmax(-1), ps)
    name = lambda dt: str(dt).split(".")[-1]
    for jst, pst in ((js0, ps0), (js, ps), (jds, pds)):
        assert {k: name(v.dtype) for k, v in pst.items()} == \
            {k: name(v.dtype) for k, v in jst.items()}
    assert pd.dtype == torch.float32 and name(jd.dtype) == "float32"
    assert bool(torch.isfinite(pd[:, :cfg.vocab_size]).all())
