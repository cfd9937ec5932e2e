"""The port's int8 KV path against the reference's, on the CPU.

Bottom-up, as tests/test_int8_kv.py does for the reference: the
quantizer (bit-equal codes and scales), the plain version of kernel K3
against the reference's jnp oracle and its Pallas kernel in interpret
mode, decode/mixed logits on the same int8 pools, and the engine with
``kv_dtype="int8"`` against the reference's int8 engine — greedy
streams, step kinds, scheduler events and the int8 pool accounting — in
all four modes, with the prefix cache and under preemption, both sides
under the step sanitizer.  Inputs come from numpy seeds.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import (MODES, SYSTEM, _pressure_prompts, _shared_prefix_prompts,
                               _system_prompts)
from test_torch_layers import PAGED_CASES
from torch_parity import both_models, reduced_cfg
from torch_parity import reduced_models as shared_reduced_models

from repro.configs import ServeConfig as JServeConfig
from repro.configs import get_config as jax_get_config
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro.kernels import kv_int8 as JQ
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import ServeConfig as PServeConfig
from repro_torch.core.engine import Engine as PEngine
from repro_torch.core.engine import Request as PRequest
from repro_torch.core.sampler import SamplingParams as PSampling
from repro_torch.kernels import kv_int8 as PQ
from repro_torch.kernels import ops as pops
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.models import transformer as PT

ATTN_ATOL = 1e-5       # f32 attention, same algorithm, summation order differs
LOGIT_ATOL = 1e-4      # f32 logits through a 2-layer stack (as test_torch_transformer)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ quantizer ----
def _q8_inputs(kind):
    rng = np.random.RandomState(0)
    if kind == "normal":
        return (rng.standard_normal((4, 8, 2, 64)) * 2.0).astype(np.float32)
    if kind == "all_zero":
        return np.zeros((2, 8, 2, 32), np.float32)
    if kind == "single_token_tail_page":
        page = np.zeros((1, 8, 2, 32), np.float32)
        page[0, 0] = rng.standard_normal((2, 32)) * 3.0
        return page
    # halves: values that land exactly on .5 code steps (round half to even)
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    return np.tile(row, (3, 2, 1))


@pytest.mark.parametrize("kind", ["normal", "all_zero", "single_token_tail_page", "halves"])
def test_q8_kv_bit_equal_to_reference(kind):
    x = _q8_inputs(kind)
    pq, ps = PQ.q8_kv(torch.from_numpy(x.copy()))
    jq, js = JQ.q8_kv(jnp.asarray(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(_np(pq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ps), np.asarray(js))
    if kind in ("all_zero", "single_token_tail_page"):
        zero_rows = (x == 0).all(-1)
        assert (_np(ps)[zero_rows] == PQ.SCALE_FLOOR).all()
        assert (_np(pq)[zero_rows] == 0).all()


def test_fake_quant_kv_equal_to_reference():
    x = (np.random.RandomState(1).standard_normal((2, 6, 4, 32)) * 0.7).astype(np.float32)
    np.testing.assert_array_equal(_np(PQ.fake_quant_kv(torch.from_numpy(x))),
                                  np.asarray(JQ.fake_quant_kv(jnp.asarray(x))))


def test_init_pages_int8_matches_reference():
    cfg = reduced_cfg()
    pk, pv = PQ.init_pages_int8(cfg, 6, 4, device="cpu")
    jk, jv = JQ.init_pages_int8(cfg, 6, 4)
    for p, j in ((pk, jk), (pv, jv)):
        assert set(p) == set(j) == {"q", "s"}
        for name in ("q", "s"):
            np.testing.assert_array_equal(_np(p[name]), np.asarray(j[name]))


# ------------------------------------------------------- K3 plain version --
def _int8_paged_inputs(seed, B, Tq, H, KV, d, ps, N, Pmax):
    """K1's test inputs (test_torch_layers._paged_inputs) with the pages
    quantized by the reference's q8_kv."""
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((B, Tq, H, d)) * 0.5).astype(np.float32)
    kq, ks = map(np.asarray, JQ.q8_kv(jnp.asarray(
        (rng.standard_normal((N, ps, KV, d)) * 0.5).astype(np.float32))))
    vq, vs = map(np.asarray, JQ.q8_kv(jnp.asarray(
        (rng.standard_normal((N, ps, KV, d)) * 0.5).astype(np.float32))))
    bt = rng.permutation(N - 1)[: B * Pmax].reshape(B, Pmax).astype(np.int32)
    q_pos = rng.randint(0, Pmax * ps - Tq, size=B).astype(np.int32)
    return q, kq, ks, vq, vs, bt, q_pos + Tq, q_pos


def _close(port, ref, atol=ATTN_ATOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), atol=atol, rtol=0)


CASES = [(c, None, None) for c in PAGED_CASES] + [
    ((2, 4, 4, 2, 64, 8, 16, 4), 20.0, None),
    ((2, 4, 4, 2, 64, 8, 16, 4), None, 7),
    ((2, 4, 4, 2, 64, 8, 16, 4), 30.0, 5)]


@pytest.mark.parametrize("case,softcap,window", CASES)
def test_int8_plain_matches_reference_oracle_and_pallas(case, softcap, window):
    args = _int8_paged_inputs(0, *case)
    q, kq, ks, vq, vs, bt, lens, q_pos = args
    targs = [torch.from_numpy(np.array(a)) for a in args]
    port = K3.paged_attention_int8(*targs, scale=0.2, softcap=softcap, window=window)
    Tq = q.shape[1]
    oracle = JQ.paged_attention_int8(
        *map(jnp.asarray, (q, kq, ks, vq, vs, bt, lens)),
        jnp.asarray(q_pos[:, None] + np.arange(Tq, dtype=np.int32)[None]),
        scale=0.2, window=window, attn_softcap=softcap)
    pallas = jops.paged_attention_int8(*map(jnp.asarray, args), scale=0.2,
                                       softcap=softcap, window=window, interpret=True)
    _close(port, oracle)
    _close(port, pallas)
    # the model-layout adapter takes the same path
    _close(pops.paged_attention_int8(*targs, scale=0.2, softcap=softcap, window=window),
           oracle)


def test_int8_wrapper_checks_arguments_and_counts_only_launches():
    args = [torch.from_numpy(np.array(a)) for a in _int8_paged_inputs(2, *PAGED_CASES[0])]
    before = K3.launches
    K3.paged_attention_int8(*args, scale=0.3)              # CPU: plain version
    bad_codes = [args[0], args[1].float()] + args[2:]
    with pytest.raises(ValueError, match="int8 codes"):
        K3.paged_attention_int8(*bad_codes, scale=0.3)
    bad_scales = args[:2] + [args[2].double()] + args[3:]
    with pytest.raises(ValueError, match="float32"):
        K3.paged_attention_int8(*bad_scales, scale=0.3)
    with pytest.raises(ValueError, match=r"k_scales/v_scales must be"):
        K3.paged_attention_int8(*(args[:2] + [args[2][..., :1, :]] + args[3:]), scale=0.3)
    with pytest.raises(ValueError, match="block_table"):
        K3.paged_attention_int8(*(args[:5] + [args[5][:1]] + args[6:]), scale=0.3)
    assert K3.launches == before


# ------------------------------------------------------------ transformer --
CFGS = {
    "reduced": lambda: reduced_cfg(),
    "real-heads": lambda: dataclasses.replace(jax_get_config("qwen3-0.6b"),
                                              n_layers=2, vocab_size=512),
}


@pytest.fixture(scope="module", params=sorted(CFGS))
def models(request):
    return both_models(CFGS[request.param]())


@pytest.fixture(scope="module")
def reduced_models():
    """The reduced model alone.  At qwen3's real head geometry the two
    frameworks' fp K/V (equal to ~1e-5) straddle a rounding boundary of
    the quantizer for a few of ~50k elements: those codes differ by one
    step (~0.03) and move a logit by ~1e-3.  The quantizer is bit-equal on
    equal inputs (test_q8_kv_bit_equal_to_reference), so the tests that
    quantize freshly computed K/V at every position (fake-quant prefill,
    the mixed step's chunk) compare on the reduced model."""
    return shared_reduced_models()


def _int8_pools(cfg, n_pages, ps, seed):
    """Random int8 pools, the same numbers for both packages."""
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads)
    pools = []
    for _ in range(2):
        codes = rng.randint(-127, 128, size=shape + (cfg.head_dim,)).astype(np.int8)
        scales = rng.uniform(1e-3, 1e-2, size=shape + (1,)).astype(np.float32)
        pools.append({"q": codes, "s": scales})
    return pools


def _as_torch(pool):
    return {n: torch.from_numpy(a.copy()) for n, a in pool.items()}


def _as_jax(pool):
    return {n: jnp.asarray(a) for n, a in pool.items()}


def test_fake_quant_prefill_matches_reference(reduced_models):
    jm, jp, pm, pp = reduced_models
    toks = np.random.RandomState(1).randint(0, jm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, (jk, _) = JT.prefill(jp, jm.cfg, jnp.asarray(toks), kv_fake_quant=JQ.fake_quant_kv)
    pl, (pk, _) = PT.prefill(pp, pm.cfg, torch.from_numpy(toks), kv_fake_quant=PQ.fake_quant_kv)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(pk), np.asarray(jk), atol=LOGIT_ATOL, rtol=0)  # collected fp


def test_int8_decode_matches_reference_on_same_pools(models):
    jm, jp, pm, pp = models
    cfg = jm.cfg
    B, ps, N, W = 3, 4, 20, 5
    kpool, vpool = _int8_pools(cfg, N, ps, seed=2)
    rng = np.random.RandomState(3)
    bt = rng.permutation(N - 1)[: B * W].reshape(B, W).astype(np.int32)
    lens = np.asarray([5, 0, 13], np.int32)
    active = np.asarray([True, False, True])
    toks = rng.randint(0, cfg.vocab_size, size=B).astype(np.int32)
    jl, (jk, _) = JT.decode(jp, cfg, jnp.asarray(toks), _as_jax(kpool), _as_jax(vpool),
                            jnp.asarray(bt), jnp.asarray(lens), active=jnp.asarray(active),
                            attn_fn=JQ.int8_decode_attn)
    pk, pv = _as_torch(kpool), _as_torch(vpool)
    pl, (pk2, _) = PT.decode(pp, pm.cfg, torch.from_numpy(toks), pk, pv,
                             torch.from_numpy(bt), torch.from_numpy(lens),
                             active=torch.from_numpy(active))
    assert pk2 is pk                                   # pools written in place
    np.testing.assert_allclose(_np(pl)[[0, 2]], np.asarray(jl)[[0, 2]],
                               atol=LOGIT_ATOL, rtol=0)
    # the written scales agree (every page but the trash page)
    np.testing.assert_allclose(_np(pk["s"])[:, :-1], np.asarray(jk["s"])[:, :-1],
                               rtol=1e-5, atol=0)


def test_int8_mixed_matches_reference_on_same_pools(reduced_models):
    jm, jp, pm, pp = reduced_models
    cfg = jm.cfg
    P, C, B, ps, N, W = 2, 4, 3, 4, 40, 6
    kpool, vpool = _int8_pools(cfg, N, ps, seed=4)
    rng = np.random.RandomState(5)
    perm = rng.permutation(N - 1)
    mb = dict(
        p_tokens=rng.randint(0, cfg.vocab_size, size=(P, C)).astype(np.int32),
        p_table=perm[: P * (W + 1)].reshape(P, W + 1).astype(np.int32),
        p_start=np.asarray([6, 0], np.int32),
        p_lens=np.asarray([3, 0], np.int32),       # a padded and an empty stream
        d_tokens=rng.randint(0, cfg.vocab_size, size=B).astype(np.int32),
        d_table=perm[P * (W + 1):][: B * W].reshape(B, W).astype(np.int32),
        d_lens=np.asarray([9, 0, 2], np.int32),
        d_active=np.asarray([True, False, True]),
    )
    jpl, jdl, _, _ = JT.mixed(jp, cfg, {a: jnp.asarray(b) for a, b in mb.items()},
                              _as_jax(kpool), _as_jax(vpool),
                              attn_fn={"decode": JQ.int8_decode_attn,
                                       "chunk": JQ.int8_chunk_attn})
    ppl, pdl, _ = PT.mixed(pp, pm.cfg, {a: torch.from_numpy(b) for a, b in mb.items()},
                           _as_torch(kpool), _as_torch(vpool))
    np.testing.assert_allclose(_np(ppl)[0], np.asarray(jpl)[0], atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(pdl)[[0, 2]], np.asarray(jdl)[[0, 2]],
                               atol=LOGIT_ATOL, rtol=0)


# ------------------------------------------------------------------ engine --
def _run(engine_cls, req_cls, sp_cls, model, params, serve, prompts, n_new, **kw):
    eng = engine_cls(model, params, serve, **kw)
    reqs = [req_cls(rid=i, prompt=[int(t) for t in p], sampling=sp_cls(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]
    m = eng.run(reqs, max_steps=4000)
    events = [{k: v for k, v in e.items() if k != "t"} for e in m.sched_events]
    return dict(tokens=[r.out_tokens for r in reqs], kinds=list(m.step_kinds),
                events=events, n_quant_pages=m.n_quant_pages, n_pages=eng.alloc.n_pages,
                kv_pool_bytes=m.kv_pool_bytes, summary=m.summary(),
                n_checks=eng.sanitizer.n_checks)


def _both(models, prompts, n_new, **serve_kw):
    jm, jp, pm, pp = models
    kw = dict(serve_kw, kv_dtype="int8", sanitize_level="step", dispatch_sentinel=False)
    ref = _run(JEngine, JRequest, JSampling, jm, jp, JServeConfig(**kw), prompts, n_new)
    port = _run(PEngine, PRequest, PSampling, pm, pp, PServeConfig(**kw), prompts, n_new,
                device="cpu")
    return ref, port


def _assert_same(ref, port):
    for key in ("tokens", "kinds", "events", "n_quant_pages", "n_pages", "kv_pool_bytes"):
        assert port[key] == ref[key], key
    assert port["n_checks"] > 0 and port["n_quant_pages"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "opt-125m"])
def test_int8_engine_matches_reference(arch, mode):
    models = shared_reduced_models(arch)
    ref, port = _both(models, _system_prompts(models[0].cfg.vocab_size), 6,
                      mode=mode, **SYSTEM)
    _assert_same(ref, port)
    assert port["summary"]["n_done"] == 6


@pytest.mark.parametrize("mode", MODES)
def test_int8_engine_prefix_cache_matches_reference(reduced_models, mode):
    ref, port = _both(reduced_models,
                      _shared_prefix_prompts(reduced_models[0].cfg.vocab_size), 8,
                      mode=mode, enable_prefix_cache=True, **SYSTEM)
    _assert_same(ref, port)
    s = port["summary"]
    assert s["cache_hit_rate"] > 0 and s["pages_shared_peak"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_int8_engine_preemption_matches_reference(reduced_models, mode):
    # int8 pages are 3.2x denser on the f32 reduced model: a byte budget
    # of 7 fp pages gives 22 int8 pages, tight enough to preempt
    jm = reduced_models[0]
    budget = 7 * JQ.kv_page_bytes(jm.cfg, 4, jnp.float32)
    small = dict(SYSTEM, max_pages_per_seq=12, kv_pool_bytes=budget)
    ref, port = _both(reduced_models, _pressure_prompts(jm.cfg.vocab_size), 16,
                      mode=mode, **small)
    _assert_same(ref, port)
    assert port["summary"]["n_preemptions"] > 0


def test_int8_pool_grows_at_equal_bytes(reduced_models):
    """Port of test_int8_kv::test_int8_pool_grows_at_equal_bytes: flipping
    kv_dtype alone buys >= 1.8x the usable pages at (at most) the same
    device bytes, and the pool tensors hold exactly those bytes."""
    _, _, pm, pp = reduced_models
    serve = dict(SYSTEM, sanitize_level="off", dispatch_sentinel=False)
    fp = PEngine(pm, pp, PServeConfig(**serve), device="cpu")
    i8 = PEngine(pm, pp, PServeConfig(kv_dtype="int8", **serve), device="cpu")
    assert i8.metrics.kv_pool_bytes <= fp.metrics.kv_pool_bytes
    assert i8.alloc.n_pages >= 1.8 * fp.alloc.n_pages
    assert i8.metrics.kv_bytes_per_token < fp.metrics.kv_bytes_per_token
    held = sum(t.numel() * t.element_size()
               for pool in (i8.k_pages, i8.v_pages) for t in pool.values())
    assert held == i8.metrics.kv_pool_bytes


def test_cow_copy_moves_scales_with_codes(reduced_models):
    """A copy-on-write page copy carries codes AND scales: the copy
    dequantizes bit-identically to its source, and the sidecar mirror
    registers the destination."""
    _, _, pm, pp = reduced_models
    eng = PEngine(pm, pp, PServeConfig(kv_dtype="int8", sanitize_level="off",
                                       dispatch_sentinel=False, **SYSTEM), device="cpu")
    rng = np.random.RandomState(8)
    src, dst = 3, 11
    for pool in (eng.k_pages, eng.v_pages):
        pool["q"][:, src] = torch.from_numpy(
            rng.randint(-127, 128, size=pool["q"][:, src].shape).astype(np.int8))
        pool["s"][:, src] = torch.from_numpy(
            rng.uniform(1e-3, 1e-2, size=pool["s"][:, src].shape).astype(np.float32))
    eng.kv_quant.note_write([src])
    eng._apply_cow([(src, dst)])

    def deq(pool, p):
        return pool["q"][:, p].float() * pool["s"][:, p]
    for pool in (eng.k_pages, eng.v_pages):
        assert torch.equal(pool["q"][:, dst], pool["q"][:, src])
        assert torch.equal(pool["s"][:, dst], pool["s"][:, src])
        assert torch.equal(deq(pool, dst), deq(pool, src))
    assert eng.kv_quant.entries[dst] == 1
