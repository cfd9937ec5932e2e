"""The port's dispatch sentinel (repro_torch/analysis/dispatch.py), the
counterpart of tests/test_dispatch.py.

The port's step callables are plain functions, so the sentinel counts
distinct argument signatures (its fallback probe): the unit tests hold
that probe, the storm guard, the sparse-recompile pass and the warm
budget on plain callables; the engine tests show the hot path keeps one
signature per static shape after two warm runs in every mode, and that
its counts equal the reference engine's (whose probe is the real
``jax.jit`` caches) on the same workload.  The reference's two tests that
count real ``jax.jit`` compiles (``test_counts_real_jit_compiles``,
``test_warm_budget_with_real_jit``) have no counterpart: nothing in the
port compiles per shape.
"""
import numpy as np
import pytest
import torch

from torch_parity import both_models, reduced_cfg

from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.analysis import DispatchSentinel
from repro_torch.analysis.dispatch import STORM_THRESHOLD, STORM_WINDOW
from repro_torch.analysis.invariants import InvariantViolation
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams

MODES = ["sequential", "splitwiser", "splitwiser_mps", "chunked"]


# ------------------------------------------------------- unit: counting ----
def test_fallback_signature_probe_for_plain_callables():
    sent = DispatchSentinel()
    fn = sent.wrap("plain", lambda x, flag=False: x)
    fn(torch.ones(4))
    fn(torch.ones(4))                     # same signature: no compile
    fn(torch.ones(4, dtype=torch.int32))  # dtype change counts
    fn(torch.ones(4), flag=True)          # kwarg *value* change counts
    fn({"a": torch.ones(4)})              # dicts by their entries' signatures
    fn({"a": torch.ones(4)})
    assert sent.stats["plain"].n_compiles == 4
    assert sent.stats["plain"].n_calls == 6


def test_warm_budget_with_plain_callables():
    sent = DispatchSentinel()
    fn = sent.wrap("f", lambda x: x + 1)
    fn(torch.ones(4))
    fn(torch.ones(8))
    sent.mark_warm()
    fn(torch.ones(4))                     # a known signature: no compile
    sent.check(budget=0)
    fn(torch.ones(16))                    # post-warmup new signature
    assert sent.post_warm_compiles() == {"f": 1}
    with pytest.raises(InvariantViolation) as e:
        sent.check(budget=0)
    assert e.value.invariant == "jit_dispatch"
    assert "dispatch" in e.value.state
    sent.check(budget=1)


# --------------------------------------------------- unit: storm guard ----
def _storm(fn, n):
    for i in range(n):
        fn(torch.ones(i + 1))             # every call a fresh shape


def test_storm_guard_catches_injected_recompile_storm():
    sent = DispatchSentinel()
    fn = sent.wrap("decode", lambda x: x.sum(), storm_guard=True)
    with pytest.raises(InvariantViolation) as e:
        _storm(fn, STORM_WINDOW + 1)
    assert e.value.invariant == "jit_dispatch"
    assert "recompile storm" in str(e.value)
    assert sent.stats["decode"].n_calls >= STORM_WINDOW
    assert sent.stats["decode"].n_compiles >= STORM_THRESHOLD


def test_storm_guard_catches_a_python_scalar_varying_per_call():
    """A step argument that is a Python scalar changing every call (a
    position, a length) counts as a new signature each time."""
    sent = DispatchSentinel()
    fn = sent.wrap("mixed", lambda x, n: x, storm_guard=True)
    with pytest.raises(InvariantViolation):
        for i in range(STORM_WINDOW + 1):
            fn(torch.ones(4), i)


def test_storm_guard_off_only_counts():
    sent = DispatchSentinel()
    fn = sent.wrap("prefill", lambda x: x.sum(), storm_guard=False)
    _storm(fn, STORM_WINDOW + 8)
    assert sent.stats["prefill"].n_compiles == STORM_WINDOW + 8


def test_sparse_recompiles_below_threshold_pass():
    sent = DispatchSentinel(storm_window=8, storm_threshold=4)
    fn = sent.wrap("decode", lambda x: x * 1.0, storm_guard=True)
    shapes = [4, 8]
    for i in range(32):
        fn(torch.ones(shapes[i % 2]))     # two signatures, then all known
    assert sent.stats["decode"].n_compiles == 2


# -------------------------------------------------------- engine wiring ----
# tests/test_dispatch.py's workload, with chunked's round budget at two
# pages (its default, 256 tokens, pads every round to 512 chunk rows)
SMALL = dict(max_batch=4, page_size=4, n_pages=20, max_pages_per_seq=12,
             prefill_chunk=4, n_streams=2, chunk_tokens=8,
             enable_prefix_cache=True, sanitize_level="off",
             dispatch_sentinel=True)


@pytest.fixture(scope="module")
def setup():
    models = both_models(reduced_cfg())
    rng = np.random.RandomState(0)
    vocab = models[0].cfg.vocab_size
    shared = list(rng.randint(2, vocab, size=8))
    prompts = [shared + list(rng.randint(2, vocab, size=4)) for _ in range(4)]
    return models, prompts


def _requests(req_cls, sp_cls, prompts, base_rid=0, n_new=8):
    return [req_cls(rid=base_rid + i, prompt=[int(t) for t in p],
                    sampling=sp_cls(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]


def _warm_then_run(eng, req_cls, sp_cls, prompts):
    """Two warm runs (the second hits the prefix cache the first filled),
    ``mark_warm``, then a third identical run."""
    eng.run(_requests(req_cls, sp_cls, prompts), max_steps=4000)
    eng.run(_requests(req_cls, sp_cls, prompts, base_rid=50), max_steps=4000)
    warm = eng.dispatch.total_compiles
    eng.dispatch.mark_warm()
    eng.run(_requests(req_cls, sp_cls, prompts, base_rid=100), max_steps=4000)
    return warm


@pytest.mark.parametrize("mode", MODES)
def test_engine_hot_path_is_compiled_once(setup, mode):
    (_, _, pm, pp), prompts = setup
    eng = Engine(pm, pp, ServeConfig(mode=mode, **SMALL), device="cpu")
    assert _warm_then_run(eng, Request, SamplingParams, prompts) > 0
    eng.dispatch.check(budget=0)
    assert all(n == 0 for n in eng.dispatch.post_warm_compiles().values())
    # the step loop's callables ran, under their reference names
    ran = {n for n, row in eng.dispatch.report().items() if row["calls"]}
    assert ran >= {"sample_greedy"} and ran & {"decode", "mixed"}


@pytest.mark.parametrize("mode", MODES)
def test_engine_counts_equal_the_reference(setup, mode):
    """Calls and post-warm compiles per step callable equal the reference
    engine's on the same workload (its probe: the jit caches), and so do
    the compiles of the steps it jits per engine.  Its samplers are jitted
    once per process, so their cache also holds other engines' shapes and
    their compile counts depend on what ran before: not compared."""
    (jm, jp, pm, pp), prompts = setup
    jeng = JEngine(jm, jp, JServeConfig(mode=mode, **SMALL))
    _warm_then_run(jeng, JRequest, JSampling, prompts)
    peng = Engine(pm, pp, ServeConfig(mode=mode, **SMALL), device="cpu")
    _warm_then_run(peng, Request, SamplingParams, prompts)
    want, got = jeng.dispatch.report(), peng.dispatch.report()
    assert set(got) == set(want)
    for name, row in want.items():
        assert (got[name]["calls"], got[name]["post_warm"]) == (row["calls"], 0)
        if not name.startswith("sample"):
            assert got[name]["compiles"] == row["compiles"], name


def test_engine_report_names_step_callables(setup):
    (_, _, pm, pp), prompts = setup
    eng = Engine(pm, pp, ServeConfig(mode="splitwiser", **SMALL), device="cpu")
    eng.run(_requests(Request, SamplingParams, prompts), max_steps=4000)
    report = eng.dispatch.report()
    assert set(report) == {"prefill", "commit", "decode", "mixed",
                           "sample_greedy", "sample"}
    assert report["mixed"]["calls"] and report["decode"]["calls"]
    for row in report.values():
        assert set(row) == {"calls", "compiles", "post_warm"}


def test_sentinel_off_by_default(setup):
    (_, _, pm, pp), prompts = setup
    eng = Engine(pm, pp, ServeConfig(mode="chunked", **dict(SMALL, dispatch_sentinel=False)),
                 device="cpu")
    assert eng.dispatch is None
    eng.run(_requests(Request, SamplingParams, prompts, n_new=4), max_steps=4000)


def test_env_default(monkeypatch):
    monkeypatch.delenv("REPRO_DISPATCH_SENTINEL", raising=False)
    assert ServeConfig().dispatch_sentinel is False
    monkeypatch.setenv("REPRO_DISPATCH_SENTINEL", "1")
    assert ServeConfig().dispatch_sentinel is True
    monkeypatch.setenv("REPRO_DISPATCH_SENTINEL", "0")
    assert ServeConfig().dispatch_sentinel is False
