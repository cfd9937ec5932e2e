"""The port's analysis layer (``repro_torch.analysis``) on the port's
engine, on the CPU.

The sanitizer runs clean at every level with fp and int8 pages; the
final allocator+trie state of the port equals the reference's after the
same workload (``state_fingerprint``); the cross-mode harness finds no
drift between modes; and injected corruptions of the int8 scale sidecar
are caught and named, as in tests/test_sanitizer.py for the reference.
"""
import numpy as np
import pytest

from torch_parity import both_models, reduced_cfg

from repro.analysis.differential import state_fingerprint as jax_fingerprint
from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.analysis import (InvariantViolation, diff_fingerprints,
                                  run_cross_mode, state_fingerprint)
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams

# tests/test_sanitizer.py's oversubscribed pool: 4 requests each growing
# to ~7 pages vs 19 usable fp pages, prefix cache on, so sharing, reclaim,
# COW and preemption all run checked
SMALL = dict(max_batch=4, page_size=4, n_pages=20, max_pages_per_seq=12,
             prefill_chunk=4, n_streams=2, enable_prefix_cache=True,
             dispatch_sentinel=False)
MODES = ["sequential", "splitwiser", "splitwiser_mps", "chunked"]


@pytest.fixture(scope="module")
def setup():
    models = both_models(reduced_cfg())
    vocab = models[0].cfg.vocab_size
    rng = np.random.RandomState(0)
    shared = list(rng.randint(2, vocab, size=8))
    prompts = [[int(t) for t in shared + list(rng.randint(2, vocab, size=4))]
               for _ in range(4)]
    return models, prompts


def _requests(prompts, n_new=12, req_cls=Request, sp_cls=SamplingParams):
    return [req_cls(rid=i, prompt=list(p), sampling=sp_cls(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]


def _port_engine(setup, **serve):
    (_, _, pm, pp), _ = setup
    return Engine(pm, pp, ServeConfig(**dict(SMALL, **serve)), device="cpu")


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("level", ["finish", "step", "call"])
def test_sanitizer_runs_clean_on_port_engine(setup, level, kv_dtype):
    eng = _port_engine(setup, mode="splitwiser_mps", sanitize_level=level,
                       kv_dtype=kv_dtype)
    m = eng.run(_requests(setup[1]), max_steps=4000)
    s = m.summary()
    assert s["n_done"] == len(setup[1])
    assert eng.sanitizer is not None and eng.sanitizer.n_checks > 0
    if kv_dtype == "int8":
        assert s["n_quant_pages"] > 0
        # at idle every surviving scale entry belongs to a parked cached page
        assert all(eng.prefix_cache.is_cached(p) for p in eng.kv_quant.entries)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("mode", ["sequential", "chunked"])
def test_state_fingerprint_equals_reference(setup, mode, kv_dtype):
    """Same workload on both engines: the final allocator+trie state, by
    token path, is the same."""
    (jm, jp, pm, pp), prompts = setup
    kw = dict(SMALL, mode=mode, kv_dtype=kv_dtype, sanitize_level="step")
    ref = JEngine(jm, jp, JServeConfig(**kw))
    ref.run(_requests(prompts, req_cls=JRequest, sp_cls=JSampling), max_steps=4000)
    port = Engine(pm, pp, ServeConfig(**kw), device="cpu")
    port.run(_requests(prompts), max_steps=4000)
    a = jax_fingerprint(ref.alloc, ref.prefix_cache)
    b = state_fingerprint(port.alloc, port.prefix_cache)
    assert b["chains"]                            # the workload cached chains
    assert diff_fingerprints(a, b, label_a="reference", label_b="port") == []


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_cross_mode_fingerprints_identical(setup, kv_dtype):
    (_, _, pm, pp), prompts = setup
    roomy = dict(SMALL, n_pages=96, sanitize_level="step", kv_dtype=kv_dtype)
    report = run_cross_mode(
        lambda mode: Engine(pm, pp, ServeConfig(mode=mode, **roomy), device="cpu"),
        lambda: _requests(prompts, n_new=8), modes=MODES, max_steps=4000)
    assert report["streams_match"]
    assert all(d == [] for d in report["state_diffs"].values()), report["state_diffs"]
    assert report["fingerprints"]["chunked"]["chains"]


def _int8_engine_mid_run(setup):
    """An int8 engine a few steps into the workload, with live slots whose
    pages carry scale entries."""
    eng = _port_engine(setup, mode="sequential", sanitize_level="step", kv_dtype="int8")
    for r in _requests(setup[1]):
        eng.submit(r)
    while not any(eng.slots) and not eng.idle():
        eng.step()
    return eng


def _drop_live_entry(eng):
    slot = next(s for s in eng.slots if s is not None)
    del eng.kv_quant.entries[eng.alloc.owned(slot.req.rid)[0]]
    return "no scale entry"


def _double_entry(eng):
    eng.kv_quant.entries[next(iter(eng.kv_quant.entries))] = 2
    return "exactly one"


def _freed_page_entry(eng):
    eng.kv_quant.entries[eng.alloc._free[0]] = 1
    return "free list"


def _byte_drift(eng):
    eng.metrics.kv_pool_bytes += 1
    return "conserve"


@pytest.mark.parametrize("inject", [_drop_live_entry, _double_entry, _freed_page_entry,
                                    _byte_drift])
def test_scale_sidecar_corruption_detected(setup, inject):
    eng = _int8_engine_mid_run(setup)
    eng.sanitizer.check_now()                     # clean before the injection
    words = inject(eng)
    with pytest.raises(InvariantViolation) as e:
        eng.sanitizer.check_now()
    assert e.value.invariant == "scale_sidecar"
    assert words in str(e.value)


def test_corruption_caught_at_the_next_step(setup):
    """A scale entry dropped mid-run surfaces at the next step boundary
    of the step-level sanitizer."""
    eng = _int8_engine_mid_run(setup)
    _drop_live_entry(eng)
    with pytest.raises(InvariantViolation) as e:
        eng.step()
    assert e.value.invariant == "scale_sidecar"


def test_sanitizer_off_builds_no_checker(setup):
    eng = _port_engine(setup, mode="chunked", sanitize_level="off", kv_dtype="int8")
    assert eng.sanitizer is None
    assert eng.run(_requests(setup[1], n_new=4), max_steps=4000).summary()["n_done"] == 4


def test_unknown_sanitize_level_is_rejected():
    with pytest.raises(ValueError, match="sanitize_level"):
        ServeConfig(**dict(SMALL, sanitize_level="sometimes"))


def test_analysis_exports_match_reference():
    """The port's analysis package exports the reference's names."""
    import repro.analysis as ref
    import repro_torch.analysis as port
    assert set(port.__all__) == set(ref.__all__)
    assert port.SANITIZE_LEVELS == ref.SANITIZE_LEVELS
    assert sorted(port.CHECKS) == sorted(ref.CHECKS)
