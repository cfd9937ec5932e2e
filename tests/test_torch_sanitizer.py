"""The port's runtime sanitizer (``repro_torch/analysis/invariants.py``),
held to tests/test_sanitizer.py: injected-corruption proofs + clean-run
coverage on the port's allocator, trie and engine.

Each reference test has its counterpart of the same name here, except
the six that tests/test_torch_analysis.py already holds on the port:
``test_sanitize_off_has_no_checker`` (there
``test_sanitizer_off_builds_no_checker``), ``test_int8_clean_run_under_step_sanitizer``
(``test_sanitizer_runs_clean_on_port_engine[step-int8]``, the same
assertions) and the four scale-sidecar corruptions
``test_missing_scale_entry_detected``, ``test_duplicate_scale_entry_detected``,
``test_freed_page_scale_entry_detected`` and ``test_pool_byte_drift_detected``
(``test_scale_sidecar_corruption_detected``).  The engine tests run the
reference's reduced qwen3-0.6b with its weights converted
(``tests/torch_parity.py``), in the reference's three modes plus
``chunked``.

Each corruption test deliberately breaks one cross-module invariant the
way a real bug would — a leaked refcount, a double-freed page, an
orphaned trie node, an under-budgeted admission — and asserts the
sanitizer raises :class:`InvariantViolation` *naming that invariant*.
This is mutation-style evidence the checks are live, not vacuous: if a
check regresses to a no-op, its injection test fails.

The clean-run tests drive all three engine modes under
``sanitize_level="step"`` on an oversubscribed pool (preemption +
prefix sharing + COW all firing) and require zero violations — the
contract holds on every real path, and the checker actually ran.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import reduced_models

from repro_torch.analysis.invariants import InvariantViolation, verify_state
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request, SamplingParams
from repro_torch.core.kv_cache import PageAllocator
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.scheduler import Scheduler

PS = 4


def _pair():
    cache = PrefixCache(PS)
    alloc = PageAllocator(16, PS, cache=cache)
    return alloc, cache


# ------------------------------------------------- injected corruption ----
def test_clean_state_passes():
    alloc, cache = _pair()
    pages = alloc.alloc(1, 3)
    cache.insert(list(range(2 * PS)), pages[:2])
    verify_state(alloc, cache)
    alloc.free(1)
    verify_state(alloc, cache)


def test_leaked_refcount_detected():
    alloc, cache = _pair()
    pages = alloc.alloc(1, 2)
    alloc._ref[pages[0]] += 1          # inject: refcount without an owner
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "refcount_honesty"


def test_double_free_detected():
    alloc, cache = _pair()
    pages = alloc.alloc(1, 2)
    alloc.free(1)
    alloc._free.append(alloc._free[-1])   # inject: page freed twice
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "page_conservation"
    assert "double free" in str(e.value)
    del pages


def test_page_leak_detected():
    alloc, cache = _pair()
    alloc._free.pop()                  # inject: page vanishes entirely
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "page_conservation"


def test_orphaned_trie_node_detected():
    alloc, cache = _pair()
    pages = alloc.alloc(1, 2)
    cache.insert(list(range(2 * PS)), pages)    # parent -> child chain
    parent = cache._by_page[pages[0]]
    cache._evict(parent)               # inject: child's parent vanishes
    cache.orphaned_shared.discard(pages[0])
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "trie_structure"
    assert "orphaned" in str(e.value)


def test_uncached_shared_page_detected():
    alloc, cache = _pair()
    (page,) = alloc.alloc(1, 1)
    # inject: a second request maps the page outside the cache contract
    # (refcounts stay honest, but no COW guard can know it's shared)
    alloc._owned[2] = [page]
    alloc._ref[page] += 1
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "cow_exclusivity"


def test_reclaimable_while_referenced_detected():
    alloc, cache = _pair()
    pages = alloc.alloc(1, 1)
    cache.insert(list(range(PS)), pages)
    # inject: park a still-referenced cached page as reclaimable — a
    # strip would yank it out from under its live reader (the page now
    # sits in two pools at once, so conservation flags it)
    cache.on_release(pages[0])
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    assert e.value.invariant == "page_conservation"


def test_violation_carries_state_dump():
    alloc, cache = _pair()
    pages = alloc.alloc(7, 2)
    alloc._ref[pages[0]] += 1
    with pytest.raises(InvariantViolation) as e:
        verify_state(alloc, cache)
    exc = e.value
    assert exc.invariant == "refcount_honesty"
    assert exc.state["allocator"]["n_pages"] == 16
    assert "7" in exc.state["allocator"]["owned"]
    assert "state dump" in str(exc)


# ------------------------------------------------------ engine wiring ----
MODES = ["sequential", "splitwiser", "splitwiser_mps", "chunked"]

# oversubscribed: 4 requests each growing to ~7 pages vs 19 usable pages,
# with the prefix cache on so sharing/reclaim/COW paths all run checked
SMALL = ServeConfig(max_batch=4, page_size=4, n_pages=20,
                    max_pages_per_seq=12, prefill_chunk=4, n_streams=2,
                    enable_prefix_cache=True, sanitize_level="step",
                    dispatch_sentinel=False)


@pytest.fixture(scope="module")
def setup():
    _, _, model, params = reduced_models()
    rng = np.random.RandomState(0)
    shared = [int(t) for t in rng.randint(2, model.cfg.vocab_size, size=8)]
    prompts = [shared + [int(t) for t in rng.randint(2, model.cfg.vocab_size, size=4)]
               for _ in range(4)]
    return model, params, prompts


def _engine(model, params, serve):
    return Engine(model, params, serve, device="cpu")


def _requests(prompts, n_new=12):
    return [Request(rid=i, prompt=list(p),
                    sampling=SamplingParams(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode", MODES)
def test_clean_run_under_step_sanitizer(setup, mode):
    model, params, prompts = setup
    eng = _engine(model, params, dataclasses.replace(SMALL, mode=mode))
    m = eng.run(_requests(prompts), max_steps=4000)
    s = m.summary()
    assert s["n_done"] == len(prompts)
    assert eng.sanitizer is not None and eng.sanitizer.n_checks > 0


def test_underbudgeted_admission_detected(setup, monkeypatch):
    """Budget honesty end-to-end: make the scheduler charge zero pages
    for every admission — prefill consumption then exceeds the recorded
    budget and the first-token hook must flag it."""
    model, params, prompts = setup
    monkeypatch.setattr(
        Scheduler, "admission_pages",
        lambda self, req, free_cached=0, cow_extra=0, n_hit=0: 0)
    eng = _engine(model, params, SMALL)
    with pytest.raises(InvariantViolation) as e:
        eng.run(_requests(prompts), max_steps=4000)
    assert e.value.invariant == "scheduler_budget"


def test_pressure_run_exercises_preempt_promises(setup):
    """The oversubscribed pool actually preempts, so the differential
    preempt/resume checker ran on real scheduler paths — and stayed
    silent."""
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    m = eng.run(_requests(prompts), max_steps=4000)
    assert m.summary()["n_done"] == len(prompts)
    assert m.n_preempt_events > 0           # the checker had work to do
    assert not eng.sanitizer._preempt_snaps  # every promise was settled


def _promised_chain(eng):
    """Build the differential checker's precondition by hand: rid 1 owns
    a cached 2-page chain that rid 2 also references, so at preemption
    both pages are promised to survive rid 1's free."""
    toks = list(range(100, 100 + 2 * PS))
    pages = eng.alloc.alloc(1, 2)
    eng.prefix_cache.insert(toks, pages)
    eng.alloc.share(2, pages)               # the external reference
    req = Request(rid=1, prompt=list(toks),
                  sampling=SamplingParams(max_new_tokens=4))
    return req, toks, pages


def test_resume_recompute_of_promised_page_detected(setup):
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    req, toks, pages = _promised_chain(eng)
    eng.sanitizer.note_preempt(req, len(toks))
    eng.alloc.free(1)                       # the scheduler's eviction
    # inject: the resume recomputes instead of remapping — the promised
    # pages are still cached, so the empty match is a regression
    with pytest.raises(InvariantViolation) as e:
        eng.sanitizer.note_resume(req, [])
    assert e.value.invariant == "preempt_resume"
    assert "recomputed promised page" in str(e.value)


def test_resume_without_ownership_detected(setup):
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    req, toks, pages = _promised_chain(eng)
    eng.sanitizer.note_preempt(req, len(toks))
    eng.alloc.free(1)
    # inject: resume claims the match but never re-acquired references
    with pytest.raises(InvariantViolation) as e:
        eng.sanitizer.note_resume(req, list(pages))
    assert e.value.invariant == "preempt_resume"
    assert "does not own" in str(e.value)


def test_resume_remap_settles_promise(setup):
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    req, toks, pages = _promised_chain(eng)
    eng.sanitizer.note_preempt(req, len(toks))
    eng.alloc.free(1)
    eng.alloc.share(1, pages)               # the honest resume remap
    eng.sanitizer.note_resume(req, list(pages))
    assert 1 not in eng.sanitizer._preempt_snaps


def test_promise_lapses_on_eviction(setup):
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    req, toks, pages = _promised_chain(eng)
    eng.sanitizer.note_preempt(req, len(toks))
    eng.alloc.free(1)
    eng.alloc.free(2)                       # chain parks reclaimable...
    while eng.prefix_cache.pop_reclaimable() is not None:
        pass                                # ...and pressure strips it
    assert not any(eng.prefix_cache.is_cached(p) for p in pages)
    eng.sanitizer.note_resume(req, [])      # recompute is legitimate now


def test_lossy_resume_match_detected_end_to_end(setup, monkeypatch):
    """Integration proof: regress the resume-side prefix match (the
    engine recomputes what resume_safe_pages promised to remap) and the
    differential checker must catch it on a real preempt/resume cycle."""
    model, params, prompts = setup
    orig = Engine._map_cached

    def lossy(self, req):
        if (self.sanitizer is not None
                and req.rid in self.sanitizer._preempt_snaps):
            # resumes recompute from scratch; first admissions unaffected
            self.sanitizer.note_resume(req, [])
            return 0
        return orig(self, req)

    monkeypatch.setattr(Engine, "_map_cached", lossy)
    eng = _engine(model, params, SMALL)
    with pytest.raises(InvariantViolation) as e:
        eng.run(_requests(prompts), max_steps=4000)
    assert e.value.invariant == "preempt_resume"


def test_step_corruption_caught_at_the_step(setup):
    """A corruption planted mid-run surfaces at the next step boundary,
    with the event-ring tail attached for post-mortem."""
    model, params, prompts = setup
    eng = _engine(model, params, SMALL)
    for r in _requests(prompts):
        eng.submit(r)
    eng.step()
    live_rids = [rid for rid in eng.alloc._owned if eng.alloc._owned[rid]]
    page = eng.alloc._owned[live_rids[0]][0]
    eng.alloc._ref[page] += 1          # inject mid-run
    with pytest.raises(InvariantViolation) as e:
        eng.step()
    assert e.value.invariant == "refcount_honesty"
    assert e.value.events                  # post-mortem trace attached
    assert any(ev.get("event") == "admit" for ev in e.value.events)
