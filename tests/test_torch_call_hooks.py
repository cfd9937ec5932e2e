"""The port's call-tier sanitizer (``repro_torch/analysis/hooks.py``),
held to tests/test_call_hooks.py: every hooked mutator of the port's
``PageAllocator`` / ``PrefixCache`` proven live by an injected corruption
that its own invariant subset catches at the mutator's exit, attributed
to that exact call site, and the port's engine wired to it.  Each
reference test has its counterpart of the same name, on the reference's
reduced qwen3-0.6b with its weights converted (``tests/torch_parity.py``)
for the engine tests, whose modes are the reference's three plus
``chunked``.  The cross-mode fingerprint is also held to the reference
engine's.

Mirrors the mutation-proof discipline of tests/test_sanitizer.py one
level deeper: the step-boundary tests prove the *checks* are live; these
prove the *attribution* is right — the violation names the mutating
method, carries an args digest and the request id, and nested compound
mutators (``cow_partial`` -> ``share``/``prepare_write``, ``alloc`` ->
``pop_reclaimable``) attribute to the outermost public entry point, not
a mid-compound transient.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import reduced_models

from repro.analysis.differential import state_fingerprint as jax_fingerprint
from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.analysis.differential import (diff_fingerprints, run_cross_mode,
                                               state_fingerprint)
from repro_torch.analysis.hooks import ALLOCATOR_HOOKS, CACHE_HOOKS, install_call_hooks
from repro_torch.analysis.invariants import InvariantViolation, verify_state
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request, SamplingParams
from repro_torch.core.kv_cache import PageAllocator
from repro_torch.core.prefix_cache import PrefixCache

PS = 4


def _pair(hooked=True):
    cache = PrefixCache(PS)
    alloc = PageAllocator(16, PS, cache=cache)
    hooks = install_call_hooks(alloc, cache) if hooked else None
    return alloc, cache, hooks


# ------------------------------------------- per-mutator attribution ----
def test_clean_lifecycle_passes_under_hooks():
    alloc, cache, hooks = _pair()
    pages = alloc.alloc(1, 3)
    cache.insert(list(range(2 * PS)), pages[:2])
    alloc.share(2, pages[:2])
    alloc.prepare_write(2, 2 * PS, 1)
    alloc.free(1)
    alloc.free(2)
    verify_state(alloc, cache)
    # every public mutator exercised above was checked at its exit
    assert hooks.n_call_checks >= 5
    for method in ("alloc", "share", "prepare_write", "free"):
        assert hooks.calls.get(method, 0) > 0, method


def test_alloc_attributed():
    alloc, cache, _ = _pair()
    pages = alloc.alloc(1, 2)
    alloc._ref[pages[0]] += 1            # inject: refcount without an owner
    with pytest.raises(InvariantViolation) as e:
        alloc.alloc(2, 1)
    assert e.value.invariant == "refcount_honesty"
    assert e.value.call_site["method"] == "alloc"
    assert e.value.call_site["rid"] == 2


def test_free_attributed():
    alloc, cache, _ = _pair()
    alloc.alloc(1, 2)
    alloc._free.pop()                    # inject: a page vanishes entirely
    with pytest.raises(InvariantViolation) as e:
        alloc.free(1)
    assert e.value.invariant == "page_conservation"
    assert e.value.call_site["method"] == "free"
    assert e.value.call_site["rid"] == 1


def test_share_outside_cache_contract_attributed():
    # genuine misuse, not a planted flag: sharing an uncached page makes
    # it multi-referenced with no COW guard — the hook catches the bad
    # call itself, at the call
    alloc, cache, _ = _pair()
    (page,) = alloc.alloc(1, 1)
    with pytest.raises(InvariantViolation) as e:
        alloc.share(2, [page])
    assert e.value.invariant == "cow_exclusivity"
    assert e.value.call_site["method"] == "share"
    assert str(page) in e.value.call_site["args"]


def test_prepare_write_attributed():
    alloc, cache, _ = _pair()
    (page,) = alloc.alloc(1, 1)
    cache.insert(list(range(PS)), [page])
    alloc.share(2, [page])
    alloc._owned[1].append(page)         # inject: duplicate mapping
    with pytest.raises(InvariantViolation) as e:
        alloc.prepare_write(2, 0, 1)
    assert e.value.invariant in ("refcount_honesty", "cow_exclusivity")
    assert e.value.call_site["method"] == "prepare_write"


def test_cow_partial_attributed_not_its_nested_calls():
    # cow_partial internally calls share() and prepare_write() — both
    # hooked.  The depth guard must attribute the violation to the
    # outermost public call, and must not false-positive on the
    # legitimately-inconsistent mid-compound states.
    alloc, cache, _ = _pair()
    (donor,) = alloc.alloc(1, 1)
    cache.insert(list(range(3)), [donor], allow_partial=True)
    alloc.free(1)                        # donor parks reclaimable
    alloc._free.append(99)               # inject: phantom page in the pool
    with pytest.raises(InvariantViolation) as e:
        alloc.cow_partial(2, donor)
    assert e.value.invariant == "page_conservation"
    assert e.value.call_site["method"] == "cow_partial"


def test_cow_partial_clean_counts_only_outer_call():
    alloc, cache, hooks = _pair()
    (donor,) = alloc.alloc(1, 1)
    cache.insert(list(range(3)), [donor], allow_partial=True)
    alloc.free(1)
    before_share = hooks.calls.get("share", 0)
    alloc.cow_partial(2, donor)
    # nested share/prepare_write ran but were not separately checked
    assert hooks.calls["cow_partial"] == 1
    assert hooks.calls.get("share", 0) == before_share


def test_insert_attributed():
    alloc, cache, _ = _pair()
    pages = alloc.alloc(1, 2)
    cache.insert(list(range(2 * PS)), pages)
    cache._by_page[pages[0]].n_desc += 1      # inject: descendant drift
    extra = alloc.alloc(2, 1)
    with pytest.raises(InvariantViolation) as e:
        cache.insert(list(range(100, 100 + PS)), extra)
    assert e.value.invariant == "trie_structure"
    assert e.value.call_site["method"] == "insert"


def test_pop_reclaimable_clean_exit_is_exempt():
    # the returned page is in the caller's hands — in no bucket — and
    # the hook must excuse exactly that page from conservation
    alloc, cache, hooks = _pair()
    (page,) = alloc.alloc(1, 1)
    cache.insert(list(range(PS)), [page])
    alloc.free(1)                        # parks reclaimable
    got = cache.pop_reclaimable()
    assert got == page
    assert hooks.calls["pop_reclaimable"] == 1   # checked, did not raise


def test_pop_reclaimable_attributed():
    alloc, cache, _ = _pair()
    (p1,) = alloc.alloc(1, 1)
    cache.insert(list(range(PS)), [p1])
    alloc.free(1)
    (p2,) = alloc.alloc(2, 1)
    cache.insert(list(range(50, 50 + PS)), [p2])
    alloc.free(2)
    cache._by_page[p2].reclaimable = False    # inject: pool/flag split
    with pytest.raises(InvariantViolation) as e:
        cache.pop_reclaimable()               # pops p1 (LRU), checks, sees p2
    assert e.value.invariant == "trie_structure"
    assert e.value.call_site["method"] == "pop_reclaimable"


def test_pop_blocked_attributed():
    alloc, cache, _ = _pair()
    pages = alloc.alloc(1, 2)
    cache.insert(list(range(2 * PS)), pages)
    alloc.share(2, [pages[1]])           # keep the child referenced
    alloc.free(1)                        # parent parks reclaimable, blocked
    cache._by_page[pages[0]].n_desc += 5      # inject: descendant drift
    with pytest.raises(InvariantViolation) as e:
        cache._pop_blocked(cache.default_policy)
    assert e.value.invariant == "trie_structure"
    assert e.value.call_site["method"] == "_pop_blocked"


def test_every_hooked_method_has_an_attribution_test():
    """Meta-check: the per-method tests above cover the full hook maps,
    so adding a mutator to hooks.py without a proof here fails."""
    proven = {"alloc", "free", "share", "prepare_write", "cow_partial",
              "insert", "pop_reclaimable", "_pop_blocked"}
    assert set(ALLOCATOR_HOOKS) | set(CACHE_HOOKS) == proven


def test_uninstall_restores_unhooked_behaviour():
    alloc, cache, hooks = _pair()
    hooks.uninstall()
    pages = alloc.alloc(1, 2)
    alloc._ref[pages[0]] += 1
    alloc.alloc(2, 1)                    # no hook: corruption sails through
    with pytest.raises(InvariantViolation):
        verify_state(alloc, cache)       # ...but the state checker still sees it


# ------------------------------------------------------ engine wiring ----
SMALL_KW = dict(max_batch=4, page_size=4, n_pages=20, max_pages_per_seq=12,
                prefill_chunk=4, n_streams=2, enable_prefix_cache=True,
                sanitize_level="call", dispatch_sentinel=False)
SMALL = ServeConfig(**SMALL_KW)


@pytest.fixture(scope="module")
def setup():
    jm, jp, model, params = reduced_models()
    rng = np.random.RandomState(0)
    shared = [int(t) for t in rng.randint(2, model.cfg.vocab_size, size=8)]
    prompts = [shared + [int(t) for t in rng.randint(2, model.cfg.vocab_size, size=4)]
               for _ in range(4)]
    return model, params, prompts, (jm, jp)


def _requests(prompts, n_new=12, req_cls=Request, sp_cls=SamplingParams):
    return [req_cls(rid=i, prompt=list(p), sampling=sp_cls(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]


def _engine(model, params, serve):
    return Engine(model, params, serve, device="cpu")


@pytest.mark.parametrize("mode", ["sequential", "splitwiser", "splitwiser_mps", "chunked"])
def test_clean_run_under_call_sanitizer(setup, mode):
    model, params, prompts, _ = setup
    eng = _engine(model, params, dataclasses.replace(SMALL, mode=mode))
    m = eng.run(_requests(prompts), max_steps=4000)
    assert m.summary()["n_done"] == len(prompts)
    assert eng.sanitizer.n_call_checks > 0     # hooks actually ran
    assert eng.sanitizer.n_checks > 0          # step tier still active


def test_call_level_streams_match_off(setup):
    model, params, prompts, _ = setup
    outs = {}
    for level in ("off", "call"):
        eng = _engine(model, params,
                      dataclasses.replace(SMALL, sanitize_level=level))
        reqs = _requests(prompts)
        eng.run(reqs, max_steps=4000)
        outs[level] = [r.out_tokens for r in reqs]
    assert outs["off"] == outs["call"]         # checks are read-only


def test_engine_corruption_attributed_to_call(setup):
    model, params, prompts, _ = setup
    eng = _engine(model, params, SMALL)
    for r in _requests(prompts):
        eng.submit(r)
    eng.step()
    live = [rid for rid, pages in eng.alloc._owned.items() if pages]
    eng.alloc._ref[eng.alloc._owned[live[0]][0]] += 1    # inject mid-run
    with pytest.raises(InvariantViolation) as e:
        eng.alloc.alloc(999, 1)            # engine allocator is hooked
    assert e.value.invariant == "refcount_honesty"
    assert e.value.call_site["method"] == "alloc"
    # engine context rides along: event tail + engine state in the dump
    assert "engine" in e.value.state
    assert any(ev.get("event") == "admit" for ev in e.value.events)


# ------------------------------------------- cross-mode differential ----
def test_state_fingerprint_detects_drift():
    alloc_a, cache_a, _ = _pair(hooked=False)
    alloc_b, cache_b, _ = _pair(hooked=False)
    for alloc, cache in ((alloc_a, cache_a), (alloc_b, cache_b)):
        pages = alloc.alloc(1, 2)
        cache.insert(list(range(2 * PS)), pages)
        alloc.free(1)
    assert diff_fingerprints(state_fingerprint(alloc_a),
                             state_fingerprint(alloc_b)) == []
    # b caches one extra chain -> reported by token path, not page id
    (extra,) = alloc_b.alloc(2, 1)
    cache_b.insert(list(range(70, 70 + PS)), [extra])
    alloc_b.free(2)
    diffs = diff_fingerprints(state_fingerprint(alloc_a),
                              state_fingerprint(alloc_b),
                              label_a="sequential", label_b="splitwiser")
    assert diffs and any("only in splitwiser" in d for d in diffs)


def test_cross_mode_differential_state_identical(setup):
    """Same workload, ample pool: all three modes must leave *identical*
    final allocator/cache state (by token path), not just identical
    token streams — and the reference engine's state after the same
    workload."""
    model, params, prompts, (jm, jp) = setup
    roomy = dataclasses.replace(SMALL, n_pages=96, sanitize_level="step")

    report = run_cross_mode(
        lambda mode: _engine(model, params,
                             dataclasses.replace(roomy, mode=mode)),
        lambda: _requests(prompts, n_new=8),
        modes=("sequential", "splitwiser", "splitwiser_mps", "chunked"),
        max_steps=4000)
    assert report["streams_match"]
    assert all(d == [] for d in report["state_diffs"].values()), \
        report["state_diffs"]
    # and the fingerprints are non-trivial (the workload cached chains)
    assert report["fingerprints"]["sequential"]["chains"]
    ref = JEngine(jm, jp, JServeConfig(**dict(SMALL_KW, n_pages=96, sanitize_level="step")))
    ref.run(_requests(prompts, n_new=8, req_cls=JRequest, sp_cls=JSampling), max_steps=4000)
    assert diff_fingerprints(jax_fingerprint(ref.alloc, ref.prefix_cache),
                             report["fingerprints"]["sequential"],
                             label_a="reference", label_b="port") == []
