"""The port's chunked-prefill mixed dispatch (``mode="chunked"``), held to
tests/test_chunked.py and tests/test_chunked_properties.py.

* **Planner** (pure, the port's copy of ``core/planner.py``): decodes
  pack unconditionally, prefill chunks fill the leftover budget
  work-conservingly, the rotating cursor keeps tight budgets fair, and
  ``validate_plan`` rejects every way a plan can break the packing
  contract; hypothesis drives random rounds through it.
* **Engine**: chunked greedy streams equal the reference engine's
  sequential streams on the same weights across the full
  ``admission x eviction x preempt`` policy matrix and under random
  interleavings (chunk boundary x partial-prefix hit x preemption); the
  final allocator/cache state matches across modes; the pressured run
  drives preemptions through the differential preempt/resume checker.
* **Scheduler/metrics**: admission charges one chunk's pages; live
  decodes ride every round while a long prompt prefills; ``n_chunks`` /
  occupancy / the packed-token histogram surface in ``summary()``.

Every reference test has its counterpart of the same name, on the
reference's reduced qwen3-0.6b with its weights converted
(``tests/torch_parity.py``).  The interleaving properties run with
``database=None`` and derandomized, as the reference file's do, and the
same 8 and 60 examples.
"""
import dataclasses
import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from torch_parity import reduced_models

from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.analysis.differential import run_cross_mode
from repro_torch.analysis.invariants import InvariantViolation
from repro_torch.configs import ServeConfig
from repro_torch.configs.base import SERVE_MODES
from repro_torch.core.engine import Engine, Request, SamplingParams
from repro_torch.core.planner import ChunkPlan, ChunkPlanner, validate_plan

PS = 4
N_NEW = 8
BASE = ServeConfig(mode="chunked", max_batch=3, page_size=PS, n_pages=26,
                   max_pages_per_seq=12, prefill_chunk=PS, n_streams=2,
                   chunk_tokens=8, enable_prefix_cache=True, sanitize_level="off",
                   dispatch_sentinel=False)


@pytest.fixture(scope="module")
def setup():
    jm, jp, model, params = reduced_models()
    return model, params, (jm, jp)


def _engine(setup, serve):
    return Engine(setup[0], setup[1], serve, device="cpu")


def _prompts(vocab, seed=0):
    """test_policies' pressured shared-prefix workload: adjacent twins
    (same-round identical prefixes) plus a unique prompt."""
    rng = np.random.RandomState(seed)
    a = [int(t) for t in rng.randint(2, vocab, size=12)]
    b = [int(t) for t in rng.randint(2, vocab, size=12)]
    return [a + [11, 12], a + [13, 14], b + [15, 16], b + [17, 18],
            [int(t) for t in rng.randint(2, vocab, size=14)]]


def _workload(vocab, seed=0):
    return [Request(rid=i, prompt=list(p), sampling=SamplingParams(max_new_tokens=N_NEW))
            for i, p in enumerate(_prompts(vocab, seed))]


_ORACLES = {}   # workload signature -> the reference engine's greedy streams


def _reference_streams(setup, prompts, n_new):
    """Cache-off, generous-pool sequential greedy streams of the reference
    engine on the same weights."""
    key = (tuple(tuple(p) for p in prompts), n_new)
    if key not in _ORACLES:
        jm, jp = setup[2]
        serve = JServeConfig(mode="sequential", max_batch=3, page_size=PS, n_pages=128,
                             max_pages_per_seq=12, prefill_chunk=PS, n_streams=2,
                             chunk_tokens=8, sanitize_level="off", dispatch_sentinel=False)
        reqs = [JRequest(rid=i, prompt=list(p), sampling=JSampling(max_new_tokens=n_new))
                for i, p in enumerate(prompts)]
        JEngine(jm, jp, serve).run(reqs, max_steps=4000)
        _ORACLES[key] = [r.out_tokens for r in reqs]
    return _ORACLES[key]


@pytest.fixture(scope="module")
def oracle(setup):
    return _reference_streams(setup, _prompts(setup[0].cfg.vocab_size), N_NEW)


# ================================================== planner unit tests ====
def test_decodes_claim_budget_first():
    p = ChunkPlanner(chunk_tokens=8, n_streams=2)
    plan = p.plan([100, 100], n_decode_tokens=3)
    assert plan.n_decode_tokens == 3
    assert plan.n_prefill_tokens == 5          # 8 - 3 left for prefill
    assert plan.n_packed_tokens == 8
    assert plan.occupancy == 1.0


def test_decode_batch_alone_may_exceed_budget():
    p = ChunkPlanner(chunk_tokens=4, n_streams=2)
    plan = p.plan([50, 50], n_decode_tokens=6)
    assert plan.chunk_lens == (0, 0)
    assert plan.n_packed_tokens == 6
    assert plan.occupancy > 1.0


def test_carve_is_work_conserving():
    p = ChunkPlanner(chunk_tokens=16, n_streams=3)
    plan = p.plan([2, 0, 3], n_decode_tokens=0)
    assert plan.chunk_lens == (2, 0, 3)
    validate_plan(plan, [2, 0, 3], 0)


def test_cursor_rotates_for_fairness():
    p = ChunkPlanner(chunk_tokens=4, n_streams=2)
    assert p.plan([100, 100], 0).chunk_lens == (4, 0)
    assert p.plan([100, 100], 0).chunk_lens == (0, 4)
    assert p.plan([100, 100], 0).chunk_lens == (4, 0)


def test_planner_ctor_validates():
    with pytest.raises(ValueError, match="chunk_tokens"):
        ChunkPlanner(0, 2)
    with pytest.raises(ValueError, match="n_streams"):
        ChunkPlanner(8, 0)


def test_plan_inputs_validated():
    p = ChunkPlanner(8, 2)
    with pytest.raises(ValueError, match="stream remainders"):
        p.plan([1, 2, 3], 0)
    with pytest.raises(ValueError, match="n_decode_tokens"):
        p.plan([1, 2], -1)


@pytest.mark.parametrize("plan,remaining,n_decode,msg", [
    (ChunkPlan((4, 0), 1, 8, 8), [10, 10], 2, "unconditionally"),
    (ChunkPlan((5, 0), 0, 8, 8), [3, 10], 0, "remaining prefill"),
    (ChunkPlan((-1, 0), 0, 8, 8), [3, 10], 0, "negative"),
    (ChunkPlan((4, 4), 2, 8, 8), [10, 10], 2, "budget"),
    (ChunkPlan((9, 0), 0, 8, 4), [10, 0], 0, "cap"),
    (ChunkPlan((2, 0), 0, 8, 8), [2, 10], 0, "work-conserving"),
    (ChunkPlan((4,), 0, 8, 8), [10, 10], 0, "streams"),
])
def test_validate_plan_rejects_contract_breaks(plan, remaining, n_decode, msg):
    with pytest.raises(ValueError, match=msg):
        validate_plan(plan, remaining, n_decode)


@given(budget=st.integers(1, 64), n_streams=st.integers(1, 4),
       n_decode=st.integers(0, 12), data=st.data())
@settings(max_examples=60, deadline=None, database=None, derandomize=True)
def test_planner_always_emits_valid_plans(budget, n_streams, n_decode, data):
    p = ChunkPlanner(budget, n_streams)
    remaining = data.draw(st.lists(st.integers(0, 100), min_size=n_streams,
                                   max_size=n_streams))
    total = sum(remaining)
    for _ in range(sum(remaining) + 1):
        plan = p.plan(remaining, n_decode)
        validate_plan(plan, remaining, n_decode)
        assert plan.n_prefill_tokens <= max(budget - n_decode, 0)
        remaining = [r - c for r, c in zip(remaining, plan.chunk_lens)]
        total -= plan.n_prefill_tokens
        if plan.n_prefill_tokens == 0:
            break
    assert (total == 0) or (budget <= n_decode)


# ===================================================== config plumbing ====
def test_chunked_registered_and_knob_validated():
    assert "chunked" in SERVE_MODES
    ServeConfig(mode="chunked", chunk_tokens=16, page_size=16)  # fine
    with pytest.raises(ValueError, match="chunk_tokens"):
        ServeConfig(chunk_tokens=0)
    with pytest.raises(ValueError, match="page_size"):
        ServeConfig(chunk_tokens=8, page_size=16)


def test_unknown_mode_fails_loud(setup):
    eng = _engine(setup, dataclasses.replace(BASE, mode="sequential"))
    object.__setattr__(eng.serve, "mode", "time_warp")
    with pytest.raises(RuntimeError, match="no step path"):
        eng.step()


# ============================================= stream-level equivalence ====
def test_greedy_bit_identical_across_policy_matrix(setup, oracle):
    """Chunking changes *when* prompt tokens are prefilled, never *what*
    is generated: the reference's streams under every policy combination,
    with the pool fully drained."""
    matrix = list(itertools.product(("fcfs", "cache_aware"), ("lru", "fifo", "cost"),
                                    ("latest", "cache_aware")))
    for adm, ev, pre in matrix:
        serve = dataclasses.replace(BASE, admission_policy=adm, eviction_policy=ev,
                                    preempt_policy=pre)
        eng = _engine(setup, serve)
        reqs = _workload(setup[0].cfg.vocab_size)
        s = eng.run(reqs, max_steps=8000).summary()
        assert s["n_done"] == len(reqs), (adm, ev, pre)
        assert [r.out_tokens for r in reqs] == oracle, (adm, ev, pre)
        assert eng.alloc.n_allocated == 0 and eng.idle()


def test_cross_mode_state_fingerprints_identical(setup):
    roomy = dataclasses.replace(BASE, n_pages=96, sanitize_level="step")
    report = run_cross_mode(
        lambda mode: _engine(setup, dataclasses.replace(roomy, mode=mode)),
        lambda: _workload(setup[0].cfg.vocab_size),
        modes=("sequential", "splitwiser", "chunked"), max_steps=8000)
    assert report["streams_match"]
    assert all(d == [] for d in report["state_diffs"].values()), report["state_diffs"]
    assert report["fingerprints"]["chunked"]["chains"]


def test_pressured_run_exercises_preempt_promises(setup, oracle):
    eng = _engine(setup, dataclasses.replace(BASE, n_pages=18, sanitize_level="step"))
    reqs = _workload(setup[0].cfg.vocab_size)
    m = eng.run(reqs, max_steps=8000)
    assert m.summary()["n_done"] == len(reqs)
    assert m.n_preempt_events > 0            # the checker had work to do
    assert not eng.sanitizer._preempt_snaps  # every promise was settled
    assert [r.out_tokens for r in reqs] == oracle


@given(chunk_tokens=st.integers(PS, 14),
       shared_len=st.integers(4, 13),
       tails=st.lists(st.integers(1, 6), min_size=2, max_size=3),
       n_pages=st.sampled_from([16, 20, 40]),
       n_new=st.integers(3, 6))
@settings(max_examples=8, deadline=None, database=None, derandomize=True)
def test_interleaving_properties(setup, chunk_tokens, shared_len, tails, n_pages, n_new):
    rng = np.random.RandomState(chunk_tokens * 131 + shared_len)
    vocab = setup[0].cfg.vocab_size
    shared = [int(t) for t in rng.randint(2, vocab, size=shared_len)]
    prompts = [shared + [int(t) for t in rng.randint(2, vocab, size=t)] for t in tails]
    serve = dataclasses.replace(BASE, chunk_tokens=chunk_tokens, n_pages=n_pages,
                                sanitize_level="step")
    eng = _engine(setup, serve)
    reqs = [Request(rid=i, prompt=list(p), sampling=SamplingParams(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]
    s = eng.run(reqs, max_steps=6000).summary()
    assert s["n_done"] == len(reqs)
    assert [r.out_tokens for r in reqs] == _reference_streams(setup, prompts, n_new)
    assert eng.alloc.n_allocated == 0 and eng.idle()
    assert not eng.sanitizer._preempt_snaps


# =============================================== scheduler + sanitizer ====
def test_admission_charges_per_chunk_not_whole_prompt(setup):
    req = Request(rid=0, prompt=list(range(2, 66)), sampling=SamplingParams(max_new_tokens=4))
    roomy = dataclasses.replace(BASE, n_pages=64, max_pages_per_seq=32)
    chunked_need = _engine(setup, roomy).sched.admission_pages(req)
    seq_need = _engine(setup, dataclasses.replace(roomy, mode="sequential")) \
        .sched.admission_pages(req)
    assert chunked_need < seq_need
    assert chunked_need <= (BASE.chunk_tokens // PS) + 2


def test_sanitizer_flags_contract_breaking_plan(setup):
    class _DropsDecodes:
        def plan(self, remaining, n_decode_tokens, priorities=None):
            return ChunkPlan(tuple(0 for _ in remaining), max(n_decode_tokens - 1, 0),
                             BASE.chunk_tokens, BASE.chunk_tokens)

    eng = _engine(setup, dataclasses.replace(BASE, sanitize_level="step"))
    eng.planner = _DropsDecodes()
    with pytest.raises(InvariantViolation) as e:
        eng.run(_workload(setup[0].cfg.vocab_size), max_steps=8000)
    assert e.value.invariant == "chunk_plan"


# =========================================== tail-TBT property + metrics ====
def test_decodes_ride_every_round_during_long_prefill(setup):
    rng = np.random.RandomState(3)
    vocab = setup[0].cfg.vocab_size
    short = [int(t) for t in rng.randint(2, vocab, size=4)]
    long_p = [int(t) for t in rng.randint(2, vocab, size=48)]

    def starved_rounds(mode):
        eng = _engine(setup, dataclasses.replace(BASE, mode=mode, n_pages=96,
                                                 max_pages_per_seq=24))
        sr = Request(rid=0, prompt=list(short), sampling=SamplingParams(max_new_tokens=16))
        eng.submit(sr)
        while not sr.out_tokens:             # short request mid-decode...
            eng.step()
        eng.submit(Request(rid=1, prompt=list(long_p),   # ...enter the long prompt
                           sampling=SamplingParams(max_new_tokens=2)))
        starved = 0
        while len(sr.out_tokens) < 16:
            evs = eng.step()
            if not any(ev.rid == sr.rid for ev in evs):
                starved += 1
        while not eng.idle():
            eng.step()
        return starved

    assert starved_rounds("chunked") == 0
    assert starved_rounds("splitwiser") > 0


def test_chunk_metrics_surface_in_summary(setup):
    eng = _engine(setup, dataclasses.replace(BASE, n_pages=96))
    s = eng.run(_workload(setup[0].cfg.vocab_size), max_steps=8000).summary()
    assert s["n_chunks"] > 0
    assert 0.0 < s["chunk_occupancy"] <= 2.0
    hist = s["packed_tokens_hist"]
    assert hist and all(k > 0 and v > 0 for k, v in hist.items())
    assert sum(hist.values()) == eng.metrics.step_kinds.count("mixed")
    assert max(hist) <= BASE.chunk_tokens + BASE.max_batch
