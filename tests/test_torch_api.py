"""The port's request/response API, held to tests/test_api.py.

Per-request ``SamplingParams`` honored identically in every engine mode,
``TokenEvent`` streams well-ordered, ``RequestOutput`` polling, open-loop
arrivals respecting timestamps, seeded sampling independent of batch
composition, and the arrival-sentinel and slot-invariant regressions —
each reference test has its counterpart of the same name here, on the
reference test's reduced qwen3-0.6b and prompts with the reference's
weights converted (``tests/torch_parity.py``).  The modes run are the
reference's three plus ``chunked``.

Sampled token values differ from the reference by design (the port draws
its noise from ``torch.Generator``, the reference from threefry), so the
sampled assertions stay properties.  Where a test pins a greedy token,
the expected value is the reference engine's on the same weights.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import reduced_models

from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request, SamplingParams

MODES = ["sequential", "splitwiser", "splitwiser_mps", "chunked"]
SERVE = ServeConfig(mode="sequential", max_batch=4, page_size=4, n_pages=128,
                    max_pages_per_seq=16, prefill_chunk=4, n_streams=2, chunk_tokens=8,
                    sanitize_level="off", dispatch_sentinel=False)


@pytest.fixture(scope="module")
def setup():
    jm, jp, model, params = reduced_models()
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(2, model.cfg.vocab_size,
                                            size=rng.randint(5, 18))] for _ in range(4)]
    return model, params, prompts, (jm, jp)


def _engine(setup, serve=SERVE):
    model, params = setup[:2]
    return Engine(model, params, serve, device="cpu")


def _reference_greedy(setup, prompt, n_new):
    """The reference engine's greedy tokens for ``prompt`` (same weights)."""
    jm, jp = setup[3]
    serve = JServeConfig(**{f.name: getattr(SERVE, f.name)
                            for f in dataclasses.fields(JServeConfig)})
    r = JRequest(rid=0, prompt=list(prompt), sampling=JSampling(max_new_tokens=n_new))
    JEngine(jm, jp, serve).run([r], max_steps=1000)
    return r.out_tokens


def _mixed_requests(prompts):
    """One batch, four different sampling policies."""
    policies = [
        SamplingParams(max_new_tokens=6),                          # greedy
        SamplingParams(max_new_tokens=8, temperature=0.8, seed=7),
        SamplingParams(max_new_tokens=5, temperature=1.0, top_k=3, seed=9),
        SamplingParams(max_new_tokens=7, temperature=0.9, top_p=0.8, seed=3),
    ]
    return [Request(rid=i, prompt=list(p), sampling=policies[i])
            for i, p in enumerate(prompts)]


# ------------------------------------------------- per-request sampling ----
def test_per_request_params_agree_across_modes(setup):
    """A heterogeneous batch (greedy + temperature + top-k + top-p, mixed
    budgets) produces the same per-request tokens in every mode; its
    greedy request gives the reference engine's tokens."""
    prompts = setup[2]
    per_mode = {}
    for mode in MODES:
        eng = _engine(setup, dataclasses.replace(SERVE, mode=mode))
        reqs = _mixed_requests(prompts)
        eng.run(reqs, max_steps=1000)
        per_mode[mode] = [r.out_tokens for r in reqs]
        for r in reqs:
            assert len(r.out_tokens) == r.sampling.max_new_tokens
    for mode in MODES[1:]:
        assert per_mode["sequential"] == per_mode[mode], mode
    assert per_mode["sequential"][0] == _reference_greedy(setup, prompts[0], 6)


def test_seeded_sampling_independent_of_batch_composition(setup):
    """(seed, rid, pos)-derived streams: a request's sampled tokens don't
    change when other requests share (or leave) the batch."""
    prompts = setup[2]
    sp = SamplingParams(max_new_tokens=6, temperature=1.0, seed=5)
    alone = Request(rid=2, prompt=list(prompts[2]), sampling=sp)
    _engine(setup).run([alone], max_steps=1000)
    eng = _engine(setup, dataclasses.replace(SERVE, mode="splitwiser_mps"))
    reqs = _mixed_requests(prompts)
    reqs[2] = Request(rid=2, prompt=list(prompts[2]), sampling=sp)
    eng.run(reqs, max_steps=1000)
    assert reqs[2].out_tokens == alone.out_tokens


def test_seed_changes_sampled_tokens(setup):
    prompts = setup[2]
    outs = []
    for seed in (0, 1):
        r = Request(rid=0, prompt=list(prompts[0]),
                    sampling=SamplingParams(max_new_tokens=8, temperature=1.0, seed=seed))
        _engine(setup).run([r], max_steps=1000)
        outs.append(r.out_tokens)
    assert outs[0] != outs[1]


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="max_new_tokens"):
        SamplingParams(max_new_tokens=0)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-0.1)


# ------------------------------------------------------- events/outputs ----
@pytest.mark.parametrize("mode", MODES)
def test_stream_event_ordering(setup, mode):
    eng = _engine(setup, dataclasses.replace(SERVE, mode=mode))
    events = list(eng.stream(_mixed_requests(setup[2]), max_steps=1000))
    outs = {o.rid: o for o in eng.poll()}
    assert [e.t for e in events] == sorted(e.t for e in events)
    by_rid = {}
    for e in events:
        by_rid.setdefault(e.rid, []).append(e)
    assert set(by_rid) == set(outs)
    for rid, evs in by_rid.items():
        assert [e.index for e in evs] == list(range(len(evs)))
        assert [e.first for e in evs] == [True] + [False] * (len(evs) - 1)
        assert [e.finish_reason for e in evs[:-1]] == [None] * (len(evs) - 1)
        assert evs[-1].finish_reason in ("length", "stop")
        assert [e.token for e in evs] == outs[rid].tokens
        assert [e.t for e in evs] == outs[rid].token_times


def test_poll_drains_once(setup):
    eng = _engine(setup)
    eng.run(_mixed_requests(setup[2]), max_steps=1000)
    outs = eng.poll()
    assert len(outs) == len(setup[2])
    assert eng.poll() == []
    for o in outs:
        assert o.ttft is not None and o.ttft >= 0
        assert o.e2e >= 0 and o.t_done >= o.arrival
        assert len(o.token_times) == len(o.tokens)


def test_stop_token_finish_reason(setup):
    prompts = setup[2]
    r = Request(rid=0, prompt=list(prompts[0]), sampling=SamplingParams(max_new_tokens=5))
    _engine(setup).run([r], max_steps=1000)
    first = r.out_tokens[0]
    assert r.out_tokens == _reference_greedy(setup, prompts[0], 5)
    eng = _engine(setup)
    r2 = Request(rid=0, prompt=list(prompts[0]),
                 sampling=SamplingParams(max_new_tokens=5, stop_token_ids=(first,)))
    eng.run([r2], max_steps=1000)
    (out,) = eng.poll()
    assert out.tokens == [first]
    assert out.finish_reason == "stop"


def test_step_returns_events(setup):
    eng = _engine(setup)
    eng.submit(Request(rid=0, prompt=list(setup[2][0]),
                       sampling=SamplingParams(max_new_tokens=3)))
    all_events = []
    for _ in range(100):
        if eng.idle():
            break
        all_events.extend(eng.step())
    assert [e.index for e in all_events] == [0, 1, 2]


# ----------------------------------------------------- open-loop arrivals --
def test_open_loop_respects_arrival_timestamps(setup):
    prompts = setup[2]
    offsets = [0.0, 0.3, 0.6, 0.9]
    eng = _engine(setup)
    reqs = [Request(rid=i, prompt=list(p), sampling=SamplingParams(max_new_tokens=3),
                    arrival=offsets[i])
            for i, p in enumerate(prompts)]
    m = eng.run(reqs, open_loop=True, max_steps=2000)
    assert m.summary()["n_done"] == len(prompts)
    t0 = min(m.req(i).arrival for i in range(len(prompts)))
    for i, off in enumerate(offsets):
        r = m.req(i)
        assert r.arrival == pytest.approx(t0 + off)   # offsets preserved
        assert r.t_first_token >= r.arrival           # no time travel
    admit_t = {e["rid"]: e["t"] for e in m.sched_events if e["event"] == "admit"}
    for i in range(len(prompts)):
        assert admit_t[i] >= m.req(i).arrival


def test_open_loop_matches_closed_loop_tokens(setup):
    """Arrival timing shifts latency, never tokens."""
    closed = _mixed_requests(setup[2])
    _engine(setup).run(closed, max_steps=1000)
    opened = _mixed_requests(setup[2])
    for i, r in enumerate(opened):
        r.arrival = 0.05 * i
    _engine(setup).run(opened, open_loop=True, max_steps=2000)
    assert [r.out_tokens for r in opened] == [r.out_tokens for r in closed]


def test_submit_is_legal_mid_run(setup):
    eng = _engine(setup)
    eng.submit(Request(rid=0, prompt=list(setup[2][0]),
                       sampling=SamplingParams(max_new_tokens=4)))
    eng.step()                                   # engine is now mid-run
    eng.submit(Request(rid=1, prompt=list(setup[2][1]),
                       sampling=SamplingParams(max_new_tokens=4)))
    m = eng.run([], max_steps=1000)              # drain both
    assert m.summary()["n_done"] == 2
    assert {o.rid for o in eng.poll()} == {0, 1}


def test_submit_preserves_explicit_zero_arrival(setup):
    """Regression: `arrival or now()` treated an explicit 0.0 as unset."""
    eng = _engine(setup)
    r = Request(rid=0, prompt=list(setup[2][0]), sampling=SamplingParams(max_new_tokens=2),
                arrival=0.0)
    eng.submit(r)
    assert r.arrival == 0.0
    assert eng.metrics.req(0).arrival == 0.0
    r2 = Request(rid=1, prompt=list(setup[2][1]), sampling=SamplingParams(max_new_tokens=2))
    eng.submit(r2)
    assert r2.arrival is not None and r2.arrival > 0.0   # stamped at submit


# -------------------------------------------------------- config / slots ---
def test_unknown_mode_rejected_at_config():
    with pytest.raises(ValueError, match="supported modes"):
        ServeConfig(mode="splitwise")
    with pytest.raises(ValueError, match="supported modes"):
        dataclasses.replace(SERVE, mode="mp2")


def test_sequential_admission_never_overfills_slots(setup):
    """Admission is bounded by free decode slots: with max_batch=2 and 6
    requests, active slots never exceed 2 and no prefill batch is larger
    than the free-slot count (the `_emit_first_token` invariant)."""
    prompts = setup[2]
    eng = _engine(setup, dataclasses.replace(SERVE, max_batch=2))
    for i in range(6):
        eng.submit(Request(rid=i, prompt=list(prompts[i % len(prompts)]),
                           sampling=SamplingParams(max_new_tokens=4)))
    orig = eng._do_full_prefill

    def spy(reqs):
        assert len(reqs) <= sum(s is None for s in eng.slots)
        return orig(reqs)

    eng._do_full_prefill = spy
    for _ in range(500):
        if eng.idle():
            break
        eng.step()
        assert sum(s is not None for s in eng.slots) <= 2
    assert eng.metrics.summary()["n_done"] == 6


def test_overfull_slots_raise_clear_invariant_error(setup):
    """If the invariant ever breaks, the error says so instead of a bare
    `ValueError: None is not in list`."""
    eng = _engine(setup)
    r = Request(rid=99, prompt=list(setup[2][0]), sampling=SamplingParams(max_new_tokens=4))
    eng.submit(r)
    eng.slots = [object()] * len(eng.slots)      # simulate the broken state
    with pytest.raises(RuntimeError, match="slot invariant"):
        eng._emit_first_token(r, tok=1, seq_len=4, t=0.0)


# ------------------------------------------------------------ quickstart ---
def test_torch_quickstart_runs_on_cpu():
    """examples/torch_quickstart.py as a user runs it, with ``--device cpu``:
    its stop-token request stops, and the three arms agree."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, str(root / "examples" / "torch_quickstart.py"),
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done(stop)" in out.stdout
    assert "all three arms produce identical tokens" in out.stdout
