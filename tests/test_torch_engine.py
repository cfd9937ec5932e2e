"""The port's Engine against the reference Engine, on the CPU.

Same model, weights, requests and ServeConfig on both sides: greedy
token streams, step kinds and scheduler event traces (without their
wall-clock ``t``) must be equal, in every mode (on qwen3-0.6b, opt-125m
and gemma2-2b, whose reduced window of 8 keys the prompts outgrow), with
the prefix cache on and under preemption.
"""
import numpy as np
import pytest

from torch_parity import reduced_models

from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.configs import ServeConfig as PServeConfig
from repro_torch.core.engine import Engine as PEngine
from repro_torch.core.engine import Request as PRequest
from repro_torch.core.sampler import SamplingParams as PSampling

MODES = ["sequential", "splitwiser", "splitwiser_mps", "chunked"]
ARCHS = ["qwen3-0.6b", "opt-125m", "gemma2-2b"]
# the workload of tests/test_system.py
SYSTEM = dict(max_batch=4, page_size=4, n_pages=128, max_pages_per_seq=16,
              prefill_chunk=4, n_streams=2, chunk_tokens=8)


@pytest.fixture(scope="module")
def models():
    return reduced_models()


def _system_prompts(vocab):
    rng = np.random.RandomState(0)
    return [list(rng.randint(2, vocab, size=rng.randint(5, 20)))
            for _ in range(6)]


def _shared_prefix_prompts(vocab):
    rng = np.random.RandomState(0)
    system = list(rng.randint(2, vocab, size=24))
    return [system + list(rng.randint(2, vocab, size=4)) for _ in range(6)]


def _pressure_prompts(vocab):
    rng = np.random.RandomState(0)
    return [list(rng.randint(2, vocab, size=n)) for n in (12, 11, 12, 10)]


def _run(engine_cls, req_cls, sp_cls, model, params, serve, prompts, n_new,
         **kw):
    eng = engine_cls(model, params, serve, **kw)
    reqs = [req_cls(rid=i, prompt=[int(t) for t in p],
                    sampling=sp_cls(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]
    m = eng.run(reqs, max_steps=4000)
    events = [{k: v for k, v in e.items() if k != "t"}
              for e in m.sched_events]
    return [r.out_tokens for r in reqs], list(m.step_kinds), events, m


def _both(models, prompts, n_new, **serve_kw):
    jm, jp, pm, pp = models
    kw = dict(serve_kw, sanitize_level="off", dispatch_sentinel=False)
    ref = _run(JEngine, JRequest, JSampling, jm, jp, JServeConfig(**kw),
               prompts, n_new)
    port = _run(PEngine, PRequest, PSampling, pm, pp, PServeConfig(**kw),
                prompts, n_new, device="cpu")
    return ref, port


def _assert_same(ref, port):
    tokens, kinds, events, _ = port
    assert tokens == ref[0]
    assert kinds == ref[1]
    assert events == ref[2]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, mode):
    models = reduced_models(arch)
    ref, port = _both(models, _system_prompts(models[0].cfg.vocab_size), 6,
                      mode=mode, **SYSTEM)
    _assert_same(ref, port)
    assert port[3].summary()["n_done"] == 6


@pytest.mark.parametrize("mode", ["sequential", "splitwiser_mps"])
def test_engine_prefix_cache_matches_reference(models, mode):
    ref, port = _both(models, _shared_prefix_prompts(models[0].cfg.vocab_size),
                      8, mode=mode, enable_prefix_cache=True, **SYSTEM)
    _assert_same(ref, port)
    s = port[3].summary()
    assert s["cache_hit_rate"] > 0 and s["pages_shared_peak"] > 0


@pytest.mark.parametrize("mode", ["sequential", "chunked"])
def test_engine_preemption_matches_reference(models, mode):
    small = dict(SYSTEM, n_pages=20, max_pages_per_seq=12)
    ref, port = _both(models, _pressure_prompts(models[0].cfg.vocab_size), 16,
                      mode=mode, **small)
    _assert_same(ref, port)
    assert port[3].summary()["n_preemptions"] > 0


def _counting_clock():
    ticks = iter(range(10**9))
    return lambda: float(next(ticks))


@pytest.mark.parametrize("mode", ["splitwiser", "chunked"])
def test_engine_open_loop_matches_reference(models, mode):
    """Open-loop arrivals on a counting clock: both engines read the clock
    at the same points, so even the event timestamps agree."""
    jm, jp, pm, pp = models
    prompts = _system_prompts(jm.cfg.vocab_size)
    arrivals = [0.0, 0.0, 30.0, 60.0, 61.0, 400.0]
    kw = dict(SYSTEM, mode=mode, sanitize_level="off", dispatch_sentinel=False)
    runs = []
    for eng_cls, req_cls, sp_cls, serve_cls, model, params, extra in (
            (JEngine, JRequest, JSampling, JServeConfig, jm, jp, {}),
            (PEngine, PRequest, PSampling, PServeConfig, pm, pp, {"device": "cpu"})):
        eng = eng_cls(model, params, serve_cls(**kw), time_fn=_counting_clock(), **extra)
        reqs = [req_cls(rid=i, prompt=[int(t) for t in p], arrival=a,
                        sampling=sp_cls(max_new_tokens=6))
                for i, (p, a) in enumerate(zip(prompts, arrivals))]
        m = eng.run(reqs, open_loop=True, max_steps=4000)
        runs.append(([r.out_tokens for r in reqs], list(m.step_kinds),
                     list(m.sched_events),
                     [m.requests[i].token_times for i in range(len(reqs))]))
    assert runs[1] == runs[0]
