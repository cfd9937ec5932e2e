"""End-to-end system behaviour of the port's engine, held to
tests/test_system.py: every engine mode produces EXACTLY the tokens a
naive full-forward greedy loop produces, while tracking the paper's
metrics; plus phase accounting per mode and per-request EOS.

The oracle is the port's own full forward (``embed`` ->
``forward_hidden`` -> ``unembed`` over the whole sequence, re-run for
every token), on the reference's reduced qwen3-0.6b weights converted
with ``params_from_jax``; the reference test's prompts and workloads.
Each reference test has its counterpart of the same name; the modes run
are the reference's three plus ``chunked``.  The first greedy token that
``test_eos_termination`` stops on is the reference engine's.
"""
import numpy as np
import pytest
import torch

from torch_parity import reduced_models

from repro.configs import ServeConfig as JServeConfig
from repro.core.engine import Engine as JEngine
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSampling
from repro_torch.configs import ServeConfig
from repro_torch.core.engine import Engine, Request, SamplingParams
from repro_torch.models import transformer as T

N_NEW = 6
OFF = dict(sanitize_level="off", dispatch_sentinel=False)


@pytest.fixture(scope="module")
def setup():
    jm, jp, model, params = reduced_models()
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(2, model.cfg.vocab_size,
                                            size=rng.randint(5, 20))] for _ in range(6)]

    def naive(prompt):
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(N_NEW):
                x = T.embed(params, model.cfg, torch.tensor([toks]))
                h, _ = T.forward_hidden(params, model.cfg, x,
                                        torch.arange(len(toks))[None])
                toks.append(int(T.unembed(params, model.cfg, h[0, -1]).argmax()))
        return toks[len(prompt):]

    oracle = [naive(p) for p in prompts]
    return model, params, prompts, oracle, (jm, jp)


def _requests(prompts, n_new=N_NEW):
    return [Request(rid=i, prompt=list(p), sampling=SamplingParams(max_new_tokens=n_new))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("mode", ["sequential", "splitwiser", "splitwiser_mps", "chunked"])
def test_mode_matches_oracle(setup, mode):
    model, params, prompts, oracle, _ = setup
    serve = ServeConfig(mode=mode, max_batch=4, page_size=4, n_pages=128,
                        max_pages_per_seq=16, prefill_chunk=4, n_streams=2, chunk_tokens=8,
                        **OFF)
    eng = Engine(model, params, serve, device="cpu")
    reqs = _requests(prompts)
    m = eng.run(reqs, max_steps=1000)
    assert [r.out_tokens for r in reqs] == oracle
    outs = {o.rid: o for o in eng.poll()}
    assert [outs[i].tokens for i in range(len(prompts))] == oracle
    assert all(o.finish_reason == "length" for o in outs.values())
    s = m.summary()
    assert s["n_done"] == len(prompts)
    assert s["finish_reasons"] == {"length": len(prompts)}
    assert s["throughput_tok_s"] > 0
    assert s["ttft"]["mean"] is not None and s["ttft"]["mean"] >= 0
    assert 0 < s["kv_usage_peak"] <= 1.0


def test_mode_step_kinds(setup):
    """sequential never emits mixed steps; splitwiser_mps and chunked only
    mixed."""
    model, params, prompts, _, _ = setup
    for mode in ["sequential", "splitwiser_mps", "chunked"]:
        serve = ServeConfig(mode=mode, max_batch=4, page_size=4, n_pages=128,
                            max_pages_per_seq=16, prefill_chunk=4, n_streams=2,
                            chunk_tokens=8, **OFF)
        eng = Engine(model, params, serve, device="cpu")
        eng.run(_requests(prompts), max_steps=1000)
        kinds = set(eng.metrics.step_kinds) - {"idle"}
        if mode == "sequential":
            assert kinds == {"prefill", "decode"}
        else:
            assert kinds == {"mixed"}


def test_mixed_batching_reduces_steps(setup):
    """The Splitwiser property: fused mode advances both phases per step
    -> strictly fewer engine steps than the time-sliced (no-MPS) mode on
    a mixed workload."""
    model, params, prompts, _, _ = setup
    results = {}
    for mode in ["splitwiser", "splitwiser_mps"]:
        serve = ServeConfig(mode=mode, max_batch=4, page_size=4, n_pages=256,
                            max_pages_per_seq=32, prefill_chunk=4, n_streams=2, **OFF)
        eng = Engine(model, params, serve, device="cpu")
        long_prompt = [int(t) for t in np.random.RandomState(7).randint(2, 200, size=64)]
        reqs = [Request(rid=0, prompt=list(prompts[0]),
                        sampling=SamplingParams(max_new_tokens=20)),
                Request(rid=1, prompt=long_prompt, sampling=SamplingParams(max_new_tokens=4))]
        eng.run(reqs, max_steps=1000)
        results[mode] = eng.metrics.n_steps
    assert results["splitwiser_mps"] < results["splitwiser"], results


def test_eos_termination(setup):
    """eos_id is a per-request SamplingParams knob, not engine state."""
    model, params, prompts, _, (jm, jp) = setup
    kw = dict(mode="sequential", max_batch=4, page_size=4, n_pages=128, max_pages_per_seq=16,
              **OFF)
    ref = JRequest(rid=0, prompt=list(prompts[0]), sampling=JSampling(max_new_tokens=5))
    JEngine(jm, jp, JServeConfig(**kw)).run([ref])
    first = ref.out_tokens[0]
    eng = Engine(model, params, ServeConfig(**kw), device="cpu")
    r2 = Request(rid=0, prompt=list(prompts[0]),
                 sampling=SamplingParams(max_new_tokens=5, eos_id=first))
    # an eos-less request in the SAME batch keeps generating
    r3 = Request(rid=1, prompt=list(prompts[0]), sampling=SamplingParams(max_new_tokens=5))
    eng.run([r2, r3])
    assert r2.out_tokens[0] == first and len(r2.out_tokens) == 1
    assert r3.out_tokens == ref.out_tokens
    outs = {o.rid: o for o in eng.poll()}
    assert outs[0].finish_reason == "stop"
    assert outs[1].finish_reason == "length"
    assert eng.alloc.n_allocated == 0
