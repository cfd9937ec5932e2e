"""The port's serving launcher (``repro_torch.launch.serve``) and its
synthetic data (``repro_torch.data``) against the reference's, on the
CPU.

The data helpers give the reference's values exactly.  The launcher's
``--json`` summary on a reduced opt-125m (4 requests of 16 tokens, 4 new)
has the reference CLI's request count, engine steps and finish reasons
in each of its three modes: greedy decoding with no EOS makes those
independent of the weights.  An engine built from ``build_engine``'s
configuration on the reference's converted weights gives the reference
engine's streams exactly.  The model registry builds every architecture
of the reference's, with its family and cache kind.
"""
import json
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import data as JD
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_get_config
from repro.core.engine import Request as JRequest
from repro.core.sampler import SamplingParams as JSamplingParams
from repro.launch import serve as JS
from repro.models.registry import CACHE_KIND as JCACHE_KIND
from repro_torch import data as PD
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.launch import serve as PS
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model

CLI_ARGS = ["--reduced", "--json", "--n-requests", "4", "--input-tokens", "16",
            "--output-tokens", "4"]


def test_synthetic_data_matches_reference():
    assert PD.synthetic_reports(5, seed=3) == JD.synthetic_reports(5, seed=3)
    for n, length, vocab, seed in ((4, 16, 256, 0), (3, 300, 50_272, 2)):
        assert PD.report_tokens(n, length, vocab, seed) == \
            JD.report_tokens(n, length, vocab, seed)
    np.testing.assert_array_equal(PD.poisson_arrivals(16, 2.5, seed=1),
                                  JD.poisson_arrivals(16, 2.5, seed=1))
    for step in (0, 7):
        got = PD.lm_batch(step, batch=4, seq=32, vocab=256, seed=5)
        want = JD.lm_batch(step, batch=4, seq=32, vocab=256, seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    tcfg = SimpleNamespace(global_batch=2, seq_len=8, seed=1)
    for arch in ("seamless-m4t-medium", "internvl2-2b"):
        cfg = get_config(arch).reduced()
        got, want = PD.make_train_data_fn(cfg, tcfg)(3), JD.make_train_data_fn(cfg, tcfg)(3)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _summary(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["sequential", "splitwiser", "splitwiser_mps"])
def test_cli_summary_matches_reference(mode, monkeypatch, capsys):
    argv = CLI_ARGS + ["--mode", mode]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    JS.main()
    want = _summary(capsys.readouterr().out)
    PS.main(argv + ["--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert got["n_done"] == 4
    for key in ("n_done", "n_steps", "finish_reason_by_rid", "finish_reasons"):
        assert got[key] == want[key], key


def test_build_engine_streams_match_reference():
    """``main``'s engine configuration (opt-125m reduced, 4 prompts of 16
    report tokens, 4 new) in ``splitwiser_mps``."""
    kw = dict(reduced=True, n_pages=512, max_pages_per_seq=3)
    ref, cfg = JS.build_engine("opt-125m", "splitwiser_mps", **kw)
    port, port_cfg = PS.build_engine("opt-125m", "splitwiser_mps", device="cpu", **kw)
    assert port.serve == type(port.serve)(**vars(ref.serve))
    assert port_cfg.name == cfg.name
    eng = Engine(port.model, params_from_jax(jax.tree.map(np.asarray, ref.params), "cpu"),
                 port.serve, device="cpu")
    prompts = PD.report_tokens(4, 16, cfg.vocab_size)
    want = [JRequest(rid=i, prompt=p, sampling=JSamplingParams(max_new_tokens=4))
            for i, p in enumerate(prompts)]
    got = [Request(rid=i, prompt=p, sampling=SamplingParams(max_new_tokens=4))
           for i, p in enumerate(prompts)]
    ref.run(want)
    eng.run(got)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 4 for r in got)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_registry_builds_every_reference_arch(arch, monkeypatch):
    """Every arch of the reference registry builds, reduced, with the
    reference's family and cache kind; the Engine serves the paged kind
    alone, as the reference's does.  rwkv6 and seamless-m4t init on the
    CPU when asked and, with no card, raise naming device="cpu"."""
    cfg = get_config(arch).reduced()
    model = get_model(arch, cfg)
    assert cfg == type(cfg)(**vars(jax_get_config(arch).reduced()))
    assert model.cache_kind == JCACHE_KIND[cfg.family]
    if model.cache_kind != "paged":
        with pytest.raises(TypeError, match=re.escape(model.cache_kind)):
            Engine(model, {}, ServeConfig(), device="cpu")
    if cfg.family in ("ssm", "encdec"):
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        assert params["embed"].device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            model.init(torch.Generator().manual_seed(0))
