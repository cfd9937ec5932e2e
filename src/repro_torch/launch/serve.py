"""Serving launcher — drive the Splitwiser engine on a synthetic workload.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-125m \\
        --mode splitwiser_mps --n-requests 16 --input-tokens 64 \\
        --output-tokens 16                       # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-125m \\
        --reduced --device cpu                   # plain versions, on the CPU

The counterpart of the reference's ``launch/serve.py``, with its flags,
defaults and output, plus ``--device`` (default ``cuda``, which raises
without a card; ``cpu`` runs the kernels' plain versions).  Modes:
sequential | splitwiser | splitwiser_mps (paper arms; see
core/engine.py).  Sampling knobs (--temperature/--top-k/--top-p/--seed)
apply per request via ``SamplingParams``; ``--arrival-rate R`` switches
to an open-loop replay with Poisson arrivals at R requests per virtual
second.  Prints the paper's metrics (E2E, TTFT, TBT, throughput, KV
usage).  The engine serves paged-KV architectures (the transformer
family); the others raise, as in the reference.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.data import report_tokens
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model


def build_engine(arch, mode, *, reduced=True, max_batch=8, page_size=16,
                 n_pages=512, n_streams=2, prefill_chunk=64, seed=0,
                 max_pages_per_seq=64, device=None):
    """(Engine, model config): ``arch`` (its reduced config with
    ``reduced``) with random weights drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    device = resolve_device(device)
    model = get_model(arch, cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    serve = ServeConfig(mode=mode, max_batch=max_batch, page_size=page_size,
                        n_pages=n_pages, n_streams=n_streams,
                        prefill_chunk=prefill_chunk,
                        max_pages_per_seq=max_pages_per_seq)
    return Engine(model, params, serve, device=device), cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--mode", default="splitwiser_mps",
                    choices=["sequential", "splitwiser", "splitwiser_mps"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--input-tokens", type=int, default=64)
    ap.add_argument("--output-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--n-streams", type=int, default=2)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals at this many req/s "
                         "(0 = closed loop, all requests at t=0)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    engine, cfg = build_engine(
        args.arch, args.mode, reduced=args.reduced, max_batch=args.max_batch,
        n_streams=args.n_streams, prefill_chunk=args.prefill_chunk,
        n_pages=max(512, args.n_requests *
                    (args.input_tokens + args.output_tokens) // 16 + 64),
        max_pages_per_seq=(args.input_tokens + args.output_tokens) // 16 + 2,
        device=args.device)
    prompts = report_tokens(args.n_requests, args.input_tokens,
                            cfg.vocab_size)
    sampling = SamplingParams(max_new_tokens=args.output_tokens,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    open_loop = args.arrival_rate > 0
    arrivals = (np.cumsum(np.random.default_rng(0).exponential(
        1.0 / args.arrival_rate, size=args.n_requests))
        if open_loop else [None] * args.n_requests)
    reqs = [Request(rid=i, prompt=p, sampling=sampling, arrival=arrivals[i])
            for i, p in enumerate(prompts)]
    metrics = engine.run(reqs, open_loop=open_loop)
    outputs = engine.poll()
    s = metrics.summary()
    if args.json:
        s["finish_reason_by_rid"] = {o.rid: o.finish_reason for o in outputs}
        print(json.dumps(s, default=str))
    else:
        print(f"mode={args.mode} done={s['n_done']}/{args.n_requests} "
              f"steps={s['n_steps']} wall={s['wall_s']:.2f}s "
              f"open_loop={open_loop}")
        print(f"throughput {s['throughput_tok_s']:.1f} tok/s | "
              f"TTFT mean {s['ttft']['mean']:.3f}s | "
              f"TBT mean {(s['tbt']['mean'] or 0):.4f}s | "
              f"E2E mean {s['e2e']['mean']:.3f}s")
        print(f"KV usage peak {s['kv_usage_peak']:.1%} "
              f"mean {s['kv_usage_mean']:.1%} | "
              f"finish_reasons {s['finish_reasons']}")


if __name__ == "__main__":
    main()
