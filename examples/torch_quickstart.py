"""Quickstart with the PyTorch port: serve a small LM with the Splitwiser
engine (the counterpart of ``examples/quickstart.py``).

    export PYTHONPATH=src
    python examples/torch_quickstart.py                # on the GPU
    python examples/torch_quickstart.py --device cpu   # on the CPU

Builds the paper's model (opt-125m dims, reduced) and walks the
vLLM-shaped API surface:

  1. per-request ``SamplingParams`` — a greedy request, a temperature-
     sampled one, and one that stops on a stop token, all in one batch;
  2. streaming ``TokenEvent``s from ``Engine.stream()`` and final
     ``RequestOutput``s from ``Engine.poll()``;
  3. the three execution arms from the paper (sequential, splitwiser,
     splitwiser+MPS) producing identical tokens.
"""
import argparse

import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.data import report_tokens
from repro_torch.models.registry import get_model


def serve_config(mode):
    return ServeConfig(mode=mode, max_batch=4, page_size=16, n_pages=256,
                       max_pages_per_seq=8, prefill_chunk=32, n_streams=2)


def make_requests(prompts, stop_token):
    """One batch, three different per-request sampling policies."""
    greedy = SamplingParams(max_new_tokens=10)
    sampled = SamplingParams(max_new_tokens=10, temperature=0.8, top_k=40, seed=7)
    short = SamplingParams(max_new_tokens=10, stop_token_ids=(stop_token,))
    policies = [greedy, sampled, short]
    return [Request(rid=i, prompt=list(p), sampling=policies[i % 3])
            for i, p in enumerate(prompts)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = get_model("opt-125m", get_config("opt-125m").reduced())
    params = model.init(torch.Generator().manual_seed(0), device=args.device)
    prompts = report_tokens(6, 48, model.cfg.vocab_size)

    def engine(mode):
        return Engine(model, params, serve_config(mode), device=args.device)

    # learn a token the model actually emits for prompt 2, so the
    # stop-token policy demonstrably fires (finish_reason="stop")
    pr = Request(rid=0, prompt=list(prompts[2]), sampling=SamplingParams(max_new_tokens=2))
    engine("sequential").run([pr])
    stop_token = pr.out_tokens[-1]

    # --- streaming: watch tokens arrive (splitwiser_mps arm) -------------
    eng = engine("splitwiser_mps")
    n_events = 0
    for ev in eng.stream(make_requests(prompts, stop_token)):
        n_events += 1
        if ev.first or ev.finish_reason:
            tag = "first" if ev.first else f"done({ev.finish_reason})"
            print(f"  [stream] rid={ev.rid} token#{ev.index}={ev.token:4d} {tag}")
    outputs = {o.rid: o for o in eng.poll()}
    print(f"streamed {n_events} TokenEvents; "
          f"finish reasons: { {r: o.finish_reason for r, o in sorted(outputs.items())} }")
    if outputs[2].finish_reason != "stop":
        raise RuntimeError("the stop-token demo did not fire")
    print(f"rid=0 output: {outputs[0].tokens}  "
          f"TTFT={outputs[0].ttft:.3f}s TBT={(outputs[0].tbt or 0):.4f}s\n")

    # --- the paper's three arms on the same mixed workload ---------------
    per_mode = {}
    for mode in ["sequential", "splitwiser", "splitwiser_mps"]:
        reqs = make_requests(prompts, stop_token)
        s = engine(mode).run(reqs).summary()
        per_mode[mode] = [r.out_tokens for r in reqs]
        print(f"{mode:16s} steps={s['n_steps']:4d} "
              f"wall={s['wall_s']:.2f}s tput={s['throughput_tok_s']:7.1f} tok/s "
              f"TTFT={s['ttft']['mean']:.3f}s KVpeak={s['kv_usage_peak']:.0%}")
    if not per_mode["sequential"] == per_mode["splitwiser"] == per_mode["splitwiser_mps"]:
        raise RuntimeError("the modes disagree token for token")
    print("\nall three arms produce identical tokens per request "
          "(seeded sampling is batch- and mode-independent)")


if __name__ == "__main__":
    main()
