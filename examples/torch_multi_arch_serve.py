"""Serve different architecture families through the same engine and API
with the PyTorch port (the counterpart of ``examples/multi_arch_serve.py``):
dense (qwen3), MoE (olmoe), sliding-window+softcap (gemma2) — all reduced
configs, in the ``splitwiser_mps`` arm.

    export PYTHONPATH=src
    python examples/torch_multi_arch_serve.py                # on the GPU
    python examples/torch_multi_arch_serve.py --device cpu   # on the CPU
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.models.registry import get_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    for arch in ["qwen3-0.6b", "olmoe-1b-7b", "gemma2-2b"]:
        model = get_model(arch, get_config(arch).reduced())
        cfg = model.cfg
        params = model.init(torch.Generator().manual_seed(0), device=args.device)
        serve = ServeConfig(mode="splitwiser_mps", max_batch=4, page_size=8, n_pages=256,
                            max_pages_per_seq=16, prefill_chunk=8, n_streams=2)
        eng = Engine(model, params, serve, device=args.device)
        reqs = [Request(rid=i, prompt=[int(t) for t in rng.randint(2, cfg.vocab_size, 24)],
                        sampling=SamplingParams(max_new_tokens=8))
                for i in range(6)]
        s = eng.run(reqs).summary()
        print(f"{arch:14s} [{cfg.family:5s}] done={s['n_done']} "
              f"steps={s['n_steps']} tput={s['throughput_tok_s']:7.1f} tok/s "
              f"KVpeak={s['kv_usage_peak']:.0%} "
              f"sample={reqs[0].out_tokens[:4]}")


if __name__ == "__main__":
    main()
