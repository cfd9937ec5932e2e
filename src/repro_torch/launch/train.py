"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --batch 8 --seq 128 [--reduced] [--device cpu]

The reference CLI's flags (``src/repro/launch/train.py``) plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions); ``--ckpt-dir`` defaults under the system's temporary
directory, and a rerun on the same directory resumes.  It prints the
reference's lines: the arch and start step, ``step <n> loss <x>`` every
10 steps and at the end, then ``done: <s>s, <n> tok/s``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import make_train_data_fn
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(args.arch, cfg)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                       total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, microbatch=args.microbatch,
                       int8_moments=args.int8_moments, remat=True)
    trainer = Trainer(model, tcfg, make_train_data_fn(cfg, tcfg), device=args.device)
    print(f"arch={args.arch} ({cfg.name}) family={cfg.family} "
          f"start_step={trainer.start_step}", flush=True)
    t0 = time.time()
    hist = trainer.run()
    dt = time.time() - t0
    for step, loss in hist:
        print(f"step {step:5d} loss {loss:.4f}")
    n_tok = args.steps * args.batch * args.seq
    print(f"done: {dt:.1f}s, {n_tok/dt:.0f} tok/s", flush=True)


if __name__ == "__main__":
    main()
