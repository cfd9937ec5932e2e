"""End-to-end training with the PyTorch port: train a ~100M-param
qwen3-family model for a few hundred steps on the synthetic pipeline,
with checkpointing enabled (the counterpart of ``examples/train_100m.py``).

    export PYTHONPATH=src
    python examples/torch_train_100m.py [--steps 300]          # on the GPU
    python examples/torch_train_100m.py --tiny --device cpu    # reduced, on the CPU

--tiny uses the reduced config; the default builds a ~100M-parameter
variant (scaled-down qwen3: 12L x 512d).  Attention runs K2 (its
training forward and the recompute backward) on the card.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.common.tree import tree_count
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import make_train_data_fn
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    base = get_config("qwen3-0.6b")
    if args.tiny:
        cfg = base.reduced()
    else:  # ~100M params
        cfg = dataclasses.replace(
            base, name="qwen3-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=32_000)
    model = get_model(cfg.name, cfg)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq, lr=1e-3,
                       warmup_steps=20, total_steps=args.steps,
                       ckpt_dir=os.path.join(tempfile.gettempdir(), "repro_torch_100m"),
                       ckpt_every=100, remat=True)
    trainer = Trainer(model, tcfg, make_train_data_fn(cfg, tcfg), log_every=20,
                      device=args.device)
    print(f"{cfg.name}: {tree_count(trainer.state['params'])/1e6:.1f}M params; "
          f"resuming from step {trainer.start_step}")
    t0 = time.time()
    for step, loss in trainer.run():
        print(f"step {step:5d}  loss {loss:.4f}")
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.0f}s "
          f"({args.steps * args.batch * args.seq / max(dt,1e-9):.0f} tok/s); "
          f"checkpoints in {tcfg.ckpt_dir}")


if __name__ == "__main__":
    main()
