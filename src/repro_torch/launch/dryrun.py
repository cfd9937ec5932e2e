"""One-card dry run: trace every (architecture x input-shape) cell under
fake tensors and record its costs and roofline terms on the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

The counterpart of the reference's ``launch/dryrun.py`` on one card:
nothing is lowered or compiled (the port runs eagerly) and nothing is
allocated, so it needs no device.  Each row has the reference's keys, with
``mesh: "h100"`` and ``n_devices: 1``; ``t_lower_s`` is the time of the
traced run and ``t_compile_s`` is null.  FLOPs, bytes and peak live bytes
come from ``launch/costs.py::traced_costs``; the terms are bounds from
the H100's data-sheet peaks (``common/hw.py::H100_SXM``).
"""
import argparse
import json
import sys
import time
import traceback

from repro_torch.common.hw import H100_SXM
from repro_torch.configs.registry import ASSIGNED
from repro_torch.launch.roofline import analyze
from repro_torch.launch.steps import build_cell

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "mixed_32k"]
# mixed_32k is the extra paper-technique cell, traced for one MoE arch
# and qwen3 (the Splitwiser fused step)
MIXED_ARCHS = {"qwen3-0.6b", "olmoe-1b-7b"}


def run_cell(arch, shape, *, verbose=True):
    cell, why = build_cell(arch, shape)
    if cell is None:
        return dict(arch=arch, shape=shape, mesh="h100", n_devices=1,
                    status="skipped", reason=why)
    t0 = time.time()
    rl = analyze(cell, arch=arch, shape=shape, hw=H100_SXM)
    row = rl.row()
    row.update(status="ok", note=cell["note"], t_lower_s=round(time.time() - t0, 1),
               t_compile_s=None,
               fits_hbm=rl.peak_mem_per_dev <= H100_SXM.hbm_bytes)
    row["memory_analysis"] = (f"traced peak live bytes {rl.peak_mem_per_dev:.0f} "
                              f"of {H100_SXM.hbm_bytes} HBM bytes")
    if verbose:
        print(f"[{arch} x {shape} x h100] OK "
              f"mem/dev={row['peak_mem_GiB']:.2f}GiB "
              f"t_c={row['t_compute_s']:.3e}s t_m={row['t_memory_s']:.3e}s "
              f"-> {row['bottleneck']}")
        print(f"  cost: flops/dev={row['flops_per_dev']:.3e} "
              f"bytes/dev={row['bytes_per_dev']:.3e} "
              f"useful_ratio={row['useful_ratio']:.3f} fits_hbm={row['fits_hbm']}")
    return row


def cells_for(arch):
    out = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    if arch in MIXED_ARCHS:
        out.append("mixed_32k")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPE_ORDER)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in cells_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required unless --all is set")
        cells = [(args.arch, args.shape)]

    rows, failures = [], 0
    t0 = time.time()
    for arch, shape in cells:
        try:
            row = run_cell(arch, shape)
        except Exception as e:
            traceback.print_exc()
            row = dict(arch=arch, shape=shape, mesh="h100", n_devices=1,
                       status="FAIL", error=f"{type(e).__name__}: {e}")
            failures += 1
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
    ok = sum(r["status"] == "ok" for r in rows)
    sk = sum(r["status"] == "skipped" for r in rows)
    print(f"\n=== dry-run: {ok} ok / {sk} skipped / {failures} FAILED "
          f"of {len(rows)} cells in {time.time() - t0:.1f} s ===")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
