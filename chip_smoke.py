#!/usr/bin/env python3
"""Run the PyTorch port of the Splitwiser engine on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (what the port's chip check runs)
    python3 chip_smoke.py --quick    # phases 1-3 at one repeat: build + kernel check

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: device name and count, ``nvidia-smi`` name and power limit;
  2. build: every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` summary;
  3. kernels against their plain PyTorch versions at the main path's shapes,
     in f32 and bf16, with times of the kernel, the plain version and a
     library yardstick (``scaled_dot_product_attention`` on gathered K/V,
     never called by the port), and the card's bound for the same work;
  4. cross-device engine check: qwen3-0.6b at full width and 2 layers, f32,
     one seeded set of weights, served on ``cuda`` (kernels) and on the CPU
     (plain versions); greedy streams must be equal;
  5. the main path: all 28 layers, bf16, ~16 requests of 128-1024 prompt
     tokens through all four serving modes.  Kernel launch counters are
     zeroed just before and read just after; every request must finish by
     length with finite logits, and every kernel must have launched;
  6. where the time goes: per mode, one window of engine steps timed on
     the host clock and, on a fresh engine, under ``torch.profiler``:
     device time by kernel class and the device's busy share.

The last three lines of standard output are the ``{"kernels": [...]}``
line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HBM_BYTES_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 non-tensor
# kernel vs plain version: f32 differs only in summation order; bf16 adds
# the rounding of the output to 8 mantissa bits
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ServeConfig reads these two from the environment; the port refuses both
UNPORTED_OFF = dict(sanitize_level="off", dispatch_sentinel=False)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3 ---
def paged_case(torch, B, C, KV, G, d, ps, max_kv, dtype, seed):
    """Inputs of one K1 call as the main path gives them: ragged kv lens
    up to ``max_kv``, chunks ending at each sequence's length, pages
    scattered over the pool."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Pmax = -(-max_kv // ps)
    N = B * Pmax + 1
    q = torch.randn(B, C, KV * G, d, generator=g, device="cuda").to(dtype)
    kp = torch.randn(N, ps, KV, d, generator=g, device="cuda").to(dtype)
    vp = torch.randn(N, ps, KV, d, generator=g, device="cuda").to(dtype)
    table = torch.randperm(N - 1, generator=g, device="cuda")[: B * Pmax]
    table = table.reshape(B, Pmax).to(torch.int32)
    lo = max(C, max_kv // 8)
    kv_lens = torch.linspace(lo, max_kv, B, device="cuda").round().to(torch.int32)
    q_pos = (kv_lens - C).to(torch.int32)
    return q, kp, vp, table, kv_lens, q_pos


def paged_work(q, kp, table, kv_lens, q_pos):
    B, C, H, d = q.shape
    KV = kp.shape[2]
    isz = q.element_size()
    keys = 0
    for b in range(B):
        L, p0 = int(kv_lens[b]), int(q_pos[b])
        keys += sum(max(min(L, p0 + c + 1), 0) for c in range(C))
    read_kv = int(kv_lens.sum()) * KV * d * 2 * isz
    nbytes = read_kv + 2 * q.numel() * isz + table.numel() * 4 + 2 * B * 4
    flops = 4.0 * d * (H // KV) * KV * keys
    return nbytes, flops


def flash_work(q, k, kv_lens):
    B, T, H, d = q.shape
    Tk = k.shape[1]
    isz = q.element_size()
    keys = sum(min(t + 1, int(kv_lens[b]), Tk) for b in range(B) for t in range(T))
    nbytes = (2 * q.numel() + 2 * k.numel()) * isz + B * 4
    return nbytes, 4.0 * d * H * keys


def sdpa_paged(torch, q, kp, vp, table, kv_lens, q_pos, scale):
    """Library yardstick for K1: SDPA over K/V gathered from the pages
    (gathered once, outside the timed call)."""
    F = torch.nn.functional
    B, C, H, d = q.shape
    KV = kp.shape[2]
    k = kp[table.long()].reshape(B, -1, KV, d).transpose(1, 2)
    v = vp[table.long()].reshape(B, -1, KV, d).transpose(1, 2)
    k = k.repeat_interleave(H // KV, dim=1).contiguous()
    v = v.repeat_interleave(H // KV, dim=1).contiguous()
    qt = q.transpose(1, 2).contiguous()
    t = torch.arange(k.shape[2], device="cuda")
    qp = q_pos[:, None].long() + torch.arange(C, device="cuda")[None]
    mask = (t[None, None, :] < kv_lens[:, None, None]) & (t[None, None, :] <= qp[:, :, None])
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, scale=scale)


def phase_kernels(torch, iters):
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    F = torch.nn.functional
    scale = 1.0 / math.sqrt(128)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, B, C in (("decode", 16, 1), ("chunk", 2, 128)):
            args = paged_case(torch, B, C, 8, 2, 128, 16, 1024, dtype, seed=1)
            out = K1.paged_attention(*args, scale=scale)
            torch.cuda.synchronize()
            want = K1.paged_attention_plain(*args, scale=scale)
            err = (out.float() - want.float()).abs().max().item()
            ms = cuda_time_ms(lambda: K1.paged_attention(*args, scale=scale), iters)
            plain_ms = cuda_time_ms(
                lambda: K1.paged_attention_plain(*args, scale=scale), max(iters // 4, 1))
            lib_ms = cuda_time_ms(sdpa_paged(torch, *args, scale), iters)
            nbytes, flops = paged_work(args[0], args[1], args[3], args[4], args[5])
            b_ms, b_by = bound(nbytes, flops, dname)
            cases.append(dict(kernel="paged_attention", case=f"{label} B={B} C={C}",
                              dtype=dname, max_abs_err=err, tol=TOL[dname], ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by))
        g = torch.Generator(device="cuda").manual_seed(2)
        B, T, H, KV, d = 4, 1024, 16, 8, 128
        q = torch.randn(B, T, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        out = K2.flash_attention(q, k, v, lens, scale=scale)
        torch.cuda.synchronize()
        want = K2.flash_attention_plain(q, k, v, lens, scale=scale)
        err = (out.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(lambda: K2.flash_attention(q, k, v, lens, scale=scale), iters)
        plain_ms = cuda_time_ms(
            lambda: K2.flash_attention_plain(q, k, v, lens, scale=scale), max(iters // 4, 1))
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), iters)
        nbytes, flops = flash_work(q, k, lens)
        b_ms, b_by = bound(nbytes, flops, dname)
        cases.append(dict(kernel="flash_attention", case=f"prefill B={B} T={T}",
                          dtype=dname, max_abs_err=err, tol=TOL[dname], ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                          bound_by=b_by))
    for c in cases:
        log("kernel " + json.dumps(c))
    bad = [c for c in cases if not c["max_abs_err"] <= c["tol"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return cases


# ------------------------------------------------------------ phase 4/5 ---
def make_engine_cls():
    import torch
    from repro_torch.core.engine import Engine

    class CheckedEngine(Engine):
        """The port's Engine, failing on any non-finite logit it samples."""

        def _sample_rows(self, logits, reqs):
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite logits")
            return super()._sample_rows(logits, reqs)

    return CheckedEngine


def requests(n, vocab, lo, hi, new_lo, new_hi, seed):
    import numpy as np
    from repro_torch.core.engine import Request
    from repro_torch.core.sampler import SamplingParams
    rng = np.random.RandomState(seed)
    return [Request(rid=i,
                    prompt=[int(t) for t in rng.randint(2, vocab, size=rng.randint(lo, hi + 1))],
                    sampling=SamplingParams(max_new_tokens=int(rng.randint(new_lo, new_hi + 1))))
            for i in range(n)]


def phase_cross_device(torch):
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    cfg = replace(get_config("qwen3-0.6b"), n_layers=2)
    model = get_model("qwen3-0.6b", cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    Engine = make_engine_cls()
    serve_kw = dict(max_batch=8, page_size=16, n_pages=128, max_pages_per_seq=16,
                    prefill_chunk=32, n_streams=2, chunk_tokens=64, **UNPORTED_OFF)
    for mode in ("sequential", "splitwiser_mps"):
        streams = {}
        for dev in ("cuda", "cpu"):
            K1.launches = K2.launches = 0
            reqs = requests(6, cfg.vocab_size, 16, 96, 8, 8, seed=3)
            eng = Engine(model, params, ServeConfig(mode=mode, **serve_kw), device=dev)
            eng.run(reqs, max_steps=2000)
            streams[dev] = [r.out_tokens for r in reqs]
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = (K1.launches, K2.launches)
        if streams["cuda"] != streams["cpu"]:
            first = next((i, a, b) for i, (a, b) in
                         enumerate(zip(streams["cuda"], streams["cpu"])) if a != b)
            fail(f"{mode}: greedy streams differ between cuda and cpu: {first}")
        if counts[0] == 0 or (mode == "sequential" and counts[1] == 0):
            fail(f"{mode}: kernels were not launched on cuda: K1={counts[0]} K2={counts[1]}")
        log(f"cross-device {mode}: {len(streams['cuda'])} greedy streams equal "
            f"(cuda vs cpu); launches K1={counts[0]} K2={counts[1]}")


def pct(vals, q):
    vals = sorted(vals)
    if not vals:
        return None
    return vals[min(len(vals) - 1, math.ceil(q * len(vals)) - 1)]


def phase_main_path(torch):
    from repro_torch.configs import SERVE_MODES, ServeConfig, get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.models.registry import get_model
    cfg = get_config("qwen3-0.6b")
    model = get_model("qwen3-0.6b", cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"main path: qwen3-0.6b, {cfg.n_layers} layers, {n_params} params bf16")
    Engine = make_engine_cls()
    serve_kw = dict(max_batch=16, page_size=16, n_pages=2048, max_pages_per_seq=72,
                    max_seq_len=1152, prefill_chunk=128, n_streams=2,
                    chunk_tokens=256, **UNPORTED_OFF)
    per_mode, steps = {}, 0
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    for mode in SERVE_MODES:
        # the engine and its scheduler reference each other: collect the
        # last mode's engine so its page pool is not in this mode's peak
        gc.collect()
        eng = Engine(model, params, ServeConfig(mode=mode, **serve_kw), device="cuda")
        reqs = requests(16, cfg.vocab_size, 128, 1024, 32, 64, seed=5)
        torch.cuda.reset_peak_memory_stats()
        m = eng.run(reqs, max_steps=20000)
        torch.cuda.synchronize()
        outs = eng.poll()
        if len(outs) != len(reqs) or any(o.finish_reason != "length" for o in outs):
            fail(f"{mode}: not every request finished by length: "
                 f"{[(o.rid, o.finish_reason) for o in outs]}")
        if any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
            fail(f"{mode}: a request generated the wrong number of tokens")
        s = m.summary()
        done = [m.requests[r.rid] for r in reqs]
        ttft = [r.ttft for r in done]
        gaps = [b - a for r in done for a, b in zip(r.token_times, r.token_times[1:])]
        per_mode[mode] = dict(
            tokens_per_s=s["throughput_tok_s"], ttft_p50_s=pct(ttft, 0.5),
            ttft_p99_s=pct(ttft, 0.99), tbt_p99_s=pct(gaps, 0.99), steps=s["n_steps"],
            wall_s=s["wall_s"], prompt_tokens=sum(len(r.prompt) for r in reqs),
            new_tokens=sum(len(r.out_tokens) for r in reqs),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        steps += s["n_steps"]
        log(f"mode {mode}: " + json.dumps(per_mode[mode]))
        del eng
    launches = {"paged_attention": K1.launches, "flash_attention": K2.launches}
    log("main path launches " + json.dumps(launches) + f" over {steps} engine steps")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    return per_mode, launches, steps, (model, params, serve_kw)


KERNEL_CLASSES = (("paged_attention", ("paged_attention_kernel",)),
                  ("flash_attention", ("flash_attention_kernel",)),
                  ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def phase_profile(torch, setup, warm_steps=8, window=16):
    """Where the time goes, per mode: the same window of engine steps
    (after ``warm_steps``) run twice on fresh engines with the same
    requests — once timed on the host clock, once under
    ``torch.profiler`` for device time by kernel class.  The device's
    busy share is the profiled device time over the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SERVE_MODES, ServeConfig
    model, params, serve_kw = setup
    Engine = make_engine_cls()

    def engine_at_window(mode):
        eng = Engine(model, params, ServeConfig(mode=mode, **serve_kw), device="cuda")
        for r in requests(16, model.cfg.vocab_size, 128, 1024, 32, 64, seed=5):
            eng.submit(r)
        for _ in range(warm_steps):
            eng.step()
        torch.cuda.synchronize()
        return eng

    out = {}
    for mode in SERVE_MODES:
        eng = engine_at_window(mode)
        t0 = time.perf_counter()
        for _ in range(window):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kinds = eng.metrics.step_kinds[warm_steps:warm_steps + window]
        eng = engine_at_window(mode)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
        by_class, n_kernels = {}, 0
        for e in prof.key_averages():
            us = e.self_device_time_total
            if not us or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            n_kernels += e.count
            name = e.key.lower()
            cls = next((c for c, keys in KERNEL_CLASSES
                        if any(k in name for k in keys)), "other")
            by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
        busy_ms = sum(by_class.values())
        out[mode] = dict(
            steps=f"{warm_steps}..{warm_steps + window - 1}",
            step_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
            wall_ms=wall_ms, device_ms=busy_ms if busy_ms else "not measured",
            busy_share=busy_ms / wall_ms if busy_ms else "not measured",
            device_kernels=n_kernels,
            device_ms_by_class={k: round(v, 3) for k, v in sorted(by_class.items())})
        log(f"profile {mode}: " + json.dumps(out[mode]))
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ------------------------------------------------------------------ main ---
KERNELS = {
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:109",
        replaces_function="src/repro/kernels/paged_attention.py::paged_attention",
        headline=("decode B=16 C=1", "bfloat16")),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        replaces_function="src/repro/kernels/flash_attention.py::flash_attention",
        headline=("prefill B=4 T=1024", "bfloat16")),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (phases 1-3, 1 timed repeat)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, str(src))
    # every f32 comparison on the card is in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. environment
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi()
    log(f"device: {name} count={count} nvidia-smi: {card} torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.KERNELS)} kernels")
    for kname, info in build.build_log.items():
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"ptxas {kname}: {line.strip()}")

    # 3. kernels against their plain versions
    cases = phase_kernels(torch, iters=1 if args.quick else 20)
    if args.quick:
        log(f"quick check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 4. cross-device engine check
    phase_cross_device(torch)

    # 5. the main path
    per_mode, launches, steps, setup = phase_main_path(torch)
    log("modes " + json.dumps(per_mode))

    # 6. where the time goes
    phase_profile(torch, setup)

    kernels = []
    for kname, meta in KERNELS.items():
        label, dtype = meta["headline"]
        c = next(c for c in cases if c["kernel"] == kname and c["case"] == label
                 and c["dtype"] == dtype)
        kernels.append(dict(
            name=kname, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], replaces_function=meta["replaces_function"],
            launches=launches[kname], launches_per_step=launches[kname] / steps,
            case=f"{label} {dtype}", max_abs_err=c["max_abs_err"], tol=c["tol"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            cases=[{k: v for k, v in x.items() if k != "kernel"}
                   for x in cases if x["kernel"] == kname]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
