#!/usr/bin/env python3
"""Run the PyTorch port of the Splitwiser engine on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases (what the port's chip check runs)
    python3 chip_smoke.py --quick       # phases 1-3: build + kernel check
    python3 chip_smoke.py --train-only  # phases 1-2 and 7: build + training
    python3 chip_smoke.py --roofline-only  # phases 1-2 and 8: build + roofline
    python3 chip_smoke.py --sampling-only  # phases 1-2 and 9: build + sampled decoding
    python3 chip_smoke.py --mesh-only   # phases 1-2, 10 and 11: build + the mesh

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: device name and count, ``nvidia-smi`` name and power limit,
     the host's CPUs and torch's threads;
  2. build: every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` summary;
  3. kernels against their plain PyTorch versions at the main paths' shapes,
     in f32 and bf16, with times of the kernel, the plain version and a
     library yardstick (``scaled_dot_product_attention`` on gathered K/V —
     for the int8 kernel after one dequantize call — never called by the
     port; none for the SSD scan and its backward, which no single
     PyTorch call computes),
     and the card's bound for the same work (K2's f32 cases, K1/K3's f32
     chunks and K4's f32 forward and backward run on the tensor cores:
     their ``bound_ms`` is the TF32 bound, also ``bound_3xtf32_ms``, at
     three TF32 products an f32 one, two for K3's products on int8 codes
     (``tf32_passes``), at ``common/hw.py::H100_SXM``'s 494.7 TFLOP/s,
     and the CUDA cores' f32 bound is ``bound_cuda_core_ms``), and the
     kernel's and the library's device time (``device_ms``: the calls
     queued behind a device sleep, so the host's cost per call does not
     pace them);
     K1/K3 at decode (C = 1: the split-KV kernel, each case logging its
     split count, split length and workspace bytes, and its error held to
     the tolerance relative to each sequence's max |o| too) for B = 16
     at the main path's 72-page table, 64 and one sequence of 4096 keys,
     and at chunks of C = 128 and 256 (bf16 chunks run their tensor-core
     tile loop, f32 chunks their 3xTF32 tile loop with a key split: each
     f32 chunk case logs its split count, split length and workspace
     bytes, and its device time with the split off (S = 1) as
     ``unsplit_device_ms``, held to the plain version too);
     plus K1/K3 on empty rows and stale page tables at C = 4
     and at decode (K3 also on all-zero pages; at decode the stale slots
     clamp onto a NaN page), K1/K2 at the hybrid's head geometry and at
     seamless-m4t-medium's (K2 non-causal over a ragged encoder, cross-
     attention of 64 and of 1 query row against 1024 frames, K1 decode at
     G = 1, d = 64), and K4's forward at zamba2's prefill (B = 8, T =
     1024), at a ragged T = 1000 with a nonzero h0 and, in f32, at the
     hybrid's training shape (B = 4, T = 1024), its y and h_final errors
     logged apart (y held to the dtype's tolerance, h_final to 1e-4 in
     both dtypes; f32 runs 3xTF32 on the tensor cores, so its cases'
     ``bound_ms`` is the 3xTF32 bound); K4's backward kernels at the hybrid's
     training shape (B = 4, T = 1024) and at a ragged T = 1000 with h0 and
     a gradient on h_final, each gradient (dx, dla, dB, dC, dh0) logged
     apart and held to the dtype's tolerance relative to its own max |g|,
     with each pass's device time apart (``states_device_ms``,
     ``chunks_device_ms``), the state workspace's bytes and the byte floor
     with it (``ws_floor_ms``), and in f32 the 3xTF32 bound.
     First it logs the ``ptxas -v`` registers and spills
     and the dynamic shared memory of each instantiation of the
     tensor-core kernels (K2's bf16 and f32 ones and the bf16 and f32
     chunk loops of K1 and K3, with the blocks an SM holds of the f32
     ones), and fails if a head-dim 64 or 128 one spills; then the same for every
     instantiation of the decode kernels and their combines, failing on
     any spill but f32's at d > 128; then for K4's forward kernels, the
     bf16 one and the f32 one (3xTF32), each with its dynamic shared
     memory and the blocks an SM holds, failing if an instantiation with
     whole 16-byte rows (the main path's) spills, and for K4's backward
     kernels (states and chunks), failing if an f32 one with whole
     16-byte rows spills;
  4. cross-device checks, f32, one seeded set of weights each, greedy
     streams equal between ``cuda`` (kernels) and the CPU (plain versions):
     the engine on qwen3-0.6b at full width and 2 layers with fp pages and
     with int8 pages under the runtime sanitizer (``sanitize_level="step"``)
     and on the rest of the transformer family (``CROSS_ENGINE``);
     the zamba2 hybrid at full width and 7 layer-units (2 prompts of 64
     tokens, 8 decode steps), whose first decode logits on ``cuda`` must
     match the full-sequence forward; internvl2-2b's prefill logits;
     rwkv6-7b at full width and 2 layers and seamless-m4t-medium at full
     width and 2 + 2 layers (2 prompts of 64 tokens, seamless after 12
     frames, 8 decode steps), with their logit and state gaps.  The CPU's
     side of every check whose weights are drawn on the CPU runs in a
     worker process (``CrossCPU``: all but 2 of the host's CPUs, at a
     lower priority) spawned before the build, beside the build and phase
     3; the serving launcher of
     phase 5 runs beside this phase;
  5. the main paths, in bf16 at full depth: qwen3-0.6b, 16 requests of
     128-1024 prompt tokens through all four serving modes, first with fp
     KV pages, then with int8 KV pages in a pool of the same bytes; then
     zamba2-7b (81 layer-units), 8 prompts of 1024 tokens prefilled as one
     batch and 32 greedy decode steps; rwkv6-7b, the same prompts, 32
     decode steps and 8 ``mixed`` steps (128-token chunks of 4 new prompts
     beside the 8 decode rows), launching no hand-written kernel;
     seamless-m4t-medium, 16 utterances of 1024 frames with 64-token
     prompts and 32 decode steps over fp pages (K2 in the encoder, the
     decoder prefill and every cross-attention, K1 in decode); and the
     launcher, ``python -m repro_torch.launch.serve`` on opt-125m in a
     subprocess, which must finish its 16 requests.  Kernel launch
     counters are zeroed just before each path and read just after; every
     request must finish by length (every logit finite), and every kernel
     of the path must have launched (the int8 kernel in every mode; the
     scan once per Mamba2 block of the prefill), and K1/K3's chunk loop
     (C > 1) in every mode that chunks prompts (``splitwiser``,
     ``splitwiser_mps``, ``chunked``); K1 and K3 count decode and chunk
     launches apart;
  6. where the time goes: per mode and page type, one window of engine
     steps, for the hybrid its prefill and 8 decode steps, and for rwkv6
     and seamless 8 decode steps, timed on the host clock and, run again
     from the same state, under ``torch.profiler``: device time by kernel
     class (K1/K3 split into decode, with its combine, and chunk) and the
     device's busy share;
  7. training: every family on cuda against the CPU, f32 (qwen3-0.6b at
     full width and 2 layers with the chunked and the vocab-tiled loss,
     zamba2-7b at full width and 7 layer-units over T = 160, the others
     reduced): the loss and every gradient leaf at each step, and the
     params after the steps; the main path, qwen3-0.6b at full width and
     depth in f32 with remat, B = 4, T = 512, 6 ``Trainer`` steps and one
     asynchronous checkpoint, with K2's training forward
     (``flash_attention_lse``) launched 2 x 28 a step and no other
     kernel; the hybrid's path, zamba2-7b at full width and 13
     layer-units in f32 with remat, B = 4, T = 1024, 6 ``Trainer`` steps
     and a checkpoint, with K4's forward launched 2 x 11 a step, its
     backward kernel 11 and K2's training forward 2 x 2, and no other
     kernel; for each path its step time, tokens/s, peak memory and a
     profiled step's device split; in a subprocess under
     ``torch.use_deterministic_algorithms``, bitwise crash/resume and
     int8 moments (with a resume through them) on the reduced config;
     the training launcher in a subprocess (both beside the cross-device
     rows, read before the timed paths).  Phase 3 also holds K2's
     training forward (o and lse) against its plain version beside the
     forward-only K2 at the same shapes (the hybrid's d = 112 included),
     K4's backward kernel against its plain version, and
     ``flash_attention_ckpt``'s backward on cuda against the CPU's;
  8. the cost model and the dry run held to the card (``repro_torch.launch.
     {costs,roofline,steps}``, peaks from ``common/hw.py::H100_SXM``): the
     15 rows of the paper's Figs. 2-4 on opt-125m at full size in bf16
     (prefill of 128-2048 tokens, decode at 128-2048 context, decode of
     1-40 sequences at 512), each with its traced FLOPs and bytes, its
     intensity against the H100's ridge, its device time and the achieved
     shares of the peaks (K2 and K1's decode must launch); then
     qwen3-0.6b's dry-run cells (train 8 x 512, prefill 4 x 2048, decode
     8 x 1024, mixed 2 x 64 + 8 at 1024 with fp and int8 pages) on seeded
     args, one run each: estimated against measured peak memory and
     max(t_compute, t_memory) against device time, logged; fatal on a
     non-finite output or a kernel of the cell not launched (K2's training
     forward, K2, K1 decode and chunk, K3 under int8 pages).  The cost
     counts run in worker processes beside the card's runs;
  9. sampled decoding: qwen3-0.6b at full width and 2 layers in f32 with
     fp pages, 16 requests of 64-512 prompt tokens and 32 new tokens, a
     third greedy, a third at temperature 0.8 with top-k 40, a third at
     temperature 1.0 with top-p 0.9, each with its own seed.  Fatal: the
     four modes give equal streams; each sampled request served alone
     gives its batched stream; a pool small enough to preempt gives the
     same streams (with preemptions); the greedy rows equal an all-greedy
     run; every request finishes by length with finite logits; K1's
     decode and chunk loops and K2 launch where phase 5 requires them.
     Logged: the share of tokens the cuda streams share with the CPU
     engine's on the same weights (a near-tie may flip), ``sample_tokens``
     at B = 16 and V = 151,936 on cuda logits (host ms, device ms, the
     host ms of its CPU noise ``_gumbel_rows``), and a decode step's wall
     with all rows greedy against all rows sampled.  Last, the port's lint
     (``python -m repro_torch.analysis.lint src/repro_torch``) in a
     subprocess, started with the run, must exit 0;
 10. the mesh (``launch/{mesh,shardings,spmd}.py``, ``models/sharding.py``):
     the sharded prefill, decode and mixed steps of every family but
     grok-1 through ``launch/steps.py``'s cells with a mesh, f32, pages of 16
     tokens.  First NCCL at world size 1 in this process (one card: NCCL
     refuses two ranks on one device), mesh (1, 1): qwen3-0.6b at full
     width and depth, fp pages, 16 sequences of 128-1024 prompt tokens
     prefilled one by one, 8 greedy decode steps and 2 mixed steps (2
     prompt streams in chunks of 128 beside the decode rows).  Then two
     ranks as two processes on the one card over gloo (collectives staged
     through host memory), meshes (1, 2) and (2, 1): qwen3-0.6b (8 + 4
     heads a rank at tp = 2) with fp pages at full depth and int8 pages at
     2 layers (below), and olmoe-1b-7b at
     full width and 4 of its 16 layers with 32 of 64 experts a rank at
     tp = 2, 8 sequences of 128-512 tokens each.  Every path's launch
     counters are zeroed before it and read after; then each rank runs the
     one-card steps on the full weights and pools over its data shard's
     rows, fed the same tokens (the MoE's capacity then comes from the same
     tokens).  Fatal: logits beyond 1e-5 (NCCL) or 1e-4 (gloo) of max
     |logit|, a greedy token that differs, a rank's pages beyond 1e-5 of
     max |value| of the one-card pool's slice, K2 and K1's (fp) or K3's
     (int8) decode and chunk loops not launched on a rank.  int8 pages:
     the two quantize a few K/V to codes one apart (a rounding boundary,
     ROADMAP's "Expected"; counted), which moves logits ~1e-3 and the next
     layer's K/V, so their logits and scales are held to 1e-2 of their
     max, a code off by more than one is fatal, and a greedy token may
     differ only in a near tie (the one-card step's top two logits closer
     than the steps' logit gap; counted).
     The other four families on the mesh, each case also at (1, 2) and
     (2, 1) over gloo, f32, fp pages, 4 sequences: zamba2-7b at full width
     and 13 layer-units (11 Mamba2 units with K4 on each rank's heads, 56
     of 112 at tp = 2; 2 shared-attention invocations with K2 on 16 of
     its 32 heads of d = 112 and K1 on pool layers 0 and 1), 256-token
     prompts, also at NCCL (1, 1) in this process; rwkv6-7b at full width
     and 4 layers, 256-token prompts (no hand-written kernel: its WKV
     scan is torch ops); seamless-m4t-medium at full width and depth, 1024
     frames and 64-token prompts (K2 non-causal in the encoder on 8 of 16
     heads, over the rank's cross K/V, K1 in decode); internvl2-2b at full
     width and 4 layers behind its 256-patch prefix, 128-token prompts
     (8 q / 4 kv heads of d = 128 a rank; prefill, decode and mixed
     steps as qwen3's).  The hybrid, rwkv6 and seamless prefill their
     rows as one batch and take 8 decode steps; their caches (pools, conv
     and SSM states, rwkv6's state, cross K/V) are held to the one-card
     tensor's slice at 1e-5 of its max on top of the one-card step's own
     one-ulp floor (its gap to itself with every embedding value moved by
     one f32 ulp; the phase's header says why) after the prefill and
     after the decode steps.  Then the decode ``2d`` scheme and the
     replicated batch (``mesh_decode_case``): olmoe-1b-7b at 4 layers, B
     = 8, ``2d`` at (1, 2) and (2, 1), and one row at (2, 1) of qwen3-0.6b
     and zamba2-7b (13 units), 8 steps from random caches of 512 tokens,
     held to the one-card step (logits, every row; the rank's caches).
     Logged per rank: the step walls, the collectives a step with their
     bytes, the backend.
 11. mesh training (``launch/steps.py::train_mesh``, the sharded train
     step of every family), f32 with TF32 off, in the same
     process groups as phase 10: NCCL at world size 1, mesh (1, 1),
     qwen3-0.6b at full width and depth, B = 4 x T = 512, the ``tp``
     scheme, 3 steps; then on the two gloo ranks qwen3-0.6b at full width
     and 4 of 28 layers, B = 4 x T = 256, 2 steps, at (1, 2) and (2, 1)
     (``tp``: at (2, 1) every weight FSDP'd over data) and at (1, 2) in the
     ``fsdp`` scheme, and olmoe-1b-7b at full width and 2 of 16 layers, B =
     2 x T = 256, at (1, 2) (EP: 32 of 64 experts a rank) and (2, 1)
     (experts FSDP'd, ``fsdp_gather``); zamba2-7b at one group of 6 of 81
     layer-units (NCCL (1, 1) and gloo (1, 2)), rwkv6-7b at 2 layers and
     seamless-m4t-medium whole ((1, 2), and (2, 1)), B = 2 x T = 256; and
     qwen3 at 4 layers, (2, 1), ``microbatch=2``.  Each rank also runs the one-card step
     (``make_grad_fn``/``apply_grads``) on the full state of the same seed
     and the same batch (its MoE routed over each data shard's rows, and
     its loss holding this rank's data shard's aux term with the
     gradient of the shards' mean, as the mesh's and the reference's);
     both optimizers then take the one-card gradients (as phase 7's
     cross-device check).  Fatal at every step: the loss or the gnorm of
     the mesh's own gradients beyond 1e-5 relative, a gradient leaf
     beyond 1e-4 of the one-card leaf's max |g| (each of them, or beyond
     4 times its own one-card one-ulp floor in that step where that is
     larger: ``train_bound``), the params beyond 1e-4 of the one-card
     params' slice, and a kernel of the
     family's path (K2's training forward; the hybrid's K4 forward and
     backward too) not launched.  Logged per rank: each step's wall, the
     collectives a step by kind with their bytes, the peak memory, the
     gaps and floors, the launches a step.  Then its witness
     (``mesh_witness_rank``): rwkv6-7b's first step at (1, 2), at the
     reference's own init and with its zero leaves drawn, mesh and one
     card in f32 and in f64 (``.float()`` keeping f64), fatal if the f64
     loss or a leaf strays beyond 1e-9; logged per leaf: the f32 gaps
     and each f32 step's error against the f64 one.

Parts of phases 4-7 log their wall as ``time <part>: <s> s``.  The last
three lines of standard output are the ``{"kernels": [...]}``
line (every f32 case that runs TF32 on the tensor cores, a headline
case too, gives its TF32 bound as ``bound_ms`` and the CUDA cores' as
``bound_cuda_core_ms``), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

SLEEP_CYCLES_S = 2.0e9         # above the H100's 1.98 GHz boost clock: a sleep lasts at least its time
# kernel vs plain version: f32 differs only in summation order; bf16 adds
# the rounding of the output to 8 mantissa bits
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ServeConfig reads these two from the environment: fix them so the run
# does not depend on it (the sentinel phase turns the sentinel on itself)
ANALYSIS_OFF = dict(sanitize_level="off", dispatch_sentinel=False)
INT8_SANITIZED = dict(kv_dtype="int8", sanitize_level="step", dispatch_sentinel=False)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class Background:
    """A command started now and read later (``result``), its output in
    temporary files (an unread pipe could fill and stall it); killed at
    exit if it is still running."""

    def __init__(self, cmd, env, timeout):
        import atexit
        import tempfile
        self.cmd, self.timeout, self.t0 = cmd, timeout, time.perf_counter()
        self.files = [tempfile.TemporaryFile(mode="w+") for _ in range(2)]
        self.proc = subprocess.Popen(cmd, env=env, stdout=self.files[0], stderr=self.files[1],
                                     text=True)
        atexit.register(self.kill)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self):
        """(exit code, stdout, stderr, s from the start to this read)."""
        try:
            self.proc.wait(timeout=max(1.0, self.timeout - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"{' '.join(self.cmd[1:])} ran past {self.timeout} s")
        out = []
        for f in self.files:
            f.seek(0)
            out.append(f.read())
            f.close()
        return self.proc.returncode, out[0], out[1], time.perf_counter() - self.t0


def src_env(**extra):
    """This process's environment with the checkout's ``src`` first on
    ``PYTHONPATH``, for a subprocess of the port."""
    import os
    src = str(Path(__file__).resolve().parent / "src")
    return dict(os.environ, **extra, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))


def timed(label, fn, *args):
    """``fn(*args)``, logging its wall as ``time <label>: <s> s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"time {label}: {time.perf_counter() - t0:.1f} s")
    return out


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


KERNEL_ITERS = 20   # timed repeats of each phase-3 case, --quick or not


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


def device_time_ms(fn, iters: int, warmup: int = 3):
    """(device ms, host ms) of one call of ``fn``.  Like ``cuda_time_ms``,
    but the timed calls queue behind a device-side sleep that outlasts the
    host's enqueueing of all of them (twice the host time they took just
    before, at most 0.5 s), so the host's own cost per call (Python,
    launch) does not pace the device: the kernels' device time.  The host
    time is that of the calls just before, on the host's clock.
    ``cuda_time_ms`` times a call that costs the host more than the device
    at the host's pace, as the engine sees it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s, 0.5) * SLEEP_CYCLES_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


def card_spec():
    """The card's data-sheet peaks: ``repro_torch/common/hw.py::H100_SXM``
    (HBM bytes/s, dense bf16 and TF32 FLOP/s on the tensor cores, f32
    outside them)."""
    from repro_torch.common.hw import H100_SXM
    return H100_SXM


def bound(nbytes: float, flops: float, dtype: str):
    hw = card_spec()
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = flops / {"bfloat16": hw.peak_flops_bf16, "float32": hw.peak_flops_f32}[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: float, flops: float, passes: int = 3):
    """(ms, by) of the work on the tensor cores in TF32: ``passes`` TF32
    products for each f32 one (3xTF32 in K2's f32 kernel and K1's f32
    chunks; 2 in K3's, whose codes are exact in TF32), at the TF32 peak."""
    hw = card_spec()
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = passes * flops / hw.peak_flops_tf32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3 ---
def paged_case(torch, B, C, KV, G, d, ps, max_kv, dtype, seed, min_kv=None, pmax=None):
    """Inputs of one K1 call as the main path gives them: kv lens from
    ``min_kv`` (default: max_kv / 8, ragged) up to ``max_kv``, chunks
    ending at each sequence's length, pages scattered over the pool; with
    ``pmax``, the table is widened to that many slots by zeros, as the
    engine's table is past a sequence's pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Pmax = -(-max_kv // ps)
    N = B * Pmax + 1
    q = torch.randn(B, C, KV * G, d, generator=g, device="cuda").to(dtype)
    kp = torch.randn(N, ps, KV, d, generator=g, device="cuda").to(dtype)
    vp = torch.randn(N, ps, KV, d, generator=g, device="cuda").to(dtype)
    table = torch.randperm(N - 1, generator=g, device="cuda")[: B * Pmax]
    table = table.reshape(B, Pmax).to(torch.int32)
    if pmax is not None:
        table = torch.nn.functional.pad(table, (0, pmax - Pmax))
    lo = max(C, max_kv // 8 if min_kv is None else min_kv)
    kv_lens = torch.linspace(lo, max_kv, B, device="cuda").round().to(torch.int32)
    q_pos = (kv_lens - C).to(torch.int32)
    return q, kp, vp, table, kv_lens, q_pos


def visible_keys(L, p, window=None):
    """Keys a query at position p sees among a row's first L: causal, and
    inside the window when there is one."""
    return max(min(L, p + 1) - (0 if window is None else max(p - window + 1, 0)), 0)


def paged_work(q, kp, table, kv_lens, q_pos, kv_bytes=None, window=None):
    """(bytes, flops) a paged-attention call must move and do on these
    inputs: each K/V row below kv_len that some query sees read once
    (``kv_bytes`` per (token, head) of K or V, default d elements of q's
    type), q read and out written once; 4 flops per (query row, visible
    key, dim), plus, for int8 pages, one dequant multiply per K/V element
    read."""
    B, C, H, d = q.shape
    KV = kp.shape[2]
    isz = q.element_size()
    keys = rows = 0
    for b in range(B):
        L, p0 = int(kv_lens[b]), int(q_pos[b])
        keys += sum(visible_keys(L, p0 + c, window) for c in range(C))
        rows += L - (0 if window is None else min(max(p0 - window + 1, 0), L))
    rows *= KV * 2
    read_kv = rows * (d * isz if kv_bytes is None else kv_bytes)
    nbytes = read_kv + 2 * q.numel() * isz + table.numel() * 4 + 2 * B * 4
    flops = 4.0 * d * (H // KV) * KV * keys + (0 if kv_bytes is None else rows * d)
    return nbytes, flops


def flash_work(q, k, kv_lens, window=None, causal=True):
    """(bytes, flops) of a flash-attention call: q read and out written
    once, each K/V row below kv_len read once; 4 flops per (query row,
    visible key, dim) — causal rows see the keys up to their own index
    (and inside the window), non-causal ones all keys below kv_len."""
    B, T, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    isz = q.element_size()
    lens = [min(int(n), Tk) for n in kv_lens]
    keys = (sum(visible_keys(L, t, window) for L in lens for t in range(T)) if causal
            else T * sum(lens))
    nbytes = (2 * q.numel() + 2 * sum(lens) * KV * d) * isz + B * 4
    return nbytes, 4.0 * d * H * keys


def _gather_heads(torch, pages, table, H):
    """[N, ps, KV, x] pages -> [B, H, Pmax*ps, x], gathered by the table
    and expanded to the query heads (once, outside any timed call)."""
    B = table.shape[0]
    g = pages[table.long()].reshape(B, -1, *pages.shape[2:]).transpose(1, 2)
    return g.repeat_interleave(H // pages.shape[2], dim=1).contiguous()


def _sdpa_mask(torch, q, kv_lens, q_pos, T, window=None):
    C = q.shape[1]
    t = torch.arange(T, device="cuda")
    qp = q_pos[:, None].long() + torch.arange(C, device="cuda")[None]
    mask = (t[None, None, :] < kv_lens[:, None, None]) & (t[None, None, :] <= qp[:, :, None])
    if window is not None:
        mask &= t[None, None, :] > qp[:, :, None] - window
    return mask[:, None]


def sdpa_paged(torch, q, kp, vp, table, kv_lens, q_pos, scale, window=None):
    """Library yardstick for K1: SDPA over K/V gathered from the pages
    that some row reads (gathered once, outside the timed call); with a
    window, masked to it (SDPA has no softcap)."""
    F = torch.nn.functional
    H = q.shape[2]
    table = table[:, :-(-int(kv_lens.max()) // kp.shape[1])]
    k, v = _gather_heads(torch, kp, table, H), _gather_heads(torch, vp, table, H)
    qt = q.transpose(1, 2).contiguous()
    mask = _sdpa_mask(torch, q, kv_lens, q_pos, k.shape[2], window)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, scale=scale)


def sdpa_paged_int8(torch, q, kq, ks, vq, vs, table, kv_lens, q_pos, scale, window=None):
    """Library yardstick for K3, two calls: one dequantize (``torch.mul``
    of the stacked K/V codes by their scales, cast to q's type) and SDPA,
    on codes and scales of the pages that some row reads, gathered once
    outside the timed call."""
    F = torch.nn.functional
    H = q.shape[2]
    table = table[:, :-(-int(kv_lens.max()) // kq.shape[1])]
    codes = torch.stack([_gather_heads(torch, kq, table, H), _gather_heads(torch, vq, table, H)])
    scales = torch.stack([_gather_heads(torch, ks, table, H), _gather_heads(torch, vs, table, H)])
    qt = q.transpose(1, 2).contiguous()
    mask = _sdpa_mask(torch, q, kv_lens, q_pos, codes.shape[3], window)

    def call():
        kv = torch.mul(codes, scales).to(q.dtype)
        return F.scaled_dot_product_attention(qt, kv[0], kv[1], attn_mask=mask, scale=scale)
    return call


def max_err(a, b):
    """Max abs difference of two outputs."""
    return (a.float() - b.float()).abs().max().item()


def row_rel_err(a, b):
    """Max over sequences (dim 0) of a sequence's max abs difference over
    the largest |b| of that sequence (the abs difference where b is all 0):
    an error that would hide under a tolerance beside small outputs."""
    e = (a.float() - b.float()).abs().flatten(1).amax(1)
    r = b.float().abs().flatten(1).amax(1)
    return (e / r.clamp(min=1e-30)).where(r > 0, e).max().item()


def measure(torch, kernel, label, dname, run, plain, lib, work, iters, extra=None,
            outputs=None, tf32_passes=None):
    """One case: the kernel against its plain version on the same inputs
    (max abs error and, for a single output, ``row_rel_err``; for a tuple
    of outputs named by ``outputs``, each one's error as ``<name>_err``,
    ``max_abs_err`` being the first's), then
    ``cuda_time_ms`` times of kernel, plain version and library yardstick
    (None: there is none), the kernel's and the library's
    ``device_time_ms`` times and the kernel's host time per call, and the
    bound for the work (f32 with ``tf32_passes``, and K2 in f32, runs its
    products in TF32 on the tensor cores: ``bound_ms`` is then the TF32
    bound, also logged as ``bound_3xtf32_ms``, and the CUDA cores' f32
    bound is ``bound_cuda_core_ms``); ``extra`` (e.g. a decode call's
    split) is logged with it."""
    out = run()
    torch.cuda.synchronize()
    want = plain()
    if isinstance(out, tuple):
        errs = {f"{n}_err": max_err(o, w) for n, o, w in zip(outputs, out, want)}
        err, rel = errs[f"{outputs[0]}_err"], None
        extra = dict(extra or {}, **errs)
    else:
        err, rel = max_err(out, want), row_rel_err(out, want)
    ms = cuda_time_ms(run, iters)
    plain_ms = cuda_time_ms(plain, max(iters // 4, 1))
    lib_ms = cuda_time_ms(lib, iters) if lib else None
    device_ms, host_ms = device_time_ms(run, iters)
    lib_device_ms = device_time_ms(lib, iters)[0] if lib else None
    b_ms, b_by = bound(*work, dname)
    if kernel == "flash_attention" and dname == "float32":   # K2's f32 runs 3xTF32
        tf32_passes = 3
    if tf32_passes and dname == "float32":
        t_ms, t_by = bound_3xtf32(*work, passes=tf32_passes)
        extra = dict(extra or {}, tf32_passes=tf32_passes, bound_3xtf32_ms=t_ms,
                     bound_3xtf32_by=t_by, bound_cuda_core_ms=b_ms, bound_cuda_core_by=b_by)
        b_ms, b_by = t_ms, t_by
    return dict(kernel=kernel, case=label, dtype=dname, max_abs_err=err, tol=TOL[dname],
                row_rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                device_ms=device_ms, host_ms=host_ms, library_device_ms=lib_device_ms,
                **(extra or {}))


def int8_pool(torch, kp, vp):
    """K/V pages as int8 codes and f32 scales (the engine's quantizer)."""
    from repro_torch.kernels.kv_int8 import q8_kv
    (kq, ks), (vq, vs) = q8_kv(kp), q8_kv(vp)
    return kq, ks, vq, vs


def stale_checks(torch):
    """Empty rows, all-zero pages with floored scales, and stale table
    entries past ceil(kv_len / ps) (ids far outside the pool): outputs
    equal the plain version on the clean table, empty rows write 0.  At
    C = 4 (the chunk loops) and at decode (C = 1, split over several
    blocks), where the pool's last page, onto which a stale slot would
    clamp, holds NaN."""
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    from repro_torch.kernels.kv_int8 import SCALE_FLOOR
    out = []
    for C, max_kv, lens, dtype in ((4, 64, (0, 37, 64), torch.float32),
                                   (1, 1024, (0, 37, 1000), torch.float32),
                                   (1, 1024, (0, 37, 1000), torch.bfloat16)):
        q, kp, vp, table, _, _ = paged_case(torch, 3, C, 8, 2, 128, 16, max_kv, dtype, seed=4)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q_pos = (kv_lens - C).clamp(min=0).to(torch.int32)
        kq, ks, vq, vs = int8_pool(torch, kp.float(), vp.float())
        zero = table[1, :2].long()                 # two of row 1's pages: all zero
        kq[zero], vq[zero] = 0, 0
        ks[zero], vs[zero] = SCALE_FLOOR, SCALE_FLOOR
        kp[zero], vp[zero] = 0, 0
        if C == 1:                                 # the unowned last page: NaN
            for pool in (kp, vp, ks, vs):
                pool[-1] = float("nan")
        scale = 1.0 / math.sqrt(128)
        i8 = (q, kq, ks, vq, vs)
        want = {"paged_attention": K1.paged_attention_plain(q, kp, vp, table, kv_lens, q_pos,
                                                            scale=scale),
                "paged_attention_int8": K3.paged_attention_int8_plain(
                    *i8, table, kv_lens, q_pos, scale=scale)}
        stale = table.clone()
        stale[0, :] = 10**6                        # kv_len 0: no page is read
        stale[1, 3:] = 10**6                       # ceil(37 / 16) = 3 pages are read
        stale[2, -(-lens[2] // 16):] = 10**6
        got = {"paged_attention": K1.paged_attention(q, kp, vp, stale, kv_lens, q_pos,
                                                     scale=scale),
               "paged_attention_int8": K3.paged_attention_int8(*i8, stale, kv_lens, q_pos,
                                                               scale=scale)}
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        label = ("decode C=1" if C == 1 else f"C={C}") + ", empty row, zero pages, stale table"
        for name in got:
            o = got[name]
            out.append(dict(kernel=name, case=label, dtype=dname,
                            max_abs_err=max_err(o, want[name]), tol=TOL[dname],
                            finite=bool(torch.isfinite(o.float()).all()),
                            empty_row_zero=bool((o[0] == 0).all())))
    return out


def ssd_case(torch, B, T, H, P, N, dtype, h0, seed):
    """Inputs of one K4 call at the hybrid prefill's shapes: seeded
    normals at scale 0.25 (|y| stays below 4, where one bf16 step is
    inside the 2e-2 tolerance), log-decay -|normal| * 0.1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda") * 0.25
    x, Bc, Cc = r(B, T, H, P).to(dtype), r(B, T, N).to(dtype), r(B, T, N).to(dtype)
    la = -torch.randn(B, T, H, generator=g, device="cuda").abs() * 0.1
    return x, la, Bc, Cc, (r(B, H, P, N) if h0 else None)


def ssd_work(x, Bc, h0, chunk):
    """(bytes, flops) of one scan: x, la, B, C, y and h_final (and h0 when
    given) each moved once; the four products' multiply-adds over real
    steps only — the causal triangle of C.B^T and of its product with x,
    C.h (not on the first chunk when h0 = 0) and the state update."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    isz = x.element_size()
    nbytes = (2 * x.numel() + 2 * Bc.numel()) * isz + B * T * H * 4 \
        + B * H * P * N * 4 * (1 if h0 is None else 2)
    macs = 0
    for t0 in range(0, T, chunk):
        q = min(chunk, T - t0)
        macs += q * (q + 1) // 2 * (N + P) + q * P * N * (1 if t0 == 0 and h0 is None else 2)
    return nbytes, 2.0 * B * H * macs


def ssd_fwd_cases(torch, dtype, dname, iters):
    """K4's forward (``ssd_chunk_scan``) against its plain version: at
    zamba2's prefill (B = 8 prompts of 1024, 112 heads of 64, state 64,
    chunk 64), at a ragged T = 1000 with a nonzero h0 and, in f32, at the
    hybrid's training shape (B = 4, T = 1024), each with y's and h_final's
    errors apart (``y_err``, ``h_final_err``); f32 runs 3xTF32 on the
    tensor cores (``bound_ms`` is its 3xTF32 bound).  No single PyTorch
    call computes the scan."""
    from repro_torch.kernels import ssd_scan as K4
    shapes = [("prefill B=8 T=1024 H=112", 8, 1024, False),
              ("ragged T=1000 h0!=0", 8, 1000, True)]
    if dname == "float32":
        shapes.append(("train fwd B=4 T=1024 H=112", 4, 1024, False))
    cases = []
    for label, B, T, h0 in shapes:
        x, la, Bc, Cc, h = ssd_case(torch, B, T, 112, 64, 64, dtype, h0, seed=3)
        cases.append(measure(
            torch, "ssd_scan", label, dname,
            lambda: K4.ssd_chunk_scan(x, la, Bc, Cc, h, chunk=64),
            lambda: K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=64),
            None, ssd_work(x, Bc, h, 64), iters,
            dict(h_final_tol=TOL["float32"]), outputs=("y", "h_final"), tf32_passes=3))
        del x, la, Bc, Cc, h
    return cases


def ssd_bwd_work(x, Bc, h0, dh_final, chunk):
    """(bytes, flops) of one backward of the scan: x, la, B, C, dy (and
    h0, dh_final when given) read once, dx, dla, dB, dC (and dh0) written
    once; the multiply-adds over real steps only, and only those whose
    result is used — the causal triangles of C.B^T and dy.x^T and of the
    three products with them (dx, dB, dC); the state leaving each chunk
    but the last (the forward's state update); h^T.dy where the state
    entering the chunk is not zero (not on the first chunk when h0 = 0);
    dh.B and x^T.dh where the carried dh is not zero (not on the last
    chunk when dh_final = None); and dh's update where the dh entering
    the chunk is used (not on the first chunk when h0 = None: dh0 is not
    returned)."""
    B, T, H, P = x.shape
    N = Bc.shape[-1]
    isz = x.element_size()
    state = B * H * P * N * 4
    nbytes = (3 * x.numel() + 4 * Bc.numel()) * isz + 2 * B * T * H * 4 \
        + state * ((2 if h0 is not None else 0) + (dh_final is not None))
    macs = 0
    for t0 in range(0, T, chunk):
        q = min(chunk, T - t0)
        last = t0 + chunk >= T
        h_in = t0 > 0 or h0 is not None
        macs += q * (q + 1) // 2 * (3 * N + 2 * P) + q * P * N * (
            (not last) + h_in + 2 * (not last or dh_final is not None) + h_in)
    return nbytes, 2.0 * B * H * macs


SSD_BWD_OUTPUTS = ("dx", "dla", "dB", "dC", "dh0")


def ssd_bwd_cases(torch, dtype, dname, iters):
    """K4's backward kernels (``ssd_chunk_scan_bwd``) against their plain
    version on the same inputs: at the hybrid's training shape (B = 4, T =
    1024, 112 heads, P = N = 64, chunk 64, h0 = 0, no gradient on the final
    state) and at a ragged T = 1000 with h0 and dh_final given.  Each
    gradient's max abs difference over its own max |g| is logged apart
    (``<name>_rel_err``) and held to the dtype's tolerance (bf16: the
    inputs' and dx's rounding); ``max_abs_err`` is the largest abs
    difference.  Each pass's device time (``states_device_ms``,
    ``chunks_device_ms``) comes from ``torch.profiler``, and the
    workspace's bytes are logged with ``ws_floor_ms``: the call's bytes
    plus the states written and read once, at the card's HBM rate.  f32
    runs 3xTF32 on the tensor cores (``bound_ms`` is its 3xTF32 bound).
    No single PyTorch call computes the scan's backward."""
    from repro_torch.kernels import ssd_scan as K4
    cases = []
    for label, T, given in (("train B=4 T=1024 H=112", 1024, False),
                            ("ragged T=1000 h0!=0 dh_final!=0", 1000, True)):
        x, la, Bc, Cc, h = ssd_case(torch, 4, T, 112, 64, 64, dtype, given, seed=8)
        g = torch.Generator(device="cuda").manual_seed(9)
        dy = (torch.randn(x.shape, generator=g, device="cuda") * 0.25).to(dtype)
        dh = torch.randn(h.shape, generator=g, device="cuda") * 0.25 if given else None
        names = SSD_BWD_OUTPUTS[:5 if given else 4]
        run = lambda: K4.ssd_chunk_scan_bwd(x, la, Bc, Cc, h, dy, dh, chunk=64)[:len(names)]
        plain = lambda: K4.ssd_chunk_scan_bwd_plain(x, la, Bc, Cc, h, dy, dh,
                                                    chunk=64)[:len(names)]
        got, want = run(), plain()
        torch.cuda.synchronize()
        rel = {f"{n}_rel_err": max_err(a, b) / max(b.float().abs().max().item(), 1e-30)
               for n, a, b in zip(names, got, want)}
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        del got, want
        passes = ssd_bwd_pass_ms(torch, run, iters)
        work = ssd_bwd_work(x, Bc, h, dh, 64)
        states = 4 * math.prod((*x.shape[::2], x.shape[3], Bc.shape[-1]))  # [B, H, P, N] f32
        n_chunks = -(-T // 64)
        ws_bytes = 2 * n_chunks * states                 # h and dh entering each chunk
        ws_used = 2 * 2 * (n_chunks - 1) * states        # written, read; h0, dh_final not stored
        extra = dict(rel, finite=finite, **passes, ws_bytes=ws_bytes,
                     ws_floor_ms=(work[0] + ws_used) / card_spec().hbm_bw * 1e3)
        c = measure(torch, "ssd_scan_bwd", label, dname, run, plain, None, work, iters, extra,
                    outputs=names, tf32_passes=3)
        c["max_abs_err"] = max(c[f"{n}_err"] for n in names)
        cases.append(c)
        del x, la, Bc, Cc, h, dy, dh
    return cases


def ssd_bwd_pass_ms(torch, run, iters):
    """Device ms a call of each of K4's backward kernels, from
    ``torch.profiler`` over ``iters`` calls of ``run``."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    us = {k: 0.0 for k in ("states", "chunks")}
    for name, t in device_events(torch, prof):
        for k in us:
            if f"ssd_bwd_{k}_kernel" in name:
                us[k] += t
    return {f"{k}_device_ms": v / iters / 1e3 if v else "not measured" for k, v in us.items()}


TC_KERNELS = (  # library, kernel name, dtype, C helpers of its dynamic shared memory
    # and (or None) of its blocks an SM
    ("flash_attention", "flash_attention_kernel_tc", "bf16", "flash_attention_bf16_smem_bytes",
     None),
    ("flash_attention", "flash_attention_kernel_f32", "f32", "flash_attention_f32_smem_bytes",
     "flash_attention_f32_blocks_per_sm"),
    ("paged_attention", "paged_attention_kernel_tc", "bf16", "paged_attention_bf16_smem_bytes",
     None),
    ("paged_attention_int8", "paged_attention_int8_kernel_tc", "bf16",
     "paged_attention_int8_bf16_smem_bytes", None),
    ("paged_attention", "paged_attention_kernel_f32", "f32", "paged_attention_f32_smem_bytes",
     "paged_attention_f32_blocks_per_sm"),
    ("paged_attention_int8", "paged_attention_int8_kernel_f32", "f32",
     "paged_attention_int8_f32_smem_bytes", "paged_attention_int8_f32_blocks_per_sm"))


def tc_resources(lib, kernel, dtype, smem_symbol, blocks_symbol):
    """Registers, stack and spills of each tensor-core instantiation of
    ``kernel`` in library ``lib`` (padded head dim DP, without and with
    softcap; K2's also without and with its training forward's ``lse``
    output, and its f32 kernel's forward-only ``SPLIT``, the key split of
    calls of at most 16 rows) from the ``ptxas -v`` output in
    ``build.build_log``, with the dynamic shared memory a block of it
    takes (and, given ``blocks_symbol``, the blocks of it an SM holds).
    Fails if a DP = 64 or 128 one spills (the paths run d = 112 and 128;
    spills at 256 are allowed)."""
    import ctypes
    import re
    from repro_torch.kernels import build
    text = build.build_log[lib]["ptxas"]
    if text == "(reused)":
        return "not available: the library was built before this run"
    smem = build.kernel_fn(lib, smem_symbol, [ctypes.c_int])
    blocks = build.kernel_fn(lib, blocks_symbol, [ctypes.c_int]) if blocks_symbol else None
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(kernel + r"ILi(\d+)ELb([01])E(?:Lb([01])E)?(?:Lb([01])E)?", line)
            cur = out.setdefault(f"DP={m[1]}" + (" softcap" if m[2] == "1" else "")
                                 + (" lse" if m[3] == "1" else "")
                                 + (" split" if m[4] == "1" else ""),
                                 dict(dynamic_smem_bytes=smem(int(m[1])),
                                      **({"blocks_per_sm": blocks(int(m[1]))} if blocks
                                         else {}))) if m else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    # K2 adds its training forward; its f32 kernel, the key split of
    # forward-only calls
    modes = (("", " lse") + ((" split",) if dtype == "f32" else ())
             if lib == "flash_attention" else ("",))
    want = [f"DP={dp}{cap}{x}" for dp in (32, 64, 128, 256) for cap in ("", " softcap")
            for x in modes]
    if sorted(out) != sorted(want):
        fail(f"ptxas log lacks the {dtype} instantiations of {kernel}: {sorted(out)}")
    for key in (k for k in want if k.split()[0] in ("DP=64", "DP=128")):
        if out[key].get("spill_store_bytes", 1) or out[key].get("spill_load_bytes", 1):
            fail(f"{kernel} {key} spills to local memory: {out[key]}")
    return out


def ssd_resources():
    """Registers, stack and spills of every instantiation of K4's forward
    kernels, the bf16 ``ssd_scan_kernel_tc`` and the f32
    ``ssd_scan_kernel_f32`` (``VEC``: P and N multiples of 8, the main
    path's; else element copies), from the ``ptxas -v`` output, with each
    kernel's dynamic shared memory a block and the blocks of its ``VEC``
    instantiation one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Fails if a
    ``VEC`` instantiation spills."""
    import re
    from repro_torch.kernels import build
    text = build.build_log["ssd_scan"]["ptxas"]
    if text == "(reused)":
        return "not available: the library was built before this run"
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"ssd_scan_kernel_(tc|f32)ILb([01])E", line)
            cur = out.setdefault(f"{'bf16' if m[1] == 'tc' else 'f32'} "
                                 + ("VEC" if m[2] == "1" else "element copies"),
                                 {}) if m else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    want = [f"{d} {v}" for d in ("bf16", "f32") for v in ("VEC", "element copies")]
    if sorted(out) != sorted(want):
        fail(f"ptxas log lacks the instantiations of K4's forward kernels: {sorted(out)}")
    for d in ("bf16", "f32"):
        k = f"{d} VEC"
        if out[k].get("spill_store_bytes", 1) or out[k].get("spill_load_bytes", 1):
            fail(f"K4's forward {k} spills to local memory: {out[k]}")
        out[f"{d} dynamic_smem_bytes"] = build.kernel_fn(
            "ssd_scan", f"ssd_scan_{d}_smem_bytes", [])()
        out[f"{d} blocks_per_sm"] = build.kernel_fn(
            "ssd_scan", f"ssd_scan_{d}_blocks_per_sm", [])()
        if out[f"{d} blocks_per_sm"] < 1:
            fail(f"K4's forward {d} kernel cannot be resident on an SM: {out}")
    return out


def ssd_bwd_resources():
    """Registers, stack and spills of every instantiation of K4's backward
    kernels (``ssd_bwd_states_kernel`` and ``ssd_bwd_chunks_kernel``, f32
    and bf16 inputs, ``VEC``: P and N multiples of 8, else element copies)
    from the ``ptxas -v`` output of both libraries (``ssd_scan_bwd`` for
    f32, ``ssd_scan_bwd_bf16``), with each kernel's dynamic shared memory
    and the blocks of its f32 ``VEC`` instantiation one SM holds.  Fails
    if an f32 ``VEC`` instantiation (the training path's) spills."""
    import ctypes
    import re
    from repro_torch.kernels import build
    texts = [build.build_log[lib]["ptxas"] for lib in ("ssd_scan_bwd", "ssd_scan_bwd_bf16")]
    if "(reused)" in texts:
        return "not available: the library was built before this run"
    text = "\n".join(texts)
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"ssd_bwd_(states|chunks)_kernelI(f|13__nv_bfloat16)Lb([01])E", line)
            cur = out.setdefault(f"{m[1]} {'f32' if m[2] == 'f' else 'bf16'}"
                                 + (" VEC" if m[3] == "1" else " element copies"),
                                 {}) if m else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    want = [f"{k} {d} {v}" for k in ("states", "chunks") for d in ("f32", "bf16")
            for v in ("VEC", "element copies")]
    if sorted(out) != sorted(want):
        fail(f"ptxas log lacks the instantiations of K4's backward kernels: {sorted(out)}")
    for k in ("states f32 VEC", "chunks f32 VEC"):
        if out[k].get("spill_store_bytes", 1) or out[k].get("spill_load_bytes", 1):
            fail(f"K4's backward {k} spills to local memory: {out[k]}")
    for i, k in ((1, "states"), (2, "chunks")):
        out[f"{k} dynamic_smem_bytes"] = build.kernel_fn(
            "ssd_scan_bwd", "ssd_scan_bwd_smem_bytes", [ctypes.c_int])(i)
        out[f"{k} blocks_per_sm"] = build.kernel_fn(
            "ssd_scan_bwd", "ssd_scan_bwd_blocks_per_sm", [ctypes.c_int])(i)
        if out[f"{k} blocks_per_sm"] < 1:
            fail(f"K4's backward {k} kernel cannot be resident on an SM: {out}")
    return out


DECODE_KERNELS = (  # library, kernel name, template arguments after the type
    ("paged_attention", "paged_attention_decode_kernel", ("VPL", "GR")),
    ("paged_attention_int8", "paged_attention_int8_decode_kernel", ("GR",)))


def decode_resources(lib, kernel, params):
    """Registers, stack, spills and static shared memory of every
    instantiation of the split-KV decode ``kernel`` in library ``lib`` and
    of its combine, from the ``ptxas -v`` output in ``build.build_log``.
    Fails if one spills, except f32 with two vectors a lane (VPL = 2,
    d > 128)."""
    import re
    from repro_torch.kernels import build
    text = build.build_log[lib]["ptxas"]
    if text == "(reused)":
        return "not available: the library was built before this run"
    combine = kernel.replace("_kernel", "_combine_kernel")
    args = "".join(r"Li(\d+)E" for _ in params)
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(kernel + r"I(f|13__nv_bfloat16)" + args, line)
            c = re.search(combine + r"I(f|13__nv_bfloat16)E", line)
            cur = None
            if m:
                key = ("f32" if m[1] == "f" else "bf16") + "".join(
                    f" {p}={v}" for p, v in zip(params, m.groups()[1:]))
                cur = out.setdefault(key, {})
            elif c:
                cur = out.setdefault("combine " + ("f32" if c[1] == "f" else "bf16"), {})
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem[1]) if smem else 0
    if not any(k.startswith("combine") for k in out) or len(out) < 4:
        fail(f"ptxas log lacks the decode instantiations of {kernel}: {sorted(out)}")
    for key, r in out.items():
        if "VPL=2" in key and key.startswith("f32"):
            continue
        if r.get("spill_store_bytes", 1) or r.get("spill_load_bytes", 1):
            fail(f"{kernel} {key} spills to local memory: {r}")
    return out


def decode_split_info(torch, q, kp, table):
    """The split of a decode call on this card: split count, split length
    in keys, and the f32 workspace bytes its partials take."""
    from repro_torch.kernels import paged_attention as K1
    B, _, H, d = q.shape
    S, L = K1.decode_splits(B, kp.shape[2], table.shape[1], kp.shape[1],
                            K1.sm_count(q.device))
    return dict(splits=S, split_keys=L, workspace_bytes=B * H * S * (d + 2) * 4 if S > 1 else 0)


def f32_chunk_split(torch, kernel, args, kw, plain, iters):
    """An f32 chunk call's key split on this card (split count, split
    length in keys, the f32 workspace bytes of its partials), and the same
    call with the split off: the kernel's C entry called with S = 1, which
    takes no workspace, its device ms (``unsplit_device_ms``) and its max
    abs error against the plain version (``unsplit_max_abs_err``)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    from repro_torch.models.layers import NO_WINDOW
    q, kp, table = args[0], args[1], args[-3]
    B, C, H, d = q.shape
    N, ps, KV, _ = kp.shape
    Pmax = table.shape[1]
    slots = K1.sm_count(q.device) * K1.chunk_blocks_per_sm(kernel, d)
    S, L = K1.chunk_splits(B, C, H // KV, KV, Pmax, ps, slots)
    wrapper = K1 if kernel == "paged_attention" else K3
    fn = build.kernel_fn(kernel, f"{kernel}_f32", wrapper._F32_ARGTYPES)
    out = torch.empty_like(q)
    window = kw.get("window")
    tail = (B, C, H, KV, d, N, ps, Pmax, 1, Pmax * ps, float(kw["scale"]),
            NO_WINDOW if window is None else int(window), float(kw.get("softcap") or 0.0),
            torch.cuda.current_stream().cuda_stream)

    def unsplit():   # the wrapper's pointers: its inputs in order, then out
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), None, None, *tail)
        if rc != 0:
            fail(f"{kernel}_f32 with S = 1 failed: CUDA error {rc}")
        return out

    return dict(chunk_splits=S, chunk_split_keys=L, chunk_slots=slots,
                chunk_workspace_bytes=B * C * H * S * (d + 2) * 4 if S > 1 else 0,
                unsplit_max_abs_err=max_err(unsplit(), plain()),
                unsplit_device_ms=device_time_ms(unsplit, iters)[0])


SDPA_WINDOW_ONLY = "SDPA with the window mask alone (it has no softcap)"


def gemma2_cases(torch, dtype, dname, iters):
    """K1, K2 and K3 at gemma2-2b's attention: 8 q / 4 kv heads of d = 256
    (the kernels' <256> instantiations), scale 1/16, window 4096 and
    attention softcap 50, at the shapes of its phase-5 path: K2 on a
    prefill of 2 prompts of 4608 tokens, K1/K3 decode for 16 sequences of
    up to 5000 keys through the path's table width, and chunks of 256
    tokens ending past 4096.  The library yardstick has the window mask
    but no softcap."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    F = torch.nn.functional
    cfg = get_config("gemma2-2b")
    KV, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    kw = dict(scale=cfg.attn_scale_override, window=W, softcap=cfg.attn_logit_softcap)
    note = dict(library_note=SDPA_WINDOW_ONLY)
    cases = []
    g = torch.Generator(device="cuda").manual_seed(8)
    B, T = 2, 4608
    q = torch.randn(B, T, KV * G, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    t = torch.arange(T, device="cuda")
    mask = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - W)
    cases.append(measure(
        torch, "flash_attention", f"gemma2 prefill B={B} T={T} d=256 window={W}", dname,
        lambda: K2.flash_attention(q, k, v, lens, **kw),
        lambda: K2.flash_attention_plain(q, k, v, lens, **kw),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=kw["scale"]),
        flash_work(q, k, lens, W), iters, note))
    del q, k, v, qt, kt, vt, mask
    for label, B, C, min_kv, pmax in (
            ("gemma2 decode B=16 C=1 d=256 kv<=5000", 16, 1, None, GEMMA_SERVE["max_pages_per_seq"]),
            ("gemma2 chunk B=2 C=256 d=256 kv 4400-5000", 2, 256, 4400, None)):
        args = paged_case(torch, B, C, KV, G, d, 16, 5000, dtype, seed=9, min_kv=min_kv,
                          pmax=pmax)
        run = lambda: K1.paged_attention(*args, **kw)
        plain = lambda: K1.paged_attention_plain(*args, **kw)
        f32_chunk = C > 1 and dtype == torch.float32
        split = (decode_split_info(torch, args[0], args[1], args[3]) if C == 1 else
                 f32_chunk_split(torch, "paged_attention", args, kw, plain, iters)
                 if f32_chunk else {})
        cases.append(measure(
            torch, "paged_attention", label, dname, run, plain,
            sdpa_paged(torch, *args, kw["scale"], W),
            paged_work(args[0], args[1], args[3], args[4], args[5], window=W), iters,
            dict(split, **note), tf32_passes=3 if f32_chunk else None))
        q, kp, vp, table, kv_lens, q_pos = paged_case(
            torch, B, C, KV, G, d, 16, 5000, torch.float32, seed=9, min_kv=min_kv, pmax=pmax)
        i8 = (q.to(dtype), *int8_pool(torch, kp, vp), table, kv_lens, q_pos)
        del args, kp, vp
        run = lambda: K3.paged_attention_int8(*i8, **kw)
        plain = lambda: K3.paged_attention_int8_plain(*i8, **kw)
        if f32_chunk:
            split = f32_chunk_split(torch, "paged_attention_int8", i8, kw, plain, iters)
        cases.append(measure(
            torch, "paged_attention_int8", label, dname, run, plain,
            sdpa_paged_int8(torch, *i8, kw["scale"], W),
            paged_work(i8[0], i8[1], table, kv_lens, q_pos, kv_bytes=i8[1].shape[3] + 4,
                       window=W),
            iters, dict(split, **note), tf32_passes=2 if f32_chunk else None))
        del i8
    return cases


def seamless_cases(torch, dtype, dname, iters):
    """K2 and K1 at seamless-m4t-medium's attention (16 q / 16 kv heads of
    d = 64, G = 1, scale 1/8) in the shapes its phase-5 path gives them:
    K2 over the encoder (B = 8 utterances of 1024 frames, non-causal,
    valid frames ragged from 512 to 1024), cross-attention in prefill (B =
    8 prompts of 64 tokens against 1024 frames) and in decode (B = 16, one
    query row against 1024 frames), all non-causal; K1 decode for 16 rows
    of 65-96 keys (64-token prompts and up to 32 new tokens) through the
    path's 6-page table.  K2's library yardstick is SDPA with the kv_lens
    mask."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    F = torch.nn.functional
    cfg = get_config("seamless-m4t-medium")
    H, d = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(d)
    g = torch.Generator(device="cuda").manual_seed(10)
    cases = []
    for label, B, T, Tk, ragged in (
            ("seamless encoder B=8 T=1024 non-causal, ragged kv_lens", 8, 1024, 1024, True),
            ("seamless cross prefill B=8 T=64 Tk=1024", 8, 64, 1024, False),
            ("seamless cross decode B=16 T=1 Tk=1024", 16, 1, 1024, False)):
        q = torch.randn(B, T, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Tk, H, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Tk, H, d, generator=g, device="cuda").to(dtype)
        lens = (torch.linspace(Tk // 2, Tk, B, device="cuda").round().to(torch.int32) if ragged
                else torch.full((B,), Tk, dtype=torch.int32, device="cuda"))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        mask = (torch.arange(Tk, device="cuda")[None, :] < lens[:, None])[:, None, None]
        cases.append(measure(
            torch, "flash_attention", label, dname,
            lambda: K2.flash_attention(q, k, v, lens, scale=scale, causal=False),
            lambda: K2.flash_attention_plain(q, k, v, lens, scale=scale, causal=False),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale),
            flash_work(q, k, lens, causal=False), iters))
        del q, k, v, qt, kt, vt
    args = paged_case(torch, 16, 1, H, 1, d, 16, 96, dtype, seed=11, min_kv=65)
    cases.append(measure(
        torch, "paged_attention", "seamless decode B=16 C=1 d=64 G=1, kv 65-96", dname,
        lambda: K1.paged_attention(*args, scale=scale),
        lambda: K1.paged_attention_plain(*args, scale=scale),
        sdpa_paged(torch, *args, scale),
        paged_work(args[0], args[1], args[3], args[4], args[5]), iters,
        decode_split_info(torch, args[0], args[1], args[3])))
    return cases


LSE_TOL = 1e-4     # lse is f32 in both dtypes: relative, |a - b| <= 1e-4 max(|b|, 1)


def lse_rel_err(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()


def lse_cases(torch, dtype, dname, iters):
    """K2's training forward (``flash_attention_lse``: o and the
    log-normalizer) against its plain version, beside the forward-only
    K2 at the same shape: qwen3-0.6b's training shape (B = 4, T = 512, 16
    q / 8 kv heads of 128, causal), gemma2-2b's heads (d = 256, softcap
    50, scale 1/16) with a window of 256 keys at T = 1024, and a ragged
    non-causal call (seamless-m4t's cross-attention heads, 256 query rows
    against 1024 keys, valid keys from 300), and the zamba2 hybrid's
    shared attention at its training shape (B = 4, T = 1024, 32 heads of
    112, causal).  o is held to the dtype's
    tolerance, lse to ``LSE_TOL``.  The library yardstick is SDPA's
    forward, which returns no lse.  For the qwen3 shape the recompute
    backward (``layers.flash_ckpt_bwd``, torch ops) is timed too
    (``bwd_ms``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.models import layers
    F = torch.nn.functional
    gem = get_config("gemma2-2b")
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    for label, B, T, Tk, H, KV, d, kw, ragged in (
            ("train lse qwen3 B=4 T=512", 4, 512, 512, 16, 8, 128,
             dict(scale=1.0 / math.sqrt(128)), False),
            ("train lse gemma2 B=2 T=1024 d=256 window=256 softcap=50", 2, 1024, 1024, 8, 4,
             256, dict(scale=gem.attn_scale_override, window=256,
                       softcap=gem.attn_logit_softcap), False),
            ("train lse non-causal B=4 T=256 Tk=1024 ragged", 4, 256, 1024, 16, 16, 64,
             dict(scale=0.125, causal=False), True),
            ("train lse hybrid B=4 T=1024 d=112", 4, 1024, 1024, 32, 32, 112,
             dict(scale=1.0 / math.sqrt(112)), False)):
        q = torch.randn(B, T, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Tk, KV, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Tk, KV, d, generator=g, device="cuda").to(dtype)
        lens = (torch.linspace(300, Tk, B, device="cuda").round().to(torch.int32) if ragged
                else torch.full((B,), Tk, dtype=torch.int32, device="cuda"))
        causal = kw.get("causal", True)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
                  for a in (k, v))
        t, tk = torch.arange(T, device="cuda"), torch.arange(Tk, device="cuda")
        mask = tk[None, None, :] < lens[:, None, None]
        if causal:
            mask = mask & (tk[None, None, :] <= t[None, :, None])
        if "window" in kw:
            mask = mask & (tk[None, None, :] > t[None, :, None] - kw["window"])
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                                     scale=kw["scale"])
        nbytes, flops = flash_work(q, k, lens, kw.get("window"), causal)
        o, lse = K2.flash_attention_lse(q, k, v, lens, **kw)
        want_o, want_lse = K2.flash_attention_lse_plain(q, k, v, lens, **kw)
        extra = dict(lse_rel_err=lse_rel_err(lse, want_lse), lse_tol=LSE_TOL,
                     library_note="SDPA forward (no lse)")
        if label.startswith("train lse qwen3"):
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            extra["bwd_ms"] = cuda_time_ms(lambda: layers.flash_ckpt_bwd(
                q, k, v, lens, o, lse, do, **kw), max(iters // 4, 1))
            extra["bwd_device_ms"] = device_time_ms(lambda: layers.flash_ckpt_bwd(
                q, k, v, lens, o, lse, do, **kw), max(iters // 4, 1))[0]
            del do
        del o, lse, want_o, want_lse
        cases.append(measure(
            torch, "flash_attention", label, dname,
            lambda: K2.flash_attention_lse(q, k, v, lens, **kw),
            lambda: K2.flash_attention_lse_plain(q, k, v, lens, **kw),
            lib, (nbytes + B * H * T * 4, flops), iters, extra, outputs=("o", "lse")))
        cases.append(measure(
            torch, "flash_attention", label.replace("train lse", "train forward-only"), dname,
            lambda: K2.flash_attention(q, k, v, lens, **kw),
            lambda: K2.flash_attention_plain(q, k, v, lens, **kw),
            lib, (nbytes, flops), iters))
        del q, k, v, qt, kt, vt, mask
    return cases


def ckpt_backward_check(torch):
    """The backward of ``flash_attention_ckpt`` on cuda (K2's training
    forward, then the recompute in torch ops on the card) against the same
    ``torch.autograd.Function`` on the CPU (plain forward, the same
    recompute), f32, on the same inputs: qwen3-0.6b's heads causal (B = 2,
    T = 512) and gemma2-2b's (d = 256, window 256, softcap 50).  dq, dk
    and dv must agree within 1e-4 relative to each tensor's max |g|."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    gem = get_config("gemma2-2b")
    g = torch.Generator().manual_seed(13)
    out = []
    for label, B, T, H, KV, d, kw in (
            ("qwen3 B=2 T=512", 2, 512, 16, 8, 128, dict(scale=1.0 / math.sqrt(128))),
            ("gemma2 B=1 T=512 d=256 window=256 softcap=50", 1, 512, 8, 4, 256,
             dict(scale=gem.attn_scale_override, window=256, softcap=gem.attn_logit_softcap))):
        x = [torch.randn(B, T, h, d, generator=g) for h in (H, KV, KV)]
        do = torch.randn(B, T, H, d, generator=g)
        lens = torch.full((B,), T, dtype=torch.int32)
        grads = {}
        for dev in ("cuda", "cpu"):
            q, k, v = (t.detach().to(dev).requires_grad_() for t in x)
            o = ops.flash_attention_ckpt(q, k, v, lens.to(dev), **kw)
            o.backward(do.to(dev))
            grads[dev] = [t.grad.cpu() for t in (q, k, v)]
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(grads["cuda"], grads["cpu"])]
        r = dict(case=label, dq_rel=rel[0], dk_rel=rel[1], dv_rel=rel[2], tol=1e-4)
        log("flash_attention_ckpt backward cuda vs cpu " + json.dumps(r))
        if not max(rel) <= 1e-4:
            fail(f"flash_attention_ckpt backward differs between cuda and cpu: {r}")
        out.append(r)
    return out


def phase_kernels(torch, iters):
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    F = torch.nn.functional
    scale = 1.0 / math.sqrt(128)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        cases += ssd_fwd_cases(torch, dtype, dname, iters)
        cases += ssd_bwd_cases(torch, dtype, dname, iters)
        # K1/K2 at the hybrid's shared attention: d=112, 32 q and 32 kv
        # heads (G=1); decode rows all at one length, as in its decode
        hy_scale = 1.0 / math.sqrt(112)
        args = paged_case(torch, 8, 1, 32, 1, 112, 16, 1040, dtype, seed=6, min_kv=1040)
        cases.append(measure(
            torch, "paged_attention", "hybrid decode B=8 C=1 d=112 G=1", dname,
            lambda: K1.paged_attention(*args, scale=hy_scale),
            lambda: K1.paged_attention_plain(*args, scale=hy_scale),
            sdpa_paged(torch, *args, hy_scale),
            paged_work(args[0], args[1], args[3], args[4], args[5]), iters,
            decode_split_info(torch, args[0], args[1], args[3])))
        g = torch.Generator(device="cuda").manual_seed(7)
        qkv = [torch.randn(8, 1024, 32, 112, generator=g, device="cuda").to(dtype)
               for _ in range(3)]
        lens = torch.full((8,), 1024, dtype=torch.int32, device="cuda")
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in qkv)
        cases.append(measure(
            torch, "flash_attention", "hybrid prefill B=8 T=1024 d=112 G=1", dname,
            lambda: K2.flash_attention(*qkv, lens, scale=hy_scale),
            lambda: K2.flash_attention_plain(*qkv, lens, scale=hy_scale),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=hy_scale),
            flash_work(qkv[0], qkv[1], lens), iters))
        del qkv, qt, kt, vt
        # decode at qwen3's batch (with the main path's table width, so its
        # split is the one the engine runs), a full batch of 64 and one user
        # on a 4096-key context; chunks of 128 and 256
        for label, B, C, max_kv, min_kv, pmax in (
                ("decode B=16 C=1", 16, 1, 1024, None, MAIN_SERVE["max_pages_per_seq"]),
                ("decode B=64 C=1", 64, 1, 1024, None, None),
                ("decode B=1 C=1 kv=4096", 1, 1, 4096, 4096, None),
                ("chunk B=2 C=128", 2, 128, 1024, None, None),
                ("chunk B=2 C=256", 2, 256, 1024, None, None)):
            args = paged_case(torch, B, C, 8, 2, 128, 16, max_kv, dtype, seed=1, min_kv=min_kv,
                              pmax=pmax)
            run = lambda: K1.paged_attention(*args, scale=scale)
            plain = lambda: K1.paged_attention_plain(*args, scale=scale)
            f32_chunk = C > 1 and dtype == torch.float32
            split = (decode_split_info(torch, args[0], args[1], args[3]) if C == 1 else
                     f32_chunk_split(torch, "paged_attention", args, dict(scale=scale), plain,
                                     iters) if f32_chunk else None)
            cases.append(measure(
                torch, "paged_attention", label, dname, run, plain,
                sdpa_paged(torch, *args, scale),
                paged_work(args[0], args[1], args[3], args[4], args[5]), iters, split,
                tf32_passes=3 if f32_chunk else None))
            # K3 on the same shapes: codes and scales of seeded f32 normals
            q, kp, vp, table, kv_lens, q_pos = paged_case(
                torch, B, C, 8, 2, 128, 16, max_kv, torch.float32, seed=1, min_kv=min_kv,
                pmax=pmax)
            i8 = (q.to(dtype), *int8_pool(torch, kp, vp), table, kv_lens, q_pos)
            del args, kp, vp
            run = lambda: K3.paged_attention_int8(*i8, scale=scale)
            plain = lambda: K3.paged_attention_int8_plain(*i8, scale=scale)
            if f32_chunk:
                split = f32_chunk_split(torch, "paged_attention_int8", i8, dict(scale=scale),
                                        plain, iters)
            cases.append(measure(
                torch, "paged_attention_int8", label, dname, run, plain,
                sdpa_paged_int8(torch, *i8, scale),
                paged_work(i8[0], i8[1], table, kv_lens, q_pos, kv_bytes=i8[1].shape[3] + 4),
                iters, split, tf32_passes=2 if f32_chunk else None))
            del i8
        g = torch.Generator(device="cuda").manual_seed(2)
        B, T, H, KV, d = 4, 1024, 16, 8, 128
        q = torch.randn(B, T, H, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, T, KV, d, generator=g, device="cuda").to(dtype)
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
        cases.append(measure(
            torch, "flash_attention", f"prefill B={B} T={T}", dname,
            lambda: K2.flash_attention(q, k, v, lens, scale=scale),
            lambda: K2.flash_attention_plain(q, k, v, lens, scale=scale),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale),
            flash_work(q, k, lens), iters))
        del q, k, v, qt, kt, vt
        cases += gemma2_cases(torch, dtype, dname, iters)
        cases += seamless_cases(torch, dtype, dname, iters)
        cases += lse_cases(torch, dtype, dname, iters)
    edge = stale_checks(torch)
    ckpt_backward_check(torch)
    for c in cases + edge:
        log("kernel " + json.dumps(c))
    bad = [c for c in cases + edge if c["kernel"] != "ssd_scan_bwd"
           and not c["max_abs_err"] <= c["tol"]]
    # K4's backward: each gradient to the dtype's tolerance relative to its
    # own max |g| (the dL sums run over Q * P * N products)
    bad += [c for c in cases if c["kernel"] == "ssd_scan_bwd" and not (c["finite"] and all(
        c[f"{n}_rel_err"] <= c["tol"] for n in SSD_BWD_OUTPUTS if f"{n}_rel_err" in c))]
    # K4's state feeds every later step: h_final is held to f32's 1e-4 in
    # both dtypes, y (max_abs_err) to the dtype's tolerance
    bad += [c for c in cases if "h_final_tol" in c and not c["h_final_err"] <= c["h_final_tol"]]
    # decode averages softmax weights over up to thousands of keys, so its
    # |o| is small: its error is held to the tolerance relative to each
    # sequence's max |o| as well, which a dropped split or a halved output
    # would exceed
    bad += [c for c in cases if "splits" in c and not c["row_rel_err"] <= c["tol"]]
    bad += [c for c in edge if not (c["finite"] and c["empty_row_zero"])]
    bad += [c for c in cases if "lse_rel_err" in c and not c["lse_rel_err"] <= LSE_TOL]
    # the f32 chunk kernels agree with the split off too
    bad += [c for c in cases if "unsplit_max_abs_err" in c
            and not c["unsplit_max_abs_err"] <= c["tol"]]
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


def requests(n, vocab, lo, hi, new_lo, new_hi, seed, base_rid=0):
    import numpy as np
    from repro_torch.core.engine import Request
    from repro_torch.core.sampler import SamplingParams
    rng = np.random.RandomState(seed)
    return [Request(rid=base_rid + i,
                    prompt=[int(t) for t in rng.randint(2, vocab, size=rng.randint(lo, hi + 1))],
                    sampling=SamplingParams(max_new_tokens=int(rng.randint(new_lo, new_hi + 1))))
            for i in range(n)]


def requests_of_lengths(lengths, vocab, new, seed):
    """One request per prompt length, each generating ``new`` tokens."""
    import numpy as np
    from repro_torch.core.engine import Request
    from repro_torch.core.sampler import SamplingParams
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.randint(2, vocab, size=n)],
                    sampling=SamplingParams(max_new_tokens=new))
            for i, n in enumerate(lengths)]


def launch_counts():
    """Every launch counter of the kernel wrappers: name -> (module,
    attribute).  K1 and K3 also count decode (C = 1) and chunk (C > 1)
    launches apart, as ``<name>_decode`` and ``<name>_chunk``."""
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    from repro_torch.kernels import ssd_scan as K4
    mods = {"paged_attention": K1, "flash_attention": K2, "paged_attention_int8": K3,
            "ssd_scan": K4}
    counters = {name: (mod, "launches") for name, mod in mods.items()}
    for name in ("paged_attention", "paged_attention_int8"):
        for part in ("decode", "chunk"):
            counters[f"{name}_{part}"] = (mods[name], f"launches_{part}")
    counters["flash_attention_lse"] = (K2, "launches_lse")     # K2's training forward
    counters["ssd_scan_bwd"] = (K4, "launches_bwd")            # K4's backward
    return counters


def zero_launches():
    for mod, attr in launch_counts().values():
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in launch_counts().items()}


CROSS_SERVE = dict(max_batch=8, page_size=16, n_pages=128, max_pages_per_seq=16,
                   prefill_chunk=32, n_streams=2, chunk_tokens=64)
CHUNKING_MODES = ("splitwiser", "splitwiser_mps", "chunked")
# phase 4's engine checks, f32, weights drawn on the CPU from seed 0: name
# (None: qwen3-0.6b, labelled by its page type alone), arch, config
# overrides ({}: full depth), serve config, modes (None: every mode) and
# requests (``cross_requests``).  qwen3-0.6b at full width and 2 layers
# with fp pages, then int8 pages under the runtime sanitizer; opt-125m at
# full width and depth; gemma2-2b at full width and 4 layers (2 local, 2
# global) with one prompt of 4200 tokens, past its window of 4096;
# olmoe-1b-7b (MoE) at full width and 2 layers.
CROSS_ENGINE = (
    (None, "qwen3-0.6b", dict(n_layers=2), dict(CROSS_SERVE, **ANALYSIS_OFF),
     ("sequential", "splitwiser_mps"), ("random", 6, 16, 96, 8, 8)),
    (None, "qwen3-0.6b", dict(n_layers=2), dict(CROSS_SERVE, **INT8_SANITIZED),
     ("sequential", "splitwiser_mps"), ("random", 6, 16, 96, 8, 8)),
    ("opt-125m", "opt-125m", {}, dict(CROSS_SERVE, **ANALYSIS_OFF), None,
     ("random", 6, 16, 96, 8, 8)),
    ("gemma2-2b", "gemma2-2b", dict(n_layers=4),
     dict(CROSS_SERVE, max_batch=4, n_pages=320, max_pages_per_seq=272, max_seq_len=4352,
          prefill_chunk=256, chunk_tokens=512, **ANALYSIS_OFF),
     ("sequential", "chunked"), ("lengths", (4200, 64), 8)),
    ("olmoe-1b-7b", "olmoe-1b-7b", dict(n_layers=2), dict(CROSS_SERVE, **ANALYSIS_OFF),
     ("splitwiser_mps",), ("random", 4, 16, 96, 8, 8)))


def cross_requests(spec, vocab):
    """A phase-4 check's requests, seed 3: ("random", n, prompt lo, hi,
    new lo, hi) or ("lengths", prompt lengths, new tokens)."""
    kind, *args = spec
    if kind == "lengths":
        lengths, new = args
        return requests_of_lengths(lengths, vocab, new, seed=3)
    return requests(args[0], vocab, *args[1:], seed=3)


def cross_model(torch, arch, over):
    """(model, f32 params on the CPU from seed 0) of ``arch`` with the
    config overrides ``over``: the same weights in every process."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    model = get_model(arch, replace(get_config(arch), **over))
    return model, model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")


def cross_label(name, model, serve_kw):
    pages = "int8" if serve_kw.get("kv_dtype") == "int8" else "fp"
    return pages if name is None else f"{name} ({model.cfg.n_layers} layers) {pages}"


def engine_streams(torch, model, params, cfg, device, reqs):
    """Serve ``reqs`` with ``cfg`` on ``device``: (greedy streams, the
    sanitizer's checks)."""
    eng = make_engine_cls()(model, params, cfg, device=device)
    eng.run(reqs, max_steps=4000)
    return [r.out_tokens for r in reqs], eng.sanitizer.n_checks if eng.sanitizer else 0


def cross_device(torch, label, model, params, serve_kw, modes, make_requests, cpu_side):
    """Serve ``make_requests()`` on cuda (kernels) in each of ``modes``,
    f32: the greedy streams must equal the CPU's (plain versions;
    ``cpu_side``: mode -> (streams, sanitizer checks)), and on cuda the
    paged kernel (K1, or K3 for int8 pages) must launch, K2 in
    ``sequential`` and the paged chunk loop in the modes that chunk
    prompts; under the sanitizer it must have run on cuda (clean: a
    violation raises)."""
    from repro_torch.configs import ServeConfig
    cfg = ServeConfig(**serve_kw)
    paged = "paged_attention_int8" if cfg.kv_dtype == "int8" else "paged_attention"
    for mode in modes:
        zero_launches()
        streams, checks = engine_streams(torch, model, params, replace(cfg, mode=mode), "cuda",
                                         make_requests())
        torch.cuda.synchronize()
        counts = read_launches()
        cpu_streams, cpu_checks = cpu_side[mode]
        if streams != cpu_streams:
            first = next((i, a, b) for i, (a, b) in
                         enumerate(zip(streams, cpu_streams)) if a != b)
            fail(f"{label} {mode}: greedy streams differ between cuda and cpu: {first}")
        want = ([paged] + (["flash_attention"] if mode == "sequential" else [])
                + ([paged + "_chunk"] if mode in CHUNKING_MODES else []))
        if any(counts[k] == 0 for k in want):
            fail(f"{label} {mode}: kernels were not launched on cuda: {counts}")
        if cfg.sanitize_level != "off" and not checks:
            fail(f"{label} {mode}: the sanitizer did not run on cuda")
        log(f"cross-device {label} {mode}: {len(streams)} greedy streams equal "
            f"(cuda vs cpu); launches {json.dumps(counts)}; sanitizer checks "
            f"cuda={checks} cpu={cpu_checks} (clean)")


def phase_cross_device(torch, cpu):
    """cuda vs cpu greedy streams for each row of ``CROSS_ENGINE``, the
    CPU's sides from the worker ``cpu``."""
    from repro_torch.configs import SERVE_MODES
    key = model = params = None
    for name, arch, over, serve_kw, modes, spec in CROSS_ENGINE:
        if key != (arch, over):
            del model, params
            gc.collect()
            key, (model, params) = (arch, over), cross_model(torch, arch, over)
        label = cross_label(name, model, serve_kw)
        cross_device(torch, label, model, params, serve_kw, modes or SERVE_MODES,
                     lambda: cross_requests(spec, model.cfg.vocab_size), cpu.get(label))
    del model, params
    gc.collect()


def vlm_cross_inputs(torch, cfg):
    """internvl2-2b's check: 2 prompts of 64 tokens and 256 patches each."""
    toks = torch.as_tensor(prompts(2, 64, cfg.vocab_size, seed=4))
    patches = torch.randn(2, cfg.n_vision_patches, cfg.d_vision,
                          generator=torch.Generator().manual_seed(5)) * 0.3
    return toks, patches


def phase_vlm_cross_device(torch, cpu):
    """internvl2-2b's prefill logits over 256 patches and 64 tokens at full
    width and 2 layers, f32, within 1e-4 of the CPU's (from the worker
    ``cpu``)."""
    from repro_torch.models import transformer as T
    model, params = cross_model(torch, "internvl2-2b", dict(n_layers=2))
    cfg = model.cfg
    toks, patches = vlm_cross_inputs(torch, cfg)
    zero_launches()
    logits, _ = T.prefill(to_device(params, "cuda"), cfg, toks.cuda(), patches=patches.cuda())
    torch.cuda.synchronize()
    counts = read_launches()
    gap = max_err(logits.cpu()[:, :cfg.vocab_size], torch.as_tensor(cpu.get("internvl2-2b")))
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"internvl2-2b: K2 launched {counts['flash_attention']} times in a "
             f"{cfg.n_layers}-layer prefill")
    if not gap <= TOL["float32"]:
        fail(f"internvl2-2b: prefill logits differ between cuda and cpu by {gap}")
    log(f"cross-device internvl2-2b ({cfg.n_layers} layers): prefill of 2 x "
        f"({cfg.n_vision_patches} patches + 64 tokens), max abs logit gap cuda vs cpu "
        f"{gap:.3e}; launches {json.dumps(counts)}")


def cross_cpu_sides(torch):
    """The CPU's side of each phase-4 check whose weights are drawn on the
    CPU, in phase 4's order: yields (key, result) — per ``CROSS_ENGINE``
    row its label and mode -> (streams, sanitizer checks); "hybrid" its
    greedy tokens; "internvl2-2b" its prefill logits [2, vocab]."""
    from repro_torch.configs import SERVE_MODES, ServeConfig
    from repro_torch.models import transformer as T
    key = model = params = None
    for name, arch, over, serve_kw, modes, spec in CROSS_ENGINE:
        if key != (arch, over):
            del model, params
            gc.collect()
            key, (model, params) = (arch, over), cross_model(torch, arch, over)
        cfg = ServeConfig(**serve_kw)
        yield cross_label(name, model, serve_kw), {
            mode: engine_streams(torch, model, params, replace(cfg, mode=mode), "cpu",
                                 cross_requests(spec, model.cfg.vocab_size))
            for mode in modes or SERVE_MODES}
    del model, params
    gc.collect()
    model, params = cross_model(torch, "zamba2-7b", dict(n_layers=7))
    toks = prompts(2, 64, model.cfg.vocab_size, seed=4)
    yield "hybrid", hybrid_serve(torch, params, model.cfg, toks, steps=8, ps=16)["tokens"].tolist()
    del model, params
    gc.collect()
    model, params = cross_model(torch, "internvl2-2b", dict(n_layers=2))
    cfg = model.cfg
    toks, patches = vlm_cross_inputs(torch, cfg)
    logits, _ = T.prefill(params, cfg, toks, patches=patches)
    yield "internvl2-2b", logits[:, :cfg.vocab_size].numpy()


def cross_cpu_worker(src, threads, conn):
    """Entry of phase 4's CPU worker process: sends each (key, result) of
    ``cross_cpu_sides`` as it is done, or ("error", traceback)."""
    import os
    try:
        # below the build's nvcc and this run's own thread in priority
        os.nice(10)
    except OSError:
        pass
    try:
        if src not in sys.path:
            sys.path.insert(0, src)
        import torch
        torch.set_num_threads(threads)
        for item in cross_cpu_sides(torch):
            conn.send(item)
    except BaseException:   # fail() exits with SystemExit: report it too
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class CrossCPU:
    """Phase 4's CPU sides, computed by a worker process with ``threads``
    torch threads at a lower priority, spawned before the build: it runs
    beside the build and phase 3, which leave most of the host's cores
    idle.  ``get(key)`` waits for one result."""

    def __init__(self, threads):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        src = str(Path(__file__).resolve().parent / "src")
        # daemon: terminated at exit if this process fails first
        self.proc = ctx.Process(target=cross_cpu_worker, args=(src, threads, child), daemon=True)
        self.proc.start()
        child.close()
        self.got, self.t0 = {}, time.perf_counter()

    def get(self, key):
        while key not in self.got:
            try:
                k, v = self.conn.recv()
            except EOFError:
                fail(f"phase 4's CPU worker ended (exit code {self.proc.exitcode}) "
                     f"before sending {key}")
            if k == "error":
                fail(f"phase 4's CPU worker failed:\n{v}")
            self.got[k] = v
            log(f"phase 4 CPU worker: {k} done {time.perf_counter() - self.t0:.1f} s "
                f"after its start")
        return self.got.pop(key)


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def prompts(n, S, vocab, seed):
    import numpy as np
    return np.random.RandomState(seed).randint(2, vocab, size=(n, S))


def hybrid_serve(torch, params, cfg, toks, steps, ps):
    """Serve the hybrid at model level, as its users do (``paged_serve``
    over ``hybrid.prefill``/``decode``, which update the conv/SSM states
    in place)."""
    from repro_torch.models import hybrid as HY
    states = []

    def prefill(t):
        last, kv, st = HY.prefill(params, cfg, t)
        states[:] = st
        return last, kv

    def decode(nxt, kp, vp, bt, lens):
        return HY.decode(params, cfg, nxt, *states, kp, vp, bt, lens)[0]

    return paged_serve(torch, params, cfg, toks, steps, ps, prefill, decode, "hybrid")


def vlm_serve(torch, params, cfg, toks, patches, steps, ps):
    """Serve the VLM at model level: ``paged_serve`` over the
    transformer's ``prefill`` with the patch prefix, then ``decode``."""
    from repro_torch.models import transformer as T
    return paged_serve(
        torch, params, cfg, toks, steps, ps,
        lambda t: T.prefill(params, cfg, t, patches=patches),
        lambda nxt, kp, vp, bt, lens: T.decode(params, cfg, nxt, kp, vp, bt, lens)[0],
        cfg.name)


def paged_serve(torch, params, cfg, toks, steps, ps, prefill, decode, label):
    """Prefill the prompts ``toks`` [B, S] as one batch (``prefill(toks)``
    -> last logits, (k, v) [L, B, S_tot, KV, hd]), lay the K/V out as
    pages of ``ps`` tokens with room for ``steps`` more, then ``steps``
    greedy decode steps with every row active (``decode(tokens, k_pages,
    v_pages, table, lens)`` -> logits).  Fails on a non-finite logit.
    Returns the greedy tokens [B, steps + 1] (the first from the prefill),
    the prefill's and the first decode step's logits, the prefill's wall
    time and launch counts, each decode step's wall time (host clock, each
    ending in a synchronize on the card), the pools and table
    (``pages``) and the prompt length."""
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B = toks.shape[0]
    toks = torch.as_tensor(toks, device=dev)
    sync()
    t0 = time.perf_counter()
    last, (k, v) = prefill(toks)
    nxt = last.argmax(-1)
    sync()
    ttft = time.perf_counter() - t0
    prefill_launches = read_launches()
    if not bool(torch.isfinite(last[:, :cfg.vocab_size]).all()):
        fail(f"{label}: non-finite prefill logits")
    S = k.shape[2]
    per, new = S // ps, -(-steps // ps)
    kp, vp = T.init_pages(cfg, B * (per + new) + 1, ps, k.dtype, dev, n_layers=k.shape[0])
    kp[:, :B * per] = T.kv_to_pages(k, ps)
    vp[:, :B * per] = T.kv_to_pages(v, ps)
    del k, v
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    cols = torch.arange(per + new, device=dev, dtype=torch.int32)[None]
    bt = torch.where(cols < per, rows * per + cols, B * per + rows * new + cols - per)
    out, gaps, first = [nxt], [], None
    for i in range(steps):
        t1 = time.perf_counter()
        logits = decode(nxt, kp, vp, bt, torch.full((B,), S + i, device=dev))
        nxt = logits.argmax(-1)
        sync()
        gaps.append(time.perf_counter() - t1)
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            fail(f"{label}: non-finite logits at decode step {i}")
        first = logits if first is None else first
        out.append(nxt)
    return dict(tokens=torch.stack(out, 1).cpu(), prefill_logits=last, first_logits=first,
                ttft_s=ttft, prefill_launches=prefill_launches, tbt_s=gaps,
                pages=(kp, vp, bt), prompt_len=S)


def phase_hybrid_cross_device(torch, cpu):
    """The hybrid at full width and 7 layer-units (one group of 5 Mamba2
    blocks and the shared block, 1 trailing Mamba2), f32: 2 prompts of 64
    tokens and 8 decode steps on cuda; the greedy streams must equal the
    CPU's (from the worker ``cpu``), and on cuda the first decode step's
    logits must match the full-sequence forward within 2e-3."""
    from repro_torch.models import hybrid as HY
    model, params = cross_model(torch, "zamba2-7b", dict(n_layers=7))
    cfg = model.cfg
    toks = prompts(2, 64, cfg.vocab_size, seed=4)
    p = to_device(params, "cuda")
    del params
    zero_launches()
    run = hybrid_serve(torch, p, cfg, toks, steps=8, ps=16)
    torch.cuda.synchronize()
    counts = read_launches()
    full, _ = HY.train_logits(p, cfg, {"tokens": torch.cat(
        [torch.as_tensor(toks, device="cuda"), run["tokens"][:, :1].cuda()], 1)})
    gap = (run["first_logits"] - full[:, -1]).abs().max().item()
    del p, full
    cpu_tokens = cpu.get("hybrid")
    if run["tokens"].tolist() != cpu_tokens:
        fail(f"hybrid: greedy streams differ between cuda and cpu: "
             f"{run['tokens'].tolist()} vs {cpu_tokens}")
    if any(counts[k] == 0 for k in ("paged_attention", "flash_attention", "ssd_scan")):
        fail(f"hybrid: kernels were not launched on cuda: {counts}")
    if not gap < 2e-3:
        fail(f"hybrid: first decode logits differ from the full forward by {gap}")
    log(f"cross-device hybrid: 2 greedy streams of 9 tokens equal (cuda vs cpu); "
        f"decode vs full forward max abs logit gap {gap:.3e} on cuda; launches "
        + json.dumps(counts))


def pct(vals, q):
    vals = sorted(vals)
    if not vals:
        return None
    return vals[min(len(vals) - 1, math.ceil(q * len(vals)) - 1)]


def agreement(a, b):
    """Share of token positions at which two sets of streams agree."""
    pairs = [(x, y) for sa, sb in zip(a, b) for x, y in zip(sa, sb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


MAIN_SERVE = dict(max_batch=16, page_size=16, n_pages=2048, max_pages_per_seq=72,
                  max_seq_len=1152, prefill_chunk=128, n_streams=2, chunk_tokens=256)
# gemma2-2b's path: prompts up to 5000 tokens, 32 new each (320 pages of 16)
GEMMA_SERVE = dict(MAIN_SERVE, max_pages_per_seq=320, max_seq_len=5120)


def main_requests(vocab, base_rid=0):
    """The main path's traffic: 16 requests of 128-1024 prompt tokens and
    32-64 new tokens."""
    return requests(16, vocab, 128, 1024, 32, 64, seed=5, base_rid=base_rid)


def gemma2_requests(vocab):
    """gemma2-2b's traffic: 8 requests of 256-1024 prompt tokens and 2 of
    4300-5000, past its window of 4096, 32 new tokens each."""
    import numpy as np
    rng = np.random.RandomState(7)
    lengths = [int(n) for n in rng.randint(256, 1025, size=8)]
    lengths += [int(n) for n in rng.randint(4300, 5001, size=2)]
    return requests_of_lengths(lengths, vocab, 32, seed=7)


def run_path(torch, model, params, serve_kw, label, modes, make_requests):
    """Serve ``make_requests()`` in each of ``modes`` with one page type.
    Launch counters are zeroed just before and read just after; per mode
    the launches of each kernel are the counters' growth."""
    from repro_torch.configs import ServeConfig
    Engine = make_engine_cls()
    per_mode, streams, steps = {}, {}, 0
    torch.cuda.synchronize()
    zero_launches()
    for mode in modes:
        # the engine and its scheduler reference each other: collect the
        # last mode's engine so its page pool is not in this mode's peak
        gc.collect()
        eng = Engine(model, params, ServeConfig(mode=mode, **serve_kw), device="cuda")
        reqs = make_requests()
        before = read_launches()
        torch.cuda.reset_peak_memory_stats()
        m = eng.run(reqs, max_steps=20000)
        torch.cuda.synchronize()
        outs = eng.poll()
        if len(outs) != len(reqs) or any(o.finish_reason != "length" for o in outs):
            fail(f"{label} {mode}: not every request finished by length: "
                 f"{[(o.rid, o.finish_reason) for o in outs]}")
        if any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
            fail(f"{label} {mode}: a request generated the wrong number of tokens")
        s = m.summary()
        done = [m.requests[r.rid] for r in reqs]
        ttft = [r.ttft for r in done]
        gaps = [b - a for r in done for a, b in zip(r.token_times, r.token_times[1:])]
        per_mode[mode] = dict(
            tokens_per_s=s["throughput_tok_s"], ttft_p50_s=pct(ttft, 0.5),
            ttft_p99_s=pct(ttft, 0.99), tbt_p99_s=pct(gaps, 0.99), steps=s["n_steps"],
            wall_s=s["wall_s"], prompt_tokens=sum(len(r.prompt) for r in reqs),
            new_tokens=sum(len(r.out_tokens) for r in reqs),
            usable_pages=eng.alloc.n_pages, kv_pool_bytes=s["kv_pool_bytes"],
            n_quant_pages=s["n_quant_pages"], n_preemptions=s["n_preemptions"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches={k: v - before[k] for k, v in read_launches().items()})
        streams[mode] = [r.out_tokens for r in reqs]
        steps += s["n_steps"]
        log(f"{label} mode {mode}: " + json.dumps(per_mode[mode]))
        del eng
    launches = read_launches()
    log(f"{label} path launches " + json.dumps(launches) + f" over {steps} engine steps")
    return per_mode, streams, launches, steps


def init_model(torch, arch):
    """``arch`` at full width and depth, seeded bf16 weights on the card."""
    from repro_torch.models.registry import get_model
    model = get_model(arch)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"path: {arch}, {model.cfg.n_layers} layers, {n_params} params bf16")
    return model, params


def serve_paths(torch, model, params, name, serve, pages, modes, make_requests):
    """Serve one model in each of ``modes`` for each page type of
    ``pages`` ("fp", "int8" in a pool of the same bytes), bf16.  The
    paged kernel of the page type (K1, K3) must launch in every mode, K2
    in ``sequential``'s monolithic prefill, and the paged chunk loop
    (C > 1) in every mode that chunks prompts.  Paths are labelled
    ``<name> <page type>`` (the page type alone without a name)."""
    paths = {}
    for kind in pages:
        label = kind if name is None else f"{name} {kind}"
        per_mode, streams, launches, steps = run_path(
            torch, model, params, dict(serve, **ANALYSIS_OFF, kv_dtype=kind), label, modes,
            make_requests)
        paged = "paged_attention_int8" if kind == "int8" else "paged_attention"
        for mode, r in per_mode.items():
            want = ([paged] + (["flash_attention"] if mode == "sequential" else [])
                    + ([paged + "_chunk"] if mode in CHUNKING_MODES else []))
            missing = [k for k in want if r["launches"][k] == 0]
            if missing:
                fail(f"{missing} not launched in {label} {mode}: {r['launches']}")
        paths[kind] = dict(per_mode=per_mode, streams=streams, launches=launches,
                           steps=steps)
    log_agreement(name or model.name, paths)
    return {(k if name is None else f"{name} {k}"): v for k, v in paths.items()}


def phase_main_path(torch):
    """qwen3-0.6b: the main-path traffic in every mode, with fp pages,
    then int8 pages in a pool of the same bytes (``n_pages`` fp-width
    pages), at full depth in bf16."""
    from repro_torch.configs import SERVE_MODES
    model, params = init_model(torch, "qwen3-0.6b")
    paths = serve_paths(torch, model, params, None, MAIN_SERVE, ("fp", "int8"), SERVE_MODES,
                        lambda: main_requests(model.cfg.vocab_size))
    return paths, (model, params)


def phase_family_paths(torch):
    """The rest of the transformer family at full width and depth, bf16:
    opt-125m on the main-path traffic in every mode, fp and int8 pages;
    gemma2-2b (d = 256, window 4096, softcaps) in ``sequential`` and
    ``chunked``, fp and int8, with two prompts past its window; olmoe-1b-7b
    (64 experts, top 8) in ``splitwiser_mps`` with fp pages on 8 requests;
    internvl2-2b at model level (``phase_vlm_path``).  Returns the paths
    and the (model, params) of opt-125m and gemma2-2b."""
    from repro_torch.configs import SERVE_MODES
    paths, setups = {}, {}
    for arch, serve, pages, modes, make in (
            ("opt-125m", MAIN_SERVE, ("fp", "int8"), SERVE_MODES, main_requests),
            ("gemma2-2b", GEMMA_SERVE, ("fp", "int8"), ("sequential", "chunked"),
             gemma2_requests),
            ("olmoe-1b-7b", MAIN_SERVE, ("fp",), ("splitwiser_mps",),
             lambda vocab: requests(8, vocab, 128, 1024, 32, 64, seed=5))):
        gc.collect()
        torch.cuda.empty_cache()
        model, params = init_model(torch, arch)
        vocab = model.cfg.vocab_size
        paths.update(serve_paths(torch, model, params, arch, serve, pages, modes,
                                 lambda: make(vocab)))
        if arch != "olmoe-1b-7b":
            setups[arch] = (model, params)
        del model, params
    gc.collect()
    torch.cuda.empty_cache()
    paths["internvl2-2b"] = phase_vlm_path(torch)
    return paths, setups


VLM = dict(batch=4, prompt=256, steps=8, page_size=16)


def phase_vlm_path(torch):
    """internvl2-2b at full width and depth in bf16, at model level (the
    engine serves text): 4 prompts of 256 tokens after 256 patches each,
    prefilled as one batch, then 8 greedy decode steps.  The prefill must
    launch K2 once a layer, each decode step K1 once a layer."""
    model, params = init_model(torch, "internvl2-2b")
    cfg = model.cfg
    toks = prompts(VLM["batch"], VLM["prompt"], cfg.vocab_size, seed=6)
    patches = (torch.randn(VLM["batch"], cfg.n_vision_patches, cfg.d_vision, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6)) * 0.3
               ).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    r = vlm_serve(torch, params, cfg, toks, patches, VLM["steps"], VLM["page_size"])
    torch.cuda.synchronize()
    launches = read_launches()
    pre, steps, L = r["prefill_launches"], VLM["steps"], cfg.n_layers
    want = {"flash_attention": (L, 0), "paged_attention": (0, L * steps),
            "paged_attention_decode": (0, L * steps), "paged_attention_chunk": (0, 0),
            "paged_attention_int8": (0, 0), "ssd_scan": (0, 0)}
    got = {k: (pre[k], launches[k] - pre[k]) for k in want}
    if got != want:
        fail(f"internvl2-2b path launches (prefill, decode) {got}, expected {want}")
    B, S = VLM["batch"], cfg.n_vision_patches + VLM["prompt"]
    tbt = sorted(r["tbt_s"])
    log("internvl2-2b path: " + json.dumps(dict(
        prefill_positions=B * S, prefill_tokens_per_s=B * S / r["ttft_s"], ttft_s=r["ttft_s"],
        decode_tokens_per_s=B * steps / sum(tbt), tbt_p50_s=pct(tbt, 0.5),
        tbt_p99_s=pct(tbt, 0.99), max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches_prefill={k: v[0] for k, v in got.items()},
        launches_decode_per_step={k: v[1] / steps for k, v in got.items()})))
    del params
    return dict(launches=launches, steps=1 + steps)


def phase_sentinel(torch, setup):
    """The dispatch sentinel on the opt-125m engine at full width, bf16, in
    every mode: two warm runs of the main-path traffic, ``mark_warm``, a
    third run, then ``check(budget=0)``: a step callable that met a new
    argument signature after warm-up raises, and the run fails."""
    from repro_torch.configs import SERVE_MODES, ServeConfig
    model, params = setup
    Engine = make_engine_cls()
    for mode in SERVE_MODES:
        gc.collect()
        eng = Engine(model, params, ServeConfig(mode=mode, **MAIN_SERVE, sanitize_level="off",
                                                dispatch_sentinel=True), device="cuda")
        for run in range(3):
            if run == 2:
                eng.dispatch.mark_warm()
            eng.run(main_requests(model.cfg.vocab_size, base_rid=100 * run), max_steps=20000)
        torch.cuda.synchronize()
        eng.dispatch.check(budget=0)
        log(f"sentinel opt-125m {mode}: post-warm compiles "
            f"{json.dumps(eng.dispatch.post_warm_compiles())}; report "
            + json.dumps(eng.dispatch.report()))
        del eng


HYBRID = dict(batch=8, prompt=1024, steps=32, page_size=16)


def phase_hybrid_path(torch):
    """The hybrid main path: zamba2-7b at full width and depth in bf16,
    8 prompts of 1024 tokens prefilled as one batch, then 32 greedy decode
    steps with every row active.  Counters are zeroed just before and
    read just after; the prefill must launch K4 once per Mamba2 block and
    K2 once per shared-attention invocation, each decode step K1 once per
    invocation."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid as HY
    from repro_torch.models.registry import get_model
    cfg = get_config("zamba2-7b")
    model = get_model("zamba2-7b", cfg)
    n_attn, n_mamba = HY.group_structure(cfg)[:2]
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"hybrid path: zamba2-7b, {cfg.n_layers} layer-units ({n_mamba} Mamba2, "
        f"{n_attn} shared attention), {n_params} params bf16")
    toks = prompts(HYBRID["batch"], HYBRID["prompt"], cfg.vocab_size, seed=6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    r = hybrid_serve(torch, params, cfg, toks, HYBRID["steps"], HYBRID["page_size"])
    torch.cuda.synchronize()
    launches = read_launches()
    pre = r["prefill_launches"]
    steps = HYBRID["steps"]
    want = {"ssd_scan": (n_mamba, 0), "flash_attention": (n_attn, 0),
            "paged_attention": (0, n_attn * steps), "paged_attention_int8": (0, 0),
            "paged_attention_decode": (0, n_attn * steps), "paged_attention_chunk": (0, 0)}
    got = {k: (pre[k], launches[k] - pre[k]) for k in want}
    if got != want:
        fail(f"hybrid path launches (prefill, decode) {got}, expected {want}")
    B, S = toks.shape
    tbt = sorted(r["tbt_s"])
    out = dict(
        n_params=n_params, prompt_tokens=B * S, decode_steps=steps,
        prefill_tokens_per_s=B * S / r["ttft_s"], ttft_s=r["ttft_s"],
        decode_tokens_per_s=B * steps / sum(tbt), tbt_p50_s=pct(tbt, 0.5),
        tbt_p99_s=pct(tbt, 0.99), max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches_prefill={k: v[0] for k, v in got.items()},
        launches_decode_per_step={k: v[1] / steps for k, v in got.items()})
    log("hybrid path: " + json.dumps(out))
    log(f"hybrid path launches {json.dumps(launches)} over {1 + steps} steps "
        f"(1 prefill, {steps} decode)")
    return dict(launches=launches, steps=1 + steps), (model, params)


def log_agreement(name, paths):
    """Greedy agreement between modes per page type, and between page
    types per mode.  In bf16 cross-mode streams need not agree (batch
    composition changes GEMM rounding; the int8 monolithic prefill rounds
    its fake-quantized K/V to bf16): reported, not checked."""
    streams = {label: path["streams"] for label, path in paths.items()}
    for label, st in streams.items():
        log(f"{name} {label} greedy agreement between modes, share of token positions "
            "(bf16): " + json.dumps({m: {n: agreement(st[m], st[n]) for n in st} for m in st}))
    if {"fp", "int8"} <= set(streams):
        log(f"{name} int8 vs fp greedy agreement per mode (bf16): " + json.dumps(
            {m: agreement(streams["int8"][m], streams["fp"][m]) for m in streams["int8"]}))


# K1/K3 decode (C = 1) is the split-KV kernel and its combine; every
# other paged call is a chunk (the tensor-core tile loops).
# "ssd_scan_kernel" matches K4's forward kernels, ssd_scan_kernel_f32 and
# ssd_scan_kernel_tc; its backward is the pair ssd_bwd_{states,chunks}_kernel.
KERNEL_CLASSES = (("paged_attention_int8 decode", ("paged_attention_int8_decode",)),
                  ("paged_attention_int8 chunk", ("paged_attention_int8_kernel",)),
                  ("paged_attention decode", ("paged_attention_decode",)),
                  ("paged_attention chunk", ("paged_attention_kernel",)),
                  ("flash_attention", ("flash_attention_kernel",)),
                  ("ssd_scan", ("ssd_scan_kernel",)),
                  ("ssd_scan_bwd", ("ssd_bwd_states_kernel", "ssd_bwd_chunks_kernel")),
                  ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def phase_profile(torch, windows, warm_steps=8, window=16):
    """Where the time goes, per path and mode: ``windows`` lists (label,
    (model, params), serve config, requests maker, modes).  For each, the
    same window of engine steps (after ``warm_steps``) run twice on fresh
    engines with the same requests — once timed on the host clock, once
    under ``torch.profiler`` for device time by kernel class.  The
    device's busy share is the profiled device time over the unprofiled
    wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ServeConfig
    Engine = make_engine_cls()

    def engine_at_window(setup, serve_kw, make_requests, mode):
        eng = Engine(*setup, ServeConfig(mode=mode, **serve_kw), device="cuda")
        for r in make_requests():
            eng.submit(r)
        for _ in range(warm_steps):
            eng.step()
        torch.cuda.synchronize()
        return eng

    out = {}
    for label, setup, serve_kw, make_requests, modes in windows:
        for mode in modes:
            gc.collect()
            eng = engine_at_window(setup, serve_kw, make_requests, mode)
            t0 = time.perf_counter()
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            kinds = eng.metrics.step_kinds[warm_steps:warm_steps + window]
            eng = engine_at_window(setup, serve_kw, make_requests, mode)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(window):
                    eng.step()
                torch.cuda.synchronize()
            out[f"{label} {mode}"] = r = dict(
                steps=f"{warm_steps}..{warm_steps + window - 1}",
                step_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
                **window_summary(wall_ms, *device_ms_by_class(torch, prof)))
            log(f"profile {label} {mode}: " + json.dumps(r))
    return out


def device_events(torch, prof):
    """(demangled name, µs) of each device event (kernel, copy, fill) of
    a finished ``torch.profiler`` run, read from its kineto results.  The
    same events and times as ``key_averages``' device rows, without the
    event tree that ``key_averages`` first builds of the whole trace: that
    costs the host ~80 µs an event, ~10 s a profiled window of the qwen3
    engine (60,000 kernels and their launches)."""
    cuda, names, out = torch.autograd.DeviceType.CUDA, {}, []
    demangle = getattr(torch._C, "_demangle", lambda n: n)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or getattr(e, "is_hidden_event", lambda: False)():
            continue
        us = e.duration_ns() / 1e3
        if us:
            raw = e.name()
            name = names.get(raw) or names.setdefault(raw, demangle(raw))
            out.append((name, us))
    return out


def device_ms_by_class(torch, prof):
    """(device ms by kernel class, kernel count) of one profiled run
    (``device_events``).  It reads device events only, so phase 6
    profiles CUDA activity alone."""
    by_class, n_kernels = {}, 0
    for name, us in device_events(torch, prof):
        n_kernels += 1
        name = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    return by_class, n_kernels


def window_summary(wall_ms, by_class, n_kernels):
    """Host wall, device time by class and busy share of one window (busy
    share: profiled device time over the wall of the same window run
    unprofiled)."""
    busy_ms = sum(by_class.values())
    return dict(wall_ms=wall_ms, device_ms=busy_ms if busy_ms else "not measured",
                busy_share=busy_ms / wall_ms if busy_ms else "not measured",
                device_kernels=n_kernels,
                device_ms_by_class={k: round(v, 3) for k, v in sorted(by_class.items())})


def phase_hybrid_profile(torch, setup, steps=8):
    """Where the hybrid's time goes: its prefill and ``steps`` decode
    steps from fresh state, timed on the host clock; then, profiled, the
    prefill alone and the prefill with the decode steps — the decode
    steps' device time is the difference (both runs also lay the prompts'
    K/V out as pages, which falls to the prefill)."""
    from torch.profiler import ProfilerActivity, profile
    model, params = setup
    toks = prompts(HYBRID["batch"], HYBRID["prompt"], model.cfg.vocab_size, seed=6)
    r = hybrid_serve(torch, params, model.cfg, toks, steps, HYBRID["page_size"])
    runs = {}
    for n in (0, steps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hybrid_serve(torch, params, model.cfg, toks, n, HYBRID["page_size"])
        runs[n] = device_ms_by_class(torch, prof)
    (pre, n_pre), (both, n_both) = runs[0], runs[steps]
    dec = {k: v - pre.get(k, 0.0) for k, v in both.items()}
    pre_ms, dec_ms = r["ttft_s"] * 1e3, sum(r["tbt_s"]) * 1e3
    out = {"prefill": window_summary(pre_ms, pre, n_pre),
           f"decode x{steps}": window_summary(dec_ms, dec, n_both - n_pre),
           "window": window_summary(pre_ms + dec_ms, both, n_both)}
    log("profile hybrid: " + json.dumps(out))
    return out


# ------------------------------------------- rwkv6 and the encoder-decoder ---
def rwkv_serve(torch, params, cfg, toks, steps):
    """Serve rwkv6 at model level, as its users do: prefill the prompts
    ``toks`` [B, S] as one batch, then ``steps`` greedy decode steps over
    the recurrent state.  Fails on a non-finite logit.  Returns the greedy
    tokens [B, steps + 1] (the first from the prefill), the prefill's
    logits and state, the first decode step's logits, the last state and
    tokens, the prefill's wall time and each decode step's (host clock,
    each ending in a synchronize on the card)."""
    from repro_torch.models import rwkv as RW
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    toks = torch.as_tensor(toks, device=dev)
    sync()
    t0 = time.perf_counter()
    last, state = RW.prefill(params, cfg, toks)
    nxt = last.argmax(-1)
    sync()
    ttft = time.perf_counter() - t0
    if not bool(torch.isfinite(last[:, :cfg.vocab_size]).all()):
        fail(f"{cfg.name}: non-finite prefill logits")
    out, gaps, first, prefill_state = [nxt], [], None, state
    for i in range(steps):
        t1 = time.perf_counter()
        logits, state = RW.decode(params, cfg, nxt, state)
        nxt = logits.argmax(-1)
        sync()
        gaps.append(time.perf_counter() - t1)
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            fail(f"{cfg.name}: non-finite logits at decode step {i}")
        first = logits if first is None else first
        out.append(nxt)
    return dict(tokens=torch.stack(out, 1).cpu(), prefill_logits=last,
                prefill_state=prefill_state, first_logits=first, state=state, last=nxt,
                ttft_s=ttft, tbt_s=gaps)


def encdec_serve(torch, params, cfg, frames, toks, steps, ps):
    """Serve the encoder-decoder at model level: ``paged_serve`` over
    ``encdec.prefill`` (encoder, cross K/V, decoder prompts) and
    ``encdec.decode`` (paged self-attention, cross-attention over the
    fixed cross K/V).  Returns ``paged_serve``'s dict with the decode
    step as ``decode``."""
    from repro_torch.models import encdec as ED
    cross = []

    def prefill(t):
        last, kv, xkv = ED.prefill(params, cfg, frames, t)
        cross[:] = xkv
        return last, kv

    def decode(nxt, kp, vp, bt, lens):
        return ED.decode(params, cfg, nxt, kp, vp, *cross, bt, lens)[0]

    r = paged_serve(torch, params, cfg, toks, steps, ps, prefill, decode, cfg.name)
    return dict(r, decode=decode)


def phase_model_level_cross_device(torch):
    """rwkv6-7b at full width (d_model 4096) and 2 layers, and
    seamless-m4t-medium at full width (d_model 1024) and 2 + 2 layers, f32,
    one seeded set of weights each: 2 prompts of 64 tokens (seamless:
    after 12 frames) and 8 greedy decode steps on cuda and on the CPU.
    The greedy streams must be equal, and on cuda the first decode step's
    logits must match the full-sequence forward within 2e-3; the prefill
    logit gap (and rwkv6's state gaps) cuda vs cpu are logged.  On cuda
    seamless must launch K1 and K2; rwkv6 runs no hand-written kernel (its
    WKV scan is plain PyTorch, as the reference's is jnp)."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.models import rwkv as RW
    from repro_torch.models.registry import get_model
    for arch, layers in (("rwkv6-7b", dict(n_layers=2)),
                         ("seamless-m4t-medium", dict(n_layers=2, n_encoder_layers=2))):
        cfg = replace(get_config(arch), **layers)
        params = get_model(arch, cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                           torch.float32, "cuda")
        toks = prompts(2, 64, cfg.vocab_size, seed=4)
        frames = (torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(5))
                  * 0.3)
        runs = {}
        for dev in ("cuda", "cpu"):
            p = params if dev == "cuda" else to_device(params, "cpu")
            zero_launches()
            if cfg.family == "ssm":
                runs[dev] = rwkv_serve(torch, p, cfg, toks, steps=8)
                batch = {}
            else:
                runs[dev] = encdec_serve(torch, p, cfg, frames.to(dev), toks, steps=8, ps=16)
                batch = {"frames": frames.to(dev)}
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = read_launches()
                batch["tokens"] = torch.cat([torch.as_tensor(toks, device="cuda"),
                                             runs[dev]["tokens"][:, :1].cuda()], 1)
                module = RW if cfg.family == "ssm" else ED
                full, _ = module.train_logits(params, cfg, batch)
                full_gap = max_err(runs[dev]["first_logits"][:, :cfg.vocab_size],
                                   full[:, -1, :cfg.vocab_size])
                del full
            del p
        cuda, cpu = runs["cuda"], runs["cpu"]
        if not torch.equal(cuda["tokens"], cpu["tokens"]):
            fail(f"{arch}: greedy streams differ between cuda and cpu: "
                 f"{cuda['tokens'].tolist()} vs {cpu['tokens'].tolist()}")
        want = [] if cfg.family == "ssm" else ["paged_attention", "flash_attention"]
        if any(counts[k] == 0 for k in want) or (not want and any(counts.values())):
            fail(f"{arch}: launches on cuda {counts}, expected launches of {want} only")
        if not full_gap < 2e-3:
            fail(f"{arch}: first decode logits differ from the full forward by {full_gap}")
        V = cfg.vocab_size
        gaps = {"prefill_logits": max_err(cuda["prefill_logits"].cpu()[:, :V],
                                           cpu["prefill_logits"][:, :V]),
                "first_decode_logits": max_err(cuda["first_logits"].cpu()[:, :V],
                                               cpu["first_logits"][:, :V])}
        if cfg.family == "ssm":
            gaps.update({f"state_{k}": max_err(v.cpu(), cpu["prefill_state"][k])
                         for k, v in cuda["prefill_state"].items()})
        log(f"cross-device {arch} ({json.dumps(layers)}): 2 greedy streams of "
            f"{cuda['tokens'].shape[1]} tokens equal (cuda vs cpu); max abs gaps cuda vs cpu "
            f"{json.dumps(gaps)}; decode vs full forward {full_gap:.3e} on cuda; launches "
            + json.dumps(counts))
        del params, runs, cuda, cpu
        gc.collect()


RWKV = dict(batch=8, prompt=1024, steps=32, mixed_steps=8, mixed_rows=4, mixed_chunk=128)


def phase_rwkv_path(torch):
    """rwkv6-7b at full width and depth in bf16, at model level: 8 prompts
    of 1024 tokens prefilled as one batch, 32 greedy decode steps, then 8
    ``mixed`` steps, each a 128-token chunk of 4 new prompts beside the 8
    decode rows.  No hand-written kernel may launch (the path's WKV scan
    is plain PyTorch).  Returns the path's launches and steps, and its
    decode window for phase 6."""
    from repro_torch.models import rwkv as RW
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()          # earlier paths' setups
    model, params = init_model(torch, "rwkv6-7b")
    cfg = model.cfg
    n_params = sum(t.numel() for t in _leaves(params))
    toks = prompts(RWKV["batch"], RWKV["prompt"], cfg.vocab_size, seed=6)
    C, P = RWKV["mixed_chunk"], RWKV["mixed_rows"]
    new = torch.as_tensor(prompts(P, C * RWKV["mixed_steps"], cfg.vocab_size, seed=7),
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    r = rwkv_serve(torch, params, cfg, toks, RWKV["steps"])
    p_state = RW.init_state(cfg, P, params["embed"].dtype, "cuda")
    d_state, nxt, walls = r["state"], r["last"], []
    for i in range(RWKV["mixed_steps"]):
        mb = {"p_tokens": new[:, i * C:(i + 1) * C], "d_tokens": nxt}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_logits, d_logits, p_state, d_state = RW.mixed(params, cfg, mb, p_state, d_state)
        nxt = d_logits.argmax(-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not (bool(torch.isfinite(p_logits[:, :cfg.vocab_size]).all())
                and bool(torch.isfinite(d_logits[:, :cfg.vocab_size]).all())):
            fail(f"rwkv6-7b: non-finite logits at mixed step {i}")
    launches = read_launches()
    if any(launches.values()):
        fail(f"rwkv6-7b path launched a hand-written kernel: {launches}")
    B, S, steps = RWKV["batch"], RWKV["prompt"], RWKV["steps"]
    tbt = sorted(r["tbt_s"])
    log("rwkv6-7b path: " + json.dumps(dict(
        n_params=n_params, prompt_tokens=B * S, decode_steps=steps,
        prefill_tokens_per_s=B * S / r["ttft_s"], ttft_s=r["ttft_s"],
        decode_tokens_per_s=B * steps / sum(tbt), tbt_p50_s=pct(tbt, 0.5),
        tbt_p99_s=pct(tbt, 0.99), mixed_steps=len(walls),
        mixed_step_p50_s=pct(walls, 0.5), mixed_step_max_s=max(walls),
        mixed_tokens_per_step=P * C + B, held_before_path=held,
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)))

    def window(n=8):
        state, tok = r["prefill_state"], r["tokens"][:, 0].cuda()
        for _ in range(n):
            logits, state = RW.decode(params, cfg, tok, state)
            tok = logits.argmax(-1)

    return dict(launches=launches, steps=1 + steps + len(walls)), window


SEAMLESS = dict(batch=16, frames=1024, prompt=64, steps=32, page_size=16)


def phase_seamless_path(torch):
    """seamless-m4t-medium at full width and depth in bf16, at model level:
    16 utterances of 1024 frames and 64-token decoder prompts (encoder,
    cross K/V and decoder prefill as one batch), then 32 greedy decode
    steps over fp pages.  The prefill must launch K2 once an encoder layer
    and twice a decoder layer (self and cross), each decode step K1 and K2
    once a decoder layer.  Returns the path's launches and steps, and its
    decode window for phase 6."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()          # earlier paths' setups
    model, params = init_model(torch, "seamless-m4t-medium")
    cfg = model.cfg
    B, steps = SEAMLESS["batch"], SEAMLESS["steps"]
    frames = (torch.randn(B, SEAMLESS["frames"], cfg.d_model, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(6)) * 0.3
              ).to(torch.bfloat16)
    toks = prompts(B, SEAMLESS["prompt"], cfg.vocab_size, seed=6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    r = encdec_serve(torch, params, cfg, frames, toks, steps, SEAMLESS["page_size"])
    torch.cuda.synchronize()
    launches = read_launches()
    pre, L, Le = r["prefill_launches"], cfg.n_layers, cfg.n_encoder_layers
    want = {"flash_attention": (Le + 2 * L, L * steps), "paged_attention": (0, L * steps),
            "paged_attention_decode": (0, L * steps), "paged_attention_chunk": (0, 0),
            "paged_attention_int8": (0, 0), "ssd_scan": (0, 0)}
    got = {k: (pre[k], launches[k] - pre[k]) for k in want}
    if got != want:
        fail(f"seamless-m4t-medium path launches (prefill, decode) {got}, expected {want}")
    tbt = sorted(r["tbt_s"])
    log("seamless-m4t-medium path: " + json.dumps(dict(
        n_params=sum(t.numel() for t in _leaves(params)), utterances=B,
        encoder_frames=B * SEAMLESS["frames"], prompt_tokens=B * SEAMLESS["prompt"],
        decode_steps=steps, ttft_s=r["ttft_s"], decode_tokens_per_s=B * steps / sum(tbt),
        tbt_p50_s=pct(tbt, 0.5), tbt_p99_s=pct(tbt, 0.99), held_before_path=held,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches_prefill={k: v[0] for k, v in got.items()},
        launches_decode_per_step={k: v[1] / steps for k, v in got.items()})))
    kp, vp, bt = r["pages"]

    def window(n=8):
        tok, S = r["tokens"][:, 0].cuda(), r["prompt_len"]
        for i in range(n):      # rewrites the same K/V into the same slots
            tok = r["decode"](tok, kp, vp, bt, torch.full((B,), S + i, device="cuda")).argmax(-1)

    return dict(launches=launches, steps=1 + steps), window


LAUNCHER_CMD = ("-m", "repro_torch.launch.serve", "--arch", "opt-125m", "--mode",
                "splitwiser_mps", "--n-requests", "16", "--json")


def start_launcher():
    """Start the serving launcher (``phase_launcher``) in the background."""
    return Background([sys.executable, *LAUNCHER_CMD], src_env(), timeout=600)


def phase_launcher(started):
    """The serving launcher as its users run it: ``python -m
    repro_torch.launch.serve --arch opt-125m --mode splitwiser_mps
    --n-requests 16 --json`` at full size on the card, in a subprocess
    (``started`` by ``start_launcher``, beside phase 4's checks).  It must
    exit 0 with every request done; its summary line is logged."""
    rc, stdout, stderr, wall = started.result()
    if rc != 0:
        fail(f"launcher exited {rc}: {stderr.strip()[-2000:]}")
    line = stdout.strip().splitlines()[-1]
    summary = json.loads(line)
    if summary["n_done"] != 16:
        fail(f"launcher finished {summary['n_done']} of 16 requests: {line}")
    log(f"launcher ({' '.join(LAUNCHER_CMD)}; read {wall:.1f} s after its start, beside "
        f"phase 4): {line}")


def phase_decode_profile(torch, label, window, steps=8):
    """Where a model-level path's decode time goes: ``window(steps)`` runs
    ``steps`` decode steps from a fixed state, timed on the host clock,
    then again under ``torch.profiler``: device time by kernel class and
    the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window(steps)
        torch.cuda.synchronize()
    out = window_summary(wall_ms, *device_ms_by_class(torch, prof))
    log(f"profile {label} decode x{steps}: " + json.dumps(out))
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ------------------------------------------------------------ phase 7 ---
TRAIN = dict(global_batch=4, seq_len=512, steps=6)      # the main training path
# the hybrid's training path: zamba2-7b at full width, 13 layer-units (2
# groups of 5 Mamba2 blocks and the shared block, 1 trailing Mamba2 block:
# 11 Mamba2 blocks, 2 shared-attention invocations, ~1.34 B params, ~21
# GB of f32 params, grads and AdamW moments)
HYBRID_TRAIN = dict(n_layers=13, global_batch=4, seq_len=1024, steps=6)
# phase 7's cross-device training check, every family: arch, config
# overrides (None: ``.reduced()``), loss, train steps, B, T, and whether
# the row also holds the params after steps each device took on its own
# gradients (``make_train_step`` end to end).  The first three rows are
# the check as it was (state drawn on the CPU); the others run at full
# width, their params drawn on the card and copied: the CPU's normal draws
# and its AdamW cost ~10 s per billion params each, so the full-width
# transformer, rwkv6 and seamless rows (0.3-1 B params at 2 layers) take
# one step of B = 1 x T = 64.
CROSS_TRAIN = (
    ("qwen3-0.6b", dict(n_layers=2), "chunked", 3, 2, 64, True),
    ("qwen3-0.6b", dict(n_layers=2), "vtiled", 3, 2, 64, True),
    ("olmoe-1b-7b", None, "chunked", 1, 2, 64, True),
    ("gemma2-2b", dict(n_layers=2), "chunked", 1, 1, 64, False),
    ("internvl2-2b", dict(n_layers=2), "chunked", 1, 1, 64, False),
    ("starcoder2-3b", dict(n_layers=2), "chunked", 1, 1, 64, False),
    ("phi4-mini-3.8b", dict(n_layers=2), "chunked", 1, 1, 64, False),
    ("rwkv6-7b", dict(n_layers=2), "chunked", 1, 1, 64, False),
    ("seamless-m4t-medium", dict(n_layers=2, n_encoder_layers=2), "chunked", 1, 1, 64, False),
    # 1 group of 5 Mamba2 blocks and the shared block, 1 trailing Mamba2
    # block; T = 160: three scan chunks of 64, the last ragged
    ("zamba2-7b", dict(n_layers=7), "chunked", 3, 1, 160, False))


def leaf_names(tree, prefix=""):
    """Dotted key paths of a nested dict's leaves, in ``tree_leaves`` order."""
    return [n for k, v in tree.items() for n in (
        leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict) else [prefix + k])]


def tree_to(tree, device):
    """A training state (nested dicts of tensors) on ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def independent_params_gap(torch, model, tcfg, state, data_fn, n_steps, cpu_params):
    """Max abs gap between the params after ``n_steps`` of
    ``make_train_step`` on the card from ``state``, on its own gradients,
    and ``cpu_params``, the CPU's after the same steps on its own."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.train.trainer import make_train_step
    step, st = make_train_step(model, tcfg), tree_to(state, "cuda")
    for i in range(n_steps):
        st, _ = step(st, {k: v.to("cuda") for k, v in data_fn(i).items()})
    return max((a - b.to("cuda")).abs().max().item()
               for a, b in zip(tree_leaves(st["params"]), tree_leaves(cpu_params)))


def phase_train_cross_device(torch, tmp):
    """Training on cuda against the CPU, f32, one seeded state and the
    same batches, for every family (``CROSS_TRAIN``): qwen3-0.6b at full
    width and 2 layers with the chunked and with the vocab-tiled loss,
    olmoe-1b-7b reduced for its MoE aux loss, gemma2-2b, internvl2-2b,
    starcoder2-3b, phi4-mini-3.8b, rwkv6-7b and seamless-m4t-medium at
    full width and 2 layers (seamless: 2 + 2), zamba2-7b at full width
    and 7 layer-units over T = 160 (on cuda K4's forward and backward
    kernels).  At every train step the loss within 1e-5 relative and
    every gradient leaf within 1e-4 of the leaf's max |g|; both devices'
    optimizers (``apply_grads``) then take the CPU's gradients, and after
    the steps the params agree within 1e-4.  The first three rows also
    hold, as before, the params after the steps each device took on its
    own gradients within 1e-4 (``independent_params_gap``; the CPU's
    side of it is this loop's, which steps on its own gradients).  That
    check is not asked of the others: AdamW's first steps move a param by
    about lr * sign(g), so a gradient entry within a few 1e-6 of the
    leaf's max |g| of zero, inside the gradient tolerance, can take the
    two devices' params 2 * lr apart.  Each family's wall, the CPU's
    share of it and the leaf of its largest param gap are logged."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_train_data_fn
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import apply_grads, init_state, make_loss_fn, value_and_grad
    out = []
    for arch, over, loss_impl, n_steps, B, T, independent in CROSS_TRAIN:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cfg = cfg.reduced() if over is None else replace(cfg, **over)
        model = get_model(arch, cfg)
        tcfg = TrainConfig(global_batch=B, seq_len=T, warmup_steps=0, total_steps=10,
                           loss_impl=loss_impl, remat=True, ckpt_dir=str(tmp / "unused"))
        if independent:
            state = init_state(model, torch.Generator().manual_seed(0), tcfg, device="cpu")
            states = {"cuda": tree_to(state, "cuda"), "cpu": state}
        else:
            state = None
            cu = init_state(model, torch.Generator(device="cuda").manual_seed(0), tcfg,
                            device="cuda")
            cp = tree_to(cu["params"], "cpu")
            states = {"cuda": cu,
                      "cpu": {"params": cp, "opt": adamw_init(cp, tcfg.int8_moments)}}
        names = leaf_names(states["cpu"]["params"])
        n_params = sum(p.numel() for p in tree_leaves(states["cpu"]["params"]))
        data_fn = make_train_data_fn(cfg, tcfg)
        # the CPU's side without remat: the same gradients in less time
        loss_fns = {"cuda": make_loss_fn(model, tcfg),
                    "cpu": make_loss_fn(model, replace(tcfg, remat=False))}
        loss_rel, g_rel, finite, cpu_s = [], [], True, 0.0
        zero_launches()
        for i in range(n_steps):
            batch = data_fn(i)
            loss, grads = {}, {}
            for dev in ("cuda", "cpu"):
                t1 = time.perf_counter()
                l, g = value_and_grad(loss_fns[dev], states[dev]["params"],
                                      {k: v.to(dev) for k, v in batch.items()})
                loss[dev], grads[dev] = l.item(), g
                cpu_s += (time.perf_counter() - t1) * (dev == "cpu")
            # the CPU's gradients on the card: compared there, and fed to
            # the card's optimizer
            g_cpu = tree_map(lambda g: g.to("cuda"), grads["cpu"])
            gc_, gp = tree_leaves(grads["cuda"]), tree_leaves(g_cpu)
            loss_rel.append(abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"]))
            g_rel.append(max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                             for a, b in zip(gc_, gp)))
            finite &= all(bool(torch.isfinite(g).all()) for g in gc_ + gp)
            t1 = time.perf_counter()
            states["cpu"] = apply_grads(tcfg, states["cpu"], grads["cpu"])[0]
            cpu_s += time.perf_counter() - t1
            states["cuda"] = apply_grads(tcfg, states["cuda"], g_cpu)[0]
            del grads, g_cpu, gc_, gp
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_launches().items() if v}
        p_errs = [(a - b.to("cuda")).abs().max().item() for a, b in zip(
            tree_leaves(states["cuda"]["params"]), tree_leaves(states["cpu"]["params"]))]
        p_err = max(p_errs)
        # the CPU's optimizer took its own gradients: its params are those
        # of its own trajectory, the card's is run again on its own
        ind_err = independent_params_gap(torch, model, tcfg, state, data_fn, n_steps,
                                         states["cpu"]["params"]) if independent else None
        del states
        r = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
                 batch=B, seq=T, loss_impl=loss_impl, loss_cuda=loss["cuda"], loss_cpu=loss["cpu"],
                 loss_rel=max(loss_rel), grad_rel=max(g_rel), grad_rel_by_step=g_rel,
                 grads_finite=finite, steps=n_steps, params_max_abs_err=p_err,
                 params_max_abs_err_leaf=names[p_errs.index(p_err)],
                 independent_params_max_abs_err=ind_err, launches_cuda=counts,
                 cpu_grads_adamw_s=cpu_s, wall_s=time.perf_counter() - t0)
        log("training cross-device " + json.dumps(r))
        if not (r["loss_rel"] <= 1e-5 and r["grad_rel"] <= 1e-4 and p_err <= 1e-4 and finite
                and (ind_err is None or ind_err <= 1e-4)):
            fail(f"training differs between cuda and cpu: {r}")
        if cfg.family == "hybrid" and not (counts.get("ssd_scan") and counts.get("ssd_scan_bwd")):
            fail(f"training cross-device {cfg.name}: K4's kernels not launched: {counts}")
        out.append(r)
        del state, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def profiled_train_step(torch, model, tcfg, state, batch):
    """One train step of ``state`` on ``batch``, written out so that CUDA
    events split its device time: the layers' forward (for the families
    that train on full logits, the unembedding too), the loss (forward
    and backward, up to the gradient of the hidden states or logits), the
    layers' backward (with remat's recompute), and clipping + AdamW;
    under ``torch.profiler``, the kernel classes (GEMM, K2, K4's forward
    and backward, other kernels) and the recompute backward of
    ``flash_attention_ckpt`` (its ``_FlashCkptBackward`` node, whose
    kernels also sit in the classes)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.models import transformer as T
    from repro_torch.train.losses import lm_loss, lm_loss_from_hidden
    from repro_torch.train.trainer import apply_grads
    cfg = model.cfg
    from_hidden = cfg.family in ("dense", "moe", "vlm")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        live = tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
        ev[0].record()
        if from_hidden:
            out, _ = T.train_hidden(live, cfg, batch, remat=tcfg.remat)
        else:
            out, _ = model.module.train_logits(live, cfg, batch, remat=tcfg.remat)
        ev[1].record()
        if from_hidden:
            loss, _ = lm_loss_from_hidden(out, batch["labels"], live["embed"],
                                          softcap=cfg.final_logit_softcap,
                                          v_real=cfg.vocab_size)
        else:
            loss, _ = lm_loss(out, batch["labels"], v_real=cfg.vocab_size)
        ev[2].record()
        out.register_hook(lambda g: ev[3].record())
        leaves = tree_leaves(live)
        it = iter(torch.autograd.grad(loss, leaves))
        ev[4].record()
        apply_grads(tcfg, state, tree_map(lambda _: next(it), state["params"]))
        ev[5].record()
        torch.cuda.synchronize()
    span = lambda a, b: ev[a].elapsed_time(ev[b])
    by_class, n_kernels = device_ms_by_class(torch, prof)
    bwd_ms = max((e.device_time_total / 1e3 for e in prof.key_averages()
                  if "_FlashCkptBackward" in e.key), default=0.0)
    k2_ms, kernels_ms = by_class.get("flash_attention", 0.0), sum(by_class.values())
    split = dict(step_ms=span(0, 5), layers_forward_ms=span(0, 1),
                 loss_ms=span(1, 3), layers_backward_ms=span(3, 4),
                 clip_adamw_ms=span(4, 5), k2_kernels_ms=k2_ms,
                 flash_backward_ms=bwd_ms, kernels_ms=kernels_ms, kernels=n_kernels,
                 gemm_ms=by_class.get("gemm", 0.0), ssd_scan_ms=by_class.get("ssd_scan", 0.0),
                 ssd_scan_bwd_ms=by_class.get("ssd_scan_bwd", 0.0),
                 device_ms_by_class={k: round(v, 3) for k, v in sorted(by_class.items())})
    split["other_ms"] = (split["step_ms"] - split["loss_ms"] - split["clip_adamw_ms"]
                         - k2_ms - bwd_ms)
    split["other_kernels_ms"] = kernels_ms - sum(split[k] for k in (
        "gemm_ms", "k2_kernels_ms", "ssd_scan_ms", "ssd_scan_bwd_ms"))
    split["busy_share"] = kernels_ms / split["step_ms"]
    return split


def train_path(torch, tmp, arch, cfg, tcfg, want):
    """One training path through ``Trainer`` on cuda: ``tcfg.total_steps``
    steps with one asynchronous checkpoint at the end.  Launch counters
    are zeroed just before and read just after: each kernel of ``want``
    must launch exactly that often, every other kernel not at all.  Every
    loss and gnorm finite, the params changed.  Peak memory is logged
    with what was allocated when the run started (the state, plus what
    earlier phases still hold).  Then one more step, profiled
    (``profiled_train_step``), and the checkpoint is deleted."""
    import os
    import shutil
    from repro_torch.common.tree import tree_bytes, tree_count, tree_leaves
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.data import make_train_data_fn
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import Trainer
    gc.collect()
    torch.cuda.empty_cache()
    model = get_model(arch, cfg)
    B, T, steps = tcfg.global_batch, tcfg.seq_len, tcfg.total_steps
    data_fn = make_train_data_fn(cfg, tcfg)
    trainer = Trainer(model, tcfg, data_fn, log_every=1, device="cuda")
    params = trainer.state["params"]
    leaves = tree_leaves(params)
    watched = (0, len(leaves) // 2, len(leaves) - 1)
    before = [leaves[i].clone() for i in watched]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()      # this state and what earlier phases hold
    zero_launches()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = [v for _, v in trainer.metrics]
    step_s = [v["step_s"] for v in m]
    ckpt_dir = Path(tcfg.ckpt_dir) / f"step_{steps}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir()) if ckpt_dir.is_dir() else 0
    after = tree_leaves(trainer.state["params"])
    changed = any(not torch.equal(b, after[i]) for b, i in zip(before, watched))
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    r = dict(arch=cfg.name, layers=cfg.n_layers, params=tree_count(params), dtype="float32",
             batch=B, seq=T, steps=steps, losses=[v["loss"] for v in m],
             gnorms=[v["gnorm"] for v in m], lrs=[v["lr"] for v in m], step_s=step_s,
             step_s_median_after_first=steady, tokens_per_s=B * T / steady,
             run_wall_s=wall, checkpoint_s=wall - sum(step_s),
             checkpoint_snapshot_s=trainer.ckpt.snapshot_s, checkpoint_bytes=ckpt_bytes,
             max_memory_allocated_bytes=peak, allocated_before_bytes=resident,
             state_bytes=tree_bytes(trainer.state), launches=counts, launches_expected=want)
    log(f"training {arch} path " + json.dumps(r))
    bad = []
    if not all(math.isfinite(x) for x in r["losses"] + r["gnorms"]):
        bad.append("a loss or gnorm is not finite")
    if not changed:
        bad.append("the params did not change")
    if latest_step(tcfg.ckpt_dir) != steps:
        bad.append(f"no checkpoint of step {steps}")
    for k, n in want.items():
        if counts[k] != n:
            bad.append(f"{k} launched {counts[k]} times, expected {n}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    if others:
        bad.append(f"kernels off the training path launched: {others}")
    if bad:
        fail(f"training {arch} path: " + "; ".join(bad))
    del before, after, leaves, params
    gc.collect()
    batch = {k: v.to("cuda") for k, v in data_fn(steps).items()}
    split = profiled_train_step(torch, model, tcfg, trainer.state, batch)
    log(f"training {arch} step device split " + json.dumps(split))
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tcfg.ckpt_dir, ignore_errors=True)     # the next path's disk
    os.sync()
    return r, split


def phase_train_path(torch, tmp):
    """The main training path: qwen3-0.6b at full width and depth (28
    layers), f32 master params, remat, chunked CE, AdamW, B = 4, T = 512,
    6 steps (about 7.2 GB of params and moments): K2's training forward
    (``flash_attention_lse``) launches 2 x 28 a step (the forward and
    remat's recompute) and no other kernel (``train_path``)."""
    from repro_torch.configs import TrainConfig, get_config
    cfg = get_config("qwen3-0.6b")
    steps = TRAIN["steps"]
    tcfg = TrainConfig(global_batch=TRAIN["global_batch"], seq_len=TRAIN["seq_len"],
                       total_steps=steps, ckpt_every=steps, remat=True, loss_impl="chunked",
                       ckpt_dir=str(tmp / "main"))
    return train_path(torch, tmp, "qwen3-0.6b", cfg, tcfg,
                      {"flash_attention_lse": 2 * cfg.n_layers * steps})


def phase_train_hybrid_path(torch, tmp):
    """The hybrid's training path: zamba2-7b at full width and 13
    layer-units (``HYBRID_TRAIN``), f32 master params, remat, full-logit
    CE, AdamW, B = 4, T = 1024, 6 steps: per step K4's forward launches 2
    x 11 times (the forward and remat's recompute), its backward kernel 11
    times and K2's training forward 2 x 2 times (d = 112), and no other
    kernel (``train_path``)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import hybrid as HY
    cfg = replace(get_config("zamba2-7b"), n_layers=HYBRID_TRAIN["n_layers"])
    n_attn, n_mamba = HY.group_structure(cfg)[:2]
    steps = HYBRID_TRAIN["steps"]
    tcfg = TrainConfig(global_batch=HYBRID_TRAIN["global_batch"],
                       seq_len=HYBRID_TRAIN["seq_len"], total_steps=steps, ckpt_every=steps,
                       remat=True, ckpt_dir=str(tmp / "hybrid"))
    return train_path(torch, tmp, "zamba2-7b", cfg, tcfg, {
        "ssd_scan": 2 * n_mamba * steps, "ssd_scan_bwd": n_mamba * steps,
        "flash_attention_lse": 2 * n_attn * steps})


def train_determinism(torch, tmp):
    """Run in its own process, with ``CUBLAS_WORKSPACE_CONFIG`` set before
    CUDA starts: under ``torch.use_deterministic_algorithms(True)``, the
    reduced qwen3-0.6b of the CPU tests (B = 4, T = 16, remat) trained 6
    steps uninterrupted against a run that crashes after step 5 and
    resumes from its step-4 checkpoint: the final params must be bitwise
    equal.  Then int8 moments: 3 steps against f32 moments (last loss
    within 0.1, the reference's bound), and a crash after step 2 resumed
    through the ``Q8`` moments of its checkpoint, bitwise equal to the
    uninterrupted int8 run.  Prints one JSON line."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_train_data_fn
    from repro_torch.models.registry import get_model
    from repro_torch.optim import Q8
    from repro_torch.train.trainer import Trainer
    torch.use_deterministic_algorithms(True)
    cfg = get_config("qwen3-0.6b").reduced()
    model = get_model("qwen3-0.6b", cfg)

    def run(tcfg, name, crash_at=None):
        tr = Trainer(model, replace(tcfg, ckpt_dir=str(tmp / name)), data_fn, log_every=1,
                     device="cuda")
        start = tr.start_step
        if crash_at is None:
            tr.run()
        else:
            try:
                tr.run(crash_at=crash_at)
            except RuntimeError as e:
                if "simulated failure" not in str(e):
                    raise
            else:
                fail("the simulated crash did not happen")
        return tr, start

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.state["params"]),
                                                     tree_leaves(b.state["params"]),
                                                     strict=True))

    tcfg = TrainConfig(global_batch=4, seq_len=16, total_steps=6, ckpt_every=4, remat=True)
    data_fn = make_train_data_fn(cfg, tcfg)
    ref, _ = run(tcfg, "ref")
    run(tcfg, "crash", crash_at=5)
    res, start = run(tcfg, "crash")
    t8 = replace(tcfg, total_steps=3, ckpt_every=2, int8_moments=True)
    r8, _ = run(t8, "int8")
    rf, _ = run(replace(t8, int8_moments=False), "f32")
    run(t8, "int8_crash", crash_at=2)
    c8, start8 = run(t8, "int8_crash")
    out = dict(resume_start=start, bitwise_equal=same(ref, res),
               int8_loss=r8.history[-1][1], f32_loss=rf.history[-1][1],
               int8_resume_start=start8,
               int8_resumed_q8=isinstance(c8.state["opt"]["mu"]["embed"], Q8),
               int8_bitwise_equal=same(r8, c8),
               losses=[l for _, l in ref.history])
    print("determinism " + json.dumps(out), flush=True)


TRAIN_LAUNCHER_ARGS = ("-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b",
                       "--reduced", "--steps", "4")


def start_train_subprocesses(tmp):
    """Start, in the background, bitwise resume and int8 moments on the
    card (``train_determinism``, in a subprocess of this script so
    ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts) and the
    launcher as its users run it: ``python -m repro_torch.launch.train
    --arch qwen3-0.6b --reduced --steps 4``.  Both run on the reduced
    config beside the cross-device training rows."""
    env = src_env(CUBLAS_WORKSPACE_CONFIG=":4096:8")
    return (Background([sys.executable, str(Path(__file__).resolve()), "--train-determinism",
                        str(tmp / "det")], env, timeout=600),
            Background([sys.executable, *TRAIN_LAUNCHER_ARGS, "--ckpt-dir",
                        str(tmp / "launcher")], env, timeout=600))


def phase_train_subprocesses(started):
    """Read the subprocesses of ``start_train_subprocesses``: the
    determinism run must show a bitwise resume and int8 moments within 0.1
    of f32's loss, the launcher must exit 0 and print its ``done:``
    line."""
    det_run, launcher = started
    rc, stdout, stderr, _ = det_run.result()
    if rc != 0:
        fail(f"train determinism run exited {rc}: {stderr.strip()[-3000:]}")
    line = next(x for x in stdout.splitlines() if x.startswith("determinism "))
    det = json.loads(line[len("determinism "):])
    log("training on the card under deterministic algorithms " + json.dumps(det))
    bad = []
    if not (det["resume_start"] == 4 and det["bitwise_equal"]):
        bad.append("the resumed run is not bitwise equal to the uninterrupted one")
    if not abs(det["int8_loss"] - det["f32_loss"]) < 0.1:
        bad.append("int8 moments' loss is not within 0.1 of f32 moments'")
    if not (det["int8_resume_start"] == 2 and det["int8_resumed_q8"]
            and det["int8_bitwise_equal"]):
        bad.append("the int8-moment resume is not bitwise equal to the uninterrupted run")
    if bad:
        fail("training on the card: " + "; ".join(bad))
    rc, stdout, stderr, wall = launcher.result()
    done = [x for x in stdout.splitlines() if x.startswith("done:")]
    if rc != 0 or not done:
        fail(f"train launcher exited {rc}: {stdout[-1000:]} {stderr.strip()[-2000:]}")
    log(f"train launcher ({' '.join(TRAIN_LAUNCHER_ARGS[1:5])} ... --steps 4; read "
        f"{wall:.1f} s after its start, beside the cross-device rows): "
        + " | ".join(stdout.strip().splitlines()))
    return det


def phase_train(torch):
    """Phase 7, training, in a temporary directory deleted afterwards."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        # the subprocesses run beside the cross-device rows, whose wall is
        # the CPU's, and end before the timed training paths
        started = start_train_subprocesses(tmp)
        cross = timed("phase 7 cross-device rows", phase_train_cross_device, torch, tmp)
        det = timed("phase 7 subprocesses (after the rows)", phase_train_subprocesses, started)
        main_path, split = timed("phase 7 qwen3 path", phase_train_path, torch, tmp)
        hybrid_path, hybrid_split = timed("phase 7 zamba2 path", phase_train_hybrid_path,
                                          torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(cross_device=cross, main_path=main_path, split=split, hybrid_path=hybrid_path,
                hybrid_split=hybrid_split, determinism=det)


# ------------------------------------------------------------ phase 8 ---
INTENSITY_PAGE = 16          # benchmarks/phase_intensity.py's page size
# phase 8b: qwen3-0.6b's dry-run cells, cut as the reference's own test
# cuts them (tests/test_sharding_and_dryrun.py), prefill to 4 x 2048
ROOFLINE_ARCH = "qwen3-0.6b"
ROOFLINE_CELLS = {   # label: (shape name, cut shape, mixed scheme, kernels that must launch)
    "train": ("train_4k", dict(kind="train", seq=512, batch=8), None,
              ("flash_attention_lse",)),
    "prefill": ("prefill_32k", dict(kind="prefill", seq=2048, batch=4), None,
                ("flash_attention",)),
    "decode": ("decode_32k", dict(kind="decode", seq=1024, batch=8), None,
               ("paged_attention_decode",)),
    "mixed fp": ("mixed_32k", dict(kind="mixed", seq=1024, batch=8, chunk=64, streams=2),
                 "baseline", ("paged_attention_decode", "paged_attention_chunk")),
    "mixed kv8": ("mixed_32k", dict(kind="mixed", seq=1024, batch=8, chunk=64, streams=2),
                  "kv8", ("paged_attention_int8_decode", "paged_attention_int8_chunk")),
}


def intensity_rows():
    """The 15 rows of ``benchmarks/phase_intensity.py`` (the paper's Figs.
    2-4 on opt-125m): (figure, x, kind, batch, tokens or context, pool
    pages)."""
    ps = INTENSITY_PAGE
    return ([("fig2_prefill_intensity", s, "prefill", 1, s, 0)
             for s in (128, 256, 512, 1024, 2048)]
            + [("fig3_decode_intensity", c, "decode", 1, c, c // ps + 4)
               for c in (128, 256, 512, 1024, 2048)]
            + [("fig4_decode_batch_intensity", b, "decode", b, 512, (512 // ps + 2) * 40 + 4)
               for b in (1, 5, 10, 20, 40)])


def intensity_args(torch, cfg, row, g, device):
    """A row's step arguments, seeded from ``g``: prompt tokens, or one
    decode token per sequence over bf16 pages, each sequence ``ctx``
    tokens deep in its own pages."""
    _, _, kind, b, n, n_pages = row
    toks = torch.randint(2, cfg.vocab_size, (b, n) if kind == "prefill" else (b,),
                         generator=g, device=device, dtype=torch.int32)
    if kind == "prefill":
        return (toks,)
    ps, pmax = INTENSITY_PAGE, n // INTENSITY_PAGE + 1
    pool = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    kpg, vpg = (torch.randn(pool, generator=g, device=device).to(torch.bfloat16)
                for _ in range(2))
    table = torch.randperm(n_pages - 1, generator=g, device=device)[: b * pmax]
    return (toks, kpg, vpg, table.reshape(b, pmax).to(torch.int32),
            torch.full((b,), n, dtype=torch.int32, device=device))


def intensity_step(cfg, kind):
    from repro_torch.models import transformer as T
    if kind == "prefill":
        return lambda params, toks: T.prefill(params, cfg, toks)[0]
    return lambda params, *a: T.decode(params, cfg, *a)[0]


@contextlib.contextmanager
def cut_shapes(steps, cuts):
    """``launch/steps.py``'s SHAPES with ``cuts`` in place, restored on exit."""
    saved = dict(steps.SHAPES)
    steps.SHAPES.update(cuts)
    try:
        yield
    finally:
        steps.SHAPES.clear()
        steps.SHAPES.update(saved)


def roofline_cell(label):
    """The ``launch/steps.py`` cell of ``ROOFLINE_CELLS[label]`` (call
    under its ``cut_shapes``)."""
    from repro_torch.launch import steps
    shape, _, scheme, _ = ROOFLINE_CELLS[label]
    if scheme is not None:
        return steps.build_mixed(ROOFLINE_ARCH, shape, scheme=scheme)
    cell, why = steps.build_cell(ROOFLINE_ARCH, shape)
    if cell is None:
        raise RuntimeError(why)
    return cell


_trace_cache = {}


def trace_job(src, job):
    """One cost count of phase 8, in a worker process (fake CPU tensors,
    no card): ("row", intensity row) -> ``traced_costs`` of the row's
    step; ("cell", label) -> the roofline row of the cut dry-run cell."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.costs import fake_mode, traced_costs
    from repro_torch.launch.roofline import analyze
    from repro_torch.models.registry import get_model
    kind, what = job
    if kind == "row":
        if "opt" not in _trace_cache:
            mode = fake_mode()
            with mode:
                model = get_model("opt-125m")
                params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
            _trace_cache["opt"] = model.cfg, mode, params
        cfg, mode, params = _trace_cache["opt"]
        with mode:
            args = intensity_args(torch, cfg, what, torch.Generator().manual_seed(1), "cpu")
        return traced_costs(intensity_step(cfg, what[2]), params, *args)
    shape, cut, _, _ = ROOFLINE_CELLS[what]
    with cut_shapes(steps, {shape: cut}):
        rl = analyze(roofline_cell(what), arch=ROOFLINE_ARCH, shape=shape)
    return dict(rl.row(), peak_bytes=rl.peak_mem_per_dev)


def all_finite(torch, tree):
    from torch.utils._pytree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def step_times(torch, fn, repeats=3):
    """Times of one call of a whole step: ``device_ms`` and ``host_ms``,
    the least of ``repeats`` readings of ``device_time_ms`` at one call
    each; then one call under ``torch.profiler``: ``kernel_ms``, the sum
    of its kernels' device times, and ``kernels``, their count.  A step
    that launches more kernels than the launch queue holds (about a
    thousand) blocks the host behind the device sleep, and the rest of
    its ``device_ms`` runs at the host's pace; ``kernel_ms`` is the
    device's own work at any launch count."""
    from torch.profiler import ProfilerActivity, profile
    dev_ms, host_ms = min(device_time_ms(fn, iters=1, warmup=1) for _ in range(repeats))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_class, n_kernels = device_ms_by_class(torch, prof)
    kernel_ms = sum(by_class.values()) if n_kernels else "not measured"
    return dict(device_ms=dev_ms, host_ms=host_ms, kernel_ms=kernel_ms, kernels=n_kernels)


def phase_roofline(torch):
    """Phase 8: the cost model and the dry run held to the card.  (a) The
    15 rows of the paper's Figs. 2-4 on opt-125m at full size, bf16, page
    size 16: each row's ``traced_costs``, its intensity against the
    H100's ridge, the step on the card (``device_time_ms``) and the
    achieved FLOP/s and bytes/s as shares of the data-sheet peaks; K2
    and K1's decode must launch, every output be finite.  (b) qwen3-0.6b
    through each kind of dry-run cell at a cut shape, seeded args on the
    card, one run each: the estimated peak against
    ``max_memory_allocated`` (less what was allocated before the cell's
    args: earlier phases' models) and max(t_compute, t_memory) against the
    measured device ms and a profiled call's summed kernel ms
    (``step_times``; gaps logged, not fatal); fatal on a non-finite
    output or a kernel of the cell that did not launch.  The cost counts
    run in worker processes (fake tensors, no card) beside the card's
    runs."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import steps
    hw = card_spec()
    ridge = hw.peak_flops_bf16 / hw.hbm_bw
    src = str(Path(__file__).resolve().parent / "src")
    rows = intensity_rows()
    jobs = [("cell", label) for label in ROOFLINE_CELLS] + [("row", r) for r in rows]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=max(1, min(6, (os.cpu_count() or 2) - 2)),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {job: pool.submit(trace_job, src, job) for job in jobs}

        # (a) the paper's Figs. 2-4 on the card
        model, params = init_model(torch, "opt-125m")
        cfg = model.cfg
        g = torch.Generator(device="cuda").manual_seed(8)
        measured = []
        zero_launches()
        for row in rows:
            step = intensity_step(cfg, row[2])
            args = intensity_args(torch, cfg, row, g, "cuda")
            if not all_finite(torch, step(params, *args)):
                fail(f"phase 8: non-finite logits in {row[:2]}")
            measured.append(step_times(torch, lambda: step(params, *args)))
        launches = read_launches()
        if not launches["flash_attention"] or not launches["paged_attention_decode"]:
            fail(f"phase 8: K2 or K1's decode not launched by the intensity rows: {launches}")
        del model, params, args
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the dry run's cells at cut shapes on the card
        cells = {}
        for label, (shape, cut, _, want) in ROOFLINE_CELLS.items():
            with cut_shapes(steps, {shape: cut}):
                cell = roofline_cell(label)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()      # what earlier phases still hold
            args = cell["make_args"](torch.Generator(device="cuda").manual_seed(9), "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            out = cell["fn"](*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            launches = read_launches()
            if not all_finite(torch, out):
                fail(f"phase 8: non-finite output in the {label} cell")
            missing = [k for k in want if not launches[k]]
            if missing:
                fail(f"phase 8: {missing} not launched by the {label} cell: {launches}")
            del out
            cells[label] = dict(note=cell["note"], peak_bytes=peak, held_bytes=held,
                                **step_times(torch, lambda: cell["fn"](*args)),
                                launches={k: launches[k] for k in want})
            del cell, args
            gc.collect()
            torch.cuda.empty_cache()
        t_card = time.perf_counter() - t0
        est = {job: f.result() for job, f in futures.items()}

    out_rows = []
    for row, m in zip(rows, measured):
        c = est[("row", row)]
        ai = c["flops"] / c["bytes"]
        t_bound = max(c["flops"] / hw.peak_flops_bf16, c["bytes"] / hw.hbm_bw) * 1e3
        r = dict(bench=row[0], x=row[1], flops=c["flops"], bytes=c["bytes"],
                 arith_intensity=ai, ridge=ridge, compute_bound=ai > ridge, **m,
                 bound_ms=t_bound,
                 flops_share=c["flops"] / (m["device_ms"] / 1e3) / hw.peak_flops_bf16,
                 bytes_share=c["bytes"] / (m["device_ms"] / 1e3) / hw.hbm_bw)
        out_rows.append(r)
        log(f"phase 8 {r['bench']} x={r['x']}: flops {c['flops']:.4e} bytes {c['bytes']:.4e} "
            f"AI {ai:.2f} (ridge {ridge:.1f}, {'compute' if ai > ridge else 'memory'}-bound) "
            f"device {m['device_ms']:.4f} ms (bound {t_bound:.4f}; kernels {m['kernels']}, "
            f"{m['kernel_ms']} ms) host {m['host_ms']:.4f} ms; {r['flops_share']:.4f} of "
            f"peak FLOP/s, {r['bytes_share']:.4f} of peak bytes/s")
    for label, m in cells.items():
        e = est[("cell", label)]
        t_est = max(e["t_compute_s"], e["t_memory_s"]) * 1e3
        m.update(flops=e["flops_per_dev"], bytes=e["bytes_per_dev"], bottleneck=e["bottleneck"],
                 est_peak_bytes=e["peak_bytes"], est_ms=t_est, model_flops=e["model_flops"],
                 peak_ratio=m["peak_bytes"] / e["peak_bytes"], time_ratio=m["device_ms"] / t_est)
        log(f"phase 8 cell {ROOFLINE_ARCH} {label} ({m['note']}): peak estimated "
            f"{e['peak_bytes'] / 2**30:.3f} GiB, measured {m['peak_bytes'] / 2**30:.3f} GiB "
            f"(x{m['peak_ratio']:.3f}; above {m['held_bytes'] / 2**30:.3f} GiB held); "
            f"max(t_compute, t_memory) {t_est:.4f} ms "
            f"({e['bottleneck']}-bound), device {m['device_ms']:.4f} ms "
            f"(x{m['time_ratio']:.2f}; kernels {m['kernels']}, {m['kernel_ms']} ms), "
            f"host {m['host_ms']:.4f} ms; launches {m['launches']}")
    log("roofline " + json.dumps(dict(intensity=out_rows, cells=cells)))
    log(f"phase 8: {time.perf_counter() - t0:.1f} s ({t_card:.1f} s until the card's runs ended)")
    return dict(intensity=out_rows, cells=cells)


# ------------------------------------------------------------ phase 9 ---
# sampled decoding: qwen3-0.6b at full width and 2 layers in f32 (in bf16
# the modes' GEMM rounding differs), pages sized to hold 512 + 32 tokens
SAMPLED_SERVE = dict(max_batch=16, page_size=16, n_pages=640, max_pages_per_seq=36,
                     max_seq_len=576, prefill_chunk=128, n_streams=2, chunk_tokens=256,
                     **ANALYSIS_OFF)
SAMPLED_TIGHT_PAGES = 96       # a pool this small preempts the 16 requests
SAMPLED_POLICIES = ({}, dict(temperature=0.8, top_k=40), dict(temperature=1.0, top_p=0.9))


def sampled_requests(vocab, policies=SAMPLED_POLICIES, rids=None):
    """Phase 9's traffic: 16 requests of 64-512 prompt tokens and 32 new
    tokens each, request i with ``policies[i % len(policies)]`` and its
    own seed 1000 + i.  By default a third are greedy, a third sample at
    temperature 0.8 with top-k 40 and a third at temperature 1.0 with
    top-p 0.9.  ``rids`` keeps only those requests."""
    import numpy as np
    from repro_torch.core.engine import Request
    from repro_torch.core.sampler import SamplingParams
    rng = np.random.RandomState(11)
    out = []
    for i in range(16):
        prompt = [int(t) for t in rng.randint(2, vocab, size=rng.randint(64, 513))]
        if rids is None or i in rids:
            out.append(Request(rid=i, prompt=prompt, sampling=SamplingParams(
                max_new_tokens=32, seed=1000 + i, **policies[i % len(policies)])))
    return out


def sampled_run(torch, setup, serve_kw, mode, reqs, dev):
    """Serve ``reqs`` on ``dev``: (streams by rid, summary, launches).
    Every request must finish by length (and every logit be finite)."""
    from repro_torch.configs import ServeConfig
    gc.collect()
    eng = make_engine_cls()(*setup, ServeConfig(mode=mode, **serve_kw), device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    zero_launches()
    s = eng.run(reqs, max_steps=20000).summary()
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    outs = eng.poll()
    if len(outs) != len(reqs) or any(o.finish_reason != "length" for o in outs) \
            or any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
        fail(f"phase 9 {mode} on {dev}: not every request finished by length: "
             f"{[(o.rid, o.finish_reason, len(o.tokens)) for o in outs]}")
    return {r.rid: r.out_tokens for r in reqs}, s, launches


def first_difference(a, b):
    """(rid, token index, a's token, b's token) where two stream maps first
    differ, or None."""
    for rid in sorted(a):
        for j, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                return rid, j, x, y
    return None


def sampled_checks(torch, setup, make):
    """Phase 9's fatal checks on cuda; ``make(policies, rids)`` builds the
    traffic (``sampled_requests``).  Returns the streams of the first mode,
    the kernels' launches and the engine steps per mode."""
    from repro_torch.configs import SERVE_MODES
    dev, serve_kw, tight_pages = "cuda", SAMPLED_SERVE, SAMPLED_TIGHT_PAGES
    per_mode, launches, steps = {}, {}, {}
    for mode in SERVE_MODES:                         # 1. modes agree
        per_mode[mode], s, launches[mode] = sampled_run(torch, setup, serve_kw, mode,
                                                        make(), dev)
        steps[mode] = s["n_steps"]
        want = (["paged_attention_decode"]
                + (["flash_attention"] if mode == "sequential" else [])
                + (["paged_attention_chunk"] if mode in CHUNKING_MODES else []))
        missing = [k for k in want if launches[mode][k] == 0]
        if missing:                                  # 6. the kernels ran
            fail(f"phase 9 {mode}: {missing} not launched: {launches[mode]}")
    base = per_mode[SERVE_MODES[0]]
    for mode in SERVE_MODES[1:]:
        diff = first_difference(base, per_mode[mode])
        if diff:
            fail(f"phase 9: sampled streams differ between {SERVE_MODES[0]} and {mode} "
                 f"at (rid, index, a, b) = {diff}")
    sampled = [r.rid for r in make() if r.sampling.temperature > 0]
    for rid in sampled:                              # 2. alone = in the batch
        alone, _, _ = sampled_run(torch, setup, serve_kw, "sequential", make(rids={rid}), dev)
        if alone[rid] != base[rid]:
            fail(f"phase 9: request {rid} alone differs from its batched stream at "
                 f"{first_difference({rid: alone[rid]}, {rid: base[rid]})}")
    tight, s, _ = sampled_run(torch, setup, dict(serve_kw, n_pages=tight_pages),  # 3.
                              "chunked", make(), dev)
    if s["n_preemptions"] == 0:
        fail(f"phase 9: the {tight_pages}-page pool did not preempt: {s}")
    if tight != base:
        fail(f"phase 9: streams under preemption differ at {first_difference(base, tight)}")
    greedy, _, _ = sampled_run(torch, setup, serve_kw, "sequential", make(({},)), dev)
    greedy_rids = [r.rid for r in make() if r.sampling.temperature == 0]   # 4.
    if any(greedy[rid] != base[rid] for rid in greedy_rids):
        fail("phase 9: greedy rows of the mixed batch differ from the all-greedy run")
    log(f"phase 9 on {dev}: {len(base)} streams ({len(sampled)} sampled) equal in "
        f"{list(SERVE_MODES)} (steps {json.dumps(steps)}); each sampled request alone equals "
        f"its batched stream; {tight_pages}-page pool: {s['n_preemptions']} preemptions, "
        f"{s['n_steps']} steps, streams equal; {len(greedy_rids)} greedy rows equal the "
        "all-greedy run; every request finished by length, every logit finite")
    return base, launches, steps


def sampler_timing(torch):
    """``sample_tokens`` on cuda logits [16, 151,936] (qwen3-0.6b's
    vocabulary), every row sampled (top-k 40 on the odd rows, top-p 0.9
    on the even ones): host ms a call (to its tokens on the card), device
    ms a call from ``torch.profiler`` (kernels and copies), and the host ms
    of ``_gumbel_rows`` alone (the CPU noise); medians of 10 calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sampler import _gumbel_rows, sample_tokens
    B, V, reps = 16, 151_936, 10
    g = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(B, V, device="cuda", generator=g) * 3
    rows = torch.arange(B)
    args = (torch.full((B,), 0.8), torch.where(rows % 2 == 1, 40, 0).to(torch.int32),
            torch.where(rows % 2 == 0, 0.9, 1.0), torch.full((B,), 7), rows, torch.zeros(B, dtype=torch.int64))

    def call():
        return sample_tokens(logits, *args)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[reps // 2]

    host = host_ms(call)
    noise = host_ms(lambda: _gumbel_rows(*args[3:], V))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev_us = {}
    for name, us in device_events(torch, prof):
        dev_us[name] = dev_us.get(name, 0.0) + us
    device = sum(dev_us.values()) / 1e3 / reps
    copy = sum(v for k, v in dev_us.items() if "memcpy" in k.lower()) / 1e3 / reps
    return dict(B=B, V=V, host_ms=host, device_ms=device if device else "not measured",
                device_copy_ms=copy, gumbel_rows_host_ms=noise,
                gumbel_rows_share_of_host=noise / host,
                device_top=sorted(((round(v / 1e3 / reps, 4), k) for k, v in dev_us.items()),
                                  reverse=True)[:6])


def decode_step_walls(torch, setup, reqs):
    """Median host wall (ms) of 8 sequential decode steps over the full
    batch ``reqs`` on cuda (after its prefill), each step synchronized."""
    from repro_torch.configs import ServeConfig
    n = 8
    gc.collect()
    eng = make_engine_cls()(*setup, ServeConfig(mode="sequential", **SAMPLED_SERVE),
                            device="cuda")
    for r in reqs:
        eng.submit(r)
    walls = []
    while len(walls) < n and not eng.idle():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.metrics.step_kinds[-1] == "decode" and all(eng.slots):
            walls.append((time.perf_counter() - t0) * 1e3)
    if len(walls) < n:
        fail(f"phase 9: only {len(walls)} full decode steps")
    return sorted(walls)[n // 2]


def start_lint():
    """Start the port's lint (``phase_sampling``) in the background: it
    reads source files only, so it can run from the start."""
    src = Path(__file__).resolve().parent / "src"
    return Background([sys.executable, "-m", "repro_torch.analysis.lint",
                       str(src / "repro_torch")], src_env(), timeout=300)


def phase_sampling(torch, lint=None):
    """Phase 9: sampled decoding on the card (module docstring), then the
    lint's result (``lint``: the run ``start_lint`` began, else one
    started here).  Returns the path's launches and engine steps for the
    kernels line."""
    from repro_torch.configs import SERVE_MODES, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = replace(get_config("qwen3-0.6b"), n_layers=2)
    model = get_model("qwen3-0.6b", cfg)
    cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    setup = (model, to_device(cpu_params, "cuda"))

    def make(policies=SAMPLED_POLICIES, rids=None):
        return sampled_requests(cfg.vocab_size, policies, rids)

    base, launches, steps = timed("phase 9 cuda checks", sampled_checks, torch, setup, make)
    total = {k: sum(launches[m][k] for m in SERVE_MODES) for k in launches[SERVE_MODES[0]]}
    log("phase 9 launches per mode " + json.dumps(launches))
    # logged, not fatal: logits differ by ~1e-5 between devices, so a
    # near-tie may flip a sampled token
    cpu, _, _ = timed("phase 9 cpu run", sampled_run, torch, (model, cpu_params), SAMPLED_SERVE,
                      "sequential", make(), "cpu")
    sampled = [r.rid for r in make() if r.sampling.temperature > 0]
    log("phase 9 cuda vs cpu agreement, share of token positions: " + json.dumps(dict(
        sampled=agreement([base[r] for r in sampled], [cpu[r] for r in sampled]),
        greedy=agreement([base[r] for r in base if r not in sampled],
                         [cpu[r] for r in base if r not in sampled]),
        first_difference=first_difference(base, cpu))))
    timing = timed("phase 9 sampler timing", sampler_timing, torch)
    walls = timed("phase 9 decode step walls", lambda: {
        kind: decode_step_walls(torch, setup, make(policies))
        for kind, policies in (("all_greedy", ({},)), ("all_sampled", SAMPLED_POLICIES[1:]))})
    log("phase 9 sampler on the card " + json.dumps(dict(
        sample_tokens=timing, decode_step_wall_ms=dict(B=16, **walls))))
    # the lint, as a CI job on this machine runs it
    rc, stdout, stderr, _ = timed("phase 9 lint", (lint or start_lint()).result)
    if rc != 0:
        fail(f"phase 9: the lint exited {rc}: {stdout[-2000:]}{stderr[-2000:]}")
    log(f"phase 9 lint (python -m repro_torch.analysis.lint src/repro_torch): exit 0, "
        f"{stdout.strip().splitlines()[-1]}")
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return dict(launches=total, steps=sum(steps.values()))


# ------------------------------------------------------------ phase 10 ---
# the mesh: the sharded serving steps (tensor parallel over "model", data
# parallel over "data", the MoE expert parallel) over torch.distributed.  One card: NCCL at world size 1 in this
# process (NCCL refuses two ranks on one device), then two ranks as two
# processes on the one card over gloo, whose collectives are staged
# through host memory.  A case: arch, config overrides (a cut depth), mesh
# shapes, page type, sequences, their prompt lengths (uniform in a range).
# int8 pages: the mesh and the one-card step each quantize their own K/V,
# which the tensor-parallel sums move by rounding; where a value sits on a
# rounding boundary its code flips (ROADMAP, "Expected": ~1e-3 on a
# logit), and the flip moves the next layer's K/V by up to ~1e-3 of their
# scale.  Past a few layers the drift compounds (the first runs of phase
# 10 and a CPU run of the same path: at 28 layers 2% of the codes differ,
# some by two, scales by 2.9e-3 and logits by 1.7e-3 of their max; at 2
# layers ~1e-5 of the codes, each by one), so int8 pages run qwen3 at 2
# layers, as phase 4's int8 check does.  There codes must lie within one
# of the one-card pool's (those one apart counted), scales and logits
# within MESH_INT8_TOL of their max, and a greedy token may differ only
# where the one-card step's top two logits lie closer than the two steps'
# logits do (a near tie, counted).
# The caches of the hybrid, rwkv6 and seamless (mesh_state_case) are held
# to MESH_PAGE_TOL on top of the one-card step's own f32 floor, measured in
# the same run: that step's gap to itself when every embedding value moves
# by one f32 ulp.  At tensor parallel the mesh's row-parallel sums round
# differently from the one-card GEMMs at every layer; zamba2's random
# Mamba2 stack carries that much further than qwen3's layers do: at full
# width and 13 layer-units a one-ulp move of the embeddings alone moves the
# one-card step's caches by 5.2e-6 to 1.0e-5 of their max and its logits by
# 7.7e-6, and the (1, 2) mesh's caches lay 7.5e-6 to 1.3e-5 from the
# one-card step's (PERF.md).  At (2, 1) and on NCCL (1, 1) the mesh
# computes the one-card step exactly (gaps 0).
MESH_PS, MESH_DECODE, MESH_MIXED, MESH_CHUNK, MESH_STREAMS = 16, 8, 2, 128, 2
MESH_LOGIT_TOL = {"nccl": 1e-5, "gloo": 1e-4}      # of max |logit| of the one-card step
MESH_PAGE_TOL = 1e-5                               # of max |page value| of the one-card pool
MESH_INT8_TOL = 1e-2                               # int8 pages: logits and scales
# The other families (mesh_state_case) prefill their n sequences as one
# batch of one length (the range's ends are equal): the zamba2 hybrid at 13
# layer-units (2 shared-attention invocations, pool layers 0 and 1; 11
# Mamba2 units), rwkv6 at 4 layers, seamless-m4t-medium at full depth after
# 1024 frames; internvl2 runs mesh_case behind its 256-patch prefix.
GLOO_SHAPES = ((1, 2), (2, 1))
HYBRID_CASE = ("zamba2-7b", {"n_layers": 13}, GLOO_SHAPES, "fp", 4, (256, 256))
NCCL_CASES = (("qwen3-0.6b", {}, ((1, 1),), "fp", 16, (128, 1024)),
              HYBRID_CASE[:2] + (((1, 1),),) + HYBRID_CASE[3:])
GLOO_CASES = (("qwen3-0.6b", {}, GLOO_SHAPES, "fp", 8, (128, 512)),
              ("qwen3-0.6b", {"n_layers": 2}, GLOO_SHAPES, "int8", 8, (128, 512)),
              ("olmoe-1b-7b", {"n_layers": 4}, GLOO_SHAPES, "fp", 8, (128, 512)),
              HYBRID_CASE,
              ("rwkv6-7b", {"n_layers": 4}, GLOO_SHAPES, "fp", 4, (256, 256)),
              ("seamless-m4t-medium", {}, GLOO_SHAPES, "fp", 4, (64, 64)),
              ("internvl2-2b", {"n_layers": 4}, GLOO_SHAPES, "fp", 4, (128, 128)))
MESH_KERNELS = {"fp": ("flash_attention", "paged_attention_decode", "paged_attention_chunk"),
                "int8": ("flash_attention", "paged_attention_int8_decode",
                         "paged_attention_int8_chunk"),
                "hybrid": ("ssd_scan", "flash_attention", "paged_attention_decode"),
                "ssm": (),                      # the WKV scan is no hand-written kernel
                "encdec": ("flash_attention", "paged_attention_decode")}


def _put(pool, kv, table_row, S, ps):
    """Write one sequence's K or V [L, S, KV, hd] into ``pool`` (fp, or
    int8 codes and scales) through its page-table row."""
    import torch
    from repro_torch.kernels.kv_int8 import q8_kv
    t = torch.arange(S, device=kv.device)
    pg, off = table_row.long()[t // ps], t % ps
    if isinstance(pool, dict):
        pool["q"][:, pg, off], pool["s"][:, pg, off] = q8_kv(kv)
    else:
        pool[:, pg, off] = kv


def _mesh_pool(torch, shape, int8):
    from repro_torch.kernels.kv_int8 import SCALE_FLOOR
    if not int8:
        return torch.zeros(shape, device="cuda")
    return {"q": torch.zeros(shape, dtype=torch.int8, device="cuda"),
            "s": torch.full(shape[:-1] + (1,), SCALE_FLOOR, device="cuda")}


def _logit_gap(a, b, vocab):
    a, b = a[..., :vocab].double(), b[..., :vocab].double()
    return float((a - b).abs().max() / b.abs().max())


def mesh_case(torch, mesh, backend, arch, over, pages, n_seqs, len_range):
    """One mesh path on this rank: prefill (K2), MESH_DECODE greedy decode
    steps and MESH_MIXED mixed steps (MESH_STREAMS prompt streams in
    chunks of MESH_CHUNK) through ``launch/steps.py``'s sharded cells, f32,
    launch counters zeroed before and read after; then the one-card
    steps on the full weights and pools, on this rank's data shard's rows
    fed the same tokens (for the MoE at data > 1 each shard's capacity
    comes from its own rows, as the mesh's).  Fatal: logits beyond
    ``MESH_LOGIT_TOL`` of max |logit|, a greedy token that differs, the
    rank's pages beyond ``MESH_PAGE_TOL`` of the one-card pool's slice, a
    kernel of the path not launched; int8 pages as the header of this
    phase says (``MESH_INT8_TOL``, codes within one, near ties)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_int8 import fake_quant_kv
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import param_pspecs, shard_params
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    cfg = replace(get_config(arch), **over)
    policy = sharding.Policy(sharding.make_rules(), mesh)
    nd, tp, d, m = policy.size("data"), policy.tp, policy.index("data"), policy.index("model")
    int8, ps = pages == "int8", MESH_PS
    label = (f"mesh {backend} {nd}x{tp} {arch}" + (f" {cfg.n_layers} layers" if over else "")
             + f" {pages} rank {torch.distributed.get_rank()}")
    cells = dict(prefill=steps.build_prefill(arch, mesh=mesh, cfg=cfg),
                 decode=steps.build_decode(arch, mesh=mesh, cfg=cfg,
                                           scheme="kv8" if int8 else "baseline"),
                 mixed=steps.build_mixed(arch, mesh=mesh, cfg=cfg,
                                         scheme="kv8" if int8 else "baseline"))
    full = get_model(arch, cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                     torch.float32, "cuda", tp=tp)
    local = shard_params(full, param_pspecs(full, cfg, tp=tp), policy)
    fq = fake_quant_kv if int8 else None

    rs = np.random.RandomState(1)
    lens = rs.randint(len_range[0], len_range[1] + 1, size=n_seqs)
    prompts = [rs.randint(2, cfg.vocab_size, size=n) for n in lens]
    streams = torch.as_tensor(rs.randint(2, cfg.vocab_size, (MESH_STREAMS, MESH_CHUNK * MESH_MIXED)),
                              device="cuda")
    # internvl2: each prompt behind its patch prefix
    n_p = cfg.n_vision_patches if cfg.family == "vlm" else 0
    patches = (torch.randn(n_seqs, n_p, cfg.d_vision, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
               if n_p else None)
    ctx = lens + n_p                                  # positions a prompt fills
    pmax = -(-(len_range[1] + n_p + MESH_DECODE + MESH_MIXED) // ps)
    spages = -(-MESH_CHUNK * MESH_MIXED // ps)
    b_loc, p_loc = n_seqs // nd, MESH_STREAMS // nd
    n_loc = b_loc * pmax + p_loc * spages + 1         # + the shard's trash page
    ar = torch.arange
    seq_table = torch.cat([dd * n_loc + ar(b_loc * pmax).reshape(b_loc, pmax)
                           for dd in range(nd)]).to("cuda", torch.int32)
    stream_table = torch.cat([dd * n_loc + b_loc * pmax + ar(p_loc * spages).reshape(p_loc, spages)
                              for dd in range(nd)]).to("cuda", torch.int32)
    rows, srows = range(d * b_loc, (d + 1) * b_loc), slice(d * p_loc, (d + 1) * p_loc)
    # this shard's rows: views at a row offset, which the kernels take unaligned
    bt, st = seq_table[d * b_loc:(d + 1) * b_loc], stream_table[srows]
    lens_t = torch.as_tensor(ctx[d * b_loc:(d + 1) * b_loc], device="cuda", dtype=torch.int32)
    _, KV_p, _, _, _ = T.gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    kvl = KV_p // tp

    def mixed_batch(step, tok):
        c = MESH_CHUNK
        return dict(p_tokens=streams[srows, step * c:(step + 1) * c].to(torch.int32), p_table=st,
                    p_start=torch.full((p_loc,), step * c, device="cuda", dtype=torch.int32),
                    p_lens=torch.full((p_loc,), c, device="cuda", dtype=torch.int32),
                    d_tokens=tok.to(torch.int32), d_table=bt,
                    d_lens=lens_t + MESH_DECODE + step,
                    d_active=torch.ones(b_loc, dtype=torch.bool, device="cuda"))

    # --- the mesh path: launch counters zeroed just before, read just after
    pool_shape = (cfg.n_layers, n_loc, ps, kvl, cfg.head_dim)
    kp, vp = _mesh_pool(torch, pool_shape, int8), _mesh_pool(torch, pool_shape, int8)
    rec = dict(prefill=[], decode=[], mixed=[], tokens=[])
    walls = dict(prefill=[], decode=[], mixed=[])
    coll = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_launches()
        c0 = dict(sharding.counts)
        for j, i in enumerate(rows):
            t0 = time.perf_counter()
            lg, (k, v) = cells["prefill"]["fn"](local, torch.as_tensor(prompts[i], device="cuda")[None],
                                                patches[i:i + 1] if n_p else None,
                                                kv_fake_quant=fq)
            _put(kp, k[:, 0], bt[j] % n_loc, int(ctx[i]), ps)      # pool-local page ids
            _put(vp, v[:, 0], bt[j] % n_loc, int(ctx[i]), ps)
            torch.cuda.synchronize()
            walls["prefill"].append(time.perf_counter() - t0)
            rec["prefill"].append(lg[0])
        c1 = dict(sharding.counts)
        tok = torch.stack(rec["prefill"])[:, :cfg.vocab_size].argmax(-1)
        for step in range(MESH_DECODE):
            rec["tokens"].append(tok)
            t0 = time.perf_counter()
            lg, _ = cells["decode"]["fn"](local, tok.to(torch.int32), kp, vp, bt, lens_t + step)
            tok = lg[:, :cfg.vocab_size].argmax(-1)
            torch.cuda.synchronize()
            walls["decode"].append(time.perf_counter() - t0)
            rec["decode"].append(lg)
        c2 = dict(sharding.counts)
        for step in range(MESH_MIXED):
            rec["tokens"].append(tok)
            t0 = time.perf_counter()
            pl, dl, _ = cells["mixed"]["fn"](local, mixed_batch(step, tok), kp, vp)
            tok = dl[:, :cfg.vocab_size].argmax(-1)
            torch.cuda.synchronize()
            walls["mixed"].append(time.perf_counter() - t0)
            rec["mixed"].append((pl, dl))
        launches = read_launches()
        c3 = dict(sharding.counts)
    for name, (a, b, n) in dict(prefill=(c0, c1, b_loc), decode=(c1, c2, MESH_DECODE),
                                mixed=(c2, c3, MESH_MIXED)).items():
        coll[name] = {k: (b.get(k, 0) - a.get(k, 0)) / n for k in b}
    missing = [k for k in MESH_KERNELS[pages] if not launches[k]]
    if missing:
        fail(f"phase 10 {label}: {missing} not launched: {launches}")
    del local

    # --- the one-card steps on this rank's rows, fed the mesh's tokens
    tol = MESH_INT8_TOL if int8 else MESH_LOGIT_TOL[backend]
    gaps = dict(prefill=0.0, decode=0.0, mixed=0.0)
    near_ties = []
    n_glob = nd * n_loc
    gk = _mesh_pool(torch, (cfg.n_layers, n_glob, ps, KV_p, cfg.head_dim), int8)
    gv = _mesh_pool(torch, (cfg.n_layers, n_glob, ps, KV_p, cfg.head_dim), int8)

    def check(kind, step, got, want):
        gap = _logit_gap(got, want, cfg.vocab_size)
        gaps[kind] = max(gaps[kind], gap)
        if gap > tol:
            fail(f"phase 10 {label}: {kind} step {step} logits {gap:.3e} of max |logit| "
                 f"from the one-card step (tolerance {tol})")
        g, w = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
        for r in (g.argmax(-1) != w.argmax(-1)).nonzero().flatten().tolist():
            top2 = w[r].double().topk(2).values
            margin = float((top2[0] - top2[1]) / w.abs().max())
            if not int8 or margin > gap:
                fail(f"phase 10 {label}: {kind} step {step} row {r}: greedy token differs from "
                     f"the one-card step's (its top-2 margin {margin:.3e}, logit gap {gap:.3e})")
            near_ties.append(dict(kind=kind, step=step, row=r, margin=margin, gap=gap))

    with torch.inference_mode():
        for j, i in enumerate(rows):
            lg, (k, v) = T.prefill(full, cfg, torch.as_tensor(prompts[i], device="cuda")[None],
                                   patches=patches[i:i + 1] if n_p else None, kv_fake_quant=fq)
            _put(gk, k[:, 0], bt[j], int(ctx[i]), ps)
            _put(gv, v[:, 0], bt[j], int(ctx[i]), ps)
            check("prefill", j, rec["prefill"][j], lg[0])
        for step in range(MESH_DECODE):
            lg, _ = T.decode(full, cfg, rec["tokens"][step].to(torch.int32), gk, gv, bt, lens_t + step)
            check("decode", step, rec["decode"][step], lg)
        for step in range(MESH_MIXED):
            pl, dl, _ = T.mixed(full, cfg, mixed_batch(step, rec["tokens"][MESH_DECODE + step]), gk, gv)
            check("mixed", step, rec["mixed"][step][0], pl)
            check("mixed", step, rec["mixed"][step][1], dl)
    keep = torch.arange(n_loc - 1, device="cuda")              # all but the trash page
    flips, page_gap = 0, 0.0
    for mine, glob in ((kp, gk), (vp, gv)):
        def part(pool):
            return pool[:, d * n_loc:(d + 1) * n_loc][:, keep][:, :, :, m * kvl:(m + 1) * kvl]
        if int8:
            diff = (mine["q"][:, keep].int() - part(glob["q"]).int()).abs()
            flips += int((diff == 1).sum())
            if int(diff.max()) > 1:
                fail(f"phase 10 {label}: an int8 page code differs by {int(diff.max())}")
            mine, glob = mine["s"], glob["s"]
        want = part(glob).double()
        gap = float((mine[:, keep].double() - want).abs().max() / want.abs().max())
        page_gap = max(page_gap, gap)
        if gap > (MESH_INT8_TOL if int8 else MESH_PAGE_TOL):
            fail(f"phase 10 {label}: pages {gap:.3e} of max |value| from the one-card pool")
    del full, gk, gv
    res = dict(label=label, backend=backend, mesh=[nd, tp], rank=torch.distributed.get_rank(),
               arch=arch, n_layers=cfg.n_layers, pages=pages, rows=b_loc, streams=p_loc,
               prompt_lens=[int(lens[i]) for i in rows], patches=n_p, launches=launches,
               steps=b_loc + MESH_DECODE + MESH_MIXED, logit_gap=gaps, page_gap=page_gap,
               int8_flips=flips, int8_near_ties=near_ties, prefill_wall_s=walls["prefill"],
               decode_wall_s=walls["decode"], mixed_wall_s=walls["mixed"],
               collectives_a_step=coll,
               note="collectives staged through host (gloo)" if backend == "gloo" else
               "NCCL at world size 1")
    log(f"phase 10 {json.dumps(res)}")
    return res


def mesh_state_case(torch, mesh, backend, arch, over, pages, n_seqs, len_range):
    """One mesh path of the zamba2 hybrid, rwkv6 or seamless-m4t-medium on
    this rank: a prefill of ``n_seqs`` prompts of ``len_range[0]`` tokens as
    one batch (seamless after ``encoder_seq`` frames) and MESH_DECODE greedy
    decode steps through ``launch/steps.py``'s sharded cells, f32, fp pages
    of MESH_PS tokens; launch counters zeroed before and read after.  Then
    the one-card steps on the full weights over this rank's data shard's
    rows, fed the same tokens.  Fatal: logits beyond ``MESH_LOGIT_TOL`` of
    max |logit|, a greedy token that differs, the rank's caches (pools, the
    hybrid's conv and SSM states, rwkv6's state, the cross K/V) beyond
    ``MESH_PAGE_TOL`` of max |value| of the one-card tensor's slice, on
    top of that tensor's own one-ulp floor (``one_card_ulp_floor``), after
    prefill and after decode, a kernel of ``MESH_KERNELS[family]`` not
    launched.  Every gap is logged before a failure is raised."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import param_pspecs, shard_params, shard_tensor
    from repro_torch.models import encdec, hybrid, rwkv, sharding
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    if pages != "fp" or len_range[0] != len_range[1]:
        raise ValueError(f"{arch}: fp pages and prompts of one length, not {pages} {len_range}")
    cfg = replace(get_config(arch), **over)
    fam, S, ps = cfg.family, len_range[0], MESH_PS
    policy = sharding.Policy(sharding.make_rules(), mesh)
    nd, tp, d, m = policy.size("data"), policy.tp, policy.index("data"), policy.index("model")
    label = (f"mesh {backend} {nd}x{tp} {arch}" + (f" {cfg.n_layers} layers" if over else "")
             + f" rank {torch.distributed.get_rank()}")
    cells = dict(prefill=steps.build_prefill(arch, mesh=mesh, cfg=cfg)["fn"],
                 decode=steps.build_decode(arch, mesh=mesh, cfg=cfg)["fn"])
    full = get_model(arch, cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                     torch.float32, "cuda", tp=tp)
    local = shard_params(full, param_pspecs(full, cfg, tp=tp), policy)
    b_loc = n_seqs // nd
    rows = slice(d * b_loc, (d + 1) * b_loc)
    rs = np.random.RandomState(1)
    tokens = torch.as_tensor(rs.randint(2, cfg.vocab_size, (n_seqs, S)), device="cuda")[rows]
    inputs = (tokens,)
    if fam == "encdec":
        frames = torch.randn(n_seqs, cfg.encoder_seq, cfg.d_model, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(2)) * 0.3
        inputs = (frames[rows], tokens)
    pmax = -(-(S + MESH_DECODE) // ps)
    n_loc = b_loc * pmax + 1                          # + the shard's trash page
    bt = torch.arange(b_loc * pmax, device="cuda", dtype=torch.int32).reshape(b_loc, pmax)
    bt = bt + d * n_loc                               # global page ids of this shard
    lens = torch.full((b_loc,), S, device="cuda", dtype=torch.int32)
    specs = steps.CACHE_SPECS

    def model_only(spec):        # the one-card tensors hold this shard's rows only
        return tuple(None if ax == "data" else ax for ax in spec)

    def caches(out):
        """name -> (tensor, placement) of a prefill's caches, pools built."""
        if fam == "ssm":
            return {f"state {k}": (v, specs["rwkv"][k]) for k, v in out[1].items()}
        k, v = out[1]
        pools = {}
        for name, kv in (("k pool", k), ("v pool", v)):
            kvh = kv.shape[3]
            pool = torch.zeros((kv.shape[0], n_loc, ps, kvh, cfg.head_dim), device="cuda")
            for j in range(b_loc):
                _put(pool, kv[:, j], bt[j] % n_loc, S, ps)
            pools[name] = (pool, specs["pages"])
        if fam == "hybrid":
            conv, ssm_st = out[2]
            pools.update({f"conv {n}": (c, specs["conv"][n]) for n, c in conv.items()})
            pools["ssm"] = (ssm_st, specs["ssm"])
        else:
            pools.update({"cross k": (out[2][0], specs["cross"]),
                          "cross v": (out[2][1], specs["cross"])})
        return pools

    def step(fn, params, c, tok, i, table):
        """One decode step over the caches ``c`` (written in place, rwkv6's
        state replaced) with page table ``table``; its logits."""
        if fam == "ssm":
            lg, st = fn(params, tok, {n[len("state "):]: t for n, (t, _) in c.items()})
            c.update({f"state {k}": (v, specs["rwkv"][k]) for k, v in st.items()})
            return lg
        kp, vp = c["k pool"][0], c["v pool"][0]
        if fam == "hybrid":
            conv = {n: c[f"conv {n}"][0] for n in ("x", "B", "C")}
            return fn(params, tok, conv, c["ssm"][0], kp, vp, table, lens + i)[0]
        return fn(params, tok, kp, vp, c["cross k"][0], c["cross v"][0], table, lens + i)[0]

    # --- the mesh path: launch counters zeroed just before, read just after
    walls = dict(prefill=[], decode=[])
    rec = dict(decode=[], tokens=[])
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_launches()
        c0 = dict(sharding.counts)
        t0 = time.perf_counter()
        out = cells["prefill"](local, *inputs)
        mine = caches(out)
        torch.cuda.synchronize()
        walls["prefill"].append(time.perf_counter() - t0)
        rec["prefill"] = out[0]
        prefill_caches = {n: t.clone() for n, (t, _) in mine.items()}
        c1 = dict(sharding.counts)
        tok = out[0][:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        for i in range(MESH_DECODE):
            rec["tokens"].append(tok)
            t0 = time.perf_counter()
            lg = step(cells["decode"], local, mine, tok, i, bt)
            tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            walls["decode"].append(time.perf_counter() - t0)
            rec["decode"].append(lg)
        launches = read_launches()
        c2 = dict(sharding.counts)
    coll = {name: {k: (b.get(k, 0) - a.get(k, 0)) / n for k in b}
            for name, (a, b, n) in dict(prefill=(c0, c1, 1), decode=(c1, c2, MESH_DECODE)).items()}
    missing = [k for k in MESH_KERNELS[fam] if not launches[k]]
    if missing:
        fail(f"phase 10 {label}: {missing} not launched: {launches}")
    del local

    # --- the one-card steps on this rank's rows, fed the mesh's tokens; every
    # gap is logged before a failure is raised
    gaps = dict(prefill=0.0, decode=0.0)
    cache_gaps, errors = {}, []

    def check(kind, i, got, want):
        gap = _logit_gap(got, want, cfg.vocab_size)
        gaps[kind] = max(gaps[kind], gap)
        if gap > MESH_LOGIT_TOL[backend]:
            errors.append(f"{kind} step {i} logits {gap:.3e} of max |logit| from the "
                          f"one-card step (tolerance {MESH_LOGIT_TOL[backend]})")
        if not torch.equal(got[:, :cfg.vocab_size].argmax(-1), want[:, :cfg.vocab_size].argmax(-1)):
            errors.append(f"{kind} step {i}: a greedy token differs from the one-card step's")

    def cache_gap(got, want, name, spec):
        """name -> gap of max |value| (pools: each layer too, trash pages out)."""
        part = shard_tensor(want, model_only(spec), policy, name).double()
        g = got.double()
        if name.endswith("pool"):
            g, part = g[:, :-1], part[:, :-1]
        out = {name: float((g - part).abs().max() / part.abs().max())}
        if name.endswith("pool"):
            out.update({f"{name} L{l}": float((g[l] - part[l]).abs().max() / part[l].abs().max())
                        for l in range(g.shape[0])})
        return out

    def check_caches(when, got, want):
        for name, (t, spec) in want.items():
            tol = MESH_PAGE_TOL + floor[name]
            for key, gap in cache_gap(got[name], t, name, spec).items():
                cache_gaps[f"{when} {key}"] = gap
                if gap > tol and key == name:
                    errors.append(f"{when} {name} {gap:.3e} of max |value| from the one-card "
                                  f"tensor (tolerance {MESH_PAGE_TOL} + its floor "
                                  f"{floor[name]:.3e})")

    mod = {"hybrid": hybrid, "ssm": rwkv, "encdec": encdec}[fam]
    kw = {"chunk": 64} if fam == "ssm" else {}
    with torch.inference_mode():
        ref = mod.prefill(full, cfg, *inputs, **kw)
        check("prefill", 0, rec["prefill"], ref[0])
        want = caches(ref)
        # the one-card step's own f32 floor: the same prefill with every
        # embedding value moved by one f32 ulp (x (1 +- 2^-23)), its gap to
        # the prefill's caches (the header of this phase says why)
        sign = torch.randint(0, 2, full["embed"].shape, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(3)) * 2 - 1
        moved = mod.prefill(dict(full, embed=full["embed"] * (1 + sign * 2.0 ** -23)), cfg,
                            *inputs, **kw)
        floor = {"logits": _logit_gap(moved[0], ref[0], cfg.vocab_size)}
        for name, (t, spec) in caches(moved).items():
            floor.update(cache_gap(shard_tensor(t, model_only(spec), policy, name), want[name][0],
                                   name, spec))
        del moved
        check_caches("prefill", prefill_caches, want)
        one_card = dict(hybrid=lambda *a: hybrid.decode(full, cfg, *a),
                        ssm=lambda *a: rwkv.decode(full, cfg, *a),
                        encdec=lambda *a: encdec.decode(full, cfg, *a))[fam]
        for i in range(MESH_DECODE):
            lg = step(lambda _, *a: one_card(*a), None, want, rec["tokens"][i], i, bt % n_loc)
            check("decode", i, rec["decode"][i], lg)
        check_caches("decode", {n: t for n, (t, _) in mine.items()}, want)
    del full, want, mine
    res = dict(label=label, backend=backend, mesh=[nd, tp], rank=torch.distributed.get_rank(),
               arch=arch, n_layers=cfg.n_layers, rows=b_loc, prompt_len=S,
               frames=cfg.encoder_seq if fam == "encdec" else 0, launches=launches,
               steps=1 + MESH_DECODE, logit_gap=gaps, cache_gap=cache_gaps,
               one_card_ulp_floor=floor,
               prefill_wall_s=walls["prefill"], decode_wall_s=walls["decode"],
               collectives_a_step=coll,
               note="two processes on one card, collectives staged through host (gloo)"
               if backend == "gloo" else "NCCL at world size 1")
    log(f"phase 10 {json.dumps(res)}")
    if errors:
        fail(f"phase 10 {label}: " + "; ".join(errors))
    return res


# The decode 2d scheme and the replicated decode batch (mesh_decode_case):
# a case is arch, config overrides (phase 10's cut depths), mesh shapes,
# scheme, batch.  olmoe-1b-7b's 2d scheme keeps the batch replicated over
# data with its pages data-sharded (each rank attends its shard's rows and
# gathers them) and every expert's d_ff over both axes; a batch of one row
# over 2 data shards is replicated with its caches.
MESH_DECODE_CTX = 512
GLOO_DECODE_CASES = (("olmoe-1b-7b", {"n_layers": 4}, GLOO_SHAPES, "2d", 8),
                     ("qwen3-0.6b", {}, ((2, 1),), "baseline", 1),
                     ("zamba2-7b", {"n_layers": 13}, ((2, 1),), "baseline", 1))


def mesh_decode_case(torch, mesh, backend, arch, over, scheme, B):
    """MESH_DECODE greedy decode steps of ``B`` rows through
    ``launch/steps.py``'s sharded decode cell of ``scheme`` (``2d``, or a
    batch that does not divide over the data shards), f32, from random
    pools (and the hybrid's random conv/SSM states) of MESH_DECODE_CTX
    tokens of context; launch counters zeroed before and read after.  Then
    the one-card step on the full weights and caches, every row, fed the
    same tokens.  Fatal: logits beyond ``MESH_LOGIT_TOL`` of max |logit|, a
    greedy token that differs, the rank's caches beyond ``MESH_PAGE_TOL``
    of max |value| of the one-card caches' slice, K1's decode not
    launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import shard_tensor
    from repro_torch.models import hybrid, sharding, ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    cfg = replace(get_config(arch), **over)
    model = get_model(arch, cfg)
    name, S = "phase10_decode", MESH_DECODE_CTX
    steps.SHAPES[name] = dict(kind="decode", seq=S, batch=B)
    cell = steps.build_decode(arch, name, mesh=mesh, cfg=cfg, scheme=scheme)
    shard = steps._Shard(model, mesh, batch=B, scheme=scheme)
    policy = shard.policy
    nd, tp = policy.size("data"), policy.tp
    label = (f"mesh {backend} {nd}x{tp} {arch}" + (f" {cfg.n_layers} layers" if over else "")
             + f" decode {scheme} B={B} rank {torch.distributed.get_rank()}")
    g = torch.Generator(device="cuda").manual_seed(3)
    full = model.init(torch.Generator(device="cuda").manual_seed(0), torch.float32, "cuda", tp=tp)
    local = shard.slice(full)
    n_layers = hybrid.group_structure(cfg)[0] if cfg.family == "hybrid" else None
    pg_shape, pmax = steps._page_pool_shapes(cfg, B, S, n_layers=n_layers, tp=tp,
                                             n_data=shard.cache_data)

    def spec_of(spec):
        return spec if shard.caches_sharded else tuple(None if a == "data" else a for a in spec)

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda") * 0.5
    glob = {"kpool": (rand(pg_shape), steps.CACHE_SPECS["pages"]),
            "vpool": (rand(pg_shape), steps.CACHE_SPECS["pages"])}
    if cfg.family == "hybrid":
        cs, ss = ssm.mamba2_state_shapes(cfg, B)
        n_mamba = hybrid.group_structure(cfg)[1]
        glob.update({f"conv {k}": (rand((n_mamba,) + v), steps.CACHE_SPECS["conv"][k])
                     for k, v in cs.items()})
        glob["ssm"] = (rand((n_mamba,) + ss), steps.CACHE_SPECS["ssm"])
    mine = {k: shard_tensor(v, spec_of(sp), policy) for k, (v, sp) in glob.items()}
    bt = steps._tables(g, B, pmax, pg_shape[1], "cuda", shard.cache_data)
    lens = (S - 1 - 3 * torch.arange(B, device="cuda")).to(torch.int32)

    def run(params, c, tok, step, fn):
        if cfg.family == "hybrid":
            conv = {k: c[f"conv {k}"] for k in ("x", "B", "C")}
            return fn(params, tok, conv, c["ssm"], c["kpool"], c["vpool"], shard.rows(bt),
                      shard.rows(lens) + step)[0]
        return fn(params, tok, c["kpool"], c["vpool"], shard.rows(bt), shard.rows(lens) + step)[0]

    one_card = ((lambda p, t, cv, sm, kp, vp, b, ln: hybrid.decode(p, cfg, t, cv, sm, kp, vp,
                                                                     b, ln))
                if cfg.family == "hybrid" else
                (lambda p, t, kp, vp, b, ln: T.decode(p, cfg, t, kp, vp, b, ln)))
    tok = torch.randint(2, cfg.vocab_size, (B,), generator=g, device="cuda", dtype=torch.int32)
    toks, logits, walls = [], [], []
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_launches()
        c0 = dict(sharding.counts)
        for step in range(MESH_DECODE):
            toks.append(tok)
            t0 = time.perf_counter()
            lg = run(local, mine, shard.rows(tok), step, cell["fn"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logits.append(lg)
            tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        launches = read_launches()
        coll = {k: (v - c0.get(k, 0)) / MESH_DECODE for k, v in sharding.counts.items()
                if v - c0.get(k, 0)}
        errors, gaps = [], dict(decode=0.0, caches=0.0)
        want_c = {k: v for k, (v, _) in glob.items()}
        for step in range(MESH_DECODE):
            want = run(full, want_c, toks[step], step, one_card)
            gap = _logit_gap(logits[step], want, cfg.vocab_size)
            gaps["decode"] = max(gaps["decode"], gap)
            if gap > MESH_LOGIT_TOL[backend]:
                errors.append(f"step {step} logits {gap:.3e} of max |logit|")
            if not torch.equal(logits[step][:, :cfg.vocab_size].argmax(-1),
                               want[:, :cfg.vocab_size].argmax(-1)):
                errors.append(f"step {step}: a greedy token differs from the one-card step's")
        for k, (v, sp) in glob.items():
            w = shard_tensor(v, spec_of(sp), policy).double()
            gap = float((mine[k].double() - w).abs().max() / w.abs().max())
            gaps["caches"] = max(gaps["caches"], gap)
            if gap > MESH_PAGE_TOL:
                errors.append(f"{k} {gap:.3e} of max |value| from the one-card caches")
    res = dict(label=label, backend=backend, mesh=[nd, tp], rank=torch.distributed.get_rank(),
               arch=arch, n_layers=cfg.n_layers, scheme=scheme, batch=B, context=S,
               batch_sharded=shard.batch_sharded, caches_sharded=shard.caches_sharded,
               note_of_cell=cell["note"], launches=launches, steps=MESH_DECODE,
               launches_per_step={k: v / MESH_DECODE for k, v in launches.items() if v},
               gaps=gaps, decode_wall_s=walls, collectives_a_step=coll,
               note="collectives staged through host (gloo)")
    log(f"phase 10 {json.dumps(res)}")
    if not launches["paged_attention_decode"]:
        errors.append(f"K1's decode not launched: {launches}")
    if errors:
        fail(f"phase 10 {label}: " + "; ".join(errors))
    del full, local, glob, mine
    return res


# phase 11: mesh training.  A case: arch, config overrides (a cut depth),
# mesh shape, scheme, B, T, steps, microbatch (0: none).  The zamba2
# hybrid runs one group of its layer-units (5 Mamba2 + the shared
# attention block), rwkv6 2 of its 32 layers, seamless-m4t-medium whole
# after 1024 frames, their all-zero leaves drawn random
# (``nonzero_leaves``); qwen3's microbatched case takes its rows of each
# microbatch of 2 (one a data shard).  Every case logs the one-card
# step's own one-ulp floor beside its gaps (``one_ulp_floor``).
# rwkv6 at the reference's own init is phase 11's witness
# (``mesh_witness_rank``).
TRAIN_NCCL_CASES = (("qwen3-0.6b", {}, (1, 1), "tp", 4, 512, 3, 0),
                    ("zamba2-7b", {"n_layers": 6}, (1, 1), "tp", 2, 256, 2, 0))
TRAIN_GLOO_CASES = (("qwen3-0.6b", {"n_layers": 4}, (1, 2), "tp", 4, 256, 2, 0),
                    ("qwen3-0.6b", {"n_layers": 4}, (2, 1), "tp", 4, 256, 2, 0),
                    ("qwen3-0.6b", {"n_layers": 4}, (1, 2), "fsdp", 4, 256, 2, 0),
                    ("olmoe-1b-7b", {"n_layers": 2}, (1, 2), "tp", 2, 256, 2, 0),
                    ("olmoe-1b-7b", {"n_layers": 2}, (2, 1), "tp", 2, 256, 2, 0),
                    ("zamba2-7b", {"n_layers": 6}, (1, 2), "tp", 2, 256, 2, 0),
                    ("rwkv6-7b", {"n_layers": 2}, (1, 2), "tp", 2, 256, 2, 0),
                    ("seamless-m4t-medium", {}, (1, 2), "tp", 2, 256, 2, 0),
                    ("seamless-m4t-medium", {}, (2, 1), "tp", 2, 256, 2, 0),
                    ("qwen3-0.6b", {"n_layers": 4}, (2, 1), "tp", 4, 256, 2, 2))
TRAIN_MESH_TOL = dict(loss=1e-5, gnorm=1e-5, grad=1e-4, params=1e-4)
# At each step the loss, the gradient norm and each gradient leaf are
# held to TRAIN_MESH_TOL, or to TRAIN_FLOOR_MULT times that quantity's
# own one-card floor in the same step where that is larger
# (``one_ulp_floor``: the one-card step's move when every param moves by
# one f32 ulp; a mesh's differently shaped GEMMs round several ulps
# apart).  A leaf whose floor is under TRAIN_MESH_TOL / TRAIN_FLOOR_MULT
# is held to TRAIN_MESH_TOL alone; the params after each step always
# are.  Each case logs the quantities held above TRAIN_MESH_TOL
# (``floor_bound``).
TRAIN_FLOOR_MULT = 4


def train_bound(key, floor):
    """The bound of a phase-11 gap of kind ``key`` (loss, gnorm, grad)
    whose one-card one-ulp floor in the same step is ``floor``."""
    return max(TRAIN_MESH_TOL[key], TRAIN_FLOOR_MULT * floor)


# the kernels each family's training path must launch on its ranks (the
# WKV scan of rwkv6 is no hand-written kernel)
TRAIN_MESH_KERNELS = {"dense": ("flash_attention_lse",), "moe": ("flash_attention_lse",),
                      "vlm": ("flash_attention_lse",), "encdec": ("flash_attention_lse",),
                      "hybrid": ("flash_attention_lse", "ssd_scan", "ssd_scan_bwd"),
                      "ssm": ()}


def shard_moe_fn(torch, cfg, n_data, d):
    """The one-card counterpart of the mesh's MoE hook at ``n_data`` data
    shards: each shard's rows routed over their own capacity; the aux
    loss's value data shard ``d``'s, its gradient that of the shards'
    mean (the mesh's and the reference's)."""
    from repro_torch.models.layers import act_fn
    from repro_torch.models.moe import moe_apply
    act = act_fn("silu" if cfg.mlp_act == "silu" else "gelu")

    def fn(lp, x2d):
        ys, auxs = [], []
        for part in x2d.chunk(n_data):
            y, a = moe_apply(lp, part, n_experts=cfg.n_experts, top_k=cfg.top_k, act=act,
                             capacity_factor=cfg.moe_capacity_factor)
            ys.append(y)
            auxs.append(a)
        mean = torch.stack(auxs).mean()
        return torch.cat(ys), mean + (auxs[d] - mean).detach()
    return fn


def mesh_train_case(torch, mesh, backend, arch, over, scheme, B, T, n_steps, micro=0):
    """One phase-11 case on this rank (see the header): the mesh's train
    steps, each checked against the one-card step on the full state (with
    ``micro``, both accumulate microbatches of that many rows, the mesh
    over its rows of each)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_train_data_fn
    from repro_torch.launch import steps
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import sharding
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw_init, clip_by_global_norm
    from repro_torch.train.trainer import apply_grads, init_state, make_grad_fn, take_rows
    cfg = replace(get_config(arch), **over)
    model = get_model(arch, cfg)
    tp, policy, moe_fn = steps.train_mesh(model, mesh, scheme)
    nd, nm = policy.size("data"), policy.size("model")
    label = (f"mesh train {backend} {nd}x{nm} {scheme} {arch}"
             + (f" {cfg.n_layers} layers" if over else "") + (f" micro {micro}" if micro else "")
             + f" rank {torch.distributed.get_rank()}")
    tcfg = TrainConfig(global_batch=B, seq_len=T, warmup_steps=0, total_steps=10,
                       remat=True, loss_impl="chunked", microbatch=micro)
    full = init_state(model, torch.Generator(device="cuda").manual_seed(0), tcfg,
                      device="cuda", tp=tp)
    if cfg.family in ("hybrid", "ssm", "encdec"):
        full["params"] = nonzero_leaves(torch, full["params"])
    specs = policy.params
    local = {"params": shard_params(full["params"], specs, policy)}
    local["opt"] = adamw_init(local["params"], False, specs, policy)
    names = leaf_names(local["params"])
    data_fn = make_train_data_fn(cfg, tcfg)
    one_moe = shard_moe_fn(torch, cfg, nd, policy.index("data")) if cfg.is_moe else None
    one_grad = make_grad_fn(model, tcfg, tp=tp, moe_fn=one_moe)
    mesh_grad = make_grad_fn(model, tcfg, tp=tp, policy=policy, moe_fn=moe_fn)
    gaps = dict(loss=0.0, gnorm=0.0, grad=0.0, params=0.0)
    floors = dict(loss=0.0, gnorm=0.0, grad=0.0)
    grad_leaf, walls, mesh_launches, coll, step_gaps = "", [], {}, {}, []
    floor_bound, errors = {}, []
    torch.cuda.reset_peak_memory_stats()

    def one_card_step(batch):
        """The one-card step on the full state: (loss, gnorm, each leaf's max
        |g|, the gradients sliced to this rank's shards, the one-ulp floor
        of the loss, gnorm and each gradient leaf); the full gradients
        freed."""
        nonlocal full
        l1, g1 = one_grad(full["params"], batch)
        gmax = {n: float(g.abs().max()) for n, g in zip(names, _leaves(g1))}
        floor = one_ulp_floor(torch, one_grad, full["params"], batch, l1, g1, gmax, tcfg)
        g1_local = shard_params(g1, specs, policy)
        full, gn1, _ = apply_grads(tcfg, full, g1)
        return l1, gn1, gmax, g1_local, floor

    def hold(i, kind, name, gap, floor):
        """Step ``i``'s gap of ``kind`` (loss, gnorm, grad: of leaf ``name``)
        against its bound from this step's floor."""
        bound = train_bound(kind, floor)
        if bound > TRAIN_MESH_TOL[kind]:
            floor_bound[f"{name} step {i}"] = [gap, floor, bound]
        if not gap <= bound:
            errors.append(f"step {i} {name} {gap:.3e} beyond {bound:.3e} (one-card floor "
                          f"{floor:.3e})")

    for i in range(n_steps):
        batch = {k: v.to("cuda") for k, v in data_fn(i).items()}
        l1, gn1, gmax, g1_local, floor = in_turns(torch, one_card_step, batch)
        rows = take_rows(batch, policy, micro)
        torch.cuda.synchronize()
        zero_launches()
        c0 = dict(sharding.counts)
        t0 = time.perf_counter()
        lm, gm = mesh_grad(local["params"], rows)
        local = apply_grads(tcfg, local, g1_local, policy)[0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for k, v in read_launches().items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        for k, v in sharding.counts.items():
            coll[k] = coll.get(k, 0) + (v - c0.get(k, 0)) / n_steps
        gnm = clip_by_global_norm(gm, tcfg.grad_clip, specs, policy)[1]   # its own gradients
        torch.cuda.empty_cache()          # for the other rank's one-card step
        step = dict(loss=abs(float(lm) - float(l1)) / abs(float(l1)),
                    gnorm=abs(float(gnm) - float(gn1)) / abs(float(gn1)), grad=0.0,
                    floor_loss=floor["loss"], floor_gnorm=floor["gnorm"],
                    floor_grad=max(floor["grad"].values()))
        hold(i, "loss", "loss", step["loss"], floor["loss"])
        hold(i, "gnorm", "gnorm", step["gnorm"], floor["gnorm"])
        for n, a, b in zip(names, _leaves(gm), _leaves(g1_local)):
            gap = float((a - b).abs().max()) / max(gmax[n], 1e-30)
            hold(i, "grad", n, gap, floor["grad"][n])
            step["grad"] = max(step["grad"], gap)
            if gap >= gaps["grad"]:
                gaps["grad"], grad_leaf = gap, n
        step_gaps.append(step)
        for k in ("loss", "gnorm"):
            gaps[k] = max(gaps[k], step[k])
        for k in floors:
            floors[k] = max(floors[k], step[f"floor_{k}"])
        want = shard_params(full["params"], specs, policy)
        gaps["params"] = max(gaps["params"], max(
            float((a - b).abs().max()) for a, b in zip(_leaves(local["params"]),
                                                      _leaves(want))))
        del gm, g1_local, want
    if not gaps["params"] <= TRAIN_MESH_TOL["params"]:
        errors.append(f"params {gaps['params']:.3e} beyond {TRAIN_MESH_TOL['params']}")
    missing = [k for k in TRAIN_MESH_KERNELS[cfg.family] if not mesh_launches.get(k)]
    if missing:
        errors.append(f"{missing} not launched: {mesh_launches}")
    res = dict(label=label, backend=backend, mesh=[nd, nm], scheme=scheme, tp=tp,
               rank=torch.distributed.get_rank(), arch=arch, n_layers=cfg.n_layers,
               batch=B, seq=T, microbatch=micro, steps=n_steps,
               step_wall_s=walls, gaps=gaps, step_gaps=step_gaps, grad_leaf=grad_leaf,
               one_card_ulp_floor=floors, floor_bound=floor_bound, errors=errors,
               collectives_a_step={k: v for k, v in coll.items() if v},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: v for k, v in mesh_launches.items() if v},
               launches_per_step={k: v / n_steps for k, v in mesh_launches.items() if v},
               note=("collectives staged through host (gloo); the peak holds the one-card "
                     "state too" if backend == "gloo" else
                     "NCCL at world size 1; the peak holds the one-card state too"))
    log(f"phase 11 {json.dumps(res)}")
    del full, local
    return res


def train_errors(train):
    """Fail the run if a phase-11 case (each logged first) failed."""
    bad = [f"{r['label']}: " + "; ".join(r["errors"]) for r in train if r["errors"]]
    if bad:
        fail(f"phase 11, held to {TRAIN_MESH_TOL} or {TRAIN_FLOOR_MULT} x the one-card "
             f"step's one-ulp floor: " + " | ".join(bad))


def nonzero_leaves(torch, params):
    """``params`` with every all-zero leaf (norm scales, the hybrid's LoRA
    ``*b``, rwkv6's ``u``) drawn from N(0, 0.1^2), seeded, as the CPU tests
    of the mesh draw them: each sharded piece then moves the step."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def fix(t):
        return t + torch.randn(t.shape, generator=g, device="cuda") * 0.1 if not t.any() else t
    return {k: nonzero_leaves(torch, v) if isinstance(v, dict) else fix(v)
            for k, v in params.items()}


def one_ulp_floor(torch, grad_fn, params, batch, loss, grads, gmax, tcfg):
    """The one-card step's own f32 floor: the gaps of its loss, gradient
    norm and of each gradient leaf (of that leaf's max |g|, by name) when
    every parameter moves by one f32 ulp (times 1 + 2^-24, the sign drawn
    from a fixed seed).  A well-conditioned step moves ~1e-6 of max |g|
    (qwen3-0.6b); a step whose rounding the model amplifies moves more,
    and a mesh's differently shaped GEMMs move it more than one ulp does
    (``TRAIN_FLOOR_MULT``)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.optim import clip_by_global_norm
    g = torch.Generator(device=next(iter(_leaves(params))).device).manual_seed(7)
    moved = tree_map(lambda p: p * (1 + 2.0 ** -24 * (2 * torch.randint(
        0, 2, p.shape, generator=g, device=p.device) - 1)), params)
    l2, g2 = grad_fn(moved, batch)
    del moved
    gn1 = clip_by_global_norm(grads, tcfg.grad_clip)[1]
    gn2 = clip_by_global_norm(g2, tcfg.grad_clip)[1]
    grad = {n: float((a - b).abs().max()) / max(gmax[n], 1e-30)
            for n, a, b in zip(gmax, _leaves(grads), _leaves(g2))}
    del g2
    return dict(loss=abs(float(l2) - float(loss)) / abs(float(loss)),
                gnorm=abs(float(gn2) - float(gn1)) / abs(float(gn1)), grad=grad)


def in_turns(torch, fn, *args):
    """``fn(*args)`` on each rank of the world in turn, the cache released
    after each: the gloo ranks share the one card, and each one-card
    step holds a second full training state while it runs (olmoe-1b-7b's
    two full-width layers: ~13 GB of f32 state, as much again while AdamW
    writes the new one)."""
    out = None
    for r in range(torch.distributed.get_world_size()):
        if r == torch.distributed.get_rank():
            out = fn(*args)
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return out


@contextlib.contextmanager
def f64_floats(torch):
    """``Tensor.float()`` keeps float64 tensors as they are: the port's
    paths that upcast to f32 with ``.float()`` then run a float64 state
    in float64 end to end (the witness below; no kernel of rwkv6's path
    is bypassed, it has none)."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else orig(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = orig


# phase 11's witness: rwkv6's first mesh step in f64, held to
# MESH_F64_TOL (f64 rounds 2^29 times finer than f32: a sharding fault
# stands out by orders of magnitude), at the reference's own init and
# with its all-zero leaves drawn (``nonzero_leaves``)
MESH_F64_TOL = 1e-9


def mesh_witness_rank(rank, world, rdv, out_dir):
    """rwkv6-7b at 2 layers, gloo (1, 2) ``tp``, B = 2 x T = 256 (phase
    11's case): the first step's gradients of the mesh and of the one
    card, in f32 and in f64, at the reference's own init and with its
    zero leaves drawn.  Per leaf, of the
    f64 one-card leaf's max |g|: mesh against one card in f64 (held to
    MESH_F64_TOL, as the loss) and in f32 (phase 11's gap), each f32
    step against the f64 one-card step (its own f32 error, also of the
    one card a row at a time), and each f32 step against itself run again
    (the card's run-to-run rounding)."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.tree import tree_map, tree_zip_map
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_train_data_fn
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import init_state, make_grad_fn, take_rows
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=rdv, rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, 2), device_type="cuda", backend="gloo")
        cfg = replace(get_config("rwkv6-7b"), n_layers=2)
        model = get_model("rwkv6-7b", cfg)
        tp, policy, moe_fn = steps.train_mesh(model, mesh, "tp")
        specs = policy.params
        tcfg = TrainConfig(global_batch=2, seq_len=256, warmup_steps=0, total_steps=10,
                           remat=True, loss_impl="chunked")
        batch = {k: v.to("cuda") for k, v in make_train_data_fn(cfg, tcfg)(0).items()}
        rows = take_rows(batch, policy, 0)
        one_grad = make_grad_fn(model, tcfg, tp=tp)
        mesh_grad = make_grad_fn(model, tcfg, tp=tp, policy=policy, moe_fn=moe_fn)
        init = init_state(model, torch.Generator(device="cuda").manual_seed(0), tcfg,
                          device="cuda", tp=tp)["params"]
        names = leaf_names(init)
        pairs = {"mesh_vs_one_f64": ("mesh_f64", "one_f64"),
                 "mesh_vs_one_f32": ("mesh_f32", "one_f32"),
                 "one_f32_error": ("one_f32", "one_f64"),
                 "mesh_f32_error": ("mesh_f32", "one_f64"),
                 "one_f32_rerun": ("one_f32", "one_f32_rerun"),
                 "mesh_f32_rerun": ("mesh_f32", "mesh_f32_rerun"),
                 "one_rows_f32_error": ("one_rows_f32", "one_f64")}

        def one(p):
            l1, g1 = one_grad(p, batch)
            return float(l1), list(_leaves(shard_params(g1, specs, policy))), [
                float(x.abs().max()) for x in _leaves(g1)]

        def one_rows(p):
            """The one-card gradient a row at a time (the rows' mean: each
            row holds as many tokens), sliced to this rank's shards."""
            ga, gb = (one_grad(p, {k: v[j:j + 1] for k, v in batch.items()})[1]
                      for j in range(2))
            mean = tree_zip_map(lambda a, b: (a + b) / 2, ga, gb)
            return list(_leaves(shard_params(mean, specs, policy)))
        out = []
        for variant in ("reference init", "zero leaves drawn"):
            p32 = init if variant == "reference init" else nonzero_leaves(torch, init)
            g, loss = {}, {}
            for dt in ("f32", "f32_rerun", "f64"):
                with f64_floats(torch):
                    p = p32 if dt != "f64" else tree_map(lambda t: t.double(), p32)
                    loss[f"one_{dt}"], g[f"one_{dt}"], gmax = in_turns(torch, one, p)
                    lm, gm = mesh_grad(shard_params(p, specs, policy), rows)
                    loss[f"mesh_{dt}"], g[f"mesh_{dt}"] = float(lm), list(_leaves(gm))
                    if dt == "f32":
                        g["one_rows_f32"] = in_turns(torch, one_rows, p)
                    del p, gm
                torch.cuda.empty_cache()
            leaves = {n: {k: float((g[a][j].double() - g[b][j].double()).abs().max())
                          / max(gmax[j], 1e-300) for k, (a, b) in pairs.items()}
                      for j, n in enumerate(names)}
            worst = {k: max(names, key=lambda n: leaves[n][k]) for k in pairs}
            loss_f64 = abs(loss["mesh_f64"] - loss["one_f64"]) / abs(loss["one_f64"])
            errors = [f"f64 {k} {v:.3e}" for k, v in (
                ("loss", loss_f64), (worst["mesh_vs_one_f64"],
                                     leaves[worst["mesh_vs_one_f64"]]["mesh_vs_one_f64"]))
                if not v <= MESH_F64_TOL]
            res = dict(label=f"mesh witness rwkv6-7b 2 layers gloo 1x2 tp {variant} rank {rank}",
                       loss=loss, worst={k: [n, leaves[n][k]] for k, n in worst.items()},
                       leaves={n: v for n, v in leaves.items() if max(v.values()) > 1e-5},
                       errors=errors)
            log(f"witness {json.dumps(res)}")
            out.append(res)
            del g, p32
            torch.cuda.empty_cache()
        del init
        Path(out_dir, f"witness{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_mesh_witness():
    """``mesh_witness_rank`` on two gloo ranks on the card; fails the run
    if the mesh's f64 step strays from the one card's."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(mesh_witness_rank, args=(2, f"file://{tmp}/rdv", tmp), nprocs=2, join=True)
        res = [r for k in range(2) for r in json.loads(Path(tmp, f"witness{k}.json").read_text())]
    log(f"time phase 11 witness: {time.perf_counter() - t0:.1f} s")
    bad = [f"{r['label']}: " + "; ".join(r["errors"]) for r in res if r["errors"]]
    if bad:
        fail(f"phase 11 witness, held to {MESH_F64_TOL} in f64: " + " | ".join(bad))
    return res


def mesh_run(torch, mesh, backend, case):
    """One case of phase 10's lists on this rank: the transformer family
    through ``mesh_case``, the others through ``mesh_state_case``."""
    from repro_torch.configs import get_config
    arch, over, _, pages, n, len_range = case
    fn = mesh_case if get_config(arch).family in ("dense", "moe", "vlm") else mesh_state_case
    return fn(torch, mesh, backend, arch, over, pages, n, len_range)


def mesh_rank(rank, world, init, out_dir):
    """One of phase 10's gloo ranks on the one card: every ``GLOO_CASES``
    case, its results to ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        results = []
        meshes = {shape: make_mesh(shape, device_type="cuda", backend="gloo")
                  for shape in GLOO_SHAPES}
        for case in GLOO_CASES:
            for shape in case[2]:
                results.append(mesh_run(torch, meshes[shape], "gloo", case))
                gc.collect()
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for arch, over, shapes, scheme, B in GLOO_DECODE_CASES:
            for shape in shapes:
                results.append(mesh_decode_case(torch, meshes[shape], "gloo", arch, over,
                                                scheme, B))
                gc.collect()
                torch.cuda.empty_cache()
        log(f"time phase 10 decode 2d and replicated, gloo rank {rank}: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train = []
        for arch, over, shape, *rest in TRAIN_GLOO_CASES:
            train.append(mesh_train_case(torch, meshes[shape], "gloo", arch, over, *rest))
            gc.collect()
            torch.cuda.empty_cache()
        log(f"time phase 11 gloo rank {rank}: {time.perf_counter() - t0:.1f} s")
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(results))
        Path(out_dir, f"train{rank}.json").write_text(json.dumps(train))
        train_errors(train)
    finally:
        dist.destroy_process_group()


def phase_mesh(torch):
    """Phases 10 and 11: NCCL at one rank in this process, then two gloo
    ranks spawned on the card, each running the serving cases, then the
    training cases.  Returns each rank's serving path (label -> launches
    and steps) for the kernels line, and phase 11's results (label ->
    result)."""
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    from repro_torch.launch.mesh import make_mesh
    results = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv", rank=0, world_size=1)
        try:
            for case in NCCL_CASES:
                for shape in case[2]:
                    results.append(mesh_run(torch, make_mesh(shape), "nccl", case))
                    gc.collect()
                    torch.cuda.empty_cache()
            t1 = time.perf_counter()
            train = [mesh_train_case(torch, make_mesh(shape), "nccl", arch, over, *rest)
                     for arch, over, shape, *rest in TRAIN_NCCL_CASES]
            log(f"time phase 11 nccl: {time.perf_counter() - t1:.1f} s")
            train_errors(train)
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"time phase 10 nccl: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.spawn(mesh_rank, args=(2, f"file://{tmp}/rdv", tmp), nprocs=2, join=True)
        except ProcessException as e:            # a rank's failure fails the run
            fail(f"phase 10: a gloo rank failed: {e}")
        for r in range(2):
            results += json.loads(Path(tmp, f"rank{r}.json").read_text())
            train += json.loads(Path(tmp, f"train{r}.json").read_text())
    log(f"time phases 10-11 gloo (two ranks on the card): {time.perf_counter() - t1:.1f} s")
    phase_mesh_witness()
    return {r["label"]: r for r in results}, {r["label"]: r for r in train}


# ------------------------------------------------------------------ main ---
KERNELS = {
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        decode_source="src/repro_torch/kernels/csrc/paged_decode.cuh",
        chunk_source="src/repro_torch/kernels/csrc/paged_tiles.cuh",
        f32_chunk_source="src/repro_torch/kernels/csrc/paged_tiles_f32.cuh",
        replaces="src/repro/kernels/paged_attention.py:109",
        replaces_function="src/repro/kernels/paged_attention.py::paged_attention",
        headline=("decode B=16 C=1", "bfloat16"), library="scaled_dot_product_attention"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        f32_source="src/repro_torch/kernels/csrc/tf32_common.cuh",
        replaces="src/repro/kernels/flash_attention.py:95",
        replaces_function="src/repro/kernels/flash_attention.py::flash_attention",
        headline=("prefill B=4 T=1024", "bfloat16"), library="scaled_dot_product_attention"),
    "paged_attention_int8": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention_int8.cu",
        decode_source="src/repro_torch/kernels/csrc/paged_decode.cuh",
        chunk_source="src/repro_torch/kernels/csrc/paged_tiles.cuh",
        f32_chunk_source="src/repro_torch/kernels/csrc/paged_tiles_f32.cuh",
        replaces="src/repro/kernels/paged_attention_int8.py:111",
        replaces_function="src/repro/kernels/paged_attention_int8.py::paged_attention_int8",
        headline=("decode B=16 C=1", "bfloat16"),
        library="two calls: torch.mul dequantize + scaled_dot_product_attention"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        tiles_source="src/repro_torch/kernels/csrc/ssd_tiles.cuh",
        f32_tiles_source="src/repro_torch/kernels/csrc/ssd_tiles_f32.cuh",
        replaces="src/repro/kernels/ssd_scan.py:64",
        replaces_function="src/repro/kernels/ssd_scan.py::ssd_chunk_scan",
        headline=("prefill B=8 T=1024 H=112", "bfloat16"),
        library="none (no single PyTorch call computes the scan)"),
    # K4's backward: the Pallas kernel has none; the reference trains
    # through the gradient XLA derives from its jnp scan
    "ssd_scan_bwd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        kernels_source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cuh",
        bf16_source="src/repro_torch/kernels/csrc/ssd_scan_bwd_bf16.cu",
        replaces="src/repro/kernels/ssd_scan.py:88",
        replaces_function="the gradient of src/repro/models/ssm.py::mamba2_chunk_scan "
                          "(the Pallas kernel src/repro/kernels/ssd_scan.py::ssd_chunk_scan "
                          "has no backward)",
        headline=("train B=4 T=1024 H=112", "float32"), train_only=True,
        library="none (no single PyTorch call computes the scan's backward)"),
}


# the launch counter of each kernel on phase 11's training paths: K2's
# training forward, K4's forward and backward
MESH_TRAIN_COUNTER = {"flash_attention": "flash_attention_lse", "ssd_scan": "ssd_scan",
                      "ssd_scan_bwd": "ssd_scan_bwd"}


def train_launches(train, cases, kname):
    """Training launches in the kernels line: K2's training forward (its
    launches on both training paths and its case at the qwen3 path's
    shape, f32), K4's forward (its launches on the hybrid's path)."""
    paths = {f"train {train[k]['arch']}": train[k] for k in ("main_path", "hybrid_path")}
    if kname == "ssd_scan":
        n = train["hybrid_path"]["launches"]["ssd_scan"]
        return dict(launches_train=n, launches_train_per_step=n / train["hybrid_path"]["steps"])
    by_path = {p: v["launches"]["flash_attention_lse"] for p, v in paths.items()}
    c = next(c for c in cases if c["case"] == "train lse qwen3 B=4 T=512"
             and c["dtype"] == "float32")
    return dict(launches_lse=sum(by_path.values()), launches_lse_by_path=by_path,
                launches_lse_per_step={p: by_path[p] / v["steps"] for p, v in paths.items()},
                lse_case=f"{c['case']} float32", lse_ms=c["ms"], lse_device_ms=c["device_ms"],
                lse_plain_ms=c["plain_ms"], lse_bound_ms=c["bound_ms"],
                lse_bound_by=c["bound_by"], lse_bound_cuda_core_ms=c["bound_cuda_core_ms"],
                lse_max_abs_err=c["max_abs_err"],
                lse_rel_err=c["lse_rel_err"], lse_bwd_ms=c["bwd_ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (phases 1-3)")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then the training phase only (phases 1, 2 and 7)")
    ap.add_argument("--roofline-only", action="store_true",
                    help="build, then the roofline phase only (phases 1, 2 and 8)")
    ap.add_argument("--sampling-only", action="store_true",
                    help="build, then the sampled-decoding phase only (phases 1, 2 and 9)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, then the mesh phases only (phases 1, 2, 10 and 11)")
    ap.add_argument("--train-determinism", metavar="DIR",
                    help=argparse.SUPPRESS)   # phase 7's subprocess (train_determinism)
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
    if args.train_determinism:
        train_determinism(torch, Path(args.train_determinism))
        return 0
    t_start = time.perf_counter()
    full = not (args.quick or args.train_only or args.roofline_only or args.sampling_only
                or args.mesh_only)
    import os
    # work that needs neither the kernels nor the card starts now, beside
    # the build and phase 3: phase 4's CPU sides and the lint
    workers = max(1, len(os.sched_getaffinity(0)) - 2)
    cpu = CrossCPU(workers) if full else None
    lint = start_lint() if full else None

    # 1. environment
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi()
    log(f"device: {name} count={count} nvidia-smi: {card} torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"host: {len(os.sched_getaffinity(0))} CPUs; torch threads {torch.get_num_threads()}"
        + (f", phase 4's CPU worker's {workers}" if full else ""))

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.KERNELS)} kernels")
    for kname, info in build.build_log.items():
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"ptxas {kname}: {line.strip()}")

    if args.train_only:
        phase_train(torch)
        log(f"training-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.roofline_only:
        phase_roofline(torch)
        log(f"roofline-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.sampling_only:
        phase_sampling(torch)
        log(f"sampling-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.mesh_only:
        phase_mesh(torch)
        log(f"mesh-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 3. kernels against their plain versions
    for lib, kernel, dtype, smem_symbol, blocks_symbol in TC_KERNELS:
        log(f"{kernel} {dtype} tensor-core instantiations (ptxas -v): "
            + json.dumps(tc_resources(lib, kernel, dtype, smem_symbol, blocks_symbol)))
    for lib, kernel, params in DECODE_KERNELS:
        log(f"{kernel} split-KV decode instantiations (ptxas -v): "
            + json.dumps(decode_resources(lib, kernel, params)))
    log("K4 forward ssd_scan_kernel_{tc,f32} instantiations (ptxas -v): "
        + json.dumps(ssd_resources()))
    log("K4 backward ssd_bwd_{states,chunks}_kernel instantiations (ptxas -v): "
        + json.dumps(ssd_bwd_resources()))
    cases = phase_kernels(torch, iters=KERNEL_ITERS)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    if args.quick:
        log(f"quick check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 4. cross-device checks; the serving launcher runs beside them
    launcher = start_launcher()
    timed("phase 4 engine checks", phase_cross_device, torch, cpu)
    timed("phase 4 hybrid", phase_hybrid_cross_device, torch, cpu)
    timed("phase 4 internvl2-2b", phase_vlm_cross_device, torch, cpu)
    timed("phase 4 rwkv6 and seamless", phase_model_level_cross_device, torch)
    cpu.proc.join(timeout=60)
    log(f"phase 4's CPU worker exit code: {cpu.proc.exitcode}")
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # 5. the main paths, then the dispatch sentinel on opt-125m's engine
    paths, setup = timed("phase 5 qwen3-0.6b", phase_main_path, torch)
    family, setups = timed("phase 5 family", phase_family_paths, torch)
    paths.update(family)
    log("modes " + json.dumps({k: v["per_mode"] for k, v in paths.items() if "per_mode" in v}))
    paths["hybrid"], hybrid_setup = timed("phase 5 zamba2-7b", phase_hybrid_path, torch)
    paths["rwkv6-7b"], rwkv_window = timed("phase 5 rwkv6-7b", phase_rwkv_path, torch)
    paths["seamless-m4t-medium"], seamless_window = timed(
        "phase 5 seamless-m4t-medium", phase_seamless_path, torch)
    phase_launcher(launcher)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    phase_sentinel(torch, setups["opt-125m"])
    log(f"sentinel phase done at {time.perf_counter() - t_start:.1f} s")

    # 6. where the time goes
    from repro_torch.configs import SERVE_MODES
    vocab = {name: s[0].cfg.vocab_size for name, s in dict(setups, qwen3=setup).items()}
    timed("phase 6 engine windows", phase_profile, torch, (
        ("fp", setup, dict(MAIN_SERVE, **ANALYSIS_OFF), lambda: main_requests(vocab["qwen3"]),
         SERVE_MODES),
        ("int8", setup, dict(MAIN_SERVE, **ANALYSIS_OFF, kv_dtype="int8"),
         lambda: main_requests(vocab["qwen3"]), SERVE_MODES),
        ("opt-125m fp", setups["opt-125m"], dict(MAIN_SERVE, **ANALYSIS_OFF),
         lambda: main_requests(vocab["opt-125m"]), ("splitwiser_mps",)),
        ("gemma2-2b fp", setups["gemma2-2b"], dict(GEMMA_SERVE, **ANALYSIS_OFF),
         lambda: gemma2_requests(vocab["gemma2-2b"]), ("sequential",))))
    timed("phase 6 zamba2-7b", phase_hybrid_profile, torch, hybrid_setup)
    timed("phase 6 rwkv6-7b", phase_decode_profile, torch, "rwkv6-7b", rwkv_window)
    timed("phase 6 seamless-m4t-medium", phase_decode_profile, torch, "seamless-m4t-medium",
          seamless_window)
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # 7. training, with the serving phases' models released first
    del setup, setups, hybrid_setup, rwkv_window, seamless_window
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # 8. the cost model and the dry run on the card
    phase_roofline(torch)
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # 9. sampled decoding
    paths["qwen3 f32 sampled"] = phase_sampling(torch, lint)
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # 10-11. the mesh, serving then training, with the earlier phases' models released
    gc.collect()
    torch.cuda.empty_cache()
    mesh_paths, mesh_train = phase_mesh(torch)
    paths.update(mesh_paths)
    log(f"phases 10-11 done at {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for kname, meta in KERNELS.items():
        label, dtype = meta["headline"]
        c = next(c for c in cases if c["kernel"] == kname and c["case"] == label
                 and c["dtype"] == dtype)
        # a kernel of training alone counts the hybrid's training path
        launch_paths = ({f"train {train['hybrid_path']['arch']}": train["hybrid_path"]}
                        if meta.get("train_only") else paths)
        by_path = {p: v["launches"][kname] for p, v in launch_paths.items()}
        n = sum(by_path.values())
        steps = sum(v["steps"] for p, v in launch_paths.items() if by_path[p])
        # K1 and K3: decode (C = 1) and chunk (C > 1) launches apart
        parts = {}
        for part in ("decode", "chunk") if "chunk_source" in meta else ():
            part_by_path = {p: v["launches"][f"{kname}_{part}"] for p, v in paths.items()}
            part_n = sum(part_by_path.values())
            part_steps = sum(v["steps"] for p, v in paths.items() if part_by_path[p])
            parts.update({f"launches_{part}": part_n,
                          f"launches_{part}_by_path": part_by_path,
                          f"launches_{part}_per_step": part_n / part_steps})
        kernels.append(dict(
            name=kname, route=meta["route"], source=meta["source"],
            **{k: meta[k] for k in ("decode_source", "chunk_source", "f32_chunk_source",
                                    "tiles_source", "f32_tiles_source", "f32_source",
                                    "kernels_source", "bf16_source") if k in meta},
            replaces=meta["replaces"], replaces_function=meta["replaces_function"],
            launches=n, launches_by_path=by_path, launches_per_step=n / steps, **parts,
            case=f"{label} {dtype}", max_abs_err=c["max_abs_err"], tol=c["tol"],
            ms=c["ms"], plain_ms=c["plain_ms"],
            **{k: c[k] for k in ("bound_ms", "bound_by", "tf32_passes", "bound_cuda_core_ms",
                                 "bound_cuda_core_by") if k in c},
            library_ms=c["library_ms"], library=meta["library"],
            device_ms=c["device_ms"], library_device_ms=c["library_device_ms"],
            **(train_launches(train, cases, kname)
               if kname in ("flash_attention", "ssd_scan") else {}),
            **({"launches_mesh_train_by_rank": {
                p: v["launches"].get(MESH_TRAIN_COUNTER[kname], 0)
                for p, v in mesh_train.items()},
                "launches_mesh_train_per_step": {
                p: v["launches"].get(MESH_TRAIN_COUNTER[kname], 0) / v["steps"]
                for p, v in mesh_train.items()}} if kname in MESH_TRAIN_COUNTER else {}),
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
