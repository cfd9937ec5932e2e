#!/usr/bin/env python3
"""Run the PyTorch port of the Splitwiser engine on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (what the port's chip check runs)
    python3 chip_smoke.py --quick    # phases 1-3 at one repeat: build + kernel check

Phases, each fatal on failure (non-zero exit, no result line):
  1. environment: device name and count, ``nvidia-smi`` name and power limit;
  2. build: every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` summary;
  3. kernels against their plain PyTorch versions at the main paths' shapes,
     in f32 and bf16, with times of the kernel, the plain version and a
     library yardstick (``scaled_dot_product_attention`` on gathered K/V —
     for the int8 kernel after one dequantize call — never called by the
     port; none for the SSD scan, which no single PyTorch call computes),
     and the card's bound for the same work, and the kernel's and the
     library's device time (``device_ms``: the calls queued behind a
     device sleep, so the host's cost per call does not pace them);
     K1/K3 at decode (C = 1: the split-KV kernel, each case logging its
     split count, split length and workspace bytes, and its error held to
     the tolerance relative to each sequence's max |o| too) for B = 16
     at the main path's 72-page table, 64 and one sequence of 4096 keys,
     and at chunks of C = 128 and 256 (bf16 chunks run their tensor-core
     tile loop); plus K1/K3 on empty rows and stale page tables at C = 4
     and at decode (K3 also on all-zero pages; at decode the stale slots
     clamp onto a NaN page), K1/K2 at the hybrid's head geometry, and the
     scan with a ragged T and a nonzero h0 (its y and h_final errors
     logged apart: y held to the dtype's tolerance, h_final to 1e-4 in
     both dtypes).  First it logs the ``ptxas -v`` registers and spills
     and the dynamic shared memory of each instantiation of the bf16
     tensor-core kernels (K2's and the chunk loops of K1 and K3), and
     fails if a head-dim 64 or 128 one spills; then the same for every
     instantiation of the decode kernels and their combines, failing on
     any spill but f32's at d > 128; then for K4's bf16 tensor-core
     kernel, with the blocks an SM holds, failing if its main-path
     instantiation spills;
  4. cross-device checks, f32, one seeded set of weights each, greedy
     streams equal between ``cuda`` (kernels) and the CPU (plain versions):
     the engine on qwen3-0.6b at full width and 2 layers with fp pages and
     with int8 pages under the runtime sanitizer (``sanitize_level="step"``);
     the zamba2 hybrid at full width and 7 layer-units (2 prompts of 64
     tokens, 8 decode steps), whose first decode logits on ``cuda`` must
     match the full-sequence forward;
  5. the main paths, in bf16 at full depth: qwen3-0.6b, 16 requests of
     128-1024 prompt tokens through all four serving modes, first with fp
     KV pages, then with int8 KV pages in a pool of the same bytes; then
     zamba2-7b (81 layer-units), 8 prompts of 1024 tokens prefilled as one
     batch and 32 greedy decode steps.  Kernel launch counters are zeroed
     just before each path and read just after; every request must finish
     by length (every logit finite), and every kernel of the path must
     have launched (the int8 kernel in every mode; the scan once per Mamba2
     block of the prefill), and K1/K3's chunk loop (C > 1) in every mode
     that chunks prompts (``splitwiser``, ``splitwiser_mps``, ``chunked``);
     K1 and K3 count decode and chunk launches apart;
  6. where the time goes: per mode and page type, one window of engine
     steps, and for the hybrid its prefill and 8 decode steps, timed on the
     host clock and, run again from fresh state, under ``torch.profiler``:
     device time by kernel class (K1/K3 split into decode, with its
     combine, and chunk) and the device's busy share.

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
SLEEP_CYCLES_S = 2.0e9         # above the H100's 1.98 GHz boost clock: a sleep lasts at least its time
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 non-tensor
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


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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


def flash_work(q, k, kv_lens, window=None):
    B, T, H, d = q.shape
    Tk = k.shape[1]
    isz = q.element_size()
    keys = sum(visible_keys(min(int(kv_lens[b]), Tk), t, window)
               for b in range(B) for t in range(T))
    nbytes = (2 * q.numel() + 2 * k.numel()) * isz + B * 4
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
            outputs=None):
    """One case: the kernel against its plain version on the same inputs
    (max abs error and, for a single output, ``row_rel_err``; for a tuple
    of outputs named by ``outputs``, each one's error as ``<name>_err``,
    ``max_abs_err`` being the first's), then
    ``cuda_time_ms`` times of kernel, plain version and library yardstick
    (None: there is none), the kernel's and the library's
    ``device_time_ms`` times and the kernel's host time per call, and the
    bound for the work; ``extra`` (e.g. a decode call's split) is logged
    with it."""
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


TC_KERNELS = (  # library, kernel name, C helper of its dynamic shared memory
    ("flash_attention", "flash_attention_kernel_tc", "flash_attention_bf16_smem_bytes"),
    ("paged_attention", "paged_attention_kernel_tc", "paged_attention_bf16_smem_bytes"),
    ("paged_attention_int8", "paged_attention_int8_kernel_tc",
     "paged_attention_int8_bf16_smem_bytes"))


def tc_resources(lib, kernel, smem_symbol):
    """Registers, stack and spills of each bf16 tensor-core instantiation
    of ``kernel`` in library ``lib`` (padded head dim DP, without and with
    softcap) from the ``ptxas -v`` output in ``build.build_log``, with the
    dynamic shared memory a block of it takes.  Fails if a DP = 64 or 128
    one spills (the paths run d = 112 and 128; spills at 256 are
    allowed)."""
    import ctypes
    import re
    from repro_torch.kernels import build
    text = build.build_log[lib]["ptxas"]
    if text == "(reused)":
        return "not available: the library was built before this run"
    smem = build.kernel_fn(lib, smem_symbol, [ctypes.c_int])
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(kernel + r"ILi(\d+)ELb([01])E", line)
            cur = out.setdefault(f"DP={m[1]}" + (" softcap" if m[2] == "1" else ""),
                                 dict(dynamic_smem_bytes=smem(int(m[1])))) if m else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    want = [f"DP={dp}{cap}" for dp in (32, 64, 128, 256) for cap in ("", " softcap")]
    if sorted(out) != sorted(want):
        fail(f"ptxas log lacks the bf16 instantiations of {kernel}: {sorted(out)}")
    for key in want[2:6]:                          # DP = 64 and 128
        if out[key].get("spill_store_bytes", 1) or out[key].get("spill_load_bytes", 1):
            fail(f"{kernel} {key} spills to local memory: {out[key]}")
    return out


def ssd_resources():
    """Registers, stack and spills of both instantiations of K4's bf16
    tensor-core kernel (``VEC``: P and N multiples of 8, the main path's;
    else element copies) from the ``ptxas -v`` output, with the dynamic
    shared memory a block takes and the blocks one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Fails if the
    main path's instantiation spills."""
    import re
    from repro_torch.kernels import build
    text = build.build_log["ssd_scan"]["ptxas"]
    if text == "(reused)":
        return "not available: the library was built before this run"
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"ssd_scan_kernel_tcILb([01])E", line)
            cur = out.setdefault("VEC" if m[1] == "1" else "element copies", {}) if m else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    if sorted(out) != ["VEC", "element copies"]:
        fail(f"ptxas log lacks the bf16 instantiations of ssd_scan_kernel_tc: {sorted(out)}")
    if out["VEC"].get("spill_store_bytes", 1) or out["VEC"].get("spill_load_bytes", 1):
        fail(f"ssd_scan_kernel_tc VEC spills to local memory: {out['VEC']}")
    out["dynamic_smem_bytes"] = build.kernel_fn("ssd_scan", "ssd_scan_bf16_smem_bytes", [])()
    out["blocks_per_sm"] = build.kernel_fn("ssd_scan", "ssd_scan_bf16_blocks_per_sm", [])()
    if out["blocks_per_sm"] < 1:
        fail(f"ssd_scan_kernel_tc cannot be resident on an SM: {out}")
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
        split = decode_split_info(torch, args[0], args[1], args[3]) if C == 1 else {}
        cases.append(measure(
            torch, "paged_attention", label, dname,
            lambda: K1.paged_attention(*args, **kw),
            lambda: K1.paged_attention_plain(*args, **kw),
            sdpa_paged(torch, *args, kw["scale"], W),
            paged_work(args[0], args[1], args[3], args[4], args[5], window=W), iters,
            dict(split, **note)))
        q, kp, vp, table, kv_lens, q_pos = paged_case(
            torch, B, C, KV, G, d, 16, 5000, torch.float32, seed=9, min_kv=min_kv, pmax=pmax)
        i8 = (q.to(dtype), *int8_pool(torch, kp, vp), table, kv_lens, q_pos)
        del args, kp, vp
        cases.append(measure(
            torch, "paged_attention_int8", label, dname,
            lambda: K3.paged_attention_int8(*i8, **kw),
            lambda: K3.paged_attention_int8_plain(*i8, **kw),
            sdpa_paged_int8(torch, *i8, kw["scale"], W),
            paged_work(i8[0], i8[1], table, kv_lens, q_pos, kv_bytes=i8[1].shape[3] + 4,
                       window=W),
            iters, dict(split, **note)))
        del i8
    return cases


def phase_kernels(torch, iters):
    from repro_torch.kernels import flash_attention as K2
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import paged_attention_int8 as K3
    from repro_torch.kernels import ssd_scan as K4
    F = torch.nn.functional
    scale = 1.0 / math.sqrt(128)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        # K4 at zamba2's prefill (B=8 prompts of 1024, 112 heads of 64,
        # state 64, chunk 64), then a ragged T with a nonzero h0
        for label, T, h0 in (("prefill B=8 T=1024 H=112", 1024, False),
                             ("ragged T=1000 h0!=0", 1000, True)):
            x, la, Bc, Cc, h = ssd_case(torch, 8, T, 112, 64, 64, dtype, h0, seed=3)
            cases.append(measure(
                torch, "ssd_scan", label, dname,
                lambda: K4.ssd_chunk_scan(x, la, Bc, Cc, h, chunk=64),
                lambda: K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=64),
                None, ssd_work(x, Bc, h, 64), iters,
                dict(h_final_tol=TOL["float32"]), outputs=("y", "h_final")))
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
            split = decode_split_info(torch, args[0], args[1], args[3]) if C == 1 else None
            cases.append(measure(
                torch, "paged_attention", label, dname,
                lambda: K1.paged_attention(*args, scale=scale),
                lambda: K1.paged_attention_plain(*args, scale=scale),
                sdpa_paged(torch, *args, scale),
                paged_work(args[0], args[1], args[3], args[4], args[5]), iters, split))
            # K3 on the same shapes: codes and scales of seeded f32 normals
            q, kp, vp, table, kv_lens, q_pos = paged_case(
                torch, B, C, 8, 2, 128, 16, max_kv, torch.float32, seed=1, min_kv=min_kv,
                pmax=pmax)
            i8 = (q.to(dtype), *int8_pool(torch, kp, vp), table, kv_lens, q_pos)
            del args, kp, vp
            cases.append(measure(
                torch, "paged_attention_int8", label, dname,
                lambda: K3.paged_attention_int8(*i8, scale=scale),
                lambda: K3.paged_attention_int8_plain(*i8, scale=scale),
                sdpa_paged_int8(torch, *i8, scale),
                paged_work(i8[0], i8[1], table, kv_lens, q_pos, kv_bytes=i8[1].shape[3] + 4),
                iters, split))
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
    edge = stale_checks(torch)
    for c in cases + edge:
        log("kernel " + json.dumps(c))
    bad = [c for c in cases + edge if not c["max_abs_err"] <= c["tol"]]
    # K4's state feeds every later step: h_final is held to f32's 1e-4 in
    # both dtypes, y (max_abs_err) to the dtype's tolerance
    bad += [c for c in cases if "h_final_tol" in c and not c["h_final_err"] <= c["h_final_tol"]]
    # decode averages softmax weights over up to thousands of keys, so its
    # |o| is small: its error is held to the tolerance relative to each
    # sequence's max |o| as well, which a dropped split or a halved output
    # would exceed
    bad += [c for c in cases if "splits" in c and not c["row_rel_err"] <= c["tol"]]
    bad += [c for c in edge if not (c["finite"] and c["empty_row_zero"])]
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
    return counters


def zero_launches():
    for mod, attr in launch_counts().values():
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in launch_counts().items()}


CROSS_SERVE = dict(max_batch=8, page_size=16, n_pages=128, max_pages_per_seq=16,
                   prefill_chunk=32, n_streams=2, chunk_tokens=64)
CHUNKING_MODES = ("splitwiser", "splitwiser_mps", "chunked")


def cross_device(torch, label, model, params, serve_kw, modes, make_requests):
    """Serve ``make_requests()`` on cuda (kernels) and on the CPU (plain
    versions) in each of ``modes``, f32: the greedy streams must be equal,
    and on cuda the paged kernel (K1, or K3 for int8 pages) must launch,
    K2 in ``sequential`` and the paged chunk loop in the modes that chunk
    prompts; under the sanitizer it must have run on cuda (clean: a
    violation raises)."""
    from repro_torch.configs import ServeConfig
    Engine = make_engine_cls()
    cfg = ServeConfig(**serve_kw)
    paged = "paged_attention_int8" if cfg.kv_dtype == "int8" else "paged_attention"
    for mode in modes:
        streams, checks = {}, {}
        for dev in ("cuda", "cpu"):
            zero_launches()
            reqs = make_requests()
            eng = Engine(model, params, replace(cfg, mode=mode), device=dev)
            eng.run(reqs, max_steps=4000)
            streams[dev] = [r.out_tokens for r in reqs]
            checks[dev] = eng.sanitizer.n_checks if eng.sanitizer else 0
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = read_launches()
            del eng
        if streams["cuda"] != streams["cpu"]:
            first = next((i, a, b) for i, (a, b) in
                         enumerate(zip(streams["cuda"], streams["cpu"])) if a != b)
            fail(f"{label} {mode}: greedy streams differ between cuda and cpu: {first}")
        want = ([paged] + (["flash_attention"] if mode == "sequential" else [])
                + ([paged + "_chunk"] if mode in CHUNKING_MODES else []))
        if any(counts[k] == 0 for k in want):
            fail(f"{label} {mode}: kernels were not launched on cuda: {counts}")
        if cfg.sanitize_level != "off" and not checks["cuda"]:
            fail(f"{label} {mode}: the sanitizer did not run on cuda")
        log(f"cross-device {label} {mode}: {len(streams['cuda'])} greedy streams equal "
            f"(cuda vs cpu); launches {json.dumps(counts)}; sanitizer checks "
            f"cuda={checks['cuda']} cpu={checks['cpu']} (clean)")


def phase_cross_device(torch):
    """cuda vs cpu greedy streams at full width, 2 layers, f32: fp pages,
    then int8 pages under the step sanitizer, which must run clean on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    cfg = replace(get_config("qwen3-0.6b"), n_layers=2)
    model = get_model("qwen3-0.6b", cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    for pages, extra in (("fp", ANALYSIS_OFF), ("int8", INT8_SANITIZED)):
        cross_device(torch, pages, model, params, dict(CROSS_SERVE, **extra),
                     ("sequential", "splitwiser_mps"),
                     lambda: requests(6, cfg.vocab_size, 16, 96, 8, 8, seed=3))


def phase_family_cross_device(torch):
    """The rest of the transformer family, f32, cuda against the CPU:
    opt-125m at full width and depth in every mode; gemma2-2b at full
    width and 4 layers (2 local, 2 global) in ``sequential`` and
    ``chunked``, with one prompt of 4200 tokens, past its window of 4096;
    olmoe-1b-7b (MoE) at full width and 2 layers in ``splitwiser_mps``;
    internvl2-2b's prefill logits over 256 patches and 64 tokens at full
    width and 2 layers, within 1e-4 of the CPU's."""
    from repro_torch.configs import SERVE_MODES, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    for arch, layers, modes, serve_kw, make in (
            ("opt-125m", None, SERVE_MODES, CROSS_SERVE,
             lambda vocab: requests(6, vocab, 16, 96, 8, 8, seed=3)),
            ("gemma2-2b", 4, ("sequential", "chunked"),
             dict(CROSS_SERVE, max_batch=4, n_pages=320, max_pages_per_seq=272,
                  max_seq_len=4352, prefill_chunk=256, chunk_tokens=512),
             lambda vocab: requests_of_lengths((4200, 64), vocab, 8, seed=3)),
            ("olmoe-1b-7b", 2, ("splitwiser_mps",), CROSS_SERVE,
             lambda vocab: requests(4, vocab, 16, 96, 8, 8, seed=3))):
        cfg = get_config(arch)
        cfg = replace(cfg, n_layers=layers or cfg.n_layers)
        model = get_model(arch, cfg)
        params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
        cross_device(torch, f"{arch} ({cfg.n_layers} layers) fp", model, params,
                     dict(serve_kw, **ANALYSIS_OFF), modes,
                     lambda: make(cfg.vocab_size))
        del model, params
        gc.collect()
    cfg = replace(get_config("internvl2-2b"), n_layers=2)
    params = get_model("internvl2-2b", cfg).init(torch.Generator().manual_seed(0),
                                                 torch.float32, "cpu")
    toks = torch.as_tensor(prompts(2, 64, cfg.vocab_size, seed=4))
    patches = torch.randn(2, cfg.n_vision_patches, cfg.d_vision,
                          generator=torch.Generator().manual_seed(5)) * 0.3
    logits = {}
    for dev in ("cuda", "cpu"):
        zero_launches()
        logits[dev], _ = T.prefill(to_device(params, dev), cfg, toks.to(dev),
                                   patches=patches.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
    gap = max_err(logits["cuda"].cpu()[:, :cfg.vocab_size], logits["cpu"][:, :cfg.vocab_size])
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"internvl2-2b: K2 launched {counts['flash_attention']} times in a "
             f"{cfg.n_layers}-layer prefill")
    if not gap <= TOL["float32"]:
        fail(f"internvl2-2b: prefill logits differ between cuda and cpu by {gap}")
    log(f"cross-device internvl2-2b ({cfg.n_layers} layers): prefill of 2 x "
        f"({cfg.n_vision_patches} patches + 64 tokens), max abs logit gap cuda vs cpu "
        f"{gap:.3e}; launches {json.dumps(counts)}")


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
    the first decode step's logits, the prefill's wall time and launch
    counts, and each decode step's wall time (host clock, each ending in a
    synchronize on the card)."""
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
    return dict(tokens=torch.stack(out, 1).cpu(), first_logits=first, ttft_s=ttft,
                prefill_launches=prefill_launches, tbt_s=gaps)


def phase_hybrid_cross_device(torch):
    """The hybrid at full width and 7 layer-units (one group of 5 Mamba2
    blocks and the shared block, 1 trailing Mamba2), f32: 2 prompts of 64
    tokens and 8 decode steps on cuda and on the CPU; the greedy streams
    must be equal, and on cuda the first decode step's logits must match
    the full-sequence forward within 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid as HY
    from repro_torch.models.registry import get_model
    cfg = replace(get_config("zamba2-7b"), n_layers=7)
    model = get_model("zamba2-7b", cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu")
    toks = prompts(2, 64, cfg.vocab_size, seed=4)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = to_device(params, dev)
        zero_launches()
        runs[dev] = hybrid_serve(torch, p, cfg, toks, steps=8, ps=16)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
            first = runs[dev]["tokens"][:, :1].cuda()
            full, _ = HY.train_logits(p, cfg, {"tokens": torch.cat(
                [torch.as_tensor(toks, device="cuda"), first], 1)})
            gap = (runs[dev]["first_logits"] - full[:, -1]).abs().max().item()
            del p, full
    if not torch.equal(runs["cuda"]["tokens"], runs["cpu"]["tokens"]):
        fail(f"hybrid: greedy streams differ between cuda and cpu: "
             f"{runs['cuda']['tokens'].tolist()} vs {runs['cpu']['tokens'].tolist()}")
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
# other paged call is a chunk (bf16: the tensor-core loop, f32: the
# CUDA-core loop).  "ssd_scan_kernel" matches K4's f32 kernel and its bf16
# ssd_scan_kernel_tc.
KERNEL_CLASSES = (("paged_attention_int8 decode", ("paged_attention_int8_decode",)),
                  ("paged_attention_int8 chunk", ("paged_attention_int8_kernel",)),
                  ("paged_attention decode", ("paged_attention_decode",)),
                  ("paged_attention chunk", ("paged_attention_kernel",)),
                  ("flash_attention", ("flash_attention_kernel",)),
                  ("ssd_scan", ("ssd_scan_kernel",)),
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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(window):
                    eng.step()
                torch.cuda.synchronize()
            out[f"{label} {mode}"] = r = dict(
                steps=f"{warm_steps}..{warm_steps + window - 1}",
                step_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
                **window_summary(wall_ms, *device_ms_by_class(torch, prof)))
            log(f"profile {label} {mode}: " + json.dumps(r))
    return out


def device_ms_by_class(torch, prof):
    """(device ms by kernel class, kernel count) of one profiled run."""
    by_class, n_kernels = {}, 0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += e.count
        name = e.key.lower()
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ------------------------------------------------------------------ main ---
KERNELS = {
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        decode_source="src/repro_torch/kernels/csrc/paged_decode.cuh",
        chunk_source="src/repro_torch/kernels/csrc/paged_tiles.cuh",
        replaces="src/repro/kernels/paged_attention.py:109",
        replaces_function="src/repro/kernels/paged_attention.py::paged_attention",
        headline=("decode B=16 C=1", "bfloat16"), library="scaled_dot_product_attention"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        replaces_function="src/repro/kernels/flash_attention.py::flash_attention",
        headline=("prefill B=4 T=1024", "bfloat16"), library="scaled_dot_product_attention"),
    "paged_attention_int8": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention_int8.cu",
        decode_source="src/repro_torch/kernels/csrc/paged_decode.cuh",
        chunk_source="src/repro_torch/kernels/csrc/paged_tiles.cuh",
        replaces="src/repro/kernels/paged_attention_int8.py:111",
        replaces_function="src/repro/kernels/paged_attention_int8.py::paged_attention_int8",
        headline=("decode B=16 C=1", "bfloat16"),
        library="two calls: torch.mul dequantize + scaled_dot_product_attention"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        tiles_source="src/repro_torch/kernels/csrc/ssd_tiles.cuh",
        replaces="src/repro/kernels/ssd_scan.py:64",
        replaces_function="src/repro/kernels/ssd_scan.py::ssd_chunk_scan",
        headline=("prefill B=8 T=1024 H=112", "bfloat16"),
        library="none (no single PyTorch call computes the scan)"),
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
    for lib, kernel, smem_symbol in TC_KERNELS:
        log(f"{kernel} bf16 tensor-core instantiations (ptxas -v): "
            + json.dumps(tc_resources(lib, kernel, smem_symbol)))
    for lib, kernel, params in DECODE_KERNELS:
        log(f"{kernel} split-KV decode instantiations (ptxas -v): "
            + json.dumps(decode_resources(lib, kernel, params)))
    log("ssd_scan_kernel_tc bf16 tensor-core instantiations (ptxas -v): "
        + json.dumps(ssd_resources()))
    cases = phase_kernels(torch, iters=1 if args.quick else 20)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    if args.quick:
        log(f"quick check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 4. cross-device checks
    phase_cross_device(torch)
    phase_hybrid_cross_device(torch)
    phase_family_cross_device(torch)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # 5. the main paths, then the dispatch sentinel on opt-125m's engine
    paths, setup = phase_main_path(torch)
    family, setups = phase_family_paths(torch)
    paths.update(family)
    log("modes " + json.dumps({k: v["per_mode"] for k, v in paths.items() if "per_mode" in v}))
    paths["hybrid"], hybrid_setup = phase_hybrid_path(torch)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
    phase_sentinel(torch, setups["opt-125m"])
    log(f"sentinel phase done at {time.perf_counter() - t_start:.1f} s")

    # 6. where the time goes
    from repro_torch.configs import SERVE_MODES
    vocab = {name: s[0].cfg.vocab_size for name, s in dict(setups, qwen3=setup).items()}
    phase_profile(torch, (
        ("fp", setup, dict(MAIN_SERVE, **ANALYSIS_OFF), lambda: main_requests(vocab["qwen3"]),
         SERVE_MODES),
        ("int8", setup, dict(MAIN_SERVE, **ANALYSIS_OFF, kv_dtype="int8"),
         lambda: main_requests(vocab["qwen3"]), SERVE_MODES),
        ("opt-125m fp", setups["opt-125m"], dict(MAIN_SERVE, **ANALYSIS_OFF),
         lambda: main_requests(vocab["opt-125m"]), ("splitwiser_mps",)),
        ("gemma2-2b fp", setups["gemma2-2b"], dict(GEMMA_SERVE, **ANALYSIS_OFF),
         lambda: gemma2_requests(vocab["gemma2-2b"]), ("sequential",))))
    phase_hybrid_profile(torch, hybrid_setup)

    kernels = []
    for kname, meta in KERNELS.items():
        label, dtype = meta["headline"]
        c = next(c for c in cases if c["kernel"] == kname and c["case"] == label
                 and c["dtype"] == dtype)
        by_path = {p: v["launches"][kname] for p, v in paths.items()}
        n = sum(by_path.values())
        steps = sum(v["steps"] for p, v in paths.items() if by_path[p])
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
            **{k: meta[k] for k in ("decode_source", "chunk_source", "tiles_source")
               if k in meta},
            replaces=meta["replaces"], replaces_function=meta["replaces_function"],
            launches=n, launches_by_path=by_path, launches_per_step=n / steps, **parts,
            case=f"{label} {dtype}", max_abs_err=c["max_abs_err"], tol=c["tol"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], library=meta["library"],
            device_ms=c["device_ms"], library_device_ms=c["library_device_ms"],
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
