"""The port's CUDA kernels against their plain PyTorch versions, and the
engine and the zamba2 hybrid on the card against the CPU.

Every test here needs a CUDA device and skips itself without one.  This
file imports neither JAX nor the reference package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from hybrid_serving import greedy_stream

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels.kv_int8 import SCALE_FLOOR, q8_kv
from repro_torch.models.registry import get_model

pytestmark = pytest.mark.gpu
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # f32: FMA order; bf16: output rounding

# B, C, H, KV, d, ps, N, Pmax — tests/test_kernels.py's paged cases
PAGED_CASES = [(3, 1, 4, 2, 64, 8, 16, 4), (2, 1, 8, 8, 128, 16, 32, 3),
               (2, 8, 4, 4, 64, 8, 16, 4), (1, 16, 6, 2, 32, 4, 32, 8),
               (2, 4, 4, 4, 112, 8, 16, 4)]
# C, H, KV, d, ps, q_pos and kv_len of each sequence — chunks (C > 1) at
# the edges of the paged tensor-core tile loop (64 folded rows x 64 keys
# a tile, key rows copied through the page table): C = 128 over a history
# of several key tiles that starts off a page boundary, ps = 4 (a tile
# spans 17 pages) with padded chunk rows (kv_len < q_pos + C, as the
# engine pads a short chunk), ps = 8, G = 3 (150 rows, not a multiple of
# 64), d = 112 and d = 16 (padded head dims), a sequence with kv_len 0,
# qwen3's head geometry at chunk_tokens = 256, and gemma2's (8 q / 4 kv
# heads of d = 256: the <256> instantiations) over histories longer than
# CHUNK_KWARGS' window.
PAGED_CHUNK_CASES = [(128, 4, 2, 64, 16, (300, 45), (428, 173)),
                     (40, 4, 2, 64, 4, (70, 3), (110, 40)),
                     (64, 4, 2, 32, 8, (100, 13), (164, 77)),
                     (50, 6, 2, 64, 16, (37, 90), (87, 140)),
                     (72, 4, 2, 112, 16, (90, 5), (162, 77)),
                     (33, 4, 2, 16, 8, (21, 64), (54, 90)),
                     (20, 4, 2, 64, 8, (0, 44, 9), (0, 64, 25)),
                     (256, 16, 8, 128, 16, (500,), (756,)),
                     (64, 8, 4, 256, 16, (300, 45), (364, 109)),
                     (100, 8, 4, 256, 8, (0, 130), (37, 230))]
CHUNK_KWARGS = [dict(), dict(window=70, softcap=25.0)]
# The same layout at C = 1 (q_pos = kv_len - 1, 0 for an empty row) — the
# edges of the split-KV decode kernel, whose splits are whole pages of at
# least 128 keys (paged_attention.decode_splits): a 1037-key row that no
# split length divides, rows with kv_len 0 and 1, G = 3 and 8 (query rows
# beyond one pass), d = 16 and 112 (lane groups of 2 and 14 of 16 lanes in
# bf16, 1 and 7 of 8 for int8 codes), ps = 4, 8 and 16, 40 sequences x 16
# kv heads (one split on 132 SMs) and one sequence of 4000 keys (32
# splits), then gemma2's head geometry (d = 256) over 5000 and 1201 keys.
# DECODE_KWARGS' window of 200 keys crosses a split boundary on every row
# longer than it and empties the splits before it.
PAGED_DECODE_CASES = [(1, 8, 4, 64, 16, (1036, 299), (1037, 300)),
                      (1, 4, 4, 64, 8, (0, 0, 44), (0, 1, 45)),
                      (1, 6, 2, 64, 8, (199, 76), (200, 77)),
                      (1, 16, 2, 128, 16, (499, 0), (500, 1)),
                      (1, 4, 2, 16, 4, (299, 8), (300, 9)),
                      (1, 4, 4, 112, 16, (1039, 599), (1040, 600)),
                      (1, 32, 16, 64, 8, tuple(range(0, 200, 5)), tuple(range(1, 201, 5))),
                      (1, 16, 8, 128, 16, (3999,), (4000,)),
                      (1, 8, 4, 256, 16, (4999, 1200, 0), (5000, 1201, 1))]
DECODE_KWARGS = [dict(), dict(window=200, softcap=25.0)]
# B, T, Tk, H, KV, d, first row's kv_len (None: Tk; the others Tk - 5),
# q/k scale factor.  After the first four, the edges of the bf16 kernel's
# 64-row x 64-key tensor-core tiles: T not a multiple of 64, T = 1024
# (many key tiles, online rescaling), d = 112 and d = 16 (padded head
# dims), G = 3 (folded rows that do not divide 64), Tk > T, a row with
# kv_len = 0, and q/k at 4x scale (scores 16x larger, so the running max
# jumps between key tiles).  v keeps its scale: at |o| >= 4 one bf16 step
# (0.031) would exceed the tolerance whatever the kernel computes.  Last,
# gemma2's head geometry (8 q / 4 kv heads of d = 256: the <256>
# instantiations), with a ragged T, and with an empty row.
FLASH_CASES = [(2, 32, 32, 4, 2, 64, None, 1), (1, 64, 64, 8, 8, 128, None, 1),
               (2, 16, 16, 6, 2, 32, None, 1), (2, 37, 37, 16, 8, 128, None, 1),
               (2, 100, 100, 4, 2, 64, None, 1), (1, 1024, 1024, 4, 2, 128, None, 1),
               (2, 70, 70, 4, 4, 112, None, 1), (2, 50, 50, 4, 2, 16, None, 1),
               (2, 45, 45, 12, 4, 64, None, 1), (2, 40, 96, 4, 2, 64, None, 1),
               (3, 80, 80, 4, 2, 64, 0, 1), (2, 300, 300, 8, 2, 112, None, 4),
               (1, 200, 200, 8, 4, 256, None, 1), (2, 70, 70, 8, 4, 256, 0, 1)]
# B, H, T, P, N, chunk, decay — tests/test_ssd_kernel.py's cases, then
# zamba2's head geometry with a ragged last chunk, then sizes that are not
# multiples of the kernel's 16-wide tiles (chunk above 32: both scan
# halves).  After those, the edges of the bf16 kernel's 64-row tensor-core
# tiles: zamba2's geometry at T = 130 and T = 40 (< 64), P = 16 with
# N = 64 and P = 64 with N = 16 (zero-filled columns), P = 20 and N = 12
# (rows not whole 16-byte vectors: element copies), and a strong decay
# (la down to -8 a step: 2^(L_t) and the decay underflow within a chunk).
# la = -min(|normal| * decay, 8).
SSD_CASES = [(2, 3, 32, 16, 8, 8, 0.1), (1, 2, 64, 32, 16, 16, 0.1), (2, 1, 24, 8, 8, 8, 0.1),
             (2, 112, 200, 64, 64, 64, 0.1), (1, 5, 77, 24, 40, 40, 0.1),
             (1, 112, 130, 64, 64, 64, 0.1), (2, 112, 40, 64, 64, 64, 0.1),
             (2, 4, 150, 16, 64, 64, 0.1), (2, 4, 150, 64, 16, 64, 0.1),
             (1, 3, 70, 20, 12, 64, 0.1), (2, 8, 256, 64, 64, 64, 4.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32))


def _paged(seed, B, C, H, KV, d, ps, N, Pmax, dtype, device="cuda"):
    rng = np.random.RandomState(seed)
    q, kpg, vpg = (_rand(rng, B, C, H, d), _rand(rng, N, ps, KV, d),
                   _rand(rng, N, ps, KV, d))
    bt = torch.from_numpy(rng.permutation(N - 1)[: B * Pmax].reshape(B, Pmax))
    q_pos = torch.from_numpy(rng.randint(0, Pmax * ps - C, size=B))
    args = [q, kpg, vpg, bt, q_pos + C, q_pos]
    return ([a.to(device, dtype) for a in args[:3]]
            + [a.to(device, torch.int32) for a in args[3:]])


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _row_rel_err(a, b):
    """Max over sequences (dim 0) of the max abs difference over that
    sequence's largest |b| (the abs difference where b is all 0)."""
    e = (a.float() - b.float()).abs().flatten(1).amax(1)
    r = b.float().abs().flatten(1).amax(1)
    return (e / r.clamp(min=1e-30)).where(r > 0, e).max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, case, dtype):
    args = _paged(0, *case, getattr(torch, dtype))
    n = K1.launches
    out = K1.paged_attention(*args, scale=0.2)
    torch.cuda.synchronize()
    assert K1.launches == n + 1
    assert _err(out, K1.paged_attention_plain(*args, scale=0.2)) <= TOL[dtype]


@pytest.mark.parametrize("softcap,window", [(20.0, None), (None, 7), (30.0, 5)])
def test_paged_kernel_softcap_window(cuda, softcap, window):
    args = _paged(3, 2, 4, 4, 2, 64, 8, 16, 4, torch.float32)
    kw = dict(scale=0.2, softcap=softcap, window=window)
    assert _err(K1.paged_attention(*args, **kw),
                K1.paged_attention_plain(*args, **kw)) <= TOL["float32"]


def test_paged_kernel_empty_rows_and_stale_table(cuda):
    """kv_len = 0 gives zeros; table entries past ceil(kv_len/ps) are
    never read (here: ids far outside the pool)."""
    args = _paged(5, 3, 4, 4, 2, 16, 4, 12, 3, torch.float32)
    args[4] = torch.tensor([0, 5, 9], dtype=torch.int32, device="cuda")
    args[5] = torch.tensor([0, 1, 5], dtype=torch.int32, device="cuda")
    want = K1.paged_attention_plain(*args, scale=0.3)
    args[3][1, 2] = 10**6                       # slot 2 lies past ceil(5/4) = 2
    out = K1.paged_attention(*args, scale=0.3)
    assert bool((out[0] == 0).all()) and _err(out, want) <= TOL["float32"]
    empty = [args[0][:0]] + args[1:3] + [a[:0] for a in args[3:]]
    assert K1.paged_attention(*empty, scale=0.3).shape == (0, 4, 4, 16)


def _paged_int8(seed, B, C, H, KV, d, ps, N, Pmax, dtype):
    """K3's inputs: K1's, with the pages as int8 codes and f32 scales."""
    q, kpg, vpg, bt, lens, q_pos = _paged(seed, B, C, H, KV, d, ps, N, Pmax, torch.float32)
    (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
    return [q.to(dtype), kq, ks, vq, vs, bt, lens, q_pos]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_int8_kernel_matches_plain(cuda, case, dtype):
    args = _paged_int8(0, *case, getattr(torch, dtype))
    n = K3.launches
    out = K3.paged_attention_int8(*args, scale=0.2)
    torch.cuda.synchronize()
    assert K3.launches == n + 1                 # a CUDA tensor launches, never plain
    assert _err(out, K3.paged_attention_int8_plain(*args, scale=0.2)) <= TOL[dtype]


@pytest.mark.parametrize("softcap,window", [(20.0, None), (None, 7), (30.0, 5)])
def test_paged_int8_kernel_softcap_window(cuda, softcap, window):
    args = _paged_int8(3, 2, 4, 4, 2, 64, 8, 16, 4, torch.float32)
    kw = dict(scale=0.2, softcap=softcap, window=window)
    assert _err(K3.paged_attention_int8(*args, **kw),
                K3.paged_attention_int8_plain(*args, **kw)) <= TOL["float32"]


def test_paged_int8_kernel_empty_rows_zero_pages_and_stale_table(cuda):
    """kv_len = 0 gives zeros; all-zero pages with floored scales
    dequantize to 0; table entries past ceil(kv_len/ps) are never read."""
    args = _paged_int8(5, 3, 4, 4, 2, 16, 4, 12, 3, torch.float32)
    args[6] = torch.tensor([0, 5, 9], dtype=torch.int32, device="cuda")
    args[7] = torch.tensor([0, 1, 5], dtype=torch.int32, device="cuda")
    zero = args[5][2, 0].long()
    for codes, scales in ((args[1], args[2]), (args[3], args[4])):
        codes[zero], scales[zero] = 0, SCALE_FLOOR
    want = K3.paged_attention_int8_plain(*args, scale=0.3)
    args[5][1, 2] = 10**6                       # slot 2 lies past ceil(5/4) = 2
    out = K3.paged_attention_int8(*args, scale=0.3)
    assert torch.isfinite(out).all() and bool((out[0] == 0).all())
    assert _err(out, want) <= TOL["float32"]
    empty = [args[0][:0]] + args[1:5] + [a[:0] for a in args[5:]]
    assert K3.paged_attention_int8(*empty, scale=0.3).shape == (0, 4, 4, 16)


def paged_chunk_inputs(case, seed=0):
    """A PAGED_CHUNK_CASES entry as f32 CPU tensors: q, k_pages, v_pages,
    the block table, a stale copy of it, kv_lens, q_pos.  Each sequence
    owns Pmax = ceil(max kv_len / ps) + 2 pages of a shuffled pool; the
    pool's last page belongs to no sequence.  The stale table points every
    slot past ceil(kv_len / ps) far outside the pool, where a read would
    clamp onto that last page; :func:`poison_last_page` fills it with NaN."""
    C, H, KV, d, ps, q_pos, kv_lens = case
    B = len(q_pos)
    Pmax = -(-max(kv_lens) // ps) + 2
    N = B * Pmax + 1
    rng = np.random.RandomState(seed)
    q, kpg, vpg = _rand(rng, B, C, H, d), _rand(rng, N, ps, KV, d), _rand(rng, N, ps, KV, d)
    table = torch.from_numpy(rng.permutation(N - 1)[: B * Pmax].reshape(B, Pmax)).int()
    stale = table.clone()
    for b, L in enumerate(kv_lens):
        stale[b, -(-L // ps):] = 10**6
    return (q, kpg, vpg, table, stale, torch.tensor(kv_lens, dtype=torch.int32),
            torch.tensor(q_pos, dtype=torch.int32))


def poison_last_page(*pools):
    """NaN into the last page of each pool (fp pages or int8 scales)."""
    for pool in pools:
        pool[-1] = float("nan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["paged_attention", "paged_attention_int8"])
@pytest.mark.parametrize("case", PAGED_CHUNK_CASES)
def test_paged_chunk_kernel_matches_plain(cuda, case, kernel, dtype):
    """K1 and K3 on chunks (bf16: the tensor-core tile loop; f32: the
    CUDA-core loop) through a stale table, against their plain versions
    on the clean table; a sequence with kv_len 0 writes exact zeros."""
    dt = getattr(torch, dtype)
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    if kernel == "paged_attention":
        mod, run, plain = K1, K1.paged_attention, K1.paged_attention_plain
        pages = [kpg.to(dt), vpg.to(dt)]
        poison_last_page(*pages)
    else:
        mod, run, plain = K3, K3.paged_attention_int8, K3.paged_attention_int8_plain
        (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
        poison_last_page(ks, vs)
        pages = [kq, ks, vq, vs]
    q, pages = q.to("cuda", dt), [p.to("cuda") for p in pages]
    table, stale, lens, q_pos = (x.to("cuda") for x in (table, stale, lens, q_pos))
    for kw in CHUNK_KWARGS:
        n, n_chunk = mod.launches, mod.launches_chunk
        out = run(q, *pages, stale, lens, q_pos, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert (mod.launches, mod.launches_chunk) == (n + 1, n_chunk + 1)
        assert bool(torch.isfinite(out.float()).all())
        want = plain(q, *pages, table, lens, q_pos, scale=0.2, **kw)
        assert _err(out, want) <= TOL[dtype]
        assert _row_rel_err(out, want) <= TOL[dtype]
        for b in range(len(lens)):
            if int(lens[b]) == 0:
                assert bool((out[b] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["paged_attention", "paged_attention_int8"])
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_paged_decode_kernel_matches_plain(cuda, case, kernel, dtype):
    """K1 and K3 at decode (C = 1; the split-KV kernel and its combine)
    through a stale table onto a NaN page, against their plain versions
    on the clean table; a sequence with kv_len 0 writes exact zeros.  A
    long row's |o| is small (an average over many keys), so the error is
    also held relative to each sequence's max |o|: a dropped split or a
    halved output exceeds it."""
    dt = getattr(torch, dtype)
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    if kernel == "paged_attention":
        mod, run, plain = K1, K1.paged_attention, K1.paged_attention_plain
        pages = [kpg.to(dt), vpg.to(dt)]
        poison_last_page(*pages)
    else:
        mod, run, plain = K3, K3.paged_attention_int8, K3.paged_attention_int8_plain
        (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
        poison_last_page(ks, vs)
        pages = [kq, ks, vq, vs]
    q, pages = q.to("cuda", dt), [p.to("cuda") for p in pages]
    table, stale, lens, q_pos = (x.to("cuda") for x in (table, stale, lens, q_pos))
    for kw in DECODE_KWARGS:
        n, n_decode = mod.launches, mod.launches_decode
        out = run(q, *pages, stale, lens, q_pos, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert (mod.launches, mod.launches_decode) == (n + 1, n_decode + 1)
        assert bool(torch.isfinite(out.float()).all())
        want = plain(q, *pages, table, lens, q_pos, scale=0.2, **kw)
        assert _err(out, want) <= TOL[dtype]
        assert _row_rel_err(out, want) <= TOL[dtype]
        for b in range(len(lens)):
            if int(lens[b]) == 0:
                assert bool((out[b] == 0).all())


def flash_inputs(case, seed=0):
    """q, k, v, kv_lens of a FLASH_CASES entry, as f32 CPU tensors."""
    B, T, Tk, H, KV, d, first_len, qk = case
    rng = np.random.RandomState(seed)
    q, k, v = _rand(rng, B, T, H, d) * qk, _rand(rng, B, Tk, KV, d) * qk, _rand(rng, B, Tk, KV, d)
    lens = [Tk if first_len is None else first_len] + [Tk - 5] * (B - 1)
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, lens = (x.to("cuda", dt if x.is_floating_point() else None)
                     for x in flash_inputs(case))
    for kw in (dict(), dict(window=8, softcap=25.0), dict(causal=False)):
        n = K2.launches
        out = K2.flash_attention(q, k, v, lens, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert K2.launches == n + 1
        assert _err(out, K2.flash_attention_plain(q, k, v, lens, scale=0.2, **kw)) <= TOL[dtype]
        if case[6] == 0:                        # an empty row writes exact zeros
            assert bool((out[0] == 0).all())


def ssd_inputs(case, h0):
    """Seeded inputs of one SSD case, f32 on the CPU: x [B,T,H,P], la
    [B,T,H], Bc/Cc [B,T,N] at scale 0.25, and h0 [B,H,P,N] (None for
    zeros).  Scale 0.25 keeps |y| < 4, where one bf16 step (0.0156) is
    inside 2e-2."""
    B, H, T, P, N, _, decay = case
    rng = np.random.RandomState(0)
    x, Bc, Cc = (_rand(rng, *s).mul(0.5) for s in ((B, T, H, P), (B, T, N), (B, T, N)))
    la = -np.abs(rng.standard_normal((B, T, H))).astype(np.float32) * np.float32(decay)
    h = _rand(rng, B, H, P, N).mul(0.5) if h0 == "random" else None
    return x, torch.from_numpy(np.maximum(la, np.float32(-8))), Bc, Cc, h


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, case, dtype, h0):
    """K4 against its plain version on the same inputs: y to the dtype's
    tolerance, h_final to 1e-4 in both dtypes, both finite."""
    dt = getattr(torch, dtype)
    x, la, Bc, Cc, h = ssd_inputs(case, h0)
    x, Bc, Cc = (a.to("cuda", dt) for a in (x, Bc, Cc))
    la, h = la.to("cuda"), None if h is None else h.to("cuda")
    chunk = case[5]
    n = K4.launches
    y, hf = K4.ssd_chunk_scan(x, la, Bc, Cc, h, chunk=chunk)
    torch.cuda.synchronize()
    assert K4.launches == n + 1                 # a CUDA tensor launches, never plain
    py, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=chunk)
    assert y.dtype == dt and hf.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(hf).all()
    assert float(py.float().abs().max()) < 4
    assert _err(y, py) <= TOL[dtype] and _err(hf, ph) <= TOL["float32"]


def test_ssd_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(1, 8, 2, 128, device="cuda")       # P = 128 > 64
    la = torch.zeros(1, 8, 2, device="cuda")
    b = torch.zeros(1, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="<= 64"):
        K4.ssd_chunk_scan(x, la, b, b, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        K4.ssd_chunk_scan(x[..., :64], la.bfloat16(), b, b, chunk=8)


def test_hybrid_on_card_matches_cpu(cuda):
    """Greedy streams of the reduced zamba2 hybrid on the card (K1, K2,
    K4) equal those on the CPU (plain versions), f32."""
    model = get_model("zamba2-7b", get_config("zamba2-7b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(0).randint(2, 256, size=(3, 12))
    counts = lambda: (K1.launches, K2.launches, K4.launches)
    before = counts()
    card = greedy_stream(_to(params, "cuda"), model.cfg, toks, 8, ps=4)
    assert all(a > b for a, b in zip(counts(), before))
    np.testing.assert_array_equal(card, greedy_stream(params, model.cfg, toks, 8, ps=4))


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("mode", ["sequential", "splitwiser", "splitwiser_mps", "chunked"])
def test_engine_on_card_matches_cpu(cuda, mode, kv_dtype):
    """Greedy streams on the card (kernels) equal those on the CPU (plain
    versions), f32, reduced qwen3-0.6b, with fp and with int8 pages (the
    latter under the step sanitizer)."""
    model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    serve = ServeConfig(mode=mode, max_batch=4, page_size=4, n_pages=128,
                        max_pages_per_seq=16, prefill_chunk=4, n_streams=2,
                        kv_dtype=kv_dtype,
                        sanitize_level="step" if kv_dtype == "int8" else "off",
                        dispatch_sentinel=False)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(2, 256, size=rng.randint(5, 20))]
               for _ in range(6)]
    streams = {}
    for dev in ("cuda", "cpu"):
        reqs = [Request(rid=i, prompt=p, sampling=SamplingParams(max_new_tokens=6))
                for i, p in enumerate(prompts)]
        Engine(model, params, serve, device=dev).run(reqs)
        streams[dev] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["cpu"]
