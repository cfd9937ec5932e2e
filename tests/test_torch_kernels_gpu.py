"""The port's CUDA kernels against their plain PyTorch versions, and the
engine, the zamba2 hybrid, rwkv6 and the seamless-m4t encoder-decoder on
the card against the CPU; K2's training forward (o and lse), the
recompute backward of ``flash_attention_ckpt`` on the card against the
CPU, K4's backward kernel and the hybrid's training gradient, and the
guards of the kernels that have no backward.

Every test here needs a CUDA device and skips itself without one.  This
file imports neither JAX nor the reference package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from hybrid_serving import encdec_greedy_stream, greedy_stream, rwkv_greedy_stream

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels import ssd_scan as K4
from repro_torch.kernels.kv_int8 import SCALE_FLOOR, q8_kv
from repro_torch.models import encdec as PE
from repro_torch.models import rwkv as PR
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
# A PAGED_CHUNK_CASES layout and the call's window and softcap: the f32
# chunk kernel (3xTF32 tiles of 64 folded rows) at the edges of its key
# split.  paged_attention.chunk_splits cuts a row's Pmax * ps keys into S
# splits of whole pages when the row tiles leave the card's SMs idle;
# every case here has S > 1 on an H100 (132 SMs).  A window edge inside a
# split, beside a sequence too short for any split but its first (splits
# that see no key); a first chunk (q_pos 0) beside a long history, with
# softcap alone; gemma2-2b's attention (8 q / 4 kv heads of d = 256,
# window 4096, softcap 50) on a chunk past 4096 keys beside one inside
# the window; d = 112 at ps = 4 with G = 3, whose rows' window edges
# straddle a split boundary.
PAGED_F32_SPLIT_CASES = [((64, 4, 2, 128, 16, (900, 30), (964, 94)), dict(window=300)),
                         ((40, 8, 4, 64, 8, (472, 0), (512, 40)), dict(softcap=25.0)),
                         ((64, 8, 4, 256, 16, (4200, 1000), (4264, 1064)),
                          dict(window=4096, softcap=50.0)),
                         ((100, 6, 2, 112, 4, (333,), (433,)), dict(window=150, softcap=30.0))]
# The same layout at C = 1 (q_pos = kv_len - 1, 0 for an empty row) — the
# edges of the split-KV decode kernel, whose splits are whole pages of at
# least 128 keys (paged_attention.decode_splits): a 1037-key row that no
# split length divides, rows with kv_len 0 and 1, G = 3 and 8 (query rows
# beyond one pass), d = 16 and 112 (lane groups of 2 and 14 of 16 lanes in
# bf16, 1 and 7 of 8 for int8 codes), ps = 4, 8 and 16, 40 sequences x 16
# kv heads (one split on 132 SMs) and one sequence of 4000 keys (32
# splits), then gemma2's head geometry (d = 256) over 5000 and 1201 keys,
# then seamless-m4t's decoder self-attention (16 q / 16 kv heads of 64,
# G = 1) past 64-token prompts.  DECODE_KWARGS' window of 200 keys
# crosses a split boundary on every row longer than it and empties the
# splits before it.
PAGED_DECODE_CASES = [(1, 8, 4, 64, 16, (1036, 299), (1037, 300)),
                      (1, 4, 4, 64, 8, (0, 0, 44), (0, 1, 45)),
                      (1, 6, 2, 64, 8, (199, 76), (200, 77)),
                      (1, 16, 2, 128, 16, (499, 0), (500, 1)),
                      (1, 4, 2, 16, 4, (299, 8), (300, 9)),
                      (1, 4, 4, 112, 16, (1039, 599), (1040, 600)),
                      (1, 32, 16, 64, 8, tuple(range(0, 200, 5)), tuple(range(1, 201, 5))),
                      (1, 16, 8, 128, 16, (3999,), (4000,)),
                      (1, 8, 4, 256, 16, (4999, 1200, 0), (5000, 1201, 1)),
                      (1, 16, 16, 64, 16, (95, 64, 79), (96, 65, 80))]
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
# instantiations), with a ragged T, and with an empty row.  Then the
# encoder-decoder's cross-attention shapes: one query row against 1024
# encoder frames (its decode, G = 1) and T > Tk.
FLASH_CASES = [(2, 32, 32, 4, 2, 64, None, 1), (1, 64, 64, 8, 8, 128, None, 1),
               (2, 16, 16, 6, 2, 32, None, 1), (2, 37, 37, 16, 8, 128, None, 1),
               (2, 100, 100, 4, 2, 64, None, 1), (1, 1024, 1024, 4, 2, 128, None, 1),
               (2, 70, 70, 4, 4, 112, None, 1), (2, 50, 50, 4, 2, 16, None, 1),
               (2, 45, 45, 12, 4, 64, None, 1), (2, 40, 96, 4, 2, 64, None, 1),
               (3, 80, 80, 4, 2, 64, 0, 1), (2, 300, 300, 8, 2, 112, None, 4),
               (1, 200, 200, 8, 4, 256, None, 1), (2, 70, 70, 8, 4, 256, 0, 1),
               (4, 1, 1024, 16, 16, 64, None, 1), (2, 96, 40, 4, 4, 64, None, 1)]
# The same layout at the edges of K2's f32 kernel (3xTF32 on mma.sync
# m16n8k8; 64 folded rows a block, key tiles of 64 keys at d <= 128 and
# 32 at d = 256): T not a multiple of 64, G = 3 folding rows across tile
# edges, one query row against 1024 keys, a row with kv_len = 0, d = 16,
# 112 and 256, d = 12 and 4 (a half 8-wide step of the head dim, zeroed),
# Tk > T with ragged lens, and q/k at 4x scale over d = 128 (scores where
# one TF32 pass misses 1e-4; tests/test_torch_flash_f32_tiles.py shows it).
FLASH_F32_CASES = [(2, 100, 100, 2, 2, 64, None, 1), (2, 50, 50, 6, 2, 64, None, 1),
                   (2, 1, 1024, 8, 2, 128, None, 1), (3, 70, 70, 4, 2, 64, 0, 1),
                   (2, 90, 90, 4, 2, 16, None, 1), (2, 130, 130, 4, 4, 112, None, 1),
                   (1, 150, 150, 8, 4, 256, None, 1), (2, 40, 40, 4, 2, 12, None, 1),
                   (2, 33, 33, 2, 1, 4, None, 1), (2, 40, 200, 4, 2, 64, None, 1),
                   (1, 300, 300, 4, 2, 128, None, 4)]
F32_KWARGS = [dict(), dict(window=8, softcap=25.0), dict(window=100, softcap=25.0),
              dict(causal=False)]
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


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("kernel", ["paged_attention", "paged_attention_int8", "flash_attention"])
def test_kernels_take_unaligned_index_views(cuda, kernel, C):
    """Row slices of a [B, 25] int32 table (internvl2's 25-page rows) at
    an offset of one row, and kv_lens/q_pos sliced off by one element:
    contiguous, not 16-byte aligned.  The reference's kernels take them;
    K1, K3 and K2 launch on them (their wrappers copy such small index
    arguments, never the float operands) and match the plain version on
    the same views."""
    rng = np.random.RandomState(11)
    B, H, KV, d, ps, N, Pmax = 3, 4, 2, 64, 4, 110, 25
    table = torch.from_numpy(rng.permutation(N - 1)[:(B + 1) * Pmax].reshape(B + 1, Pmax))
    table = table.to("cuda", torch.int32)
    pos = torch.from_numpy(rng.randint(0, Pmax * ps - C, size=B + 1)).to("cuda", torch.int32)
    bt, q_pos, kv_lens = table[1:], pos[1:], (pos + C)[1:]
    assert bt.is_contiguous() and bt.data_ptr() % 16 and q_pos.data_ptr() % 16
    if kernel == "flash_attention":
        q, k, v, _ = (x.cuda() for x in flash_inputs((B, C * 8, C * 8, H, KV, d, None, 1)))
        lens = torch.tensor([0, C * 8, C * 8 - 3, C * 4], dtype=torch.int32, device="cuda")[1:]
        assert lens.data_ptr() % 16
        n = K2.launches
        out = K2.flash_attention(q, k, v, lens, scale=0.2)
        assert K2.launches == n + 1
        assert _err(out, K2.flash_attention_plain(q, k, v, lens, scale=0.2)) <= TOL["float32"]
        return
    q = _rand(rng, B, C, H, d).cuda()
    kpg, vpg = _rand(rng, N, ps, KV, d).cuda(), _rand(rng, N, ps, KV, d).cuda()
    if kernel == "paged_attention":
        mod, fn, plain, args = K1, K1.paged_attention, K1.paged_attention_plain, (q, kpg, vpg)
    else:
        (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
        mod, fn, plain = K3, K3.paged_attention_int8, K3.paged_attention_int8_plain
        args = (q, kq, ks, vq, vs)
    n = mod.launches
    out = fn(*args, bt, kv_lens, q_pos, scale=0.2)
    assert mod.launches == n + 1
    assert _err(out, plain(*args, bt, kv_lens, q_pos, scale=0.2)) <= TOL["float32"]


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
    3xTF32 tile loop with its key split) through a stale table, against
    their plain versions on the clean table; a sequence with kv_len 0
    writes exact zeros."""
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


@pytest.mark.parametrize("kernel", ["paged_attention", "paged_attention_int8"])
@pytest.mark.parametrize("case,kw", PAGED_F32_SPLIT_CASES)
def test_paged_f32_chunk_split_edges(cuda, case, kw, kernel):
    """The f32 chunk kernel where its key split has edges: on this card
    each case splits (S > 1), and through a stale table onto a NaN page
    the output is within 1e-4 of the plain version on the clean table
    (also relative to each sequence's max |o|: a dropped split or a
    halved output exceeds it).  For int8 pages the first sequence's last
    two pages, which its chunk's rows see, are all-zero codes with floored
    scales."""
    q, kpg, vpg, table, stale, lens, q_pos = paged_chunk_inputs(case)
    C, H, KV, d, ps = case[:5]
    scale = 1.0 / np.sqrt(d)
    slots = K1.sm_count(cuda) * K1.chunk_blocks_per_sm(kernel, d)
    S, _ = K1.chunk_splits(len(lens), C, H // KV, KV, table.shape[1], ps, slots)
    assert S > 1
    if kernel == "paged_attention":
        mod, run, plain = K1, K1.paged_attention, K1.paged_attention_plain
        pages = [kpg, vpg]
        poison_last_page(*pages)
    else:
        mod, run, plain = K3, K3.paged_attention_int8, K3.paged_attention_int8_plain
        (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
        last = -(-int(lens[0]) // ps)
        zero = table[0, last - 2:last].long()
        for codes, scales in ((kq, ks), (vq, vs)):
            codes[zero], scales[zero] = 0, SCALE_FLOOR
        poison_last_page(ks, vs)
        pages = [kq, ks, vq, vs]
    q, pages = q.to("cuda"), [p.to("cuda") for p in pages]
    table, stale, lens, q_pos = (x.to("cuda") for x in (table, stale, lens, q_pos))
    n = mod.launches_chunk
    out = run(q, *pages, stale, lens, q_pos, scale=scale, **kw)
    torch.cuda.synchronize()
    assert mod.launches_chunk == n + 1
    assert bool(torch.isfinite(out).all())
    want = plain(q, *pages, table, lens, q_pos, scale=scale, **kw)
    assert _err(out, want) <= TOL["float32"]
    assert _row_rel_err(out, want) <= TOL["float32"]


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


def _lse_rel(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_lse_kernel_matches_plain(cuda, case, dtype):
    """K2's training forward: o to the dtype's tolerance, lse (f32 in
    both dtypes) to 1e-4 relative; an empty row gives o = 0 and lse =
    -1e30, as the plain version does."""
    dt = getattr(torch, dtype)
    q, k, v, lens = (x.to("cuda", dt if x.is_floating_point() else None)
                     for x in flash_inputs(case))
    for kw in (dict(), dict(window=8, softcap=25.0), dict(causal=False)):
        n = K2.launches_lse
        o, lse = K2.flash_attention_lse(q, k, v, lens, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert K2.launches_lse == n + 1
        want_o, want_lse = K2.flash_attention_lse_plain(q, k, v, lens, scale=0.2, **kw)
        assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
        assert _err(o, want_o) <= TOL[dtype]
        assert _lse_rel(lse, want_lse) <= 1e-4
        if case[6] == 0:
            assert bool((o[0] == 0).all()) and bool((lse[0] == -1e30).all())


@pytest.mark.parametrize("lse", [False, True], ids=["forward", "lse"])
@pytest.mark.parametrize("case", FLASH_F32_CASES)
def test_flash_f32_kernel_tile_edges(cuda, case, lse):
    """K2's f32 tensor-core kernel at its tile edges, forward-only and
    training forward: o within 1e-4 of the plain version, lse within 1e-4
    relative; an empty row gives o = 0 and lse = -1e30."""
    q, k, v, lens = (x.to("cuda") for x in flash_inputs(case))
    run, plain, counter = ((K2.flash_attention_lse, K2.flash_attention_lse_plain, "launches_lse")
                           if lse else
                           (K2.flash_attention, K2.flash_attention_plain, "launches"))
    for kw in F32_KWARGS:
        n = getattr(K2, counter)
        got = run(q, k, v, lens, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert getattr(K2, counter) == n + 1
        want = plain(q, k, v, lens, scale=0.2, **kw)
        o, want_o = (got[0], want[0]) if lse else (got, want)
        assert _err(o, want_o) <= TOL["float32"], kw
        if lse:
            assert _lse_rel(got[1], want[1]) <= 1e-4, kw
        if case[6] == 0:
            assert bool((o[0] == 0).all())
            assert not lse or bool((got[1][0] == -1e30).all())


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (0, 3, 7, 8, 10, 12, 15)])
def test_flash_ckpt_backward_on_card_matches_cpu(cuda, case):
    """``flash_attention_ckpt``'s backward on the card (K2's training
    forward, the recompute in torch ops) against the CPU's (plain
    forward), f32: dq, dk, dv within 1e-4 of each tensor's max |g|."""
    q, k, v, lens = flash_inputs(case)
    do = torch.from_numpy(np.random.RandomState(1).standard_normal(q.shape).astype(np.float32))
    for kw in (dict(), dict(window=8, softcap=25.0), dict(causal=False)):
        grads = []
        for dev in ("cuda", "cpu"):
            x = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
            ops.flash_attention_ckpt(*x, lens.to(dev), scale=0.2, **kw).backward(do.to(dev))
            grads.append([t.grad.cpu() for t in x])
        for a, b in zip(*grads):
            assert (a - b).abs().max() <= 1e-4 * max(b.abs().max().item(), 1e-30)


def test_kernels_without_backward_refuse_grad_on_card(cuda):
    """K1, K3 and the forward-only K2 raise on inputs that require grad
    under grad mode (never a tensor cut from autograd); under
    ``torch.no_grad`` they launch.  The training route differentiates.
    (K4 has a backward kernel: ``test_ssd_scan_fn_on_card_matches_cpu``.)"""
    paged = _paged(0, 2, 1, 4, 2, 64, 8, 16, 4, torch.float32)
    int8 = _paged_int8(0, 2, 1, 4, 2, 64, 8, 16, 4, torch.float32)
    q, k, v, lens = (t.to("cuda") for t in flash_inputs(FLASH_CASES[0]))
    calls = {
        "paged_attention": lambda q: K1.paged_attention(q, *paged[1:], scale=0.2),
        "paged_attention_int8": lambda q: K3.paged_attention_int8(q, *int8[1:], scale=0.2),
        "flash_attention": lambda q: K2.flash_attention(q, k, v, lens, scale=0.2),
        "flash_attention_lse": lambda q: K2.flash_attention_lse(q, k, v, lens, scale=0.2),
    }
    firsts = {"paged_attention": paged[0], "paged_attention_int8": int8[0],
              "flash_attention": q, "flash_attention_lse": q}
    for name, call in calls.items():
        live = firsts[name].clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no autograd"):
            call(live)
        with torch.no_grad():
            call(live)
    qg = q.clone().requires_grad_()
    ops.flash_attention_ckpt(qg, k, v, lens, scale=0.2).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


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
    _check_ssd_fwd(case, dtype, h0)


def _check_ssd_fwd(case, dtype, h0):
    """K4's forward against its plain version on one case: one launch
    counted, y within the dtype's tolerance and h_final within 1e-4, both
    finite, in the plain version's dtypes."""
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
    """Shapes and dtypes the kernels cannot take raise, under grad too
    (where the backward kernel would run) and in the backward's wrapper."""
    x = torch.zeros(1, 8, 2, 128, device="cuda")       # P = 128 > 64
    la = torch.zeros(1, 8, 2, device="cuda")
    b = torch.zeros(1, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="<= 64"):
        K4.ssd_chunk_scan(x, la, b, b, chunk=8)
    with pytest.raises(ValueError, match="<= 64"):
        K4.ssd_chunk_scan(x.requires_grad_(), la, b, b, chunk=8)
    with pytest.raises(ValueError, match="<= 64"):
        K4.ssd_chunk_scan(x[..., :64], la.requires_grad_(), b, b, chunk=128)
    with pytest.raises(ValueError, match="<= 64"):
        K4.ssd_chunk_scan_bwd(x.detach(), la.detach(), b, b, None, x.detach(), None, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        K4.ssd_chunk_scan(x[..., :64], la.bfloat16(), b, b, chunk=8)
    x64 = x[..., :64].detach().contiguous()
    with pytest.raises(TypeError, match="dy must be"):
        K4.ssd_chunk_scan_bwd(x64, la.detach(), b, b, None, x64.bfloat16(), None, chunk=8)


def _check_ssd_bwd(case, dtype, h0, dh_given):
    """K4's backward kernels against their plain version on one case: one
    launch counted, each gradient finite and within the dtype's tolerance
    of its own max |g|, dtypes and absent gradients as the plain version's."""
    dt = getattr(torch, dtype)
    x, la, Bc, Cc, h = ssd_inputs(case, h0)
    rng = np.random.RandomState(1)
    dy = _rand(rng, *x.shape).to("cuda", dt)
    dh = _rand(rng, *x.shape[:1], x.shape[2], x.shape[3], Bc.shape[-1]).to("cuda") \
        if dh_given else None
    x, Bc, Cc = (a.to("cuda", dt) for a in (x, Bc, Cc))
    la, h = la.to("cuda"), None if h is None else h.to("cuda")
    chunk = case[5]
    n = K4.launches_bwd
    got = K4.ssd_chunk_scan_bwd(x, la, Bc, Cc, h, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert K4.launches_bwd == n + 1             # a CUDA tensor launches, never plain
    want = K4.ssd_chunk_scan_bwd_plain(x, la, Bc, Cc, h, dy, dh, chunk=chunk)
    assert [None if g is None else g.dtype for g in got] == [
        None if g is None else g.dtype for g in want]
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert bool(torch.isfinite(a.float()).all())
        assert _err(a, b) <= TOL[dtype] * max(b.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_bwd_kernel_matches_plain(cuda, case, dtype, h0):
    """K4's backward kernels against their plain version on the same
    inputs (with h0, also a gradient on the final state): each gradient
    within the dtype's tolerance of its own max |g|, all finite."""
    _check_ssd_bwd(case, dtype, h0, h0 == "random")


# B, H, T, P, N, chunk, decay — the edges of the backward's two grids
# (states: (H, B, 2) walking the chunks; chunks: (n_chunks, H, B)): one
# chunk below and at the chunk size (the states pass carries nothing),
# whole chunks, a ragged last chunk at chunk 32, the strong decay, P and N
# not multiples of 8 (element copies; chunk 50), and grids of fewer blocks
# than an H100 has SMs.
SSD_BWD_GRID_CASES = [(2, 4, 50, 64, 64, 64, 0.1), (1, 3, 64, 64, 64, 64, 0.1),
                      (2, 4, 192, 64, 64, 64, 0.1), (1, 4, 130, 64, 64, 32, 0.1),
                      (1, 4, 200, 64, 64, 64, 4.0), (1, 3, 100, 20, 64, 64, 0.1),
                      (1, 3, 100, 64, 12, 50, 0.1), (1, 2, 128, 64, 64, 64, 0.1)]


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_BWD_GRID_CASES)
def test_ssd_fwd_grid_edges(cuda, case, dtype, h0):
    """K4's forward kernels (one block per head and batch row, walking the
    chunks) at the same edges: T below and at one chunk, whole chunks, a
    ragged last chunk at chunk 32, the strong decay, P and N not multiples
    of 8 and grids of fewer blocks than an H100 has SMs: one launch, y and
    h_final within tolerance of the plain version."""
    _check_ssd_fwd(case, dtype, h0)


@pytest.mark.parametrize("dh_final", [False, True], ids=["dh_final=None", "dh_final"])
@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_BWD_GRID_CASES)
def test_ssd_bwd_grid_edges(cuda, case, dtype, h0, dh_final):
    """K4's backward kernels at the edges of their grids, with h0 and
    dh_final each present or absent: one launch, each gradient within the
    dtype's tolerance of its own max |g| of the plain version."""
    _check_ssd_bwd(case, dtype, h0, dh_final)


@pytest.mark.parametrize("case", [SSD_CASES[i] for i in (0, 3, 4, 10)])
def test_ssd_scan_fn_on_card_matches_cpu(cuda, case):
    """The scan under grad on the card (K4's forward, then its backward
    kernel through ``SSDScanFn``) against autograd of the plain scan on
    the CPU, f32, with h0 and h_final both in the loss: every gradient
    within 1e-4 of its max |g|; one forward and one backward launch."""
    x, la, Bc, Cc, h = ssd_inputs(case, "random")
    rng = np.random.RandomState(2)
    dy, dh = _rand(rng, *x.shape), _rand(rng, *h.shape)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, la, Bc, Cc, h)]
        n = (K4.launches, K4.launches_bwd)
        y, hf = K4.ssd_chunk_scan(*leaves, chunk=case[5])
        torch.autograd.backward((y, hf), (dy.to(dev), dh.to(dev)))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (K4.launches, K4.launches_bwd) == (n[0] + 1, n[1] + 1)
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _err(a, b) <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("case,heads", [(SSD_CASES[0], (0, 2)), (SSD_CASES[0], (1, 1)),
                                        (SSD_CASES[6], (56, 56)), (SSD_CASES[6], (3, 28))],
                         ids=["H3-h0+2", "H3-h1+1", "H112-h56+56", "H112-h3+28"])
def test_ssd_scan_fn_on_a_rank_head_slice(cuda, case, heads):
    """K4 under grad on a mesh rank's heads, as ``models/ssm.py::mamba2_block``
    runs it: a head range of the full x, dt and A (non-contiguous views,
    made contiguous by ``ops.ssd_chunk_scan``), x scaled by dt and la =
    -dt A on the slice, h0 the slice's.  The gradients of the full x, dt,
    A, Bc, Cc and h0 on the card (K4's forward and backward kernels)
    against the CPU's autograd of the plain scan, f32, within 1e-4 of each
    max |g|; the slice's y and h_final within 1e-4 of the full-head call's
    slice on the card."""
    h0, n = heads
    x, la, Bc, Cc, h = ssd_inputs(case, "random")
    rng = np.random.RandomState(3)
    dt = torch.from_numpy(np.abs(rng.standard_normal(la.shape)).astype(np.float32) * 0.1)
    A = torch.from_numpy(rng.uniform(0.5, 2.0, x.shape[2]).astype(np.float32))
    dy = _rand(rng, *x[:, :, h0:h0 + n].shape)
    dh = _rand(rng, *h[:, h0:h0 + n].shape)
    grads, outs = {}, {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (x, dt, A, Bc, Cc, h)]
        xf, dtf, Af, bc, cc, hf = leaves
        xs, dts = xf[:, :, h0:h0 + n], dtf[:, :, h0:h0 + n]
        assert not xs.is_contiguous()
        nl = (K4.launches, K4.launches_bwd)
        y, hout = ops.ssd_chunk_scan(xs * dts[..., None], -dts * Af[h0:h0 + n], bc, cc,
                                     hf[:, h0:h0 + n], chunk=case[5])
        torch.autograd.backward((y, hout), (dy.to(dev), dh.to(dev)))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (K4.launches, K4.launches_bwd) == (nl[0] + 1, nl[1] + 1)
            with torch.no_grad():
                yw, hw = ops.ssd_chunk_scan(xf * dtf[..., None], -dtf * Af, bc, cc, hf,
                                            chunk=case[5])
            assert _err(y, yw[:, :, h0:h0 + n]) <= TOL["float32"]
            assert _err(hout, hw[:, h0:h0 + n]) <= TOL["float32"]
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _err(a, b) <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("kv", [(0, 1), (1, 1)], ids=lambda k: f"kv{k[0]}+{k[1]}")
@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (0, 3, 7)])
def test_flash_lse_on_a_rank_head_subset(cuda, case, kv):
    """K2's training forward on a mesh rank's heads: the query heads of a
    range of KV heads (k/v's those KV heads), as contiguous copies of
    slices of the full tensors, o within 1e-4 and lse within 1e-4 relative
    of the full-head call's slice and of the plain version on the slice,
    f32; one launch each."""
    q, k, v, lens = (t.to("cuda") for t in flash_inputs(case))
    KV, G = k.shape[2], q.shape[2] // k.shape[2]
    k0, n = kv
    qs, ks, vs = (t.contiguous() for t in (q[:, :, k0 * G:(k0 + n) * G],
                                           k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]))
    for kw in (dict(), dict(window=8, softcap=25.0), dict(causal=False)):
        n0 = K2.launches_lse
        o, lse = K2.flash_attention_lse(qs, ks, vs, lens, scale=0.2, **kw)
        of, lsef = K2.flash_attention_lse(q, k, v, lens, scale=0.2, **kw)
        torch.cuda.synchronize()
        assert K2.launches_lse == n0 + 2
        assert _err(o, of[:, :, k0 * G:(k0 + n) * G]) <= TOL["float32"], kw
        assert _lse_rel(lse, lsef[:, k0:k0 + n]) <= 1e-4, kw
        want_o, want_lse = K2.flash_attention_lse_plain(qs, ks, vs, lens, scale=0.2, **kw)
        assert _err(o, want_o) <= TOL["float32"] and _lse_rel(lse, want_lse) <= 1e-4, kw


def test_hybrid_train_grad_on_card_matches_cpu(cuda):
    """One training gradient of the reduced zamba2 hybrid at T = 80 (two
    scan chunks, the last ragged) on the card (K4's forward and backward
    kernels, K2's training forward) against the CPU's, f32: the loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its max |g|."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import TrainConfig
    from repro_torch.train.trainer import make_loss_fn, value_and_grad
    model = get_model("zamba2-7b", get_config("zamba2-7b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.RandomState(0).randint(2, 256, size=(2, 80)))
    loss_fn = make_loss_fn(model, TrainConfig(remat=True))
    runs = {}
    for dev in ("cuda", "cpu"):
        n = K4.launches_bwd
        loss, grads = value_and_grad(loss_fn, _to(params, dev),
                                     {"tokens": toks.to(dev), "labels": toks.to(dev)})
        if dev == "cuda":
            assert K4.launches_bwd > n
        runs[dev] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gc, gp):
        assert bool(torch.isfinite(a).all())
        assert _err(a, b) <= 1e-4 * max(b.abs().max().item(), 1e-30)


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


def test_rwkv_on_card_matches_cpu(cuda):
    """Reduced rwkv6, f32: prefill logits and states within 1e-4 of the
    CPU's and equal greedy streams (the WKV scan is plain PyTorch on both
    devices)."""
    model = get_model("rwkv6-7b", get_config("rwkv6-7b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(0).randint(2, 256, size=(3, 20))
    card = _to(params, "cuda")
    got, got_st = PR.prefill(card, model.cfg, torch.as_tensor(toks, device="cuda"))
    want, want_st = PR.prefill(params, model.cfg, torch.as_tensor(toks))
    assert _err(got.cpu(), want) <= TOL["float32"]
    assert all(_err(got_st[k].cpu(), want_st[k]) <= TOL["float32"] for k in want_st)
    np.testing.assert_array_equal(rwkv_greedy_stream(card, model.cfg, toks, 8),
                                  rwkv_greedy_stream(params, model.cfg, toks, 8))


def test_encdec_on_card_matches_cpu(cuda):
    """Reduced seamless-m4t, f32: prefill logits within 1e-4 of the CPU's
    (K2 in the encoder, the decoder and cross-attention) and equal greedy
    streams through K1 decode and K2 cross decode, the second utterance's
    cross keys masked past 9 of its 16 frames."""
    model = get_model("seamless-m4t-medium", get_config("seamless-m4t-medium").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(2, 256, size=(2, 8))
    frames = torch.from_numpy((rng.standard_normal((2, 16, model.cfg.d_model)) * 0.3)
                              .astype(np.float32))
    card = _to(params, "cuda")
    n1, n2 = K1.launches, K2.launches
    got = PE.prefill(card, model.cfg, frames.cuda(), torch.as_tensor(toks, device="cuda"))[0]
    want = PE.prefill(params, model.cfg, frames, torch.as_tensor(toks))[0]
    assert _err(got.cpu(), want) <= TOL["float32"]
    evl = np.array([16, 9], np.int32)
    stream = encdec_greedy_stream(card, model.cfg, frames, toks, 8, ps=4, enc_valid_len=evl)
    assert K1.launches > n1 and K2.launches > n2
    np.testing.assert_array_equal(
        stream, encdec_greedy_stream(params, model.cfg, frames, toks, 8, ps=4,
                                     enc_valid_len=evl))


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
