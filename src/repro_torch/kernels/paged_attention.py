"""K1: ragged paged attention — the Splitwiser serving kernel.

One kernel covers both inference phases: decode (C = 1 query token per
sequence) and chunked prefill (C query tokens attending to their paged
history and to their own freshly written keys).  It replaces the Pallas
TPU kernel ``src/repro/kernels/paged_attention.py::paged_attention``;
the CUDA source is ``csrc/paged_attention.cu``, whose header note says
what bounds it and how.

Layouts are the model's (no transposes around the launch):
  q            [B, C, H, d]      H = KV * G query heads
  k/v_pages    [N, ps, KV, d]    the page pool of one layer
  block_table  [B, Pmax] int32   page ids; rows past ceil(kv_len/ps) unread
  kv_lens      [B] int32         valid keys, incl. the freshly written ones
  q_pos        [B] int32         position of query row 0 (rows are consecutive)
Returns o [B, C, H, d] in q's dtype.

Dispatch: CPU tensors take :func:`paged_attention_plain`; CUDA tensors
launch a kernel or raise.  Decode (C = 1), f32 and bf16, runs the split-KV
kernel of ``csrc/paged_decode.cuh``: it is bound by the bytes of K/V it
reads, so :func:`decode_splits` cuts each row's keys into S splits of L
keys, from shapes alone, to put about four blocks on every SM whatever the
batch; with S > 1 a combine kernel merges the splits' f32 partials, which
live in a workspace allocated here once per shape (:func:`decode_plan`).  Chunks
(C > 1) run on the tensor cores: bf16 in ``csrc/paged_tiles.cuh``, f32 in
3xTF32 in ``csrc/paged_tiles_f32.cuh``, whose keys :func:`chunk_splits`
cuts, again from shapes alone, when the chunk's row tiles leave SMs idle,
with the f32 partials in a workspace of :func:`chunk_plan`.  ``launches``
counts wrapper calls that launch, ``launches_decode`` those with C = 1 and
``launches_chunk`` those with C > 1 (a split call launches two kernels and
counts once).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import NO_WINDOW, paged_attention_ref

launches = 0
launches_decode = 0
launches_chunk = 0

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_F32_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_DECODE_SYMBOLS = {torch.float32: "paged_attention_decode_f32",
                   torch.bfloat16: "paged_attention_decode_bf16"}
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])

BLOCKS_PER_SM = 4        # the decode grid aims at about this many blocks an SM
MIN_SPLIT_KEYS = 128     # a shorter split costs more in partials than it spreads
MAX_SPLIT_PAGES = 1024   # = csrc/paged_decode.cuh's, whose C entries refuse more


def decode_splits(B: int, KV: int, Pmax: int, ps: int, sms: int):
    """(S, L): the decode kernel's split of a row's ``Pmax * ps`` keys into
    S splits of L keys each, L a whole number of pages.

    Decode's grid is (S, KV, B): S grows until the grid holds about
    ``BLOCKS_PER_SM`` blocks for each of the ``sms`` SMs, but a split keeps
    at least ``MIN_SPLIT_KEYS`` keys and at most ``MAX_SPLIT_PAGES`` pages.
    It reads shapes only, never ``kv_lens`` or ``q_pos``: those live on the
    card, and reading them would put a host sync into every decode step.
    Split s covers the absolute keys [s * L, (s + 1) * L); the kernel clips
    it to the row's visible range.
    """
    S = max(1, min(-(-BLOCKS_PER_SM * sms // max(B * KV, 1)),
                   -(-Pmax * ps // MIN_SPLIT_KEYS)))
    pages = max(1, min(-(-Pmax // S), MAX_SPLIT_PAGES))
    return max(1, -(-Pmax // pages)), pages * ps


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


BLOCK_M = 64             # folded query rows a block of the chunk loops


def chunk_splits(B: int, C: int, G: int, KV: int, Pmax: int, ps: int, slots: int):
    """(S, L): the f32 chunk kernel's split of a row's ``Pmax * ps`` keys
    into S splits of L keys each, L a whole number of pages.

    The grid is S blocks for each (64 folded rows, kv head, sequence);
    ``slots`` blocks run at once (SMs times blocks an SM).  Each block is
    costed at its split's pages, and S (up to two waves of blocks, with at
    least ``MIN_SPLIT_KEYS`` keys a split) minimises waves x pages a split.
    A split is taken only if it lowers that cost below S = 1's, so a grid
    that already fills the card stays whole; among splits of equal cost
    the most are taken, since blocks are seldom full (causal rows, ragged
    lengths and windows leave some short) and smaller ones balance them.
    It reads shapes only, never ``kv_lens`` or ``q_pos`` (see
    :func:`decode_splits`).  Split s covers the absolute keys
    [s * L, (s + 1) * L); the kernel clips it to each row's visible range.
    """
    blocks = -(-C * G // BLOCK_M) * KV * B
    unsplit = best = (-(-blocks // slots) * Pmax, 1)
    for S in range(2, max(1, Pmax * ps // MIN_SPLIT_KEYS) + 1):
        if blocks * (S - 1) >= 2 * slots:
            break
        cost = -(-blocks * S // slots) * -(-Pmax // S)
        if cost < unsplit[0] and cost <= best[0]:
            best = (cost, S)
    pages = -(-Pmax // best[1])
    return -(-Pmax // pages), pages * ps


@functools.lru_cache(maxsize=None)
def chunk_blocks_per_sm(lib: str, d: int) -> int:
    """Blocks of the f32 chunk kernel of ``lib`` (``paged_attention`` or
    ``paged_attention_int8``) one SM holds at head dim d."""
    n = build.kernel_fn(lib, f"{lib}_f32_blocks_per_sm", [ctypes.c_int])(d)
    if n < 1:
        raise RuntimeError(f"{lib}: the f32 chunk kernel cannot be resident at d={d} "
                           f"(CUDA error {-n})")
    return n


_plans = {}
_chunk_plans = {}


def decode_plan(B: int, H: int, KV: int, d: int, Pmax: int, ps: int,
                device: torch.device, stream: int):
    """(S, L, acc pointer, (m, l) pointer) of a decode call: the split of
    :func:`decode_splits` and the f32 workspace of its partials, acc
    [B, H, S, d] and (m, l) [B, H, S, 2] (null pointers when S == 1).
    Made once per shape, device and stream, then reused, so a decode step
    costs the host no split choice and no allocation: calls on one stream
    run in order, so one call's combine has read the workspace before the
    next call's split kernel writes it."""
    key = (B, H, KV, d, Pmax, ps, device, stream)
    plan = _plans.get(key)
    if plan is None:
        S, L = decode_splits(B, KV, Pmax, ps, sm_count(device))
        ws = None
        if S > 1:
            ws = torch.empty(B * H * S * (d + 2), dtype=torch.float32, device=device)
        plan = _plans[key] = (S, L, None if ws is None else ws.data_ptr(),
                              None if ws is None else ws.data_ptr() + 4 * B * H * S * d, ws)
    return plan[:4]


def chunk_plan(lib: str, B: int, C: int, H: int, KV: int, d: int, Pmax: int, ps: int,
               device: torch.device, stream: int):
    """(S, L, acc pointer, (m, l) pointer) of an f32 chunk call of ``lib``:
    the split of :func:`chunk_splits` on this card and the f32 workspace of
    its partials, acc [B, C, H, S, d] and (m, l) [B, C, H, S, 2] (null
    pointers when S == 1), made once per shape, device and stream as
    :func:`decode_plan` makes decode's."""
    key = (lib, B, C, H, KV, d, Pmax, ps, device, stream)
    plan = _chunk_plans.get(key)
    if plan is None:
        slots = sm_count(device) * chunk_blocks_per_sm(lib, d)
        S, L = chunk_splits(B, C, H // KV, KV, Pmax, ps, slots)
        ws = None
        if S > 1:
            ws = torch.empty(B * C * H * S * (d + 2), dtype=torch.float32, device=device)
        plan = _chunk_plans[key] = (
            S, L, None if ws is None else ws.data_ptr(),
            None if ws is None else ws.data_ptr() + 4 * B * C * H * S * d, ws)
    return plan[:4]


def paged_attention_plain(q, k_pages, v_pages, block_table, kv_lens, q_pos, *,
                          scale, window=None, softcap=None):
    """The plain PyTorch version: gather the table's pages, then flash
    attention over them (``models.layers.paged_attention_ref``)."""
    C = q.shape[1]
    q_positions = q_pos.long()[:, None] + torch.arange(C, device=q.device)[None]
    return paged_attention_ref(q, k_pages, v_pages, block_table.long(),
                               kv_lens.long(), q_positions, scale=scale,
                               window=window, attn_softcap=softcap)


def _check(q, k_pages, v_pages, block_table, kv_lens, q_pos):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, C, H, d], got shape {tuple(q.shape)}")
    B, C, H, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must share shape [N, ps, KV, d], got "
            f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    KV = k_pages.shape[2]
    if k_pages.shape[3] != d or H % KV:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} disagree with q {tuple(q.shape)}: "
            "need the same d and H a multiple of KV")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError(f"q/k_pages/v_pages dtypes must match, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, Pmax], got "
                         f"{tuple(block_table.shape)}")
    if kv_lens.shape != (B,) or q_pos.shape != (B,):
        raise ValueError(f"kv_lens/q_pos must be [B={B}], got "
                         f"{tuple(kv_lens.shape)} / {tuple(q_pos.shape)}")
    for name, t in (("block_table", block_table), ("kv_lens", kv_lens),
                    ("q_pos", q_pos)):
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"{name} must be integer-typed, got {t.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, block_table, kv_lens, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def paged_attention(q, k_pages, v_pages, block_table, kv_lens, q_pos, *,
                    scale: float, window=None, softcap=None):
    """Ragged paged attention (see the module docstring for layouts)."""
    _check(q, k_pages, v_pages, block_table, kv_lens, q_pos)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     kv_lens, q_pos, scale=scale,
                                     window=window, softcap=softcap)
    build.refuse_grad("paged_attention", (q, k_pages, v_pages),
                      "it serves decode and chunks only: " + build.TRAIN_ROUTE)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {q.device}")
    block_table, kv_lens, q_pos = (build.index_arg(t) for t in (block_table, kv_lens, q_pos))
    build.check_cuda_args(
        dict(q=q, k_pages=k_pages, v_pages=v_pages, block_table=block_table,
             kv_lens=kv_lens, q_pos=q_pos),
        ("block_table", "kv_lens", "q_pos"), q.dtype, q.shape[-1])
    out = torch.empty_like(q)
    if out.numel() == 0:        # e.g. the zero-row decode half of a
        return out              # phase-exclusive prefill step
    B, C, H, d = q.shape
    N, ps, KV, _ = k_pages.shape
    Pmax = block_table.shape[1]
    pointers = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), kv_lens.data_ptr(), q_pos.data_ptr(),
                out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rest = (float(scale), NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap), stream)
    if C == 1:
        S, L, acc, ml = decode_plan(B, H, KV, d, Pmax, ps, q.device, stream)
        fn = build.kernel_fn("paged_attention", _DECODE_SYMBOLS[q.dtype], _DECODE_ARGTYPES)
        rc = fn(*pointers, acc, ml, B, H, KV, d, N, ps, Pmax, S, L, *rest)
    elif q.dtype == torch.float32:
        S, L, acc, ml = chunk_plan("paged_attention", B, C, H, KV, d, Pmax, ps, q.device,
                                   stream)
        fn = build.kernel_fn("paged_attention", "paged_attention_f32", _F32_ARGTYPES)
        rc = fn(*pointers, acc, ml, B, C, H, KV, d, N, ps, Pmax, S, L, *rest)
    else:
        fn = build.kernel_fn("paged_attention", "paged_attention_bf16", _ARGTYPES)
        rc = fn(*pointers, B, C, H, KV, d, N, ps, Pmax, *rest)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    global launches, launches_decode, launches_chunk
    launches += 1
    if C == 1:
        launches_decode += 1
    else:
        launches_chunk += 1
    return out
