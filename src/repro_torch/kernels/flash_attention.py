"""K2: flash attention, forward — the prompt phase of ``sequential``
serving (monolithic prefill through ``forward_hidden``) and every
attention forward of a training step (:func:`flash_attention_lse`).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``; the CUDA
source is ``csrc/flash_attention.cu``, whose header note says what
bounds it and how.  bf16 runs on the tensor cores: blocks of 64 folded
query rows, ``mma.sync`` products with P rounded to bf16, K/V tiles of
64 keys double-buffered by ``cp.async``.  f32 runs the same geometry on
the tensor cores in 3xTF32 (each f32 operand split into two TF32 parts,
three ``mma.sync.m16n8k8`` products, f32-grade results; P kept in f32),
key tiles of 64 (32 at d > 128).  Query and key positions are their
indices, as in the Pallas kernel; ``kv_lens`` masks keys at or past each
row's length.

Layouts are the model's: q [B, T, H, d]; k/v [B, Tk, KV, d]; kv_lens [B]
int32.  Returns o [B, T, H, d] in q's dtype.  :func:`flash_attention_lse`
also returns the log-normalizer lse [B, KV, G, T] f32 (the reference's
layout, in the capped-logit scale): the same kernels instantiated with a
compile-time flag that writes it, through the C entries
``flash_attention_lse_{f32,bf16}``.  Its backward is the recompute of
``models/layers.py::flash_attention_ckpt``, torch ops; the forward-only
:func:`flash_attention` refuses inputs that require grad on the card.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise.  ``launches`` counts forward-only launches and
``launches_lse`` the training forward's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.models import layers
from repro_torch.models.layers import NO_WINDOW

launches = 0
launches_lse = 0

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_LSE_SYMBOLS = {torch.float32: "flash_attention_lse_f32",
                torch.bfloat16: "flash_attention_lse_bf16"}
_TAIL = ([ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_ARGTYPES = [ctypes.c_void_p] * 5 + _TAIL
_LSE_ARGTYPES = [ctypes.c_void_p] * 6 + _TAIL


def flash_attention_plain(q, k, v, kv_lens, *, scale, causal=True,
                          window=None, softcap=None, _return_lse=False):
    """The plain PyTorch version: ``models.layers.flash_attention`` with
    index positions (with ``_return_lse``, (o, lse))."""
    B, T = q.shape[:2]
    Tk = k.shape[1]
    q_positions = torch.arange(T, device=q.device)[None].expand(B, T)
    kv_positions = torch.arange(Tk, device=q.device)[None].expand(B, Tk)
    return layers.flash_attention(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        kv_valid_len=kv_lens.long(), scale=scale, causal=causal,
        window=window, attn_softcap=softcap, _return_lse=_return_lse)


def flash_attention_lse_plain(q, k, v, kv_lens, *, scale, causal=True,
                              window=None, softcap=None):
    """The plain version of :func:`flash_attention_lse`."""
    return flash_attention_plain(q, k, v, kv_lens, scale=scale, causal=causal,
                                 window=window, softcap=softcap, _return_lse=True)


def _check(q, k, v, kv_lens):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, T, H, d], got shape {tuple(q.shape)}")
    B, T, H, d = q.shape
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"k/v must share shape [B, Tk, KV, d], got "
                         f"{tuple(k.shape)} vs {tuple(v.shape)}")
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} disagrees with q {tuple(q.shape)}: "
                         "need the same B and d and H a multiple of KV")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes must match, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_lens.shape != (B,) or kv_lens.dtype.is_floating_point \
            or kv_lens.dtype == torch.bool:
        raise ValueError(f"kv_lens must be integer [B={B}], got "
                         f"{tuple(kv_lens.shape)} {kv_lens.dtype}")
    devs = {t.device for t in (q, k, v, kv_lens)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _launch(symbol, argtypes, q, k, v, kv_lens, outs, scale, causal, window,
            softcap):
    B, T, H, d = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    fn = build.kernel_fn("flash_attention", symbol, argtypes)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
            *(o.data_ptr() for o in outs), B, T, Tk, H, KV, d, float(scale),
            int(causal), NO_WINDOW if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")


def _on_card(q, k, v, kv_lens, name):
    """Check a call for the CUDA kernel: ``kv_lens`` as the kernel reads it
    (``build.index_arg``), or None for CPU tensors (the plain version
    runs)."""
    _check(q, k, v, kv_lens)
    if q.device.type == "cpu":
        return None
    build.refuse_grad(name, (q, k, v), build.TRAIN_ROUTE)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {q.device}")
    kv_lens = build.index_arg(kv_lens)
    build.check_cuda_args(dict(q=q, k=k, v=v, kv_lens=kv_lens), ("kv_lens",),
                          q.dtype, q.shape[-1])
    return kv_lens


def flash_attention(q, k, v, kv_lens, *, scale: float, causal: bool = True,
                    window=None, softcap=None):
    """Flash attention, forward (see the module docstring for layouts)."""
    card_lens = _on_card(q, k, v, kv_lens, "flash_attention")
    if card_lens is None:
        return flash_attention_plain(q, k, v, kv_lens, scale=scale,
                                     causal=causal, window=window,
                                     softcap=softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(_SYMBOLS[q.dtype], _ARGTYPES, q, k, v, card_lens, (out,), scale,
            causal, window, softcap)
    global launches
    launches += 1
    return out


def flash_attention_lse(q, k, v, kv_lens, *, scale: float, causal: bool = True,
                        window=None, softcap=None):
    """The training forward: (o [B, T, H, d], lse [B, KV, G, T] f32).
    ``flash_attention_ckpt`` calls it inside its ``torch.autograd.Function``
    (whose forward runs without grad); called directly on the card with
    inputs that require grad, it raises as :func:`flash_attention` does."""
    card_lens = _on_card(q, k, v, kv_lens, "flash_attention_lse")
    if card_lens is None:
        return flash_attention_lse_plain(q, k, v, kv_lens, scale=scale,
                                         causal=causal, window=window,
                                         softcap=softcap)
    B, T, H, _ = q.shape
    KV = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, KV, H // KV, T, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch(_LSE_SYMBOLS[q.dtype], _LSE_ARGTYPES, q, k, v, card_lens, (out, lse),
            scale, causal, window, softcap)
    global launches_lse
    launches_lse += 1
    return out, lse
