"""Per-request token sampling: greedy / temperature / top-k / top-p.

``SamplingParams`` travels with each :class:`~repro_torch.core.engine.Request`
(vLLM-style); the engine lowers a batch of heterogeneous requests into
per-row parameter tensors and calls :func:`sample_tokens` once per batch.

Determinism: row ``i`` draws its noise from a ``torch.Generator`` seeded
from ``(seed, rid, position)`` — the request's own seed, its id, and the
index of the token being sampled — never from engine state.  Sampled
outputs are therefore independent of batch composition, engine mode,
and preemption/resume history.  The reference package draws from JAX's
threefry stream instead, which PyTorch cannot reproduce: sampled token
*values* differ between the two packages, the properties do not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters (attached to ``Request.sampling``).

    ``temperature == 0`` means greedy (argmax); ``top_k == 0`` and
    ``top_p == 1.0`` disable their filters.  ``eos_id`` /
    ``stop_token_ids`` end generation early with
    ``finish_reason="stop"``; ``max_new_tokens`` ends it with
    ``finish_reason="length"``.
    """
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.eos_id is not None and (
                not isinstance(self.eos_id, int)
                or isinstance(self.eos_id, bool) or self.eos_id < 0):
            raise ValueError(
                f"eos_id must be a non-negative int or None, got "
                f"{self.eos_id!r}")
        if not isinstance(self.stop_token_ids, tuple) or any(
                not isinstance(t, int) or isinstance(t, bool) or t < 0
                for t in self.stop_token_ids):
            raise ValueError(
                f"stop_token_ids must be a tuple of non-negative ints, got "
                f"{self.stop_token_ids!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool) \
                or self.seed < 0:
            raise ValueError(
                f"seed must be a non-negative int (PRNGKey seed), got "
                f"{self.seed!r}")

    @property
    def stop_set(self) -> frozenset:
        s = frozenset(self.stop_token_ids)
        return s if self.eos_id is None else s | {self.eos_id}


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """All-greedy fast path: argmax over the last axis.  Ties resolve to
    the first maximum, as ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64 finalizer: spreads nearby integers over 64 bits."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(seed: int, rid: int, pos: int) -> int:
    """Independent stream per (request seed, request id, token index)."""
    return _mix64(_mix64(_mix64(int(seed)) ^ int(rid)) ^ int(pos))


def _gumbel_rows(seed, rid, pos, V: int) -> torch.Tensor:
    """[B, V] Gumbel noise, row i from its own CPU generator."""
    rows = []
    # one CPU generator a row defines every sampled stream; its cost is
    # ROADMAP's sampler-noise item, so the lint's loop rules are waived here
    for s, r, p in zip(seed.tolist(), rid.tolist(), pos.tolist()):  # rpr: noqa[RPR004,RPR007]
        g = torch.Generator().manual_seed(row_seed(s, r, p))  # rpr: noqa[RPR004,RPR007]
        u = torch.rand(V, generator=g, dtype=torch.float64)  # rpr: noqa[RPR004,RPR007]
        rows.append(-torch.log(-torch.log(u.clamp_min(1e-300))))  # rpr: noqa[RPR004,RPR007]
    return torch.stack(rows).to(torch.float32)


def sample_tokens(logits, temperature, top_k, top_p, seed, rid, pos):
    """logits [B, V] + per-row parameter tensors [B] -> tokens [B] int32.

    Every row is processed with its own knobs: rows with
    ``temperature <= 0`` take the exact argmax (bit-identical to
    :func:`greedy_tokens`); the rest are temperature-scaled, top-k- then
    top-p-masked, and sampled (Gumbel-max) from their ``(seed, rid, pos)``
    stream.  ``seed``/``rid``/``pos`` may live on any device: the noise
    is drawn on the CPU and moved to ``logits.device``.
    """
    V = logits.shape[-1]
    dev = logits.device
    temperature = temperature.to(dev)
    top_k = top_k.to(dev)
    top_p = top_p.to(dev)
    logits = logits.float()
    greedy = greedy_tokens(logits)

    lg = logits / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: mask strictly below each row's k-th largest logit (k=0 -> off)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(sorted_lg, 1,
                       torch.clamp(top_k - 1, 0, V - 1)[:, None].long())
    lg = torch.where((top_k[:, None] > 0) & (lg < kth),
                     torch.full_like(lg, -1e30), lg)
    # top-p (nucleus) on the top-k-masked logits (p=1 -> off)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_lg, 1, torch.clamp(cutoff_idx, 0, V - 1))
    lg = torch.where((top_p[:, None] < 1.0) & (lg < cutoff),
                     torch.full_like(lg, -1e30), lg)

    noise = _gumbel_rows(seed.cpu(), rid.cpu(), pos.cpu(), V).to(dev)
    sampled = torch.argmax(lg + noise, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)
