"""SARATHI-style chunked-prefill phase planner (``mode="chunked"``).

The engine's other modes dispatch each phase monolithically: a single
2k-token prompt's prefill stalls every in-flight decode for the whole
prompt — the long-prompt tail-TBT cliff.  The planner inverts the
priority: each round, every runnable decode token claims its slice of a
fixed token budget (``ServeConfig.chunk_tokens``) first — decodes are
never starved — and the *remainder* is carved over the in-flight prefill
streams.  The engine dispatches the resulting :class:`ChunkPlan` as one
mixed program per round, so compute intensity stays flat and no decode
ever waits longer than ~one chunk's worth of prefill work.

The planner is pure bookkeeping: it decides *how many* tokens each
stream contributes this round; the engine keeps page budgeting,
cache fast-forwarding and dispatch.  Streams are served round-robin
from a rotating cursor so a long prompt on stream 0 cannot
permanently crowd out stream 1 when the budget is tight; when the
engine passes per-stream deadline ``priorities`` (tenant-weighted TTFT
slack, ``core/slo.py``), the carve runs most-urgent-first instead, so
a deadline-critical prefill is never the one left holding the bag on a
tight round.

:func:`validate_plan` makes the packing contract executable; the runtime
sanitizer (``analysis/invariants.py``, ``KVSanitizer.note_plan``) runs it
against every live plan at any ``sanitize_level`` above ``off``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ChunkPlan:
    """One round's mixed-batch packing decision.

    ``chunk_lens[i]`` is the prefill-token count stream ``i`` contributes
    this round (0 for empty or passed-over streams); ``n_decode_tokens``
    is every runnable decode token — packed unconditionally, they are
    what the budget is *for*.  ``cap`` is the static per-stream token
    array width the engine compiles against (== ``budget``, so a single
    stream may absorb the whole budget without a reshape).
    """
    chunk_lens: Tuple[int, ...]
    n_decode_tokens: int
    budget: int          # ServeConfig.chunk_tokens
    cap: int             # static p_tokens row width

    @property
    def n_prefill_tokens(self) -> int:
        return sum(self.chunk_lens)

    @property
    def n_packed_tokens(self) -> int:
        return self.n_prefill_tokens + self.n_decode_tokens

    @property
    def occupancy(self) -> float:
        """Packed tokens over budget; may exceed 1.0 when the decode
        batch alone outgrows ``chunk_tokens`` (decodes are never
        dropped to fit)."""
        return self.n_packed_tokens / self.budget


class ChunkPlanner:
    """Carves in-flight prefills into fixed-token-budget chunks packed
    with the round's decode tokens (one plan per engine round)."""

    def __init__(self, chunk_tokens: int, n_streams: int):
        if chunk_tokens <= 0:
            raise ValueError(
                f"chunk_tokens must be positive, got {chunk_tokens}")
        if n_streams <= 0:
            raise ValueError(f"n_streams must be positive, got {n_streams}")
        self.chunk_tokens = chunk_tokens
        self.n_streams = n_streams
        self._cursor = 0     # round-robin start stream (fairness under
                             # a budget too small for every stream)

    def plan(self, remaining: Sequence[int], n_decode_tokens: int,
             priorities: Optional[Sequence[Optional[float]]] = None
             ) -> ChunkPlan:
        """Pack one round: ``remaining[i]`` prefill tokens left on stream
        ``i`` (0 when empty), ``n_decode_tokens`` runnable decodes.

        Decodes take their budget share first; what's left is carved
        greedily over the streams starting at the rotating cursor.  The
        carve is work-conserving: budget only goes unused when no stream
        has tokens left to take it.

        ``priorities`` makes the carve order deadline/weight-aware
        (``core/slo.py``): when any entry is non-None, streams are
        carved most-urgent first — ascending by priority value
        (weighted TTFT slack as computed by the engine), ``None``
        entries (no deadline) last in stream order — instead of from
        the rotating cursor.  The cursor still advances so dropping
        back to the deadline-free path (all-None rounds) keeps its
        round-robin fairness exactly where it would have been.  Only
        the carve *order* changes; :func:`validate_plan`'s packing
        contract (totals, caps, work conservation) is order-blind, so
        urgency-ordered plans satisfy the same invariant.
        """
        if len(remaining) != self.n_streams:
            raise ValueError(
                f"plan() got {len(remaining)} stream remainders for "
                f"{self.n_streams} streams")
        if n_decode_tokens < 0:
            raise ValueError(
                f"n_decode_tokens must be >= 0, got {n_decode_tokens}")
        if priorities is not None and len(priorities) != self.n_streams:
            raise ValueError(
                f"plan() got {len(priorities)} stream priorities for "
                f"{self.n_streams} streams")
        if priorities is not None and any(p is not None for p in priorities):
            carve = sorted(range(self.n_streams),
                           key=lambda i: (priorities[i] is None,
                                          priorities[i]
                                          if priorities[i] is not None
                                          else 0.0, i))
        else:
            carve = [(self._cursor + k) % self.n_streams
                     for k in range(self.n_streams)]
        lens = [0] * self.n_streams
        left = max(self.chunk_tokens - n_decode_tokens, 0)
        for i in carve:
            if left <= 0:
                break
            take = min(max(remaining[i], 0), left)
            lens[i] = take
            left -= take
        self._cursor = (self._cursor + 1) % self.n_streams
        return ChunkPlan(chunk_lens=tuple(lens),
                         n_decode_tokens=n_decode_tokens,
                         budget=self.chunk_tokens, cap=self.chunk_tokens)


def validate_plan(plan: ChunkPlan, remaining: Sequence[int],
                  n_decode_tokens: int) -> None:
    """Raise ``ValueError`` when ``plan`` breaks the packing contract for
    the round it was made from:

    * every decode token is packed (never dropped or invented);
    * no stream is carved past its remaining tokens or the static cap;
    * total prefill fits the budget the decodes left over;
    * the carve is work-conserving — leftover budget with a stream still
      holding tokens means the planner under-packed the round.
    """
    if len(plan.chunk_lens) != len(remaining):
        raise ValueError(
            f"plan covers {len(plan.chunk_lens)} streams, round has "
            f"{len(remaining)}")
    if plan.n_decode_tokens != n_decode_tokens:
        raise ValueError(
            f"plan packs {plan.n_decode_tokens} decode tokens but the "
            f"round has {n_decode_tokens} runnable decodes: decodes must "
            "be packed unconditionally")
    prefill_budget = max(plan.budget - plan.n_decode_tokens, 0)
    for i, (take, rem) in enumerate(zip(plan.chunk_lens, remaining,
                                        strict=True)):
        if take < 0:
            raise ValueError(f"stream {i}: negative chunk length {take}")
        if take > max(rem, 0):
            raise ValueError(
                f"stream {i}: chunk of {take} tokens exceeds the stream's "
                f"{rem} remaining prefill tokens")
        if take > plan.cap:
            raise ValueError(
                f"stream {i}: chunk of {take} tokens exceeds the static "
                f"row cap {plan.cap}")
    if plan.n_prefill_tokens > prefill_budget:
        raise ValueError(
            f"plan packs {plan.n_prefill_tokens} prefill tokens but "
            f"{plan.n_decode_tokens} decodes leave only {prefill_budget} "
            f"of the {plan.budget}-token budget")
    leftover = prefill_budget - plan.n_prefill_tokens
    if leftover > 0:
        starved = [i for i, (take, rem)
                   in enumerate(zip(plan.chunk_lens, remaining, strict=True))
                   if max(rem, 0) > take]
        if starved:
            raise ValueError(
                f"plan leaves {leftover} budget tokens unused while "
                f"streams {starved} still hold prefill work "
                "(not work-conserving)")
