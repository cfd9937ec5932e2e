"""The paper's performance metrics (§II-E): E2E latency, TTFT, TBT,
throughput, plus KV-cache usage traces (Fig. 5/14/15)."""
from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

DEFAULT_SCHED_EVENTS_CAP = 16384


class EventRing:
    """Bounded scheduler-event trace (list-like, oldest-first).

    Long open-loop runs emit an admit/preempt/reclaim event stream that
    previously grew without bound; this ring keeps the newest ``cap``
    events and counts what it dropped (``n_dropped``) so consumers can
    tell a short trace from a truncated one.  Supports the list surface
    existing readers use: iteration, ``len``, indexing and slicing.
    """

    def __init__(self, cap: int = DEFAULT_SCHED_EVENTS_CAP):
        if cap <= 0:
            raise ValueError(f"EventRing cap must be positive, got {cap}")
        self.cap = cap
        self._buf: deque = deque(maxlen=cap)
        self.n_dropped = 0

    def append(self, event: dict) -> None:
        if len(self._buf) == self.cap:
            self.n_dropped += 1
        self._buf.append(event)

    @property
    def n_total(self) -> int:
        """Events ever appended (retained + dropped) — a stable cursor
        for "what arrived since" bookkeeping that survives drops."""
        return len(self._buf) + self.n_dropped

    def __iter__(self) -> Iterator[dict]:
        return iter(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._buf)[idx]
        return self._buf[idx]

    def __repr__(self) -> str:
        return (f"EventRing(cap={self.cap}, n={len(self._buf)}, "
                f"dropped={self.n_dropped})")


@dataclass
class RequestMetrics:
    rid: int
    arrival: float = 0.0
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    n_prompt: int = 0
    n_generated: int = 0
    n_preempted: int = 0         # times this request was evicted + requeued
    n_cached_tokens: int = 0     # prefill tokens served from the prefix cache
                                 # (summed across preemption resumes)
    finish_reason: Optional[str] = None   # "length" | "stop" once done
    # --- SLO accounting (core/slo.py; stamped at submit / settled at
    # finish by the engine) ---
    tenant: str = "default"
    ttft_target: Optional[float] = None   # effective (tier-resolved) targets
    tbt_target: Optional[float] = None
    slo_ok: Optional[bool] = None   # attained? None = carries no deadline

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None else self.t_first_token - self.arrival

    @property
    def e2e(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.arrival

    @property
    def tbt(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        gaps = [b - a for a, b in zip(self.token_times, self.token_times[1:],
                                      strict=False)]
        return sum(gaps) / len(gaps)

    @property
    def tbt_max(self) -> Optional[float]:
        """Worst inter-token gap — what a TBT *deadline* is judged
        against (the mean ``tbt`` hides exactly the stall an SLO exists
        to catch)."""
        if len(self.token_times) < 2:
            return None
        return max(b - a for a, b in zip(self.token_times,
                                         self.token_times[1:], strict=False))


@dataclass
class EngineMetrics:
    requests: Dict[int, RequestMetrics] = field(default_factory=dict)
    kv_usage_trace: List[float] = field(default_factory=list)
    step_kinds: List[str] = field(default_factory=list)
    # scheduler-event trace: dicts {"t", "event": "admit"|"preempt", "rid",
    # ...}; bounded ring (ServeConfig.sched_events_cap), oldest dropped
    sched_events: EventRing = field(default_factory=EventRing)
    # policy-layer counters (core/policies.py): admission_reorders,
    # admission_holds, cheap_preemptions, cost_evictions (ints) and
    # cost_flops_evicted (float)
    policy_counters: Dict[str, float] = field(default_factory=dict)
    # preemptions performed, ever — unlike the sched_events ring this
    # never drops, so step-kind accounting stays lossless at tiny caps
    n_preempt_events: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    n_steps: int = 0
    # --- prefill accounting (shared-prefix cache) ---
    n_prefill_tokens: int = 0    # prefill tokens actually computed
    n_cached_tokens: int = 0     # prefill tokens skipped via cache hits
                                 # (token-exact: partial-page spans count)
    n_partial_hits: int = 0      # admissions that reused a partial page
                                 # via token-level COW
    # allocator/cache counters snapshot, refreshed by the engine each step:
    # {"n_reclaims", "n_cow", "n_shared_maps", "pages_shared", ...}
    prefix_cache_stats: Dict[str, int] = field(default_factory=dict)
    # --- chunked-prefill planner (core/planner.py, mode="chunked") ---
    n_chunks: int = 0            # prefill chunks dispatched by the planner
    chunk_budget: int = 0        # ServeConfig.chunk_tokens (0 off-mode)
    # packed tokens (prefill chunks + decodes) per mixed round -> rounds
    # dispatched at that packing; occupancy derives from it in summary()
    packed_tokens_hist: Dict[int, int] = field(default_factory=dict)
    # --- KV pool byte accounting (kv_dtype="int8" capacity lever) ---
    kv_pool_bytes: int = 0        # device bytes of the page pool (all pages)
    kv_bytes_per_token: float = 0.0   # page_bytes / page_size (K+V, all layers)
    n_quant_pages: int = 0        # cumulative pages written with int8 KV
    # --- SLO outcomes (finished requests carrying a deadline only) ---
    slo_attained: int = 0
    slo_missed: int = 0

    def req(self, rid: int) -> RequestMetrics:
        if rid not in self.requests:
            self.requests[rid] = RequestMetrics(rid)
        return self.requests[rid]

    def bump(self, counter: str, n: float = 1) -> None:
        """Increment a policy-layer counter (created on first use)."""
        self.policy_counters[counter] = self.policy_counters.get(counter, 0) + n

    def summary(self) -> dict:
        done = [r for r in self.requests.values() if r.t_done is not None]
        total_tokens = sum(r.n_generated for r in done)
        wall = max(self.t_end - self.t_start, 1e-9)
        def agg(vals):
            vals = [v for v in vals if v is not None]
            if not vals:
                return {"mean": None, "p50": None, "max": None}
            return {"mean": sum(vals) / len(vals),
                    "p50": statistics.median(vals),
                    "max": max(vals)}
        return {
            "n_done": len(done),
            "wall_s": wall,
            "throughput_tok_s": total_tokens / wall,
            "ttft": agg([r.ttft for r in done]),
            "tbt": agg([r.tbt for r in done]),
            "e2e": agg([r.e2e for r in done]),
            "n_steps": self.n_steps,
            "n_preemptions": sum(r.n_preempted for r in self.requests.values()),
            "n_preempted_requests": sum(
                1 for r in self.requests.values() if r.n_preempted),
            # lossless engine-side counter; equals n_preemptions unless the
            # event ring dropped (kept separate as the step-kind source)
            "n_preempt_events": self.n_preempt_events,
            "finish_reasons": {
                reason: sum(1 for r in done if r.finish_reason == reason)
                for reason in sorted({r.finish_reason for r in done
                                      if r.finish_reason is not None})},
            "kv_usage_peak": max(self.kv_usage_trace, default=0.0),
            "kv_usage_mean": (sum(self.kv_usage_trace) / len(self.kv_usage_trace))
                             if self.kv_usage_trace else 0.0,
            "prefill_tokens_computed": self.n_prefill_tokens,
            "cached_tokens": self.n_cached_tokens,
            # fraction of all prefill work served from the prefix cache
            "cache_hit_rate": (
                self.n_cached_tokens
                / max(self.n_cached_tokens + self.n_prefill_tokens, 1)),
            "n_partial_hits": self.n_partial_hits,
            "pages_shared_peak": self.prefix_cache_stats.get("pages_shared_peak", 0),
            "n_reclaims": self.prefix_cache_stats.get("n_reclaims", 0),
            "n_cow": self.prefix_cache_stats.get("n_cow", 0),
            "prefix_cache": dict(self.prefix_cache_stats),
            "sched_events_dropped": getattr(self.sched_events, "n_dropped", 0),
            "policy_counters": dict(self.policy_counters),
            "n_chunks": self.n_chunks,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "n_quant_pages": self.n_quant_pages,
            # mean packed tokens per mixed round over chunk_tokens; can
            # exceed 1.0 when the decode batch alone outgrows the budget
            "chunk_occupancy": (
                sum(k * v for k, v in self.packed_tokens_hist.items())
                / (self.chunk_budget
                   * max(sum(self.packed_tokens_hist.values()), 1))
                if self.chunk_budget else None),
            "packed_tokens_hist": dict(sorted(self.packed_tokens_hist.items())),
            # SLO outcomes: only requests carrying a deadline count, so
            # attainment is None (not a vacuous 1.0) on deadline-free runs
            "slo_attained": self.slo_attained,
            "slo_missed": self.slo_missed,
            "slo_attainment": (
                self.slo_attained / (self.slo_attained + self.slo_missed)
                if self.slo_attained + self.slo_missed else None),
            "tenants": self._tenant_rollup(done),
        }

    def _tenant_rollup(self, done) -> dict:
        """Per-tenant latency/SLO aggregates over finished requests.
        Omitted entirely (empty dict) when every request rode the
        implicit deadline-free "default" tenant, so single-tenant
        summaries stay byte-stable."""
        by_tenant: Dict[str, list] = {}
        for r in done:
            by_tenant.setdefault(r.tenant, []).append(r)
        if list(by_tenant) == ["default"] and all(
                r.slo_ok is None for r in done):
            return {}
        out = {}
        for tenant in sorted(by_tenant):
            rs = by_tenant[tenant]
            judged = [r for r in rs if r.slo_ok is not None]
            ttfts = sorted(r.ttft for r in rs if r.ttft is not None)
            gaps = sorted(r.tbt_max for r in rs if r.tbt_max is not None)
            def pct(vals, q):
                if not vals:
                    return None
                return vals[min(int(q * (len(vals) - 1) + 0.5),
                                len(vals) - 1)]
            out[tenant] = {
                "n_done": len(rs),
                "slo_attained": sum(1 for r in judged if r.slo_ok),
                "slo_missed": sum(1 for r in judged if not r.slo_ok),
                "slo_attainment": (
                    sum(1 for r in judged if r.slo_ok) / len(judged)
                    if judged else None),
                "ttft_p50": pct(ttfts, 0.50),
                "ttft_p99": pct(ttfts, 0.99),
                "tbt_max_p50": pct(gaps, 0.50),
                "tbt_max_p99": pct(gaps, 0.99),
            }
        return out
