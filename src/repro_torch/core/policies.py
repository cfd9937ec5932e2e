"""Pluggable scheduling policies: admission, eviction, preemption.

Splitwiser's constrained-resource premise makes the three scheduling
decisions — who gets admitted, which cached KV pages get reclaimed, who
gets preempted — the dominant lever on throughput and TTFT once kernels
and the shared-prefix cache are in place (SARATHI and Lin et al.'s
single-moderate-GPU study both put the policy choice, not kernel speed,
on the frontier).  This module makes each decision a first-class,
swappable object; ``core/scheduler.py`` keeps only the mechanism
(budgets, eligibility, queue surgery).

Invariant shared by every policy: policies change *when* work happens,
never *what* is computed.  Sampling is batch/mode/history-independent
(``(seed, rid, pos)`` PRNG streams), so greedy and sampled token streams
are bit-identical across every ``admission x eviction x preempt``
combination (``tests/test_policies.py``).

Admission (:class:`AdmissionPolicy` — ``serve.admission_policy``)
    ``fcfs``        pop the waiting queue in arrival order (seed behaviour).
    ``cache_aware`` each admission round, order the waiting queue so
                    requests whose prefixes are *resident* in the prefix
                    cache are co-scheduled first (their pages remap instead
                    of recompute), and *hold back* a request whose prefix
                    is currently being prefilled by an in-flight request
                    (the engine's in-flight registry): it waits one round
                    and hits, instead of double-missing alongside the
                    twin that is about to insert its pages.  Every round
                    a request is passed over adds
                    ``serve.admission_age_weight`` to its score, bounding
                    the worst-case wait of a cold-prefix request under a
                    hot-template stream (no starvation).
    ``deadline``    earliest-deadline-first by TTFT *slack*: deadline
                    (``arrival + ttft_target``, resolved through the
                    request's tenant tier — ``core/slo.py``) minus the
                    current clock minus a predicted completion cost
                    (``serve.slo_page_cost`` per page the admission
                    would allocate, via the round-memoized
                    ``Scheduler.probe``/``admission_pages`` predictor).
                    Requests with no deadline carry infinite slack and
                    sort FCFS among themselves *after* every
                    deadline-bearing request; a queue with no deadlines
                    at all degenerates to exact FCFS with zero clock
                    reads.  ``holds`` enforces per-tenant in-flight
                    token quotas (``TenantTier.quota_tokens``): a
                    tenant at quota has its next request skipped for
                    the round — the burst queues behind its own quota
                    instead of starving other tenants — except that a
                    single over-quota request on an otherwise idle
                    tenant is admitted (progress guarantee: quotas
                    bound concurrency, they never wedge a tenant).

Preemption gains the matching arm:
    ``deadline``    maximum-slack victim: the binding deadline is TTFT
                    while no token has been emitted, then TBT from the
                    last emitted token; the candidate with the most
                    slack (no-deadline candidates rank as infinite, so
                    they are preempted first) is evicted, tie-broken by
                    the ``cache_aware`` resume-safe fraction and then
                    latest arrival — a deadline-critical request is
                    never evicted while a slack-rich one runs, and with
                    no deadlines anywhere the choice is bit-identical
                    to ``cache_aware``.

Eviction (:class:`EvictionPolicy` — ``serve.eviction_policy``)
    Ranks the prefix cache's reclaimable zero-ref *leaf* pages; the
    lowest-ranked leaf is stripped first when the free list runs dry.
    ``lru``   least-recently-hit leaf first (today's default).
    ``fifo``  oldest-inserted leaf first.
    ``cost``  cheapest-to-recompute leaf first, by the per-page
              recompute-FLOPs proxy ``PrefixCache.page_cost``: a deep
              page's recompute replays attention over its whole prefix
              (expensive — keep), a shallow long-tail leaf is nearly
              free to rebuild (evict).  Descendant counts weight pages
              that anchor large cached subtrees.

Preemption (:class:`PreemptPolicy` — ``serve.preempt_policy``)
    Picks one victim among the mechanism's eligible candidates (running
    requests strictly younger than the needy one whose eviction actually
    frees pages).
    ``latest``      latest-arrival victim (today's default).
    ``cache_aware`` victim whose committed KV would mostly *survive* its
                    own eviction — pages shared with another live request
                    keep serving hits, so the resume is a block-table
                    remap, not a recompute (``Engine.resume_safe_pages``).
                    Tie-broken by latest arrival.
    ``none``        preemption disabled (seed crash-on-exhaustion arm);
                    handled by the scheduler, no policy object.

Registries map config strings to classes; ``ServeConfig.__post_init__``
validates against them so a typo fails at config time, not mid-serve.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from repro_torch.core.slo import request_footprint


# --------------------------------------------------------------- admission --
class AdmissionPolicy:
    """Orders (and may hold back) the waiting queue for one admission round.

    ``order`` ranks the round's candidates once; ``holds`` is consulted
    per candidate *inside* the admission loop — after earlier candidates
    of the same round have registered their in-flight prefills — so a
    policy can defer a request based on what this very round has just
    admitted (the double-miss case).  A held request is skipped, not a
    head-of-line block.
    """

    name = "base"

    def order(self, sched) -> List:
        raise NotImplementedError

    def holds(self, sched, req) -> bool:
        return False


class FCFSAdmission(AdmissionPolicy):
    """Arrival order, head-of-line blocking — the seed behaviour."""

    name = "fcfs"

    def order(self, sched) -> List:
        return list(sched.waiting)


class CacheAwareAdmission(AdmissionPolicy):
    """Co-schedule resident prefixes; hold twins of in-flight prefills.

    ``order``: resident-hit pages sort first (descending, one trie walk
    per waiting request via ``Engine.cache_probe``), FCFS
    ``(arrival, rid)`` breaks ties — so a zero-hit queue degenerates to
    exact FCFS.  Each round a request waits adds
    ``serve.admission_age_weight`` pages to its effective score
    (``Scheduler.wait_rounds``), so a cold-prefix request passed over by
    a sustained hot-template stream eventually outranks the hits and its
    worst-case wait is bounded — with weight 0 the order is pure
    hit-first (and a cold request CAN starve under an open-loop hot
    stream).  ``holds``: a request is skipped for the round when some
    in-flight prefill (including one admitted earlier in this same
    round) will cache strictly more of its prefix than is resident now —
    admitting it would double-miss work its twin is already computing.
    Holding cannot deadlock: an in-flight entry exists only while its
    owner is actively prefilling (unregistered at completion and at
    preemption), so the held request is reconsidered next round against
    a warmer cache.
    """

    name = "cache_aware"

    def order(self, sched) -> List:
        w = sched.serve.admission_age_weight
        ranked = [(-(sched.probe(r)[0] + w * sched.wait_rounds(r.rid)),
                   r.arrival, r.rid, r)
                  for r in sched.waiting]
        ranked.sort(key=lambda t: t[:3])
        out = [t[3] for t in ranked]
        if [r.rid for r in out] != [r.rid for r in sched.waiting]:
            sched.metrics.bump("admission_reorders")
        return out

    def holds(self, sched, req) -> bool:
        # the in-flight scan stays live (same-round admits register), only
        # the trie probe is round-memoized
        if sched.eng.inflight_hit_pages(req) > sched.probe(req)[0]:
            sched.metrics.bump("admission_holds")
            return True
        return False


class DeadlineAdmission(AdmissionPolicy):
    """Slack-ranked (EDF) admission with per-tenant token quotas.

    ``order``: each waiting request's TTFT slack is its deadline
    (``arrival + ttft_target``, tier-resolved) minus the clock, minus
    ``serve.slo_page_cost`` engine-seconds per page the admission would
    allocate (the same ``probe``/``admission_pages`` arithmetic the
    watermark budget uses, round-memoized, so ranking adds no extra trie
    walks).  Least slack first; infinite-slack (deadline-free) requests
    keep FCFS order among themselves at the back.  The clock is read at
    most once per round, and not at all when no waiting request carries
    a TTFT deadline — a deadline-free queue is byte-for-byte FCFS, which
    is what makes the no-deadline bit-identity guarantee hold trivially.

    ``holds``: a request whose tenant already holds ``quota_tokens`` or
    more in-flight footprint tokens (prompt + full ``max_new_tokens``
    grant, across slots, streams, and this round's earlier admits) is
    skipped for the round.  The check is ``inflight > 0 and inflight +
    footprint > quota``: an oversized request on an idle tenant still
    admits, so a quota can bound a tenant's concurrency but never wedge
    it, and a held burst drains as its own requests finish (no
    cross-tenant dependency, no deadlock).
    """

    name = "deadline"

    def order(self, sched) -> List:
        eng = sched.eng
        effs = [(r, eng.effective_slo(r)) for r in sched.waiting]
        if all(eff.ttft_target is None for _, eff in effs):
            return list(sched.waiting)
        t_now = eng.now()
        cost = sched.serve.slo_page_cost
        ranked = []
        for r, eff in effs:
            if eff.ttft_target is None:
                slack = math.inf
            else:
                slack = (r.arrival or 0.0) + eff.ttft_target - t_now
                if cost:
                    n_hit, n_free_hit, cow_extra = sched.probe(r)
                    slack -= cost * sched.admission_pages(
                        r, free_cached=n_free_hit, cow_extra=cow_extra,
                        n_hit=n_hit)
            ranked.append((slack, r.arrival, r.rid, r))
        ranked.sort(key=lambda t: t[:3])
        out = [t[3] for t in ranked]
        if [r.rid for r in out] != [r.rid for r in sched.waiting]:
            sched.metrics.bump("admission_reorders")
        return out

    def holds(self, sched, req) -> bool:
        eff = sched.eng.effective_slo(req)
        if eff.quota_tokens is None:
            return False
        inflight = sched.tenant_inflight_tokens(eff.tenant)
        if inflight > 0 and \
                inflight + request_footprint(req) > eff.quota_tokens:
            sched.metrics.bump("quota_holds")
            return True
        return False


# ---------------------------------------------------------------- eviction --
class EvictionPolicy:
    """Ranks reclaimable prefix-cache leaves; the min-rank leaf is evicted."""

    name = "base"

    def rank(self, node, cache):
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    name = "lru"

    def rank(self, node, cache):
        return node.last_used


class FIFOEviction(EvictionPolicy):
    name = "fifo"

    def rank(self, node, cache):
        return node.nid


class CostEviction(EvictionPolicy):
    """Evict the page whose recompute is cheapest (FLOPs-saved-per-page
    cost model): rank by ``PrefixCache.page_cost`` — depth-weighted
    attention replay plus descendant fan-out — with LRU as tie-break."""

    name = "cost"

    def rank(self, node, cache):
        return (cache.page_cost(node.page), node.last_used)


# -------------------------------------------------------------- preemption --
class PreemptPolicy:
    """Chooses one eviction victim from the mechanism's candidates.

    ``candidates`` rows are ``(kind, index, req, committed)`` — container
    kind ("slot"/"stream"), position, the running request, and its
    committed-KV token count.  Returns ``(kind, index)`` or None.
    """

    name = "base"

    def select(self, candidates: List[Tuple], eng) -> Optional[Tuple[str, int]]:
        raise NotImplementedError


class LatestPreempt(PreemptPolicy):
    """Latest-arrival victim: arrival order stays a total priority order,
    so the oldest request always makes progress (termination argument in
    ``core/scheduler.py``)."""

    name = "latest"

    def select(self, candidates, eng):
        if not candidates:
            return None
        kind, i, _, _ = max(candidates, key=lambda c: (c[2].arrival, c[2].rid))
        return kind, i


class CacheAwarePreempt(PreemptPolicy):
    """Prefer the victim whose committed KV mostly survives its eviction.

    ``Engine.resume_safe_pages`` counts the victim's committed full pages
    that are cached *and* referenced by another live request — those keep
    serving after the victim's refcounts drop, so its resume re-hits them
    (remap ≈ free) instead of recomputing the whole prefix.  The score is
    the surviving fraction of committed pages; latest ``(arrival, rid)``
    breaks ties, so with a cold cache this degenerates to ``latest``.
    """

    name = "cache_aware"

    def select(self, candidates, eng):
        if not candidates:
            return None
        best, best_key, best_safe = None, None, 0
        for kind, i, req, committed in candidates:
            n_safe = eng.resume_safe_pages(req, committed)
            frac = n_safe / max(eng.alloc.pages_needed(committed), 1)
            key = (frac, req.arrival, req.rid)
            if best_key is None or key > best_key:
                best, best_key, best_safe = (kind, i), key, n_safe
        if best_safe > 0:
            eng.metrics.bump("cheap_preemptions")
        return best


class DeadlinePreempt(PreemptPolicy):
    """Maximum-slack victim: never evict a deadline-critical request
    while a slack-rich one runs.

    Each candidate's binding deadline is TTFT (``arrival +
    ttft_target``) while it has emitted no token, then TBT
    (``last token time + tbt_target``) — both tier-resolved; a request
    with no applicable target has infinite slack and is preferred as a
    victim.  Ties (notably the all-infinite no-deadline case) fall back
    to the ``cache_aware`` resume-safe fraction and then latest
    ``(arrival, rid)``, so with no deadlines anywhere the selection is
    bit-identical to ``cache_aware`` (and to ``latest`` on a cold
    cache).  The clock is read once, and only when some candidate
    actually carries a deadline.  Bumps ``deadline_spared_preemptions``
    when a tighter-slack candidate was passed over in favour of the
    chosen victim (the counter that proves the policy changed an
    outcome).
    """

    name = "deadline"

    def select(self, candidates, eng):
        if not candidates:
            return None
        effs = [eng.effective_slo(req) for _, _, req, _ in candidates]
        t_now = eng.now() if any(e.has_deadline for e in effs) else 0.0
        best, best_key, min_slack = None, None, math.inf
        for (kind, i, req, committed), eff in zip(candidates, effs):
            m = eng.metrics.req(req.rid)
            if m.t_first_token is None:
                deadline = ((req.arrival or 0.0) + eff.ttft_target
                            if eff.ttft_target is not None else math.inf)
            else:
                last = m.token_times[-1] if m.token_times \
                    else m.t_first_token
                deadline = (last + eff.tbt_target
                            if eff.tbt_target is not None else math.inf)
            slack = deadline - t_now
            min_slack = min(min_slack, slack)
            n_safe = eng.resume_safe_pages(req, committed)
            frac = n_safe / max(eng.alloc.pages_needed(committed), 1)
            key = (slack, frac, req.arrival, req.rid)
            if best_key is None or key > best_key:
                best, best_key = (kind, i), key
        if best_key is not None and min_slack < best_key[0]:
            eng.metrics.bump("deadline_spared_preemptions")
        return best


# -------------------------------------------------------------- registries --
ADMISSION_POLICIES = {p.name: p for p in (FCFSAdmission, CacheAwareAdmission,
                                          DeadlineAdmission)}
EVICTION_POLICIES = {p.name: p for p in (LRUEviction, FIFOEviction,
                                         CostEviction)}
# "none" disables preemption entirely (seed arm); it is a valid config
# value but has no policy object — the scheduler short-circuits it.
PREEMPT_POLICIES = {p.name: p for p in (LatestPreempt, CacheAwarePreempt,
                                        DeadlinePreempt)}


def _make(registry, kind: str, name: str):
    if name not in registry:
        raise ValueError(f"unknown {kind} {name!r}; expected one of "
                         f"{', '.join(sorted(registry))}")
    return registry[name]()


def make_admission(name: str) -> AdmissionPolicy:
    return _make(ADMISSION_POLICIES, "admission_policy", name)


def make_eviction(name: str) -> EvictionPolicy:
    return _make(EVICTION_POLICIES, "eviction_policy", name)


def make_preempt(name: str) -> Optional[PreemptPolicy]:
    if name == "none":
        return None
    return _make(PREEMPT_POLICIES, "preempt_policy", name)
