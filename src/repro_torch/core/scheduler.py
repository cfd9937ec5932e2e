"""Scheduling mechanism for the serving engine (policies live in
``core/policies.py``).

The paper's premise is serving under *constrained resources*: its
Fig. 5/14/15 analysis shows KV-cache usage climbing toward exhaustion as
batch size grows.  The seed engine simply crashed there — admission
reserved pages for ``len(prompt)+1`` tokens while decode kept allocating
a page every ``page_size`` generated tokens, so ``PageAllocator.extend_to``
eventually raised :class:`OutOfPages` from the decode path.

This module keeps the *mechanism* of page-pressure scheduling — budgets,
eligibility, queue surgery, event tracing — while every *decision* is a
pluggable :mod:`repro_torch.core.policies` object chosen by ``ServeConfig``:

Admission (watermark-based, ``max_new_tokens``-aware)
    A waiting request is admitted only when the pool keeps a
    ``serve.watermark`` fraction free *after* reserving pages for its
    prompt plus ``serve.decode_reserve`` of its remaining generation
    budget.  Which request is *considered* next is the
    ``AdmissionPolicy``'s call: ``fcfs`` walks the queue in arrival
    order; ``cache_aware`` co-schedules resident prefixes first and
    holds a request whose prefix an in-flight prefill is about to cache
    (it waits one round and remaps instead of double-missing), with an
    age-weighted score (``serve.admission_age_weight`` per passed-over
    round, tracked here in ``wait_rounds``) so cold-prefix requests
    cannot starve behind a hot-template stream.
    Head-of-line progress guarantee: when nothing holds pages, the first
    considered request is admitted whenever its bare prompt fits — and
    if even that exceeds the pool, :class:`OutOfPages` is raised eagerly
    with a sizing message instead of mid-decode.

Preemption by recomputation
    When a page extension would exhaust the pool, the ``PreemptPolicy``
    picks a victim among the running requests strictly younger than the
    needy one (eligibility — and with it the termination argument — is
    mechanism, not policy): its pages are freed and the request is
    requeued at the front of the waiting queue.  On re-admission it
    prefills ``prompt + out_tokens`` so greedy decoding resumes exactly
    where it stopped.  ``latest`` evicts the latest arrival;
    ``cache_aware`` prefers victims whose committed KV survives their
    own eviction (pages shared with live requests — resume is a remap,
    not a recompute), tie-broken by latest arrival.  Arrival order still
    bounds every choice — the oldest running request always makes
    progress — so any workload whose requests individually fit the pool
    terminates.  ``preempt_policy == "none"`` restores the seed
    crash-on-exhaustion behaviour (used by benchmarks to show the
    graceful-degradation delta).

Every decision is recorded in ``EngineMetrics.sched_events`` (a capped
ring — ``serve.sched_events_cap``) and aggregated by
``EngineMetrics.summary()`` so benchmarks can plot graceful-degradation
curves; policy-specific counters land in ``EngineMetrics.policy_counters``.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.core.kv_cache import OutOfPages
from repro_torch.core.policies import make_admission, make_preempt
from repro_torch.core.slo import request_footprint


class Scheduler:
    """Owns every admission and page-pressure decision for one Engine.

    The engine keeps the mechanism (batch assembly, jit dispatch, block
    tables); the scheduler keeps the budgets and eligibility rules and
    delegates each choice to its policy objects.  It reads/writes the
    engine's ``slots`` / ``streams`` lists directly when evicting.
    """

    def __init__(self, engine):
        self.eng = engine
        self.serve = engine.serve
        self.admission = make_admission(self.serve.admission_policy)
        self.preempt_pol = make_preempt(self.serve.preempt_policy)  # None =
        self.alloc = engine.alloc                                   # disabled
        self.metrics = engine.metrics
        self.waiting: Deque = deque()
        self._round_probes: dict = {}   # rid -> cache_probe, one round only
        # rid -> admission rounds the request has been passed over; feeds
        # cache_aware aging (serve.admission_age_weight) so a cold-prefix
        # request cannot starve behind a hot-template stream
        self._wait_rounds: dict = {}
        # requests admitted earlier in the CURRENT round: not yet placed
        # in slots/streams by the engine, but already holding quota —
        # tenant_inflight_tokens must see them or a burst could blow
        # through its tenant quota within a single round
        self._round_admits: List = []

    def probe(self, req) -> Tuple[int, int, int]:
        """``Engine.cache_probe`` memoized for the current admission
        round (the trie and page references don't change mid-round, and
        policy ordering, hold checks and budgeting would otherwise each
        repeat the same walk per candidate)."""
        hit = self._round_probes.get(req.rid)
        if hit is None:
            hit = self._round_probes[req.rid] = self.eng.cache_probe(req)
        return hit

    def wait_rounds(self, rid: int) -> int:
        """Admission rounds ``rid`` has been passed over while waiting
        (reset on admission) — the age signal policies weight against
        resident-prefix advantage."""
        return self._wait_rounds.get(rid, 0)

    def tenant_inflight_tokens(self, tenant: str) -> int:
        """Footprint tokens (prompt + full generation grant,
        ``core/slo.py``) `tenant` currently holds in flight: requests
        occupying decode slots or prefill streams, plus this round's
        earlier admits (not yet placed by the engine).  The quantity
        ``DeadlineAdmission.holds`` charges quotas against and the
        ``tenant_quota`` sanitizer invariant re-derives."""
        seen: set = set()
        total = 0
        for cont in (self.eng.slots, self.eng.streams):
            for s in cont:
                if s is None or s.req.rid in seen:
                    continue
                seen.add(s.req.rid)
                if self.eng.effective_slo(s.req).tenant == tenant:
                    total += request_footprint(s.req)
        for r in self._round_admits:
            if r.rid not in seen:
                seen.add(r.rid)
                if self.eng.effective_slo(r).tenant == tenant:
                    total += request_footprint(r)
        return total

    # ------------------------------------------------------------ queue ----
    def submit(self, req) -> None:
        self.waiting.append(req)

    def requeue(self, req) -> None:
        """Put a preempted request at the *front* so it resumes first."""
        self.waiting.appendleft(req)

    # -------------------------------------------------------- admission ----
    @property
    def watermark_pages(self) -> int:
        return int(math.ceil(self.serve.watermark * (self.alloc.n_pages - 1)))

    def admission_pages(self, req, free_cached: int = 0,
                        cow_extra: int = 0, n_hit: int = 0) -> int:
        """Pages to budget for admitting `req`: prompt (plus any tokens
        generated before a preemption) + 1, plus `decode_reserve` of the
        remaining generation as decode headroom.  The generation budget
        is per-request (``req.sampling.max_new_tokens``), so a mixed
        queue of short and long requests is budgeted request by request.

        With the prefix cache enabled, only the *miss* pages are
        budgeted: ``free_cached`` (live-referenced hit pages, from
        ``Engine.cache_probe``) don't come out of the free pool, while
        reclaimable hits are charged like fresh allocs — reviving them
        consumes free capacity.  ``cow_extra`` charges the transient
        page a token-level partial hit holds while its unreferenced
        donor is revived for the COW copy (the copy's destination page
        is already inside ``pages_needed``; the donor returns to the
        reclaimable pool once the copy exists).

        In ``mode="chunked"`` admission budgets *per-chunk* pages
        instead of the whole prompt: the cached prefix (``n_hit`` full
        pages — mapped in their entirety at admission) plus ONE planner
        chunk (``serve.chunk_tokens``).  Later chunks pre-commit their
        pages as the planner schedules them (``Engine._compose_prefill``
        → ``KVSanitizer.note_chunk``), so a long prompt stops reserving
        the pool up front and admission interleaves with in-flight
        prefills.
        """
        remaining = max(req.sampling.max_new_tokens - len(req.out_tokens), 1)
        headroom = int(self.serve.decode_reserve * (remaining - 1))
        n_prefill = len(req.prompt) + len(req.out_tokens)
        if self.serve.mode == "chunked":
            n_prefill = min(n_prefill, n_hit * self.alloc.page_size
                            + self.serve.chunk_tokens)
        need = self.alloc.pages_needed(n_prefill + 1 + headroom)
        return max(need - free_cached, 0) + cow_extra

    def _bare_pages(self, req) -> int:
        """Minimum pages the request needs to start; raises if the pool
        or a block-table row can never hold it (clear sizing error
        instead of a decode-path crash)."""
        n_prefill = len(req.prompt) + len(req.out_tokens)
        need = self.alloc.pages_needed(n_prefill + 1)
        if need > self.alloc.n_pages - 1:
            raise OutOfPages(
                f"request {req.rid} needs {need} pages for "
                f"{n_prefill} tokens but the pool only has "
                f"{self.alloc.n_pages - 1}; raise n_pages/page_size")
        if need > self.serve.max_pages_per_seq:
            raise OutOfPages(
                f"request {req.rid} needs {need} pages for "
                f"{n_prefill} tokens but block tables hold "
                f"{self.serve.max_pages_per_seq}; raise max_pages_per_seq")
        return need

    def _try_admit(self, r, budget: int, first: bool) -> Tuple[bool, int]:
        """Admit `r` (removing it from the waiting queue) if it fits
        `budget`.  Progress override: when the pool is completely idle
        and this would be the round's first admission, the request is
        admitted on a bare-prompt fit even if the watermark/headroom
        budget says no (otherwise a big request could wait forever
        behind its own reservation)."""
        bare = self._bare_pages(r)      # raises when it can never fit
        n_hit, n_free_hit, cow_extra = self.probe(r)
        need = self.admission_pages(r, n_free_hit, cow_extra, n_hit)
        override = False
        if need > budget:
            if not (first and self.alloc.n_allocated == 0):
                return False, budget
            need = bare
            override = True
        self.waiting.remove(r)
        self._wait_rounds.pop(r.rid, None)
        self._round_admits.append(r)
        self.alloc.begin_admission(r.rid)
        self.eng.register_inflight(r)
        if self.eng.sanitizer is not None:
            self.eng.sanitizer.note_admit(r.rid, need, override)
        self._event("admit", r.rid, pages=need, cached_pages=n_hit,
                    resumed=bool(r.out_tokens), override=override)
        return True, budget - need

    def _admit_up_to(self, limit: int) -> List:
        """One admission round: the policy orders (and may hold back)
        the waiting queue; the budget walk stops at the first candidate
        that doesn't fit (head-of-line blocking within the policy's
        order, which for ``fcfs`` is exactly the seed behaviour)."""
        out: List = []
        if limit <= 0 or not self.waiting:
            return out      # no round: skip policy ordering (and its
                            # trie walks / reorder-hold counters) entirely
        budget = self.alloc.n_free - self.watermark_pages
        self._round_probes = {}
        self._round_admits = []
        for r in self.admission.order(self):
            if len(out) >= limit:
                break
            if self.admission.holds(self, r):
                continue        # skipped this round, not a budget block
            ok, budget = self._try_admit(r, budget, first=not out)
            if not ok:
                break
            out.append(r)
        for r in self.waiting:          # passed over this round: age them
            self._wait_rounds[r.rid] = self._wait_rounds.get(r.rid, 0) + 1
        return out

    def take_prefillable(self) -> List:
        """Sequential-mode admission: requests that fit the free decode
        slots and the watermarked page budget, in policy order."""
        return self._admit_up_to(sum(s is None for s in self.eng.slots))

    def admit_streams(self) -> List:
        """Splitwiser-mode admission: requests to place on free prefill
        streams under the same watermarked budget."""
        return self._admit_up_to(sum(s is None for s in self.eng.streams))

    # -------------------------------------------------------- preemption ---
    def ensure_pages(self, req, n_tokens: int, protect=()) -> bool:
        """Make the allocator able to extend `req` to `n_tokens`,
        evicting victims chosen by the preempt policy.

        Returns False when only older requests (or `protect`-ed ones)
        hold the remaining pages — the caller yields (self-preempts or
        skips its chunk).  Raises OutOfPages when the sequence alone can
        never fit the pool or its block-table row.
        """
        if self.alloc.pages_needed(n_tokens) > self.serve.max_pages_per_seq:
            raise OutOfPages(
                f"request {req.rid} at {n_tokens} tokens needs "
                f"{self.alloc.pages_needed(n_tokens)} pages but block tables "
                f"hold {self.serve.max_pages_per_seq}; raise max_pages_per_seq")
        need = self.alloc.pages_needed(n_tokens) - len(self.alloc.owned(req.rid))
        if need <= 0 or self.alloc.can_alloc(need):
            return True
        if self.preempt_pol is not None:
            while not self.alloc.can_alloc(need):
                victim = self._pick_victim(req, protect)
                if victim is None:
                    break
                self.preempt(*victim, reason=f"pressure rid={req.rid}")
            if self.alloc.can_alloc(need):
                return True
        if self.alloc.n_allocated == len(self.alloc.owned(req.rid)):
            raise OutOfPages(
                f"request {req.rid} needs {self.alloc.pages_needed(n_tokens)} "
                f"pages at {n_tokens} tokens but the pool only has "
                f"{self.alloc.n_pages - 1}; raise n_pages/page_size")
        return False

    def _victim_candidates(self, needy, protect=()) -> List[Tuple]:
        """Eligible victims: running requests strictly younger than
        `needy` (arrival order stays a total priority order — the
        termination guarantee is mechanism, not policy) whose eviction
        would actually free capacity.  Rows are
        ``(kind, index, req, committed_tokens)``."""
        cands: List[Tuple] = []
        for kind, cont in (("slot", self.eng.slots),
                           ("stream", self.eng.streams)):
            for i, s in enumerate(cont):
                if s is None or s.req.rid in protect:
                    continue
                if not self.alloc.n_exclusive(s.req.rid):
                    continue     # page-less, or every page shared with a
                                 # live reader: evicting frees nothing
                if (s.req.arrival, s.req.rid) <= (needy.arrival, needy.rid):
                    continue
                committed = s.seq_len if kind == "slot" else s.pos
                cands.append((kind, i, s.req, committed))
        return cands

    def _pick_victim(self, needy, protect=()) -> Optional[Tuple[str, int]]:
        return self.preempt_pol.select(
            self._victim_candidates(needy, protect), self.eng)

    def preempt(self, kind: str, index: int, reason: str = "") -> None:
        """Evict a running request: free its pages and requeue it with
        its generated tokens folded into the next prefill (recomputation
        — paper §II-G's KV "mapping" is simply rebuilt)."""
        cont = self.eng.slots if kind == "slot" else self.eng.streams
        victim = cont[index]
        cont[index] = None
        r = victim.req
        # register the victim's committed KV with the prefix cache BEFORE
        # freeing: its pages park reclaimable and the resume re-hits them
        # (recomputation becomes a cheap remap unless pressure reclaimed
        # them in the meantime)
        committed = victim.seq_len if kind == "slot" else victim.pos
        self.eng.cache_insert(r, committed, final=True)
        self.eng.unregister_inflight(r.rid)
        if self.eng.sanitizer is not None:
            # re-admission re-budgets; the sanitizer also snapshots the
            # resume_safe_pages promise here (before free drops the
            # victim's refs) and settles it when the resume re-maps
            self.eng.sanitizer.note_preempt(r, committed)
        freed = self.alloc.free(r.rid)
        self.requeue(r)
        self.metrics.req(r.rid).n_preempted += 1
        self.metrics.n_preempt_events += 1
        self._event("preempt", r.rid, kind=kind, pages=freed, reason=reason)

    # ------------------------------------------------------------ trace ----
    def _event(self, ev: str, rid: int, **detail) -> None:
        self.metrics.sched_events.append(
            {"t": self.eng.now(), "event": ev, "rid": rid, **detail})
