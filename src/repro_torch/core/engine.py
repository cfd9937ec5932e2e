"""The Splitwiser serving engine (PyTorch port).

Modes (each maps to one of the paper's experimental arms; the benchmark
suites that exercise them are catalogued in EXPERIMENTS.md):

  sequential      — vLLM-style continuous batching: each engine step is
                    EITHER a full-prompt prefill batch OR a decode batch
                    (the paper's baseline, Fig. 6/8/10 "SP"/"Sequential").
  splitwiser      — phase splitting with time-sliced interleave: prompt
                    chunks and decode batches run as *separate* programs on
                    alternating steps (the paper's PyTorch-multiprocessing-
                    without-MPS arm; on a GPU these context-switch, Fig. 10
                    "MPx2").
  splitwiser_mps  — the paper's headline: both phases co-resident, as
                    the FUSED mixed step: decode tokens + prefill
                    chunks share every GEMM in one step (Fig. 9/10
                    "MPSx2"; also the paper's own stated next step, mixed
                    batching, §III-C1).
  chunked         — SARATHI-style chunked prefill with piggybacked
                    decodes: a ChunkPlanner (core/planner.py) carves
                    in-flight prefills into fixed-token-budget chunks
                    (ServeConfig.chunk_tokens), decode tokens claim their
                    budget share first, and the whole round is ONE mixed
                    dispatch — flat compute intensity, tail TBT bounded
                    by the chunk budget even under 2k-token prompts.
                    Admission budgets per-chunk pages (scheduler), so
                    new requests interleave with in-flight prefills.

("mp2" — two replicas with split resources — is built from two
"sequential" engines by benchmarks/splitwiser_vllm.py, not a mode here.)

The engine is host-driven: P prefill streams (the paper's #processes
knob) x C-token chunks + B decode slots, each step built on the host in
numpy and dispatched as one PyTorch step function.  The port keeps the
reference's scheduling code unchanged (``Scheduler``, allocator, prefix
cache, planner), so token streams, step kinds and scheduler traces match
the JAX engine's.  The reference's jitted steps are plain functions here;
the page pools are updated in place rather than donated.  Attention runs
through the hand-written CUDA kernels on the card (``repro_torch.kernels``)
and their plain versions on the CPU.

Device: ``Engine(..., device=None)`` runs on ``cuda`` and raises when no
card is present; pass ``device="cpu"`` to run on the CPU.  Not ported yet
(refused with ``NotImplementedError``): int8 KV pages, the runtime
sanitizer (``sanitize_level``) and the dispatch sentinel.

Request/response surface (vLLM-shaped):

  * each ``Request`` carries its own ``SamplingParams`` (greedy requests
    batch with sampled ones — one sampler call vectorized over per-row
    parameter arrays);
  * ``step()`` returns the step's ``TokenEvent`` list, ``stream()``
    yields events as they happen, ``poll()`` drains finished
    ``RequestOutput``s;
  * ``submit()`` is legal mid-run, and ``run(reqs, open_loop=True)``
    feeds requests in at their ``arrival`` offsets against a virtual
    clock that fast-forwards idle gaps (timed/open-loop workloads
    without wall-clock sleeps).

With ``ServeConfig.enable_prefix_cache`` the engine consults a
shared-prefix KV cache (``core/prefix_cache.py``) at every admission:
hit pages are refcount-mapped into the request's block table and prefill
starts at the first uncached token — ``sequential`` computes only the
suffix through the paged mixed kernel, the splitwiser modes fast-forward
their streams past cached chunks, and preempted victims resume by
remapping their own just-freed pages.  At token granularity
(``prefix_cache_granularity="token"``, the default) a prompt that
diverges *inside* a page still reuses the matched span: the partially
matched page is copy-on-write copied into the request's table and
prefill starts mid-page, recomputing zero matched tokens.

Scheduling decisions — admission order, reclaimable-page eviction,
preemption victim choice — are pluggable policies (``core/policies.py``,
selected by ``ServeConfig.admission_policy`` / ``eviction_policy`` /
``preempt_policy``).  The engine supplies the policy inputs: an
*in-flight prefix registry* (``register_inflight`` — which prefills are
about to insert cache pages, so ``cache_aware`` admission can hold an
identical waiting prompt one round instead of double-missing), the
``cache_probe`` trie walk, and ``resume_safe_pages`` (how much of a
victim's committed KV would survive its own eviction).  Policies change
*when* work happens, never *what* is computed: token streams are
bit-identical across every policy combination.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.core.kv_cache import PageAllocator, pool_pages_from_bytes
from repro_torch.core.metrics import EngineMetrics, EventRing
from repro_torch.core.outputs import RequestOutput, TokenEvent
from repro_torch.core.planner import ChunkPlan, ChunkPlanner
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.sampler import (SamplingParams, greedy_tokens,
                                      sample_tokens)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.slo import (EffectiveSLO, SLOParams, resolve_slo,
                                  slo_outcome)
from repro_torch.device import resolve_device
from repro_torch.kernels.kv_int8 import kv_page_bytes
from repro_torch.models import transformer as T


@dataclass
class Request:
    """One generation request.

    ``arrival=None`` (the default) means "stamp me at submit time"; an
    explicit value — including ``0.0`` — is preserved, and in open-loop
    runs is interpreted as an offset (seconds) from the run's start.
    """
    rid: int
    prompt: List[int]
    # default_factory: a shared default instance would alias one params
    # object across every request constructed without explicit sampling
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival: Optional[float] = None
    out_tokens: List[int] = field(default_factory=list)
    # per-request SLO: TTFT/TBT deadlines + tenant id (core/slo.py);
    # unset targets inherit the tenant's ServeConfig tier.  default_factory
    # for the same aliasing reason as ``sampling``
    slo: SLOParams = field(default_factory=SLOParams)

    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_new_tokens

    @property
    def prefill_tokens(self) -> List[int]:
        """Tokens to (re-)prefill: the prompt plus anything generated
        before a preemption, so a resumed request picks up exactly where
        it stopped."""
        return self.prompt + self.out_tokens


@dataclass
class _Stream:            # an in-progress chunked prefill (one "process")
    req: Request
    tokens: List[int]     # req.prefill_tokens captured at admission
    pos: int = 0          # tokens prefilled so far


@dataclass
class _Slot:              # an active decode sequence
    req: Request
    seq_len: int
    next_token: int


class _Clock:
    """Monotonic engine clock: real time plus a fast-forward offset.

    Open-loop runs jump the offset over idle gaps (nothing to serve until
    the next arrival) so timed workloads replay at full speed while every
    timestamp — metrics, events, scheduler trace — stays on one timeline.
    """

    def __init__(self, base_time_fn):
        self._base = base_time_fn
        self._offset = 0.0

    def __call__(self) -> float:
        return self._base() + self._offset

    def advance_to(self, t: float) -> None:
        self._offset += max(0.0, t - self())


class Engine:
    """Paged-KV serving engine for the dense transformer family."""

    def __init__(self, model, params, serve: ServeConfig, *,
                 time_fn=time.perf_counter, device=None):
        if model.cache_kind != "paged":
            raise TypeError(
                f"Engine supports paged-cache archs; got {model.cache_kind}")
        for knob, refused, later in (
                ("kv_dtype", serve.kv_dtype != "fp",
                 "the int8 KV slice (ROADMAP.md queue 1 item 6)"),
                ("sanitize_level", serve.sanitize_level != "off",
                 "the analysis-layer slice (ROADMAP.md queue 1 item 8)"),
                ("dispatch_sentinel", serve.dispatch_sentinel,
                 "the analysis-layer slice (ROADMAP.md queue 1 item 8)")):
            if refused:
                raise NotImplementedError(
                    f"{knob}={getattr(serve, knob)!r} is not ported yet; it "
                    f"comes with {later}")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.serve = serve
        self.params = _to_device(params, self.device)
        self.now = _Clock(time_fn)
        self.metrics = EngineMetrics(
            sched_events=EventRing(serve.sched_events_cap))
        self.prefix_cache = (
            PrefixCache(serve.page_size,
                        policy=serve.resolved_eviction_policy)
            if serve.enable_prefix_cache else None)
        # byte-denominated page pool: the budget defaults to n_pages
        # fp-width pages, so flipping kv_dtype="int8" alone holds the pool
        # BYTES constant and grows the page COUNT (codes + f32 scale
        # sidecar are narrower than fp tokens) — the capacity lever.
        dtype = self.params["embed"].dtype
        fp_page_bytes = kv_page_bytes(self.cfg, serve.page_size, dtype)
        page_bytes = kv_page_bytes(self.cfg, serve.page_size, dtype,
                                   kv_dtype=serve.kv_dtype)
        budget = (serve.kv_pool_bytes if serve.kv_pool_bytes is not None
                  else serve.n_pages * fp_page_bytes)
        n_pages = pool_pages_from_bytes(budget, page_bytes)
        self.alloc = PageAllocator(n_pages, serve.page_size,
                                   cache=self.prefix_cache,
                                   event_cb=self._alloc_event,
                                   page_bytes=page_bytes)
        self.metrics.kv_pool_bytes = n_pages * page_bytes
        self.metrics.kv_bytes_per_token = page_bytes / serve.page_size
        self._pages_shared_peak = 0
        # rid -> prefill tokens of admitted-but-not-yet-committed prefills;
        # cache_aware admission holds identical waiting prompts one round
        # so they hit the pages these are about to insert
        self._inflight: dict = {}
        # multi-tenant SLO tiers (ServeConfig.tenants) + per-rid resolved
        # EffectiveSLO cache: the deadline policies, chunk planner and
        # quota checks all read effective_slo() on hot paths, and the
        # resolution is pure per request
        self.tiers = {t.name: t for t in serve.tenants}
        self._slo_cache: dict = {}
        self.streams: List[Optional[_Stream]] = [None] * serve.n_streams
        self.slots: List[Optional[_Slot]] = [None] * serve.max_batch
        self.block_tables = np.zeros((serve.max_batch, serve.max_pages_per_seq),
                                     np.int32)
        self.stream_tables = np.zeros((serve.n_streams, serve.max_pages_per_seq),
                                      np.int32)
        self.k_pages, self.v_pages = T.init_pages(
            self.cfg, n_pages, serve.page_size, dtype=dtype,
            device=self.device)
        self._step_parity = 0
        self._events: List[TokenEvent] = []
        self._outputs: List[RequestOutput] = []
        # chunked mode: the phase planner owns the per-round packing
        # decision; every other mode dispatches phases monolithically
        self.planner = (ChunkPlanner(serve.chunk_tokens, serve.n_streams)
                        if serve.mode == "chunked" else None)
        if self.planner is not None:
            self.metrics.chunk_budget = serve.chunk_tokens
        self.sched = Scheduler(self)
        # the Scheduler reads these; both stay None until the analysis
        # layer is ported (the settings that arm them are refused above)
        self.sanitizer = None
        self.dispatch = None

    @property
    def waiting(self) -> "deque[Request]":
        return self.sched.waiting

    # ------------------------------------------------------------ steps ----
    def _tensor(self, a) -> torch.Tensor:
        """Host numpy array -> tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _prefill(self, tokens, lens):
        """Full prefill returning per-row last-token logits and the
        contiguous KV ([L, B, S, KV_p, hd] each)."""
        cfg = self.cfg
        x = T.embed(self.params, cfg, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        hidden, kv = T.forward_hidden(self.params, cfg, x, positions,
                                      collect_kv=True)
        last = torch.clamp(lens.long() - 1, 0, S - 1)
        hl = hidden[torch.arange(B, device=x.device), last]
        return T.unembed(self.params, cfg, hl), kv

    @torch.inference_mode()
    def _commit(self, k_new, v_new, dest):
        # k_new [L, M, ps, KV_p, hd]; dest [M] page ids (trash for pads)
        self.k_pages[:, dest] = k_new
        self.v_pages[:, dest] = v_new

    @torch.inference_mode()
    def _decode(self, tokens, bt, lens, active):
        logits, _ = T.decode(self.params, self.cfg, tokens, self.k_pages,
                             self.v_pages, bt, lens, active=active)
        return logits

    @torch.inference_mode()
    def _mixed(self, mb):
        p_logits, d_logits, _ = T.mixed(self.params, self.cfg, mb,
                                        self.k_pages, self.v_pages)
        return p_logits, d_logits

    # ------------------------------------------------------------ public ---
    def submit(self, req: Request):
        """Enqueue a request; legal at any point, including mid-run."""
        if req.rid in self.metrics.requests:
            raise ValueError(
                f"duplicate request id {req.rid}: metrics/page ownership are "
                "keyed by rid, so each submitted request needs a fresh one")
        if req.arrival is None:
            req.arrival = self.now()
        self.sched.submit(req)
        m = self.metrics.req(req.rid)
        m.arrival = req.arrival
        m.n_prompt = len(req.prompt)
        eff = self.effective_slo(req)   # clock-free (pure resolution)
        m.tenant = eff.tenant
        m.ttft_target = eff.ttft_target
        m.tbt_target = eff.tbt_target

    def run(self, requests: List[Request], max_steps: int = 100_000, *,
            open_loop: bool = False) -> EngineMetrics:
        """Drive the engine until every request (plus anything already
        submitted) finishes.  ``open_loop=True`` feeds ``requests`` in at
        their ``arrival`` offsets instead of all at once."""
        self.metrics.t_start = self.now()
        for _ in self.stream(requests, max_steps=max_steps, open_loop=open_loop):
            pass
        self.metrics.t_end = self.now()
        return self.metrics

    def stream(self, requests: List[Request] = (), *, open_loop: bool = False,
               max_steps: int = 100_000) -> Iterator[TokenEvent]:
        """Yield ``TokenEvent``s as the engine generates them.

        Closed loop (default): submit everything up front.  Open loop:
        treat each request's ``arrival`` as an offset from now on the
        virtual clock, submitting it when the clock reaches it and
        fast-forwarding over idle gaps.
        """
        t0 = self.now()      # bound for both loops: the arrival-feed
        if open_loop:        # condition below reads it unconditionally
            pending = deque(sorted(requests,
                                   key=lambda r: (r.arrival or 0.0, r.rid)))
        else:
            pending = deque()
            for r in requests:
                self.submit(r)
        steps = 0
        while (pending or not self.idle()) and steps < max_steps:
            while pending and t0 + (pending[0].arrival or 0.0) <= self.now():
                r = pending.popleft()
                r.arrival = t0 + (r.arrival or 0.0)
                self.submit(r)
            if pending and self.idle():
                self.now.advance_to(t0 + (pending[0].arrival or 0.0))
                continue
            yield from self.step()
            steps += 1

    def poll(self) -> List[RequestOutput]:
        """Drain the ``RequestOutput`` of every request finished since the
        last poll (in finish order)."""
        out, self._outputs = self._outputs, []
        return out

    def idle(self) -> bool:
        return (not self.waiting and all(s is None for s in self.streams)
                and all(s is None for s in self.slots))

    # ------------------------------------------------------ prefix cache ---
    def _alloc_event(self, event: str, **detail):
        """Allocator trace hook (reclaim / cow) into the scheduler trace."""
        if event == "page_free":
            return      # int8-sidecar bookkeeping, not a scheduler decision
        if event == "reclaim" and self.prefix_cache is not None and \
                self.prefix_cache.policy == "cost":
            self.metrics.bump("cost_evictions")
            self.metrics.bump("cost_flops_evicted", detail.get("cost", 0.0))
        self.metrics.sched_events.append(
            {"t": self.now(), "event": event, **detail})

    # ------------------------------------------------------ policy inputs ---
    def register_inflight(self, req: Request) -> None:
        """Record an admitted prefill as in flight: its full pages will
        land in the prefix cache as chunks commit.  The registry is what
        lets ``cache_aware`` admission hold an identical waiting prompt
        one round (hit) instead of admitting it alongside its twin
        (double miss).  Entries are removed at prefill completion
        (``_emit_first_token``) and at preemption, so a held request is
        never stranded behind a prefill that stopped."""
        if self.prefix_cache is not None:
            self._inflight[req.rid] = req.prefill_tokens

    def unregister_inflight(self, rid: int) -> None:
        self._inflight.pop(rid, None)

    def effective_slo(self, req: Request) -> EffectiveSLO:
        """``req``'s tier-resolved SLO (core/slo.py), cached per rid —
        the single answer the deadline policies, tenant quotas, chunk
        planner and SLO metrics all read.  Pure: no clock access."""
        eff = self._slo_cache.get(req.rid)
        if eff is None:
            eff = self._slo_cache[req.rid] = resolve_slo(req.slo, self.tiers)
        return eff

    def inflight_hit_pages(self, req: Request) -> int:
        """Best full-page prefix coverage of ``req``'s prefill that some
        in-flight prefill will have inserted once it commits (capped one
        token below the prefill length, like ``_cache_match``)."""
        if self.prefix_cache is None or not self._inflight:
            return 0
        toks = req.prefill_tokens
        ps = self.serve.page_size
        cap = (len(toks) - 1) // ps
        best = 0
        for other in self._inflight.values():
            lim = min(cap, len(other) // ps)
            n = 0
            while (n < lim and
                   toks[n * ps:(n + 1) * ps] == other[n * ps:(n + 1) * ps]):
                n += 1
            best = max(best, n)
        return best

    def resume_safe_pages(self, req: Request, committed: int) -> int:
        """Full pages of ``req``'s first ``committed`` tokens that would
        survive its own eviction: cached trie pages referenced by at
        least one OTHER live request.  Those keep serving hits after the
        victim's refcounts drop, so its resume remaps them instead of
        recomputing — the ``cache_aware`` PreemptPolicy's score.

        No ``_cache_match``-style cap is needed here: a victim's resume
        prefill is always at least one token longer than ``committed``
        (a slot's last generated token is in ``out_tokens`` but not in
        ``seq_len``; a stream's ``pos`` is short of its tokens), so the
        resume-side cap never truncates these committed full pages."""
        if self.prefix_cache is None:
            return 0
        toks = (req.prompt + req.out_tokens)[:committed]
        pages = self.prefix_cache.match(toks)
        owned = set(self.alloc.owned(req.rid))
        return sum(1 for p in pages
                   if self.alloc.ref_count(p) >= (2 if p in owned else 1))

    def _cache_match(self, tokens: List[int]):
        """(n_cached_tokens, hit_pages, partial) for ``tokens``.

        ``hit_pages`` are full-page hits shared in place; ``partial`` is
        ``(donor_page, n_matched)`` when — at token granularity — the
        match continues *inside* a cached page, reused via a COW copy
        (``PageAllocator.cow_partial``) so no matched token is ever
        recomputed.  The total span is capped at least one token below
        the prefill length: the engine always recomputes the final token
        (it needs its logits to sample from), so cached spans never reach
        a position the engine will write — shared pages stay read-only on
        every engine path (``PageAllocator.prepare_write`` guards the
        rest).
        """
        if self.prefix_cache is None:
            return 0, [], None
        ps = self.serve.page_size
        token_level = self.serve.prefix_cache_granularity == "token"
        if token_level:
            pages, partial = self.prefix_cache.match_tokens(tokens)
        else:
            pages, partial = self.prefix_cache.match(tokens), None
        cap_tokens = len(tokens) - 1
        cap_pages = cap_tokens // ps
        if len(pages) > cap_pages:
            # the whole prompt is cached: the capped-off page still serves
            # the tokens up to the cap as a partial donor
            t = cap_tokens - cap_pages * ps
            partial = ((pages[cap_pages], t)
                       if token_level and t > 0 else None)
            pages = pages[:cap_pages]
        elif partial is not None:
            t = min(partial[1], cap_tokens - len(pages) * ps)
            partial = (partial[0], t) if t > 0 else None
        n = len(pages) * ps + (partial[1] if partial else 0)
        return n, pages, partial

    def cache_probe(self, req: Request):
        """One trie walk answering the admission questions:
        ``(n_hit, n_free, cow_extra)`` — pages of ``req``'s next prefill
        the cache would serve (remap instead of recompute), the subset of
        those already referenced by a live request, which are
        *budget-free*, and a transient extra page to reserve when a
        token-level partial hit must revive an unreferenced donor while
        its COW copy is prepared (the donor parks reclaimable again once
        the copy exists, but both hold capacity for a moment).  The
        scheduler charges everything else — misses AND reclaimable hits,
        since reviving a parked page consumes free capacity just like a
        fresh allocation (it only saves the recompute)."""
        _, pages, partial = self._cache_match(req.prefill_tokens)
        cow_extra = int(partial is not None
                        and not self.alloc.is_referenced(partial[0]))
        return (len(pages),
                sum(1 for p in pages if self.alloc.is_referenced(p)),
                cow_extra)

    def _map_cached(self, req: Request) -> int:
        """Admission-time cache consult: map full-page hits into the
        request's refcounted ownership, materialize a token-level partial
        hit as a private COW copy of its donor page, and return the exact
        cached token count.  Prefill then starts at the first uncached
        token — possibly mid-page."""
        cache = self.prefix_cache
        if cache is None:
            return 0
        n, pages, partial = self._cache_match(req.prefill_tokens)
        if pages:
            self.alloc.share(req.rid, pages)
            cache.touch(pages)
        if partial is not None:
            donor, _ = partial
            # the copy needs a destination page now, plus the transient
            # revive of an unreferenced donor; admission budgets this
            # (cache_probe cow_extra), but the bare-fit progress override
            # doesn't — degrade to a miss on the partial span instead of
            # raising OutOfPages mid-admission
            headroom = 1 + (0 if self.alloc.is_referenced(donor) else 1)
            if self.alloc.n_free >= headroom:
                pair = self.alloc.cow_partial(req.rid, donor)
                cache.touch([donor])
                self._apply_cow([pair])
                self.metrics.n_partial_hits += 1
            else:
                n = len(pages) * self.serve.page_size
        if n:
            self.metrics.req(req.rid).n_cached_tokens += n
            self.metrics.n_cached_tokens += n
        return n

    def cache_insert(self, req: Request, n_committed: int,
                     final: bool = False) -> None:
        """Register ``req``'s committed-KV pages with the cache.

        Called after prefill work lands, at finish, and at preemption
        (scheduler) — the last one is what turns a preempted victim's
        recompute-on-resume into a remap of its own just-freed pages.
        Mid-flight inserts register full pages only (the tail page is
        still being written); ``final`` inserts — finish and preemption,
        where nothing will write into the tail again — also register the
        partial tail page at token granularity, so a future prompt that
        diverges inside it still reuses the matched span via COW.
        """
        if self.prefix_cache is None:
            return
        ps = self.serve.page_size
        n_full, rem = divmod(n_committed, ps)
        partial_tail = (final and rem > 0
                        and self.serve.prefix_cache_granularity == "token")
        n_pages = n_full + (1 if partial_tail else 0)
        if n_pages <= 0:
            return
        n_tokens = n_committed if partial_tail else n_full * ps
        tokens = (req.prompt + req.out_tokens)[:n_tokens]
        self.prefix_cache.insert(tokens, self.alloc.owned(req.rid)[:n_pages],
                                 allow_partial=partial_tail)

    def _apply_cow(self, pairs) -> None:
        """Materialize allocator copy-on-write decisions on the device
        pool (copy src page contents into the writer's private dst)."""
        if not pairs:
            return
        src = self._tensor(np.asarray([s for s, _ in pairs], np.int64))
        dst = self._tensor(np.asarray([d for _, d in pairs], np.int64))
        with torch.inference_mode():
            self.k_pages[:, dst] = self.k_pages[:, src]
            self.v_pages[:, dst] = self.v_pages[:, src]

    def _refresh_cache_stats(self) -> None:
        self._pages_shared_peak = max(self._pages_shared_peak,
                                      self.alloc.n_pages_shared)
        self.metrics.prefix_cache_stats = dict(
            enabled=int(self.prefix_cache is not None),
            n_reclaims=self.alloc.n_reclaims,
            n_cow=self.alloc.n_cow,
            n_partial_cow=self.alloc.n_partial_cow,
            n_shared_maps=self.alloc.n_shared_maps,
            pages_shared=self.alloc.n_pages_shared,
            pages_shared_peak=self._pages_shared_peak,
            n_reclaimable=(self.prefix_cache.n_reclaimable
                           if self.prefix_cache else 0),
            n_cached_pages=(self.prefix_cache.n_cached_pages
                            if self.prefix_cache else 0),
            n_evicted=(self.prefix_cache.n_evicted
                       if self.prefix_cache else 0),
        )

    # ------------------------------------------------------------- steps ---
    def step(self) -> List[TokenEvent]:
        self._events = []
        mode = self.serve.mode
        n_pre = self.metrics.n_preempt_events
        if mode == "sequential":
            kind = self._step_sequential()
        elif mode == "splitwiser":
            kind = self._step_timesliced()
        elif mode == "splitwiser_mps":
            kind = self._step_fused()
        elif mode == "chunked":
            kind = self._step_chunked()
        else:
            # ServeConfig.__post_init__ validates against SERVE_MODES, so
            # reaching here means a mode was registered without a step path
            raise RuntimeError(
                f"no step path for serve mode {mode!r}; SERVE_MODES and "
                "Engine.step() must be extended together")
        if kind == "idle" and self.metrics.n_preempt_events > n_pre:
            kind = "preempt"    # nothing dispatched, but evictions happened
        self.metrics.n_steps += 1
        self.metrics.step_kinds.append(kind)
        self.metrics.kv_usage_trace.append(self.alloc.usage())
        self._refresh_cache_stats()
        return self._events

    # --- sequential: full-prompt prefill OR decode per step -----------------
    def _step_sequential(self) -> str:
        batch = self.sched.take_prefillable()
        if batch:
            self._do_full_prefill(batch)
            return "prefill"
        if any(self.slots) and self._do_decode():
            return "decode"
        return "idle"

    def _do_full_prefill(self, reqs: List[Request]):
        """Sequential-mode prefill: cache misses take the classic
        full-prompt path; cache hits map their shared pages and compute
        only the uncached suffix through the paged mixed kernel.  Two
        identical prompts admitted in the same batch both miss (the
        first's pages are only registered at commit) — the copy is
        cached for every later request."""
        if self.prefix_cache is None:
            self._prefill_full_batch(reqs)
            return
        hits, misses = [], []
        for r in reqs:
            n_cached = self._map_cached(r)
            (hits if n_cached else misses).append((r, n_cached))
        if misses:
            self._prefill_full_batch([r for r, _ in misses])
        if hits:
            self._prefill_suffix_batch(hits)

    def _prefill_full_batch(self, reqs: List[Request]):
        ps = self.serve.page_size
        t0 = self.now()
        S_pad = max(-(-max(len(r.prefill_tokens) for r in reqs) // ps) * ps, ps)
        Bp = len(reqs)
        tokens = np.zeros((Bp, S_pad), np.int32)
        lens = np.zeros((Bp,), np.int32)
        for i, r in enumerate(reqs):
            toks = r.prefill_tokens
            tokens[i, : len(toks)] = toks
            lens[i] = len(toks)
            m = self.metrics.req(r.rid)
            if m.t_prefill_start is None:
                m.t_prefill_start = t0
            self.metrics.n_prefill_tokens += len(toks)
        logits, (k, v) = self._prefill(self._tensor(tokens), self._tensor(lens))
        # commit contiguous KV into allocated pages
        n_per = S_pad // ps
        dest = np.full((Bp * n_per,), self.alloc.trash_page, np.int32)
        for i, r in enumerate(reqs):
            pages = self.alloc.alloc(r.rid, self.alloc.pages_needed(lens[i]))
            dest[i * n_per : i * n_per + len(pages)] = pages
        self._commit(T.kv_to_pages(k, ps), T.kv_to_pages(v, ps),
                     self._tensor(dest.astype(np.int64)))
        toks = self._sample_rows(logits, reqs)
        t1 = self.now()
        for i, r in enumerate(reqs):
            self.cache_insert(r, int(lens[i]))
            self._emit_first_token(r, int(toks[i]), int(lens[i]), t1)

    def _prefill_suffix_batch(self, hits: List[tuple]):
        """Prefill (request, n_cached) pairs from their first uncached
        token: hit pages are already mapped into ownership, the suffix
        chunk attends to them through the paged mixed kernel
        (``p_start > 0`` — with token-level reuse the start may sit
        mid-page, inside the COW-copied donor), and only suffix pages
        are freshly allocated."""
        ps = self.serve.page_size
        t0 = self.now()
        P = len(hits)
        suffixes = [r.prefill_tokens[n:] for r, n in hits]
        C = max(-(-max(len(s) for s in suffixes) // ps) * ps, ps)
        W = self.serve.max_pages_per_seq + 1   # +1 slack: padded chunk page
                                               # lookups may peek one past
        p_tokens = np.zeros((P, C), np.int32)
        p_start = np.zeros((P,), np.int32)
        p_lens = np.zeros((P,), np.int32)
        p_table = np.zeros((P, W), np.int32)
        for i, (r, n) in enumerate(hits):
            toks = suffixes[i]
            m = self.metrics.req(r.rid)
            if m.t_prefill_start is None:
                m.t_prefill_start = t0
            self.alloc.extend_to(r.rid, n + len(toks))
            self._apply_cow(self.alloc.prepare_write(r.rid, n, len(toks)))
            bt = self.alloc.owned(r.rid)
            p_table[i, : len(bt)] = bt
            p_tokens[i, : len(toks)] = toks
            p_start[i] = n
            p_lens[i] = len(toks)
            self.metrics.n_prefill_tokens += len(toks)
        mb = self._mixed_batch(p_tokens, p_table, p_start, p_lens,
                               *self._no_decode(W))
        p_logits, _ = self._mixed(mb)
        toks_out = self._sample_rows(p_logits, [r for r, _ in hits])
        t1 = self.now()
        for i, (r, n) in enumerate(hits):
            full_len = n + len(suffixes[i])
            self.cache_insert(r, full_len)
            self._emit_first_token(r, int(toks_out[i]), full_len, t1)

    def _emit_first_token(self, req: Request, tok: int, seq_len: int, t):
        """First token after a (re-)prefill; a resumed request keeps its
        original TTFT."""
        self.unregister_inflight(req.rid)   # prefill committed: twins now hit
        m = self.metrics.req(req.rid)
        if m.t_first_token is None:
            m.t_first_token = t
        m.token_times.append(t)
        req.out_tokens.append(tok)
        m.n_generated = len(req.out_tokens)
        reason = self._finish_reason(req)
        self._record_event(req, tok, t, reason)
        if reason is not None:
            self._finish(req, t, reason, n_committed=seq_len)
            return
        free = next((i for i, s in enumerate(self.slots) if s is None), None)
        if free is None:
            raise RuntimeError(
                f"slot invariant violated: no free decode slot for rid "
                f"{req.rid} (max_batch={self.serve.max_batch}). Admission is "
                "bounded by free slots (take_prefillable / _compose_prefill "
                "backpressure), so an over-full prefill batch is an engine "
                "bug, not a capacity error.")
        self.slots[free] = _Slot(req=req, seq_len=seq_len, next_token=tok)
        bt = self.alloc.owned(req.rid)
        self.block_tables[free, :] = 0
        self.block_tables[free, : len(bt)] = bt

    def _finish_reason(self, req: Request) -> Optional[str]:
        """None while running, else "length" | "stop" (per-request params)."""
        if req.out_tokens and req.out_tokens[-1] in req.sampling.stop_set:
            return "stop"
        if len(req.out_tokens) >= req.sampling.max_new_tokens:
            return "length"
        return None

    def _finish(self, req: Request, t, reason: str, n_committed: int = 0):
        m = self.metrics.req(req.rid)
        m.t_done = t
        m.n_generated = len(req.out_tokens)
        m.finish_reason = reason
        # settle the SLO verdict: TTFT against the target, TBT against
        # the WORST inter-token gap; None (no deadline resolved) stays
        # out of the attainment fractions
        eff = self.effective_slo(req)
        m.slo_ok = slo_outcome(m.ttft, m.tbt_max, eff)
        if m.slo_ok is True:
            self.metrics.slo_attained += 1
        elif m.slo_ok is False:
            self.metrics.slo_missed += 1
        # register committed KV before freeing: the pages park on the
        # cache's reclaimable list and keep serving identical prefixes
        # (final: the partial tail page is reusable too)
        self.cache_insert(req, n_committed, final=True)
        self.alloc.free(req.rid)
        self._outputs.append(RequestOutput(
            rid=req.rid, prompt=list(req.prompt), tokens=list(req.out_tokens),
            finish_reason=reason, n_preempted=m.n_preempted,
            n_cached_tokens=m.n_cached_tokens,
            arrival=m.arrival, token_times=list(m.token_times), t_done=t,
            tenant=eff.tenant, slo_attained=m.slo_ok))

    def _record_event(self, req: Request, tok: int, t, reason: Optional[str]):
        self._events.append(TokenEvent(
            rid=req.rid, token=tok, index=len(req.out_tokens) - 1, t=t,
            first=len(req.out_tokens) == 1, finish_reason=reason))

    def _reserve_decode_pages(self):
        """Grow every active slot's page table for its next token,
        preempting younger requests under pressure.  A slot that cannot
        be served even after evicting every younger victim (older
        requests hold the pool) preempts itself.  With
        ``preempt_policy="none"`` the raw `extend_to` may raise
        OutOfPages — the seed crash, kept for comparison runs."""
        for i in range(len(self.slots)):
            s = self.slots[i]
            if s is None:
                continue
            if self.serve.preempt_policy != "none" and \
                    not self.sched.ensure_pages(s.req, s.seq_len + 1):
                self.sched.preempt("slot", i, reason="self")
                continue
            new = self.alloc.extend_to(s.req.rid, s.seq_len + 1)
            # COW a shared/cached tail page before the decode token's KV
            # scatters into it (no-op unless the page has other readers)
            pairs = self.alloc.prepare_write(s.req.rid, s.seq_len)
            self._apply_cow(pairs)
            if new or pairs:
                bt = self.alloc.owned(s.req.rid)
                self.block_tables[i, : len(bt)] = bt

    def _do_decode(self) -> bool:
        self._reserve_decode_pages()
        tokens, lens, active = self._decode_inputs()
        if not active.any():        # every slot was preempted
            return False
        logits = self._decode(self._tensor(tokens),
                              self._tensor(self.block_tables),
                              self._tensor(lens), self._tensor(active))
        self._advance_decode(logits, active, self.now())
        return True

    # --- splitwiser modes ----------------------------------------------------
    def _refill_streams(self):
        for r in self.sched.admit_streams():
            i = self.streams.index(None)
            # a cache hit maps shared pages and fast-forwards the stream
            # past the cached chunks: prefill starts at the first
            # uncached token (SARATHI-style streams skip cached work)
            n_cached = self._map_cached(r)
            self.streams[i] = _Stream(req=r, tokens=r.prefill_tokens,
                                      pos=n_cached)
            m = self.metrics.req(r.rid)
            if m.t_prefill_start is None:
                m.t_prefill_start = self.now()

    def _compose_prefill(self, plan: Optional[ChunkPlan] = None):
        """Build the prefill half of a mixed batch from the streams.

        A stream's final chunk is only scheduled when a decode slot is
        available for the request it completes (backpressure); a stream
        whose page extension cannot be satisfied this step — even after
        the scheduler evicts younger victims — simply skips its chunk
        and retries once pages free up.  Streams already composed this
        step are protected from eviction (their chunk is about to write
        into their pages).

        With a ``plan`` (chunked mode) each stream contributes exactly
        its planned token count — the static row width is the plan's cap
        (``chunk_tokens``) instead of ``prefill_chunk``.  A skipped
        stream's planned tokens are *not* redistributed this round
        (conservative; the next plan re-carves).
        """
        P = self.serve.n_streams
        C = self.serve.prefill_chunk if plan is None else plan.cap
        p_tokens = np.zeros((P, C), np.int32)
        p_start = np.zeros((P,), np.int32)
        p_lens = np.zeros((P,), np.int32)
        chunks = []
        protect = set()
        free_slots = sum(s is None for s in self.slots)
        for i, st in enumerate(self.streams):
            if st is None:
                continue
            want = C if plan is None else plan.chunk_lens[i]
            n = min(want, len(st.tokens) - st.pos)
            if n <= 0:
                continue
            if st.pos + n >= len(st.tokens) and free_slots <= 0:
                continue                             # completing chunk, no slot
            if self.serve.preempt_policy != "none" and \
                    not self.sched.ensure_pages(st.req, st.pos + n + 1,
                                                protect=protect):
                continue
            if st.pos + n >= len(st.tokens):
                free_slots -= 1
            self.alloc.extend_to(st.req.rid, st.pos + n + 1)
            self._apply_cow(self.alloc.prepare_write(st.req.rid, st.pos, n))
            bt = self.alloc.owned(st.req.rid)
            self.stream_tables[i, :] = 0
            self.stream_tables[i, : len(bt)] = bt
            p_tokens[i, :n] = st.tokens[st.pos : st.pos + n]
            p_start[i] = st.pos
            p_lens[i] = n
            protect.add(st.req.rid)
            chunks.append((i, st, n))
        return p_tokens, p_start, p_lens, chunks

    def _advance_streams(self, chunks, p_logits, t):
        completing = [None] * len(self.streams)
        for i, st, n in chunks:
            if st.pos + n >= len(st.tokens):
                completing[i] = st.req
        toks = (self._sample_rows(p_logits, completing)
                if any(r is not None for r in completing) else None)
        for i, st, n in chunks:
            st.pos += n
            self.metrics.n_prefill_tokens += n
            self.cache_insert(st.req, st.pos)   # register landed full pages
            if st.pos >= len(st.tokens):
                self._emit_first_token(st.req, int(toks[i]), len(st.tokens), t)
                self.streams[i] = None

    def _decode_inputs(self):
        B = self.serve.max_batch
        tokens = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tokens[i] = s.next_token
            lens[i] = s.seq_len
            active[i] = True
        return tokens, lens, active

    def _dispatch_mixed(self, composed, with_decode: bool) -> bool:
        """Dispatch ONE mixed program over the composed prefill chunks
        and advance both halves on a single timestamp — the shared tail
        of the fused, time-sliced, and chunked step paths.

        ``with_decode=True`` (fused/chunked) packs every decode slot in:
        the decode arrays stay ``max_batch``-sized even when no slot is
        active, so the mode keeps one static program shape.
        ``with_decode=False`` (the time-sliced prefill phase) dispatches
        the same kernel phase-exclusively with zero-size decode arrays.
        Returns False when there was nothing to dispatch.
        """
        p_tokens, p_start, p_lens, chunks = composed
        if with_decode:
            d_tokens, d_lens, d_active = self._decode_inputs()
            if not chunks and not d_active.any():
                return False
            d_half = (d_tokens, self.block_tables, d_lens, d_active)
        else:
            if not chunks:
                return False
            d_half = self._no_decode(self.serve.max_pages_per_seq)
            d_active = d_half[3]
        mb = self._mixed_batch(p_tokens, self.stream_tables, p_start, p_lens,
                               *d_half)
        p_logits, d_logits = self._mixed(mb)
        t = self.now()
        if d_active.size and d_active.any():
            self._advance_decode(d_logits, d_active, t)
        self._advance_streams(chunks, p_logits, t)
        return True

    def _mixed_batch(self, p_tokens, p_table, p_start, p_lens,
                     d_tokens, d_table, d_lens, d_active) -> dict:
        """The host arrays of one mixed step as ``T.mixed``'s batch dict,
        on the engine's device."""
        arrays = dict(p_tokens=p_tokens, p_table=p_table, p_start=p_start,
                      p_lens=p_lens, d_tokens=d_tokens, d_table=d_table,
                      d_lens=d_lens, d_active=d_active)
        return {k: self._tensor(v) for k, v in arrays.items()}

    @staticmethod
    def _no_decode(width: int):
        """Zero-size decode half of a phase-exclusive prefill step."""
        return (np.zeros((0,), np.int32), np.zeros((0, width), np.int32),
                np.zeros((0,), np.int32), np.zeros((0,), bool))

    def _step_fused(self) -> str:
        """splitwiser_mps: ONE program runs both phases (the contribution)."""
        self._refill_streams()
        # reserve decode pages BEFORE composing prefill: compose-time
        # eviction of an already-extended slot is safe (it just drops out
        # of the decode half), the reverse would dispatch a chunk into a
        # preempted stream's freed pages.
        self._reserve_decode_pages()
        if self._dispatch_mixed(self._compose_prefill(), with_decode=True):
            return "mixed"
        return "idle"

    def _step_timesliced(self) -> str:
        """splitwiser (no MPS): phases alternate as separate programs."""
        self._refill_streams()
        has_chunks = any(s is not None and s.pos < len(s.tokens)
                         for s in self.streams)
        has_decode = any(self.slots)
        do_prefill = has_chunks and (self._step_parity == 0 or not has_decode)
        self._step_parity ^= 1
        # phase-exclusive program: prefill chunks only (B=0 decode part);
        # when slot backpressure / page pressure filtered out every chunk,
        # don't dispatch an empty program — fall through to decode
        if do_prefill and self._dispatch_mixed(self._compose_prefill(),
                                               with_decode=False):
            return "prefill_chunk"
        if has_decode and self._do_decode():
            return "decode"
        return "idle"

    def _step_chunked(self) -> str:
        """chunked: the planner packs the round, the engine dispatches it.

        Every runnable decode token rides in every round (never starved,
        never stalled behind a prompt); the planner carves the remaining
        ``chunk_tokens`` budget over the in-flight prefill streams.  One
        mixed dispatch per round — a 2k-token prompt becomes a train of
        budget-bounded chunks interleaved with live decodes, so tail TBT
        is bounded by the chunk budget instead of the prompt length."""
        self._refill_streams()
        self._reserve_decode_pages()
        n_decode = sum(s is not None for s in self.slots)
        remaining = [0 if st is None else max(len(st.tokens) - st.pos, 0)
                     for st in self.streams]
        plan = self.planner.plan(remaining, n_decode,
                                 self._stream_priorities())
        composed = self._compose_prefill(plan)
        if not self._dispatch_mixed(composed, with_decode=True):
            return "idle"
        chunks = composed[3]
        self.metrics.n_chunks += len(chunks)
        packed = sum(n for _, _, n in chunks) + n_decode
        hist = self.metrics.packed_tokens_hist
        hist[packed] = hist.get(packed, 0) + 1
        return "mixed"

    def _stream_priorities(self) -> Optional[List[Optional[float]]]:
        """Per-stream carve urgencies for the chunk planner: tenant-
        weighted TTFT slack, ascending = more urgent (core/slo.py).
        None when no in-flight prefill carries a TTFT deadline — the
        deadline-free path stays byte-identical (cursor round-robin, no
        clock read; one ``now()`` read per round otherwise).  Weight
        scaling is sign-aware so a heavier tenant is *always* more
        urgent at equal raw slack: positive slack shrinks by the weight,
        overdue (negative) slack grows by it."""
        effs = [None if st is None else self.effective_slo(st.req)
                for st in self.streams]
        if not any(e is not None and e.ttft_target is not None for e in effs):
            return None
        t_now = self.now()
        out: List[Optional[float]] = []
        for st, e in zip(self.streams, effs):
            if e is None or e.ttft_target is None:
                out.append(None)
                continue
            slack = (st.req.arrival or 0.0) + e.ttft_target - t_now
            out.append(slack / e.weight if slack >= 0 else slack * e.weight)
        return out

    def _advance_decode(self, d_logits, d_active, t):
        rows = [s.req if (s is not None and d_active[i]) else None
                for i, s in enumerate(self.slots)]
        if not any(r is not None for r in rows):
            return
        toks = self._sample_rows(d_logits, rows)
        for i, s in enumerate(self.slots):
            if s is None or not d_active[i]:
                continue
            tok = int(toks[i])
            s.req.out_tokens.append(tok)
            s.seq_len += 1
            m = self.metrics.req(s.req.rid)
            m.token_times.append(t)
            m.n_generated = len(s.req.out_tokens)
            reason = self._finish_reason(s.req)
            self._record_event(s.req, tok, t, reason)
            if reason is not None:
                self._finish(s.req, t, reason, n_committed=s.seq_len)
                self.slots[i] = None
            else:
                s.next_token = tok

    # ---------------------------------------------------------------- misc -
    def _sample_rows(self, logits, reqs: List[Optional[Request]]):
        """Sample one token per row of ``logits`` using each aligned
        request's own SamplingParams (None rows are inactive padding:
        greedy over garbage, discarded by the caller).  Row i's PRNG
        stream is (seed, rid, len(out_tokens)) — the index of the token
        being sampled — so results don't depend on batch composition,
        engine mode, or preemption history."""
        if all(r is None or r.sampling.temperature <= 0.0 for r in reqs):
            return greedy_tokens(logits).cpu().numpy()  # all-greedy fast path
        B = logits.shape[0]
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        seed = np.zeros((B,), np.int32)
        rid = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seed[i] = sp.seed
            rid[i] = r.rid
            pos[i] = len(r.out_tokens)
        return sample_tokens(
            logits, *(torch.from_numpy(a) for a in (temp, top_k, top_p, seed,
                                                    rid, pos))).cpu().numpy()


def _to_device(params, device):
    """The parameter dict with every tensor on ``device``."""
    return {k: (_to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}
