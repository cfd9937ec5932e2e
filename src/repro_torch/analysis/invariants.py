"""Runtime KV-state sanitizer: the serving stack's cross-module contract
as machine-checked invariants.

The serving core is a web of state shared across modules — refcounted
copy-on-write pages (``core/kv_cache.py``), a token-granular prefix trie
with partial leaves (``core/prefix_cache.py``), and policy-driven
reclaim/preemption (``core/scheduler.py``).  Each module documents its
side of the contract; this module makes the *whole* contract executable,
so a violation fails loudly at the step that corrupts state instead of
surfacing N steps later as a wrong token or a phantom OutOfPages.

Gating (``ServeConfig.sanitize_level``)
    ``off``     never check (production default; zero overhead).
    ``finish``  run the full check after any engine step that finished a
                request — terminal points are where insert/free/requeue
                interact, which is where past bugs clustered.
    ``step``    run the full check after *every* engine step (CI mode;
                tier-1 and the hypothesis suite run under this level).
    ``call``    everything ``step`` does, plus call-site hooks
                (``analysis/hooks.py``) around every mutating
                ``PageAllocator``/``PrefixCache`` entry point: the
                relevant invariant subset runs at the mutator's exit, so
                a violation is attributed to the exact call (method,
                args digest, request id, event tail) instead of
                "somewhere before the step boundary".

At any level above ``off`` the sanitizer also runs the **differential
preempt/resume checker**: at preemption it snapshots the victim's
committed cached pages that other live requests keep referenced — the
exact pages ``Engine.resume_safe_pages`` promises survive the eviction —
and at the victim's re-admission verifies the resume remapped every
promised page that is still cached (page ids, ownership, refcounts).  A
promise may lapse only by eviction: if the page left the trie under
pressure, recomputing it is legitimate; if it is still cached and the
resume recomputed it anyway, prefix matching regressed and the checker
fails loudly.

Invariants checked
    * **page conservation** — the free list, the cache's reclaimable
      pool, and live-referenced pages partition the usable pool exactly
      (no page lost, none counted twice, the trash page in none of them);
    * **refcount honesty** — allocator refcounts equal the multiset of
      per-request page-table references; zero-ref entries leave the
      table entirely;
    * **COW exclusivity** — a page mapped by more than one request is
      registered in the prefix trie (sharing only arises through the
      cache; ``prepare_write`` can only guard pages it knows are
      shared), or was explicitly orphaned by the blocked-subtree
      eviction fallback; no request maps the same page twice;
    * **trie structure** — parent-before-child, gap-free chains with
      consistent child links, ``1 <= n_valid <= page_size``, partial
      leaves terminal, descendant counts exact, reclaimable pool
      consistent with refcounts (a zero-ref cached page is reclaimable,
      a referenced one is not, none sit on the free list);
    * **scale-sidecar honesty** (``ServeConfig.kv_dtype="int8"``) — the
      engine's :class:`~repro_torch.core.kv_cache.KVQuantSidecar` mirror holds
      exactly one scale entry for every page with live quantized
      contents: every committed-coverage page of every active sequence
      and every cached trie page is registered, no entry survives a
      page's return to the free list (or names the trash page), and the
      device pool's bytes (codes + scale sidecars, K and V, all layers)
      conserve against the allocator's byte-denominated sizing;
    * **scheduler budget honesty** — the pages an admission charged
      against the watermark budget bound what the request actually
      consumed from the free pool through the end of its prefill
      (fresh allocations + reclaimable revivals + COW copies).  In
      ``mode="chunked"`` admission charges only the cached prefix plus
      one chunk and the budget grows per scheduled chunk
      (:meth:`KVSanitizer.note_chunk`), each growth a pre-commitment
      computed before the chunk allocates;
    * **chunk-plan packing** (``mode="chunked"``) — every round's
      :class:`~repro_torch.core.planner.ChunkPlan` packs all runnable decode
      tokens, never carves a stream past its remaining prefill or the
      budget the decodes leave, and is work-conserving
      (:func:`~repro_torch.core.planner.validate_plan`);
    * **tenant-quota honesty** (``admission_policy="deadline"`` with
      quota'd ``ServeConfig.tenants``) — every quota'd tenant's active
      in-flight footprint (prompt + full generation grant per request,
      ``core/slo.py``) stays within its ``quota_tokens``, except for
      the documented single-oversized-request progress case.

On failure a structured :class:`InvariantViolation` is raised carrying
the violated invariant's name, an allocator/trie/scheduler state dump,
and the tail of the scheduler's :class:`~repro_torch.core.metrics.EventRing`
for post-mortem.

``verify_state(alloc, cache)`` runs the allocator/trie subset without an
engine — the hypothesis property suite drives random lifecycle
interleavings through it.

Adding an invariant: see EXPERIMENTS.md ("adding a lint rule / adding an
invariant").
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

SANITIZE_LEVELS = ("off", "finish", "step", "call")

_EVENT_TAIL = 16      # sched events carried in the violation report
_NODE_DUMP_CAP = 64   # trie nodes listed in the state dump


class InvariantViolation(RuntimeError):
    """A cross-module serving invariant failed.

    Attributes
        invariant   machine-readable name of the violated invariant
                    (e.g. ``"page_conservation"``, ``"refcount_honesty"``)
        state       allocator/trie/scheduler state dump at failure time
        events      tail of the scheduler event ring (post-mortem trace)
        call_site   at ``sanitize_level="call"``: the mutating call the
                    violation was detected at — ``method``, ``args``
                    (digest), ``rid`` (when the first argument is one),
                    ``n_call`` (how many times the method ran)
    """

    def __init__(self, invariant: str, message: str,
                 state: Optional[Dict[str, Any]] = None,
                 events: Optional[List[dict]] = None,
                 call_site: Optional[Dict[str, Any]] = None):
        self.invariant = invariant
        self.state = state or {}
        self.events = list(events or [])
        self.call_site = call_site or {}
        text = f"[{invariant}] {message}"
        if self.call_site:
            rid = self.call_site.get("rid")
            text += (f"\n--- call site ---\n  "
                     f"{self.call_site.get('method')}"
                     f"({self.call_site.get('args', '')})"
                     + ("" if rid is None else f"  [rid={rid}]")
                     + (f"  (call #{self.call_site['n_call']})"
                        if "n_call" in self.call_site else ""))
        if self.state:
            text += "\n--- state dump ---\n" + json.dumps(
                self.state, indent=1, default=str, sort_keys=True)
        if self.events:
            text += (f"\n--- last {len(self.events)} sched events ---\n"
                     + "\n".join(f"  {e}" for e in self.events))
        super().__init__(text)


# --------------------------------------------------------- state dumps ----
def allocator_state(alloc) -> Dict[str, Any]:
    """JSON-serializable snapshot of a :class:`PageAllocator`."""
    return {
        "n_pages": alloc.n_pages,
        "page_size": alloc.page_size,
        "n_free": alloc.n_free,
        "free_list": sorted(alloc._free),
        "refs": {str(p): c for p, c in sorted(alloc._ref.items())},
        "owned": {str(r): list(pages) for r, pages in sorted(alloc._owned.items())},
        "consumed": {str(r): c for r, c in sorted(alloc._consumed.items())},
    }


def trie_state(cache) -> Dict[str, Any]:
    """JSON-serializable snapshot of a :class:`PrefixCache`."""
    if cache is None:
        return {"enabled": False}
    nodes = {}
    for node in list(cache._nodes.values())[:_NODE_DUMP_CAP]:
        nodes[str(node.nid)] = {
            "page": node.page,
            "parent": None if node.parent is None else node.parent.nid,
            "n_valid": node.n_valid,
            "depth": node.depth,
            "n_desc": node.n_desc,
            "reclaimable": node.reclaimable,
        }
    return {
        "enabled": True,
        "n_nodes": len(cache._nodes),
        "n_reclaimable": cache.n_reclaimable,
        "reclaimable_pages": sorted(cache._reclaimable),
        "orphaned_shared": sorted(cache.orphaned_shared),
        "nodes": nodes,
        "nodes_truncated": len(cache._nodes) > _NODE_DUMP_CAP,
    }


def _state(alloc, cache, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    state = {"allocator": allocator_state(alloc), "trie": trie_state(cache)}
    if extra:
        state.update(extra)
    return state


# ------------------------------------------------------------- checkers ----
def _check_page_conservation(fail, alloc, cache,
                             exempt: frozenset = frozenset()) -> None:
    free_list = list(alloc._free)
    free = set(free_list)
    if len(free) != len(free_list):
        dupes = sorted(p for p in free if free_list.count(p) > 1)
        fail("page_conservation",
             f"free list holds duplicate entries {dupes} (double free)")
    live = set(alloc._ref)
    recl = set(cache._reclaimable) if cache is not None else set()
    for name, pages in (("free list", free), ("live set", live),
                        ("reclaimable pool", recl)):
        if alloc.trash_page in pages:
            fail("page_conservation",
                 f"trash page {alloc.trash_page} appears in the {name}")
    overlaps = [("free/live", free & live), ("free/reclaimable", free & recl),
                ("live/reclaimable", live & recl)]
    for name, inter in overlaps:
        if inter:
            fail("page_conservation",
                 f"page sets overlap ({name}): {sorted(inter)}")
    usable = alloc.n_pages - 1
    # ``exempt``: pages legitimately in transit at a call-site check —
    # e.g. the page ``pop_reclaimable`` just returned sits in the
    # caller's hands, in no bucket, until the caller re-registers it.
    in_transit = {p for p in exempt
                  if p not in free and p not in live and p not in recl}
    total = len(free) + len(live) + len(recl) + len(in_transit)
    if total != usable:
        missing = set(range(usable)) - free - live - recl - in_transit
        fail("page_conservation",
             f"free({len(free)}) + live({len(live)}) + "
             f"reclaimable({len(recl)}) = {total - len(in_transit)} != "
             f"pool size {usable}"
             + (f" (exempt in-transit: {sorted(in_transit)})" if in_transit else "")
             + (f"; leaked pages {sorted(missing)}" if missing else ""))
    if alloc.n_free != len(free) + len(recl):
        fail("page_conservation",
             f"n_free property reports {alloc.n_free}, actual "
             f"free+reclaimable is {len(free) + len(recl)}")


def _check_refcount_honesty(fail, alloc, cache=None) -> None:
    del cache  # uniform checker signature; refcounts are allocator-local
    for page, refs in alloc._ref.items():
        if refs < 1:
            fail("refcount_honesty",
                 f"page {page} has refcount {refs}; zero-ref entries must "
                 "leave the table (park reclaimable or return to the free list)")
    counts: Dict[int, int] = {}
    for pages in alloc._owned.values():
        for p in pages:
            counts[p] = counts.get(p, 0) + 1
    if counts != alloc._ref:
        drift = {p: (counts.get(p, 0), alloc._ref.get(p, 0))
                 for p in set(counts) | set(alloc._ref)
                 if counts.get(p, 0) != alloc._ref.get(p, 0)}
        fail("refcount_honesty",
             "allocator refcounts disagree with per-request page tables "
             f"(page: (table refs, refcount)): {drift}")


def _check_cow_exclusivity(fail, alloc, cache) -> None:
    for rid, pages in alloc._owned.items():
        if len(set(pages)) != len(pages):
            dupes = sorted(p for p in set(pages) if pages.count(p) > 1)
            fail("cow_exclusivity",
                 f"request {rid} maps pages {dupes} more than once")
    for page, refs in alloc._ref.items():
        if refs <= 1:
            continue
        cached = cache is not None and cache.is_cached(page)
        orphaned = cache is not None and page in cache.orphaned_shared
        if not (cached or orphaned):
            fail("cow_exclusivity",
                 f"page {page} is mapped by {refs} requests but is not "
                 "registered in the prefix trie: sharing outside the cache "
                 "contract means copy-on-write cannot protect its readers")


def _check_trie_structure(fail, alloc, cache) -> None:
    if cache is None:
        return
    if len(cache._by_page) != len(cache._nodes):
        fail("trie_structure",
             f"page index holds {len(cache._by_page)} entries for "
             f"{len(cache._nodes)} nodes (aliased or leaked pages)")
    n_children: Dict[int, int] = {}
    n_desc: Dict[int, int] = {}
    for node in cache._nodes.values():
        if cache._by_page.get(node.page) is not node:
            fail("trie_structure",
                 f"node {node.nid} (page {node.page}) missing from or "
                 "aliased in the page index")
        if not 1 <= node.n_valid <= cache.page_size:
            fail("trie_structure",
                 f"node {node.nid} has n_valid={node.n_valid} outside "
                 f"[1, page_size={cache.page_size}]")
        if node.n_valid < cache.page_size and node.children:
            fail("trie_structure",
                 f"partial leaf {node.nid} (n_valid={node.n_valid}) has "
                 f"{len(node.children)} children; partial pages are "
                 "terminal — nothing can chain past an unwritten tail")
        if node.parent is None:
            if node.depth != 0:
                fail("trie_structure",
                     f"root-level node {node.nid} has depth {node.depth}")
            if cache._roots.get(node.key[1]) is not node:
                fail("trie_structure",
                     f"root-level node {node.nid} is not linked from the "
                     "root map (orphaned chain head)")
        else:
            parent = node.parent
            if cache._nodes.get(parent.key) is not parent:
                fail("trie_structure",
                     f"node {node.nid} (page {node.page}) points at parent "
                     f"{parent.nid} which is not in the trie (orphaned "
                     "node: its chain has a gap)")
            if parent.nid >= node.nid:
                fail("trie_structure",
                     f"node {node.nid} was created before its parent "
                     f"{parent.nid} (parent-before-child violated)")
            if node.depth != parent.depth + 1:
                fail("trie_structure",
                     f"node {node.nid} depth {node.depth} != parent depth "
                     f"{parent.depth} + 1")
            if parent.children.get(node.key[1]) is not node:
                fail("trie_structure",
                     f"node {node.nid} is not linked from its parent's "
                     "children (gap in the chain)")
            anc = parent
            while anc is not None:
                n_desc[anc.nid] = n_desc.get(anc.nid, 0) + 1
                anc = anc.parent
            n_children[parent.nid] = n_children.get(parent.nid, 0) + 1
    for node in cache._nodes.values():
        if node.n_desc != n_desc.get(node.nid, 0):
            fail("trie_structure",
                 f"node {node.nid} records n_desc={node.n_desc}, actual "
                 f"descendant count is {n_desc.get(node.nid, 0)}")
        if len(node.children) != n_children.get(node.nid, 0):
            fail("trie_structure",
                 f"node {node.nid} child links ({len(node.children)}) "
                 f"disagree with the node table ({n_children.get(node.nid, 0)})")
        for chunk, child in node.children.items():
            if child.parent is not node or child.key != (node.nid, chunk):
                fail("trie_structure",
                     f"child link {node.nid} -> {child.nid} is inconsistent "
                     "with the child's own key/parent")
    for chunk, node in cache._roots.items():
        if cache._nodes.get(node.key) is not node or node.key != (0, chunk):
            fail("trie_structure",
                 f"root link {chunk!r} points at a dead or mis-keyed node")
    # reclaimable pool vs refcounts
    for page, node in cache._reclaimable.items():
        if cache._by_page.get(page) is not node:
            fail("trie_structure",
                 f"reclaimable page {page} is not (or no longer) cached")
        if not node.reclaimable:
            fail("trie_structure",
                 f"reclaimable page {page} has reclaimable=False on its node")
        if page in alloc._ref:
            fail("trie_structure",
                 f"page {page} is reclaimable while still referenced "
                 f"({alloc._ref[page]} refs): it could be stripped out from "
                 "under a live request")
    free = set(alloc._free)
    for page, node in cache._by_page.items():
        if page not in alloc._ref and page not in cache._reclaimable:
            fail("trie_structure",
                 f"cached page {page} has zero refs but is not parked "
                 "reclaimable (leaked capacity)")
        if node.reclaimable and page not in cache._reclaimable:
            fail("trie_structure",
                 f"node for page {page} is flagged reclaimable but absent "
                 "from the reclaimable pool")
        if page in free:
            fail("trie_structure",
                 f"cached page {page} sits on the free list: the trie "
                 "would serve stale KV after it is reallocated")


# Named registry: call-site hooks (``analysis/hooks.py``) run per-mutator
# subsets of these by name; ``verify_state`` runs them all.
CHECKS = {
    "page_conservation": _check_page_conservation,
    "refcount_honesty": _check_refcount_honesty,
    "cow_exclusivity": _check_cow_exclusivity,
    "trie_structure": _check_trie_structure,
}

_STATE_CHECKS = tuple(CHECKS.values())


def verify_subset(alloc, cache, names,
                  exempt: frozenset = frozenset(),
                  extra: Optional[Dict[str, Any]] = None,
                  events: Optional[List[dict]] = None,
                  call_site: Optional[Dict[str, Any]] = None) -> None:
    """Run the named subset of the state checks (``CHECKS`` keys); raise
    :class:`InvariantViolation` on the first failure, tagged with
    ``call_site`` when the caller is a call-tier hook.

    ``exempt`` pages are excused from page-conservation bucket membership
    (in transit between owners at the instrumented call's exit).
    """
    def fail(invariant: str, message: str) -> None:
        raise InvariantViolation(invariant, message,
                                 state=_state(alloc, cache, extra),
                                 events=events, call_site=call_site)

    for name in names:
        check = CHECKS[name]
        if name == "page_conservation":
            check(fail, alloc, cache, exempt=exempt)
        else:
            check(fail, alloc, cache)


def verify_state(alloc, cache=None,
                 extra: Optional[Dict[str, Any]] = None,
                 events: Optional[List[dict]] = None) -> None:
    """Run every allocator/trie invariant; raise :class:`InvariantViolation`
    on the first failure.  ``cache`` defaults to ``alloc.cache``.

    Engine-free entry point: the hypothesis property suite calls this
    after every random lifecycle op; :class:`KVSanitizer` wraps it with
    engine/scheduler context.
    """
    if cache is None:
        cache = alloc.cache
    verify_subset(alloc, cache, CHECKS, extra=extra, events=events)


# ------------------------------------------------------------ sanitizer ----
class KVSanitizer:
    """Engine-attached runtime sanitizer (``ServeConfig.sanitize_level``).

    The engine calls :meth:`after_step` at the end of every ``step()``;
    the scheduler reports each admission's charged page budget
    (:meth:`note_admit`) and the engine reports prefill completion
    (:meth:`note_first_token`), closing the loop on scheduler budget
    honesty.  All checks are read-only: token streams are bit-identical
    across sanitize levels.
    """

    def __init__(self, engine):
        self.eng = engine
        self.level = engine.serve.sanitize_level
        if self.level not in SANITIZE_LEVELS:     # engine built around config
            raise ValueError(f"unknown sanitize_level {self.level!r}; "
                             f"supported: {', '.join(SANITIZE_LEVELS)}")
        # rid -> (pages charged at admission, progress-override flag)
        self._budgets: Dict[int, Tuple[int, bool]] = {}
        # rid -> promise snapshot taken at preemption (differential checker)
        self._preempt_snaps: Dict[int, Dict[str, Any]] = {}
        self.n_checks = 0     # full-state validations performed (overhead/bench)
        self.call_hooks = None
        if self.level == "call":
            from repro_torch.analysis.hooks import install_call_hooks  # lazy: avoid cycle
            self.call_hooks = install_call_hooks(
                engine.alloc, engine.prefix_cache,
                context_fn=lambda: (self._engine_state(), self._events_tail()))

    @property
    def n_call_checks(self) -> int:
        """Invariant-subset checks run by call-site hooks (0 below ``call``)."""
        return 0 if self.call_hooks is None else self.call_hooks.n_call_checks

    # --- scheduler hooks ---------------------------------------------------
    def note_admit(self, rid: int, pages: int, override: bool) -> None:
        """An admission round charged ``pages`` against the watermark
        budget for ``rid`` (``override``: the bare-fit progress override
        fired, so the charge deliberately ignores headroom and transient
        COW capacity — exempt from the budget check)."""
        self._budgets[rid] = (pages, override)

    def note_chunk(self, rid: int, pages: int) -> None:
        """Chunked mode scheduled another planner chunk of ``rid``'s
        prefill, pre-committing ``pages`` more from the free pool
        (admission charged only the cached prefix plus one chunk; the
        budget grows chunk by chunk as the planner schedules the rest,
        and :meth:`note_first_token` still bounds what the whole prefill
        actually consumed)."""
        if rid in self._budgets:
            need, override = self._budgets[rid]
            self._budgets[rid] = (need + pages, override)

    def note_plan(self, plan, remaining, n_decode_tokens: int) -> None:
        """Chunked mode produced ``plan`` for a round with per-stream
        ``remaining`` prefill tokens and ``n_decode_tokens`` runnable
        decodes; fail loudly if it breaks the packing contract (prefill
        over the budget decodes leave, a stream carved past its
        remainder, decodes dropped, or budget wasted while work
        remains)."""
        # lazy: keep the analysis layer importable without core modules
        from repro_torch.core.planner import validate_plan
        try:
            validate_plan(plan, remaining, n_decode_tokens)
        except ValueError as e:
            self._fail("chunk_plan", str(e))

    def note_preempt(self, req, committed: int) -> None:
        """``req`` is being preempted with ``committed`` tokens of useful
        work; its next admission re-budgets from scratch.

        Called by the scheduler *after* ``cache_insert`` registered the
        victim's committed pages but *before* ``alloc.free`` drops its
        references — the exact instant ``resume_safe_pages`` prices.  We
        snapshot the promise: the committed full-page chain, restricted
        to pages some *other* live request keeps referenced once the
        victim's own references are gone (those survive eviction; the
        rest park reclaimable and may be stripped under pressure).
        :meth:`note_resume` settles the promise at re-admission.
        """
        self._budgets.pop(req.rid, None)
        cache = self.eng.prefix_cache
        if cache is None:
            return
        alloc = self.eng.alloc
        toks = (req.prompt + req.out_tokens)[:committed]
        chain = cache.match(toks)
        owned = set(alloc.owned(req.rid))
        promised = [p for p in chain
                    if alloc.ref_count(p) >= (2 if p in owned else 1)]
        if promised:
            self._preempt_snaps[req.rid] = {
                "committed": committed,
                "chain": list(chain),
                "promised": promised,
                # refs surviving after the victim's own free
                "refs": {p: alloc.ref_count(p) - (1 if p in owned else 0)
                         for p in promised},
                "step": self.eng.metrics.n_steps,
            }

    def note_resume(self, req, mapped_pages: List[int]) -> None:
        """A previously-preempted ``req`` was re-admitted and its prefix
        re-matched ``mapped_pages``.  Settle the preemption promise:
        every promised page still in the trie must have been remapped
        (same page id, now owned by the request, still referenced).
        Pages evicted since the preempt are excused — leaf-first reclaim
        and whole-subtree blocked eviction keep chains gap-free, so a
        still-cached promised page is always reachable by the matcher.
        """
        snap = self._preempt_snaps.pop(req.rid, None)
        if snap is None:
            return
        cache = self.eng.prefix_cache
        alloc = self.eng.alloc
        mapped = set(mapped_pages)
        owned = set(alloc.owned(req.rid))
        for p in snap["promised"]:
            if cache is None or not cache.is_cached(p):
                continue          # evicted under pressure: promise lapsed
            if p not in mapped:
                self._fail(
                    "preempt_resume",
                    f"resume of request {req.rid} recomputed promised page "
                    f"{p}: at preemption (step {snap['step']}, "
                    f"{snap['committed']} committed tokens) it survived with "
                    f"{snap['refs'][p]} external reference(s) and it is "
                    f"still cached now, but the resume's prefix match "
                    f"returned {sorted(mapped)} — resume_safe_pages promised "
                    "a remap that prefix matching failed to deliver")
            if p not in owned:
                self._fail(
                    "preempt_resume",
                    f"resume of request {req.rid} matched promised page {p} "
                    "but the request does not own it — the remap never "
                    "acquired a reference")
            if alloc.ref_count(p) < 1:
                self._fail(
                    "preempt_resume",
                    f"promised page {p} remapped by request {req.rid} has "
                    f"refcount {alloc.ref_count(p)}")

    # --- engine hooks ------------------------------------------------------
    def note_first_token(self, rid: int) -> None:
        """Prefill complete: everything the request took from the free
        pool since admission (fresh allocations, reclaimable revivals,
        COW copies) must fit the pages its admission charged."""
        budget = self._budgets.pop(rid, None)
        if budget is None:
            return
        need, override = budget
        if override:
            return
        consumed = self.eng.alloc.consumed(rid)
        if consumed > need:
            self._fail("scheduler_budget",
                       f"request {rid} consumed {consumed} pages from the "
                       f"free pool during its prefill but admission charged "
                       f"only {need}: the watermark budget under-reserved "
                       "(misses, reclaimable revivals, or COW copies were "
                       "not counted)")

    def after_step(self, finished: bool) -> None:
        """End-of-step gate: full validation at ``step``/``call`` levels
        always, at ``finish`` level only when this step finished a
        request.  (``call`` additionally checks inside the step, at each
        mutating allocator/cache call — see ``analysis/hooks.py``.)"""
        if self.level in ("step", "call") or (self.level == "finish" and finished):
            self.check_now()

    # --- validation --------------------------------------------------------
    def _events_tail(self) -> List[dict]:
        return list(self.eng.metrics.sched_events[-_EVENT_TAIL:])

    def _engine_state(self) -> Dict[str, Any]:
        eng = self.eng
        return {"engine": {
            "mode": eng.serve.mode,
            "step": eng.metrics.n_steps,
            "slots": {str(i): {"rid": s.req.rid, "seq_len": s.seq_len}
                      for i, s in enumerate(eng.slots) if s is not None},
            "streams": {str(i): {"rid": s.req.rid, "pos": s.pos,
                                 "len": len(s.tokens)}
                        for i, s in enumerate(eng.streams) if s is not None},
            "waiting": [r.rid for r in eng.sched.waiting],
            "budgets": {str(r): list(b) for r, b in self._budgets.items()},
        }}

    def _fail(self, invariant: str, message: str) -> None:
        raise InvariantViolation(
            invariant, message,
            state=_state(self.eng.alloc, self.eng.prefix_cache,
                         self._engine_state()),
            events=self._events_tail())

    def _check_scale_sidecar(self) -> None:
        """``kv_dtype="int8"``: the quant sidecar mirror is honest."""
        eng = self.eng
        quant = eng.kv_quant
        alloc = eng.alloc
        cache = eng.prefix_cache
        free = set(alloc._free)
        for page, count in quant.entries.items():
            if count != 1:
                self._fail("scale_sidecar",
                           f"page {page} holds {count} scale entries; a "
                           "quantized page carries exactly one per "
                           "(token, head) plane")
            if page == alloc.trash_page:
                self._fail("scale_sidecar",
                           f"trash page {page} holds a scale entry; inactive "
                           "rows scatter garbage there and nothing may read "
                           "it back as valid quantized KV")
            if page in free:
                self._fail("scale_sidecar",
                           f"page {page} sits on the free list but still "
                           "holds a scale entry: the next owner would "
                           "dequantize with a stale scale")
            if page not in alloc._ref and \
                    (cache is None or not cache.is_cached(page)):
                self._fail("scale_sidecar",
                           f"scale entry leaked: page {page} is neither "
                           "live-referenced nor cached")
        for kind, cont in (("slot", eng.slots), ("stream", eng.streams)):
            for i, s in enumerate(cont):
                if s is None:
                    continue
                committed = s.seq_len if kind == "slot" else s.pos
                owned = alloc.owned(s.req.rid)
                for p in owned[: alloc.pages_needed(committed)]:
                    if p not in quant.entries:
                        self._fail(
                            "scale_sidecar",
                            f"{kind}[{i}] (rid {s.req.rid}) committed page "
                            f"{p} has no scale entry: its int8 codes cannot "
                            "be dequantized")
        if cache is not None:
            for page in cache._by_page:
                if page not in quant.entries:
                    self._fail("scale_sidecar",
                               f"cached trie page {page} has no scale entry: "
                               "a future hit would remap undequantizable KV")
        # byte conservation: device pool == allocator sizing == metrics
        pool = sum(t.numel() * t.element_size()
                   for pages in (eng.k_pages, eng.v_pages)
                   for t in (pages.values() if isinstance(pages, dict)
                             else (pages,)))
        expect = alloc.n_pages * alloc.page_bytes
        if pool != expect or eng.metrics.kv_pool_bytes != expect:
            self._fail("scale_sidecar",
                       f"pool bytes do not conserve: device arrays hold "
                       f"{pool}, allocator sizing says {alloc.n_pages} pages "
                       f"x {alloc.page_bytes} B = {expect}, metrics report "
                       f"{eng.metrics.kv_pool_bytes}")

    def check_now(self) -> None:
        """Run the full cross-module contract against live engine state."""
        eng = self.eng
        self.n_checks += 1
        verify_state(eng.alloc, eng.prefix_cache,
                     extra=self._engine_state(), events=self._events_tail())
        if getattr(eng, "kv_quant", None) is not None:
            self._check_scale_sidecar()
        active: Dict[int, str] = {}
        for kind, cont in (("slot", eng.slots), ("stream", eng.streams)):
            for i, s in enumerate(cont):
                if s is None:
                    continue
                rid = s.req.rid
                where = f"{kind}[{i}]"
                if rid in active:
                    self._fail("request_identity",
                               f"request {rid} is active in both "
                               f"{active[rid]} and {where}")
                active[rid] = where
                committed = s.seq_len if kind == "slot" else s.pos
                owned = eng.alloc.owned(rid)
                need = eng.alloc.pages_needed(committed)
                if len(owned) < need:
                    self._fail("page_coverage",
                               f"{where} (rid {rid}) has {committed} "
                               f"committed tokens needing {need} pages but "
                               f"owns only {len(owned)}")
                if len(owned) > eng.serve.max_pages_per_seq:
                    self._fail("page_coverage",
                               f"{where} (rid {rid}) owns {len(owned)} pages, "
                               f"over max_pages_per_seq="
                               f"{eng.serve.max_pages_per_seq}")
                if kind == "slot":
                    row = [int(p) for p in eng.block_tables[i, :len(owned)]]
                    if row != list(owned):
                        self._fail("block_table",
                                   f"slot {i} (rid {rid}) block-table row "
                                   f"{row} diverged from its allocator "
                                   f"page table {list(owned)}")
        seen_waiting = set()
        for r in eng.sched.waiting:
            if r.rid in active:
                self._fail("request_identity",
                           f"request {r.rid} is simultaneously waiting and "
                           f"active in {active[r.rid]}")
            if r.rid in seen_waiting:
                self._fail("request_identity",
                           f"request {r.rid} queued twice")
            seen_waiting.add(r.rid)
        if eng.serve.admission_policy == "deadline" and any(
                t.quota_tokens is not None for t in eng.serve.tenants):
            self._check_tenant_quota()

    def _check_tenant_quota(self) -> None:
        """``admission_policy="deadline"`` + quota'd tiers: admission's
        quota promise holds against live engine state — each quota'd
        tenant's active footprint (prompt + full generation grant per
        request, ``core/slo.py``) stays within ``quota_tokens``, except
        for the documented single-oversized case (one request bigger
        than its tenant's whole quota admits on an idle tenant; the
        ``holds`` progress rule, so quotas bound concurrency without
        wedging a tenant)."""
        from repro_torch.core.slo import request_footprint
        eng = self.eng
        held: Dict[str, list] = {}
        seen = set()
        for cont in (eng.slots, eng.streams):
            for s in cont:
                if s is None or s.req.rid in seen:
                    continue
                seen.add(s.req.rid)
                held.setdefault(eng.effective_slo(s.req).tenant, []).append(
                    request_footprint(s.req))
        for tier in eng.serve.tenants:
            if tier.quota_tokens is None:
                continue
            fps = held.get(tier.name, [])
            if sum(fps) > tier.quota_tokens and len(fps) > 1:
                self._fail(
                    "tenant_quota",
                    f"tenant {tier.name!r} holds {sum(fps)} in-flight "
                    f"footprint tokens across {len(fps)} requests, over its "
                    f"quota of {tier.quota_tokens}: deadline admission must "
                    "queue the burst behind the quota (only a single "
                    "oversized request may exceed it)")
