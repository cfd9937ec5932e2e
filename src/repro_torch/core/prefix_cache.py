"""Shared-prefix KV cache: a hash-trie of pages with token-level reuse.

The paper's binding constraint is the KV-cache page pool (Figs. 5/14/15);
this module stretches it by turning byte-identical token prefixes —
shared system prompts, few-shot templates, and the ``prompt +
out_tokens`` replay of a preemption resume — into *shared* refcounted
pages instead of recomputed private copies.

Structure
    A trie over pages: each node is keyed by
    ``(parent_node_id, page_token_tuple)`` and records the pool page
    holding the KV for exactly those tokens at those absolute positions.
    Chaining from the root makes position alignment inherent (a page's
    KV embeds its rope positions), and using the parent's node id — not
    a hash of its tokens — makes lookups exact: no collision can map a
    request onto the wrong KV.  Every node also keeps explicit child
    links (``children``), so subtree walks (blocked-reclaimable
    eviction, partial-match scans) never scan the whole table.

Granularity
    Full-page nodes (``n_valid == page_size``) chain; **partial** nodes
    (``n_valid < page_size``) are always leaves: they record the valid
    token count of a page whose tail was never filled (a finished or
    preempted request's last page).  ``match`` walks full pages only;
    ``match_tokens`` additionally scans the divergence point's children
    for the longest token-level overlap, so two prompts that diverge
    *inside* a page still share everything before the divergence — the
    engine copies that page (copy-on-write) and recomputes zero matched
    tokens.

Lifecycle (driven by :class:`~repro_torch.core.kv_cache.PageAllocator`)
    * ``insert`` registers a request's committed full pages after a
      prefill chunk lands, and again at finish/preemption (so a resumed
      victim re-hits its own just-freed pages); terminal inserts may
      register the partial tail page too (``allow_partial``).
    * ``match``/``match_tokens`` return the longest cached prefix for a
      token list; the allocator then ``share``s the full-page hits
      (refcount += 1) and ``cow_partial``s the partial one.
    * When a page's refcount drops to zero it is *not* returned to the
      free list: it parks here as **reclaimable**, still serving future
      hits.  Under pressure the allocator strips reclaimable pages
      (leaf-first, per the eviction policy) *before* the scheduler
      resorts to preempting live requests.

A request's cached span is capped below its full prefill length (at
least one token is always recomputed so the engine has last-token logits
to sample from), and partial hits are materialized as private copies.
Writes therefore never land in shared pages on today's engine paths;
the allocator's copy-on-write (``prepare_write``) is the safety net that
keeps that an invariant rather than an assumption.

Which reclaimable leaf is stripped first is an
:class:`~repro_torch.core.policies.EvictionPolicy` decision (lru / fifo /
cost); the trie only supplies the mechanism — leaf enumeration and the
``page_cost`` recompute-FLOPs proxy the cost model ranks by.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.policies import EVICTION_POLICIES, EvictionPolicy, make_eviction

# legacy alias (pre-policy-layer name); new code should key off
# policies.EVICTION_POLICIES, which adds "cost"
PREFIX_CACHE_POLICIES = tuple(sorted(EVICTION_POLICIES))

_ROOT = 0          # parent id of first-page nodes


def _overlap(a, b) -> int:
    """Length of the common prefix of two token sequences."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class _Node:
    __slots__ = ("nid", "key", "page", "parent", "children",
                 "last_used", "reclaimable", "depth", "n_desc")

    def __init__(self, nid: int, key, page: int, parent: Optional["_Node"]):
        self.nid = nid
        self.key = key                  # (parent_nid, page_token_tuple)
        self.page = page
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}   # chunk tuple -> node
        self.last_used = 0
        self.reclaimable = False
        self.depth = 0 if parent is None else parent.depth + 1
        self.n_desc = 0                 # cached nodes anywhere below this one

    @property
    def n_valid(self) -> int:
        """Valid tokens in the page; < page_size marks a partial leaf."""
        return len(self.key[1])

    @property
    def n_children(self) -> int:
        return len(self.children)


class PrefixCache:
    """Prefix trie of full-page chains plus partial-leaf tails, with a
    reclaimable (zero-ref) pool."""

    def __init__(self, page_size: int, policy="lru"):
        if isinstance(policy, EvictionPolicy):
            self.default_policy = policy
        else:
            try:
                self.default_policy = make_eviction(policy)
            except ValueError:
                raise ValueError(
                    f"unknown prefix_cache_policy {policy!r}; expected one "
                    f"of {', '.join(sorted(EVICTION_POLICIES))}") from None
        self.page_size = page_size
        self.policy = self.default_policy.name
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], _Node] = {}
        self._roots: Dict[Tuple[int, ...], _Node] = {}  # depth-0 child links
        self._by_page: Dict[int, _Node] = {}
        self._reclaimable: Dict[int, _Node] = {}    # page -> node, ref == 0
        # pages evicted from the trie by the blocked-subtree fallback while
        # still mapped by live requests: they may legitimately stay
        # multi-referenced without being cached (the sanitizer's COW-
        # exclusivity check exempts them); cleared when the owners release
        # the page or a finish re-registers it
        self.orphaned_shared: set = set()
        self._tick = 0
        self._next_nid = _ROOT + 1
        self.n_evicted = 0   # reclaimed/evicted nodes (engine stats)
        self.last_evict_cost = 0.0   # page_cost of the latest pop (trace)

    # ------------------------------------------------------------ lookup ---
    def _chunks(self, tokens: List[int]):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(tokens[i * ps: (i + 1) * ps])

    def _children_of(self, node: Optional[_Node]) -> Dict[tuple, _Node]:
        return self._roots if node is None else node.children

    def _walk(self, tokens: List[int]) -> Tuple[List[int], Optional[_Node]]:
        """Full-page chain walk: hit pages plus the divergence node."""
        pages: List[int] = []
        node: Optional[_Node] = None
        for chunk in self._chunks(tokens):
            nxt = self._children_of(node).get(chunk)
            if nxt is None:
                break
            pages.append(nxt.page)
            node = nxt
        return pages, node

    def match(self, tokens: List[int]) -> List[int]:
        """Pages holding the longest cached full-page prefix of ``tokens``.

        Pure lookup — no refcounts or LRU state change (callers map the
        pages through ``PageAllocator.share`` and then :meth:`touch`).
        Page-granular callers (admission probes in "page" mode,
        ``resume_safe_pages``) use this; it skips ``match_tokens``'s
        divergence-point overlap scan entirely.
        """
        return self._walk(tokens)[0]

    def match_tokens(self, tokens: List[int]
                     ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens`` at token granularity.

        Returns ``(pages, partial)``: the full-page chain, plus — when
        the match ends *inside* a page — ``(page, n_matched)`` for the
        cached child sharing the longest strict token prefix with the
        remainder (ties broken most-recently-used, then newest).  The
        partial page cannot be shared in place (its tail belongs to the
        donor); callers copy it via ``PageAllocator.cow_partial``.
        """
        pages, node = self._walk(tokens)
        rest = tokens[len(pages) * self.page_size:]
        best: Optional[Tuple[int, int]] = None
        best_rank = None
        for child in self._children_of(node).values():
            t = _overlap(rest, child.key[1])
            if t <= 0:
                continue
            rank = (t, child.last_used, child.nid)
            if best_rank is None or rank > best_rank:
                best, best_rank = (child.page, t), rank
        return pages, best

    def touch(self, pages: List[int]) -> None:
        """LRU-bump the nodes behind freshly mapped hit pages."""
        self._tick += 1
        for p in pages:
            node = self._by_page.get(p)
            if node is not None:
                node.last_used = self._tick

    # ------------------------------------------------------------ insert ---
    def insert(self, tokens: List[int], pages: List[int],
               allow_partial: bool = False) -> int:
        """Register ``pages`` as holding the KV of ``tokens``.

        By default full pages only (``len(tokens) == len(pages) *
        page_size``; callers trim the partial tail).  With
        ``allow_partial`` a trailing remainder registers the last page
        as a *partial leaf* (``n_valid < page_size``) — only safe at
        terminal points (finish/preemption) where nothing will write
        into that page again.  Existing nodes win — a duplicate prefix
        computed privately by a concurrent request is simply not
        registered (its pages free normally).  Returns the number of
        newly cached pages.
        """
        ps = self.page_size
        n_full, rem = divmod(len(tokens), ps)
        if allow_partial:
            if len(pages) != n_full + (1 if rem else 0):
                raise ValueError(
                    f"insert(allow_partial): {len(tokens)} tokens at "
                    f"page_size {ps} need {n_full + (1 if rem else 0)} "
                    f"pages, got {len(pages)}")
        elif rem != 0 or len(pages) != n_full:
            raise ValueError(
                f"insert: expected whole pages ({len(tokens)} tokens at "
                f"page_size {ps} -> {n_full} full pages, remainder {rem}), "
                f"got {len(pages)} pages; trim the partial tail or pass "
                "allow_partial=True at a terminal point")
        self._tick += 1
        new = 0
        parent: Optional[_Node] = None
        complete = True
        for i, chunk in enumerate(self._chunks(tokens)):
            node = self._children_of(parent).get(chunk)
            if node is None:
                node = self._make_node(chunk, pages[i], parent)
                if node is None:
                    complete = False
                    break       # stale page alias: never double-register
                new += 1
            node.last_used = self._tick
            parent = node
        if rem and complete:
            chunk = tuple(tokens[n_full * ps:])
            node = self._children_of(parent).get(chunk)
            if node is None:
                node = self._make_node(chunk, pages[-1], parent)
                if node is not None:
                    new += 1
            if node is not None:
                node.last_used = self._tick
        return new

    def _make_node(self, chunk: tuple, page: int,
                   parent: Optional[_Node]) -> Optional[_Node]:
        """Create and link one node; None when ``page`` already caches
        other content (stale alias from a racing insert)."""
        if page in self._by_page:
            return None
        parent_id = _ROOT if parent is None else parent.nid
        node = _Node(self._next_nid, (parent_id, chunk), page, parent)
        self._next_nid += 1
        self._nodes[node.key] = node
        self._by_page[page] = node
        self.orphaned_shared.discard(page)   # cached again: contract restored
        self._children_of(parent)[chunk] = node
        if parent is not None:
            anc = parent
            while anc is not None:       # descendant accounting
                anc.n_desc += 1
                anc = anc.parent
        return node

    # --------------------------------------------------- reclaimable pool --
    def is_cached(self, page: int) -> bool:
        return page in self._by_page

    @property
    def n_cached_pages(self) -> int:
        return len(self._by_page)

    @property
    def n_reclaimable(self) -> int:
        return len(self._reclaimable)

    def on_release(self, page: int) -> None:
        """Called by the allocator when a cached page's refcount hits 0:
        park it as reclaimable instead of returning it to the free list."""
        node = self._by_page[page]
        node.reclaimable = True
        self._reclaimable[page] = node

    def on_revive(self, page: int) -> None:
        """A reclaimable page was re-shared (refcount 0 -> 1)."""
        node = self._reclaimable.pop(page)
        node.reclaimable = False

    def page_cost(self, page: int) -> float:
        """Recompute-FLOPs-saved proxy for a cached page (dimensionless,
        model-free): rebuilding the page's ``n_valid`` tokens replays
        the per-token linear work plus attention over everything before
        them, so cost grows with depth — a deep chain page is expensive
        to lose, a shallow long-tail leaf is nearly free.  Pages anchoring
        cached subtrees are weighted by their descendant count (evicting
        them would orphan the whole chain below; relevant to policies
        comparing non-leaf pages — for the leaf-first strip the factor
        is 1).  A partial leaf holds fewer valid tokens than a full page,
        so it is proportionally cheaper to lose.
        """
        node = self._by_page[page]
        nv = node.n_valid
        end = node.depth * self.page_size + nv   # context length at page end
        return (1 + node.n_desc) * nv * (nv + end)

    def pop_reclaimable(self, policy: Optional[EvictionPolicy] = None
                        ) -> Optional[int]:
        """Evict the policy's lowest-ranked zero-ref *leaf* (no cached
        children) and return its page to the caller.  Leaf-first keeps
        every remaining chain intact; since a referenced child implies a
        referenced parent (requests map whole prefix chains), every
        reclaimable page is eventually poppable this way.
        """
        policy = policy or self.default_policy
        best: Optional[_Node] = None
        best_rank = None
        for node in self._reclaimable.values():
            if node.children:
                continue
            r = policy.rank(node, self)
            if best is None or r < best_rank:
                best, best_rank = node, r
        if best is None and self._reclaimable:
            best = self._pop_blocked(policy)
        if best is None:
            return None
        self.last_evict_cost = self.page_cost(best.page)
        self._evict(best)
        return best.page

    def _pop_blocked(self, policy: EvictionPolicy) -> Optional[_Node]:
        """Rare fallback: every reclaimable page sits above *referenced*
        descendants, so no leaf is strippable.  (Engine paths never get
        here — they only write at the sequence tail — but an interior
        ``prepare_write`` COW releases a mid-chain page while its chain
        stays mapped.)  ``n_free`` counts every reclaimable page, so the
        capacity promise must be kept: take the best-ranked reclaimable
        with no reclaimable below it and evict its whole (all-referenced)
        subtree from the trie — descendant pages stay owned by their
        requests, they just stop being cached, and return to the free
        list when their owners release them."""
        blocked = set()
        for node in self._reclaimable.values():
            anc = node.parent
            while anc is not None:
                if anc.reclaimable:
                    blocked.add(anc.nid)
                anc = anc.parent
        best: Optional[_Node] = None
        best_rank = None
        for node in self._reclaimable.values():
            if node.nid in blocked:
                continue
            r = policy.rank(node, self)
            if best is None or r < best_rank:
                best, best_rank = node, r
        if best is None:        # unreachable: the deepest reclaimable in
            return None         # any chain is never blocked
        doomed = []             # subtree via explicit child links — no
        stack = list(best.children.values())        # O(nodes) table scan
        while stack:
            node = stack.pop()
            doomed.append(node)
            stack.extend(node.children.values())
        for node in sorted(doomed, key=lambda n: -n.depth):
            self._evict(node)   # leaf-upward keeps child counts consistent
            self.orphaned_shared.add(node.page)  # still owned, no longer cached
        return best             # now a leaf; caller evicts and returns it

    def _evict(self, node: _Node) -> None:
        del self._nodes[node.key]
        del self._by_page[node.page]
        self._reclaimable.pop(node.page, None)
        del self._children_of(node.parent)[node.key[1]]
        if node.parent is not None:
            anc = node.parent
            while anc is not None:
                anc.n_desc -= 1
                anc = anc.parent
        self.n_evicted += 1
