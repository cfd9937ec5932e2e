"""Host-side paged KV-cache bookkeeping.

The device-side page pool is a plain array [L, N, ps, KV_p, hd] owned by
the engine; this module owns the allocator + per-request block tables —
the paper's "mapping between the inference request ... and the generated
KV-cache file" (§II-G), solved with block tables instead of files.

Pages are **refcounted**: with a :class:`~repro_torch.core.prefix_cache.PrefixCache`
attached, byte-identical prefixes across requests map to the *same*
pages (``share``), a cached page whose refcount drops to zero parks on
the cache's reclaimable list instead of the free list (still serving
future hits, stripped leaf-first under pressure before the scheduler
preempts anyone), ``prepare_write`` copy-on-writes a shared or cached
page before a token write would mutate it, and ``cow_partial`` turns a
token-level (partial-page) cache hit into a private copy of the donor
page so the matched span is reused without recomputation.

Page N-1 is reserved as the trash page (inactive batch slots scatter
there); it is never allocated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.prefix_cache import PrefixCache


class OutOfPages(Exception):
    pass


def pool_pages_from_bytes(budget_bytes: int, page_bytes: int) -> int:
    """Byte-denominated pool sizing: pages (incl. the reserved trash
    page) a device-byte budget buys at ``page_bytes`` per page.  This is
    what makes ``kv_dtype="int8"`` a capacity lever: the same budget over
    smaller pages yields proportionally more of them.
    """
    if page_bytes <= 0:
        raise ValueError(f"page_bytes must be positive, got {page_bytes}")
    n = budget_bytes // page_bytes
    if n < 2:
        raise ValueError(
            f"kv_pool_bytes={budget_bytes} buys {n} page(s) of "
            f"{page_bytes} bytes; the pool needs >= 2 (one is the "
            "reserved trash page) — raise the budget or shrink page_size")
    return n


class KVQuantSidecar:
    """Host-side model of the int8 scale sidecar.

    Every device page written with quantized KV carries exactly one scale
    entry per (token, head) plane; this mirror tracks *which pages* hold
    live quantized contents so the sanitizer can check the sidecar
    invariant (``scale_sidecar``): entry count is exactly 1 for every
    written live/cached page, no entry survives a page's return to the
    free list, and pool bytes conserve (codes + scales = page_bytes *
    n_pages).  Maintained by the engine at every commit/COW site and from
    allocator ``cow`` / ``reclaim`` / ``page_free`` events.
    """

    def __init__(self) -> None:
        self.entries: Dict[int, int] = {}   # page -> scale-entry count
        self.n_quant_pages = 0              # cumulative fresh quantized pages

    def note_write(self, pages) -> None:
        """Pages just committed with quantized KV (idempotent: decode
        re-writes the tail page every token without re-registering)."""
        for p in pages:
            if p not in self.entries:
                self.n_quant_pages += 1
                self.entries[p] = 1

    def note_copy(self, src: int, dst: int) -> None:
        """A COW device copy carried ``src``'s codes+scales to ``dst``."""
        if src in self.entries:
            if dst not in self.entries:
                self.n_quant_pages += 1
            self.entries[dst] = self.entries[src]

    def drop(self, page: int) -> None:
        """``page`` returned to the free list; its sidecar entry dies
        with it (the next owner re-quantizes from scratch)."""
        self.entries.pop(page, None)


@dataclass
class PageAllocator:
    n_pages: int
    page_size: int
    cache: Optional[PrefixCache] = None
    # scheduler-trace hook: called as event_cb(event, **detail) on
    # reclaim/cow/page_free
    event_cb: Optional[Callable] = None
    # device bytes one page costs (codes + any scale sidecar, K+V, all
    # layers); 0 = unsized (legacy direct construction).  Set by the
    # engine from kernels.kv_int8.kv_page_bytes so pool capacity is
    # byte-denominated and the sanitizer can check byte conservation.
    page_bytes: int = 0
    _free: List[int] = field(default_factory=list)
    _owned: Dict[int, List[int]] = field(default_factory=dict)  # rid -> pages
    _ref: Dict[int, int] = field(default_factory=dict)          # page -> refs
    # rid -> free-pool capacity consumed since its last begin_admission():
    # fresh allocs + reclaimable revives + COW copies.  The sanitizer checks
    # this against the pages the scheduler charged at admission.
    _consumed: Dict[int, int] = field(default_factory=dict)
    n_reclaims: int = 0      # cached pages stripped back into the free list
    n_cow: int = 0           # copy-on-write page splits
    n_shared_maps: int = 0   # cache-hit pages mapped via share()
    n_partial_cow: int = 0   # token-level (partial-page) hit copies

    def __post_init__(self):
        # last page reserved as trash
        self._free = list(range(self.n_pages - 2, -1, -1))

    @property
    def trash_page(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        """Pages allocatable right now: the free list plus the cache's
        reclaimable pool (zero-ref cached pages are stripped on demand)."""
        return len(self._free) + (self.cache.n_reclaimable if self.cache else 0)

    @property
    def n_allocated(self) -> int:
        return (self.n_pages - 1) - self.n_free

    @property
    def n_pages_shared(self) -> int:
        """Pages currently mapped by more than one request."""
        return sum(1 for c in self._ref.values() if c > 1)

    def usage(self) -> float:
        """KV-cache usage fraction (the paper's Fig. 5/14/15 metric).
        Reclaimable cached pages count as free: they are reusable capacity."""
        return self.n_allocated / (self.n_pages - 1)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def is_referenced(self, page: int) -> bool:
        """True when the page is mapped by at least one live request.
        (A reclaimable cache hit is NOT referenced: reviving it consumes
        free capacity, so admission must budget it like a fresh alloc.)"""
        return self._ref.get(page, 0) > 0

    def ref_count(self, page: int) -> int:
        """Live-request references on ``page`` (0 = unmapped/reclaimable)."""
        return self._ref.get(page, 0)

    def n_exclusive(self, rid: int) -> int:
        """Pages only ``rid`` references — the capacity that freeing it
        would actually return (shared pages merely decref)."""
        return sum(1 for p in self._owned.get(rid, ())
                   if self._ref.get(p, 0) == 1)

    def can_alloc(self, n: int) -> bool:
        return self.n_free >= n

    def begin_admission(self, rid: int) -> None:
        """Reset ``rid``'s consumed-capacity counter; the scheduler calls
        this at admission so the sanitizer can bound what the prefill
        actually takes from the free pool against the admission budget."""
        self._consumed[rid] = 0

    def consumed(self, rid: int) -> int:
        """Free-pool capacity ``rid`` consumed since its admission."""
        return self._consumed.get(rid, 0)

    def _consume(self, rid: int, n: int = 1) -> None:
        self._consumed[rid] = self._consumed.get(rid, 0) + n

    def _event(self, ev: str, **detail) -> None:
        if self.event_cb is not None:
            self.event_cb(ev, **detail)

    def _pop_free(self, rid: int) -> int:
        """Take one page, stripping the reclaimable cache pool if the free
        list is dry (this — not preemption — is the first pressure valve)."""
        if not self._free and self.cache is not None:
            # strip order = the cache's EvictionPolicy (built by the engine
            # from ServeConfig.resolved_eviction_policy)
            page = self.cache.pop_reclaimable()
            if page is not None:
                self.n_reclaims += 1
                self._event("reclaim", rid=rid, page=page,
                            cost=self.cache.last_evict_cost)
                self._free.append(page)
        if not self._free:
            raise OutOfPages(f"need 1, have {self.n_free}")
        return self._free.pop()

    def alloc(self, rid: int, n: int) -> List[int]:
        if self.n_free < n:
            raise OutOfPages(f"need {n}, have {self.n_free}")
        pages = [self._pop_free(rid) for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._owned.setdefault(rid, []).extend(pages)
        self._consume(rid, n)
        return pages

    def share(self, rid: int, pages: List[int]) -> None:
        """Map cache-hit ``pages`` into ``rid``'s table (refcount += 1),
        reviving any that were parked reclaimable.  Must be called before
        any further ``alloc`` so a hit can't be reclaimed out from under
        the request that just matched it."""
        for p in pages:
            refs = self._ref.get(p, 0)
            if refs == 0:
                if self.cache is None:
                    raise RuntimeError(
                        f"share() got unreferenced page {p} with no prefix "
                        "cache attached: only reclaimable cached pages can "
                        "be revived")
                self.cache.on_revive(p)
                self._consume(rid)   # a revive takes reclaimable capacity
            self._ref[p] = refs + 1
        self._owned.setdefault(rid, []).extend(pages)
        self.n_shared_maps += len(pages)

    def extend_to(self, rid: int, n_tokens: int) -> List[int]:
        """Ensure rid owns enough pages for n_tokens; returns new pages."""
        have = len(self._owned.get(rid, []))
        need = self.pages_needed(n_tokens) - have
        if need <= 0:
            return []
        return self.alloc(rid, need)

    def prepare_write(self, rid: int, pos: int, n_tokens: int = 1
                      ) -> List[Tuple[int, int]]:
        """Copy-on-write every owned page that tokens [pos, pos+n) will
        scatter into and that is shared (ref > 1) or cached: the writer
        gets a private copy, the original keeps serving its other
        readers / future cache hits.  Returns (src, dst) page pairs whose
        device contents the engine must copy before dispatching.

        On today's engine paths this never fires — cached spans are
        capped below the first written position — but it is what makes
        shared pages safe by construction rather than by convention.
        """
        pages = self._owned.get(rid, [])
        ps = self.page_size
        pairs: List[Tuple[int, int]] = []
        lo = pos // ps
        hi = min((pos + n_tokens - 1) // ps, len(pages) - 1)
        for idx in range(lo, hi + 1):
            p = pages[idx]
            if self._ref.get(p, 0) <= 1 and not \
                    (self.cache is not None and self.cache.is_cached(p)):
                continue
            new = self._pop_free(rid)
            self._ref[new] = 1
            pages[idx] = new
            self._release_one(p)
            pairs.append((p, new))
            self._consume(rid)
            self.n_cow += 1
            self._event("cow", rid=rid, src=p, dst=new)
        return pairs

    def cow_partial(self, rid: int, src: int) -> Tuple[int, int]:
        """Token-level prefix reuse: map a private copy of cached page
        ``src`` into ``rid``'s table as its next page.

        The donor page cannot be shared in place — the request's own
        suffix diverges inside it — so it is referenced first (a
        reclaimable donor is revived, protecting it from being stripped
        while the copy is prepared) and then routed through the standard
        ``prepare_write`` copy-on-write, which restores the donor's
        refcount (a zero-ref donor parks reclaimable again) and hands
        ``rid`` a private page.  Returns the ``(src, dst)`` pair whose
        device contents the engine must copy before prefilling the
        uncached remainder of the page.
        """
        self.share(rid, [src])
        idx = len(self._owned[rid]) - 1
        pairs = self.prepare_write(rid, idx * self.page_size, 1)
        if len(pairs) != 1 or pairs[0][0] != src:
            raise RuntimeError(
                f"cow_partial: expected exactly one copy-on-write pair for "
                f"donor page {src}, got {pairs}; the freshly shared donor "
                "must be the page prepare_write copies")
        self.n_partial_cow += 1
        return pairs[0]

    def owned(self, rid: int) -> List[int]:
        return self._owned.get(rid, [])

    def _release_one(self, page: int) -> bool:
        """Decref; returns True when the page actually left the request's
        hold on capacity (refcount hit zero)."""
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return False
        del self._ref[page]
        if self.cache is not None and self.cache.is_cached(page):
            self.cache.on_release(page)     # park reclaimable, not free
        else:
            self._free.append(page)
            if self.cache is not None:
                self.cache.orphaned_shared.discard(page)
            # int8 scale-sidecar upkeep: the entry dies with the page
            # (engine drops it; the event is NOT a scheduler-trace entry)
            self._event("page_free", page=page)
        return True

    def free(self, rid: int) -> int:
        """Release every page ``rid`` maps; returns how many actually
        became available (shared pages only decref — they stay with
        their other readers)."""
        pages = self._owned.pop(rid, [])
        self._consumed.pop(rid, None)
        return sum(self._release_one(p) for p in reversed(pages))
