"""Call-site invariant hooks: the ``sanitize_level="call"`` tier.

The step-boundary sanitizer (``invariants.KVSanitizer``) tells you a
step corrupted KV state; it cannot tell you *which call* did it — a
single splitwiser step can admit, reclaim, COW, share and free dozens of
pages.  This module wraps every mutating entry point on
:class:`~repro_torch.core.kv_cache.PageAllocator` and
:class:`~repro_torch.core.prefix_cache.PrefixCache` so the relevant invariant
subset runs immediately at the mutator's exit, and a violation is raised
attributed to the exact call site: method name, argument digest, request
id, and the scheduler event tail.

Per-mutator subsets (keys of ``invariants.CHECKS``): each hook runs only
the invariants that call can break, so the call tier stays affordable —
``alloc`` cannot corrupt trie structure, ``insert`` cannot double-free.

Reentrancy: the public mutators nest (``cow_partial`` calls ``share``
and ``prepare_write``; ``alloc`` drains ``pop_reclaimable`` through
``_pop_free``), and *mid*-compound state is legitimately inconsistent —
e.g. while ``alloc`` is popping its second page, the first sits in no
bucket.  A depth guard therefore runs checks only at the exit of the
outermost hooked call, which is also the call site a human wants the
violation attributed to.  Directly-invoked ``pop_reclaimable`` is the
one mutator whose *exit* state is legitimately non-conserving — the
returned page is in the caller's hands, in no bucket — so its check
exempts exactly that page.

Engine-free by design: ``install_call_hooks(alloc, cache)`` works on a
bare allocator/cache pair (the hypothesis property suite installs it on
its random-lifecycle machine); the engine's ``KVSanitizer`` passes a
``context_fn`` so violations carry engine state and sched events.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.invariants import verify_subset

# method -> invariant-subset run at its exit (keys of invariants.CHECKS)
ALLOCATOR_HOOKS: Dict[str, Tuple[str, ...]] = {
    "alloc": ("page_conservation", "refcount_honesty"),
    "free": ("page_conservation", "refcount_honesty", "trie_structure"),
    "share": ("page_conservation", "refcount_honesty", "cow_exclusivity"),
    "prepare_write": ("page_conservation", "refcount_honesty",
                      "cow_exclusivity"),
    "cow_partial": ("page_conservation", "refcount_honesty",
                    "cow_exclusivity", "trie_structure"),
}
CACHE_HOOKS: Dict[str, Tuple[str, ...]] = {
    "insert": ("trie_structure", "cow_exclusivity"),
    "pop_reclaimable": ("page_conservation", "trie_structure"),
    "_pop_blocked": ("trie_structure",),
}

# mutators whose first positional argument is a request id
_RID_FIRST = frozenset(
    {"alloc", "free", "share", "prepare_write", "cow_partial"})

_ARGS_DIGEST_CAP = 96


def _digest(args: tuple, kwargs: dict) -> str:
    """Human-readable argument digest, hash-suffixed when truncated."""
    text = ", ".join([repr(a) for a in args]
                     + [f"{k}={v!r}" for k, v in kwargs.items()])
    if len(text) > _ARGS_DIGEST_CAP:
        tag = hashlib.blake2s(text.encode()).hexdigest()[:8]
        text = f"{text[:_ARGS_DIGEST_CAP]}...#{tag}"
    return text


class CallHooks:
    """Installed hook set; hold on to it for counters and uninstall.

    Attributes
        n_call_checks   invariant-subset validations run at call sites
        calls           per-method invocation counts
    """

    def __init__(self, alloc, cache, *,
                 context_fn: Optional[Callable[[], Tuple[Optional[dict],
                                                         Optional[list]]]] = None):
        self.alloc = alloc
        self.cache = cache
        self.context_fn = context_fn
        self.n_call_checks = 0
        self.calls: Dict[str, int] = {}
        self._depth = 0
        self._wrapped: List[Tuple[Any, str]] = []
        for name, checks in ALLOCATOR_HOOKS.items():
            self._wrap(alloc, name, checks)
        if cache is not None:
            for name, checks in CACHE_HOOKS.items():
                self._wrap(cache, name, checks)

    # --- installation ------------------------------------------------------
    def _wrap(self, obj, name: str, checks: Tuple[str, ...]) -> None:
        orig = getattr(obj, name)

        def hooked(*args, __orig=orig, __name=name, __checks=checks, **kwargs):
            self._depth += 1
            try:
                result = __orig(*args, **kwargs)
            finally:
                self._depth -= 1
            if self._depth == 0:
                self._check(__name, __checks, args, kwargs, result)
            return result

        hooked.__wrapped__ = orig
        hooked.__name__ = name
        setattr(obj, name, hooked)      # instance attr shadows the class method
        self._wrapped.append((obj, name))

    def uninstall(self) -> None:
        """Restore the original (class-level) methods."""
        for obj, name in self._wrapped:
            if name in vars(obj):
                delattr(obj, name)
        self._wrapped.clear()

    # --- checking ----------------------------------------------------------
    def _check(self, name: str, checks: Tuple[str, ...],
               args: tuple, kwargs: dict, result) -> None:
        self.n_call_checks += 1
        self.calls[name] = self.calls.get(name, 0) + 1
        exempt = frozenset()
        if name == "pop_reclaimable" and isinstance(result, int):
            exempt = frozenset((result,))
        extra, events = (None, None)
        if self.context_fn is not None:
            extra, events = self.context_fn()
        call_site = {
            "method": name,
            "args": _digest(args, kwargs),
            "rid": (args[0] if name in _RID_FIRST and args else None),
            "n_call": self.calls[name],
        }
        verify_subset(self.alloc, self.cache, checks, exempt=exempt,
                      extra=extra, events=events, call_site=call_site)


def install_call_hooks(alloc, cache=None, *,
                       context_fn: Optional[Callable[[], Tuple[Optional[dict],
                                                               Optional[list]]]] = None
                       ) -> CallHooks:
    """Wrap the mutating entry points of ``alloc`` (and ``cache``,
    defaulting to ``alloc.cache``) with exit-time invariant checks.
    Returns the :class:`CallHooks` handle (counters + ``uninstall()``).
    """
    if cache is None:
        cache = alloc.cache
    return CallHooks(alloc, cache, context_fn=context_fn)
