"""Jit-dispatch sentinel: prove the serving hot path stays compiled-once.

Splitwiser's chunked scheduling only delivers flat compute intensity if
the jitted step callables (`_prefill`/`_commit`/`_decode`/`_mixed` and
the samplers) compile once per static shape and then dispatch from
cache.  A Python-level bug — a shape that varies per call, a static arg
rebuilt each step, a jit wrapper constructed inside the loop — silently
turns every step into an XLA compile, and wall-clock benchmarks are the
only thing that would notice.  This module makes recompilation a
first-class, checkable signal:

* :class:`DispatchSentinel` wraps jitted callables and counts
  compilations per callable.  The primary probe is the wrapped
  function's ``_cache_size()`` (jax's per-callable compile-cache entry
  count) sampled around each call; when the probe is unavailable (plain
  callables, older jax) it falls back to tracking distinct duck-typed
  argument signatures (shape/dtype for array-likes).
* A **storm guard** on step-loop callables raises
  :class:`InvariantViolation` (invariant ``"jit_dispatch"``) when
  compile density stays pathological — ≥ ``storm_threshold`` compiles in
  the last ``storm_window`` calls once the window has filled.  Callables
  with legitimate shape diversity (prefill batches vary with workload)
  are wrapped with ``storm_guard=False`` and only counted.
* :meth:`mark_warm` snapshots per-callable compile counts after warmup;
  :meth:`check` then fails when post-warmup recompiles exceed a budget
  (default 0: the hot path must be compiled-once).  CI tier-1 exports
  ``REPRO_DISPATCH_SENTINEL=1`` so an accidental recompile in the step
  loop fails the build; ``benchmarks/sanitizer_overhead.py`` reports the
  counts per sanitize level.

Stdlib-only imports: the sentinel wraps callables handed to it and never
imports jax itself, so ``repro.analysis`` stays importable in the
jax-less lint/CI contexts.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Optional

from repro_torch.analysis.invariants import InvariantViolation

STORM_WINDOW = 32      # calls in the rolling compile-density window
STORM_THRESHOLD = 16   # compiles within the window that constitute a storm


def _signature(x: Any) -> Any:
    """Duck-typed static signature: shape/dtype for array-likes, value
    identity for Python scalars, recursive over containers."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype))
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, _signature(v))
                                        for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(_signature(v) for v in x)
    return ("py", type(x).__name__, repr(x)[:32])


class CallableStats:
    """Per-wrapped-callable dispatch accounting."""

    __slots__ = ("name", "storm_guard", "n_calls", "n_compiles",
                 "warm_compiles", "recent", "signatures")

    def __init__(self, name: str, storm_guard: bool, window: int):
        self.name = name
        self.storm_guard = storm_guard
        self.n_calls = 0
        self.n_compiles = 0
        self.warm_compiles: Optional[int] = None
        self.recent: deque = deque(maxlen=window)
        self.signatures: set = set()

    @property
    def post_warm(self) -> int:
        if self.warm_compiles is None:
            return 0
        return self.n_compiles - self.warm_compiles


class DispatchSentinel:
    """Wrap jitted callables; count, budget, and storm-check compiles."""

    def __init__(self, *, storm_window: int = STORM_WINDOW,
                 storm_threshold: int = STORM_THRESHOLD):
        self.storm_window = storm_window
        self.storm_threshold = storm_threshold
        self.stats: Dict[str, CallableStats] = {}

    def wrap(self, name: str, fn: Callable, *,
             storm_guard: bool = True) -> Callable:
        """Return ``fn`` wrapped with compile counting under ``name``.

        ``storm_guard=False`` for callables with legitimate per-workload
        shape diversity (prefill/commit batches): counted, never raised
        on mid-run density — post-warmup budgeting still applies.
        """
        st = self.stats[name] = CallableStats(name, storm_guard,
                                              self.storm_window)
        probe = getattr(fn, "_cache_size", None)

        def sentineled(*args, **kwargs):
            st.n_calls += 1
            if callable(probe):
                before = probe()
                result = fn(*args, **kwargs)
                compiled = probe() > before
            else:
                sig = _signature((args, kwargs))
                compiled = sig not in st.signatures
                st.signatures.add(sig)
                result = fn(*args, **kwargs)
            if compiled:
                st.n_compiles += 1
            st.recent.append(compiled)
            if st.storm_guard and st.n_calls >= self.storm_window:
                dense = sum(st.recent)
                if dense >= self.storm_threshold:
                    raise InvariantViolation(
                        "jit_dispatch",
                        f"recompile storm on '{name}': {dense} compiles in "
                        f"the last {len(st.recent)} calls "
                        f"({st.n_compiles} total over {st.n_calls} calls) — "
                        "a Python-level static arg or shape is varying per "
                        "call, so every dispatch pays an XLA compile",
                        state={"dispatch": self.report()})
            return result

        sentineled.__wrapped__ = fn
        sentineled.__name__ = name
        return sentineled

    # --- warmup budgeting ----------------------------------------------------
    def mark_warm(self) -> None:
        """Snapshot compile counts: everything so far was warmup."""
        for st in self.stats.values():
            st.warm_compiles = st.n_compiles

    def post_warm_compiles(self) -> Dict[str, int]:
        """Per-callable compiles since :meth:`mark_warm` (0 before it)."""
        return {name: st.post_warm for name, st in self.stats.items()}

    def check(self, budget: int = 0) -> None:
        """Raise when any callable recompiled more than ``budget`` times
        after :meth:`mark_warm` — the compiled-once guarantee."""
        over = {name: n for name, n in self.post_warm_compiles().items()
                if n > budget}
        if over:
            raise InvariantViolation(
                "jit_dispatch",
                f"post-warmup recompiles exceed budget {budget}: {over} — "
                "the hot path is no longer compiled-once",
                state={"dispatch": self.report()})

    # --- reporting -----------------------------------------------------------
    @property
    def total_compiles(self) -> int:
        return sum(st.n_compiles for st in self.stats.values())

    def report(self) -> Dict[str, Dict[str, int]]:
        return {name: {"calls": st.n_calls, "compiles": st.n_compiles,
                       "post_warm": st.post_warm}
                for name, st in self.stats.items()}
