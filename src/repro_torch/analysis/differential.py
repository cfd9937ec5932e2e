"""Cross-mode differential harness: diff *allocator state*, not just
token streams.

The repo has always proven the three serving modes bit-identical on
token output; that is necessary but not sufficient — two modes can emit
the same tokens while leaving different KV state behind (a leaked page,
a chain inserted at the wrong granularity, a refcount that never
dropped), and the divergence only bites the *next* workload.  This
module fingerprints final allocator+cache state in a canonical,
page-id-independent form and diffs it across modes.

The fingerprint keys trie content by **token path**, not page id or node
id: page numbering depends on allocation order, which legitimately
differs across modes, but the set of cached token chains, their valid
lengths, their reclaimability, and their reference counts must agree on
any workload where scheduling pressure (eviction/preemption order) does
not itself diverge.  Tests assert an empty diff on ample-pool
shared-prefix workloads; under deliberate pressure the harness still
*reports* the drift so a human can judge it.

Stdlib-only: engine/request construction is injected via factories, so
this module imports no array framework.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Sequence

_SCALAR_KEYS = ("n_free", "n_reclaimable", "n_live", "n_owned_requests")


def state_fingerprint(alloc, cache=None) -> Dict[str, Any]:
    """Canonical snapshot of allocator+cache state.

    ``chains`` is a sorted list of ``(token_path, n_valid, reclaimable,
    refcount)`` per trie node, where ``token_path`` is the full token
    tuple from the root — identical across runs that cached the same
    content, whatever pages it landed on.
    """
    if cache is None:
        cache = alloc.cache
    chains: List[tuple] = []
    if cache is not None:
        for node in cache._nodes.values():
            parts = []
            n = node
            while n is not None:
                parts.append(n.key[1])
                n = n.parent
            path = tuple(t for chunk in reversed(parts) for t in chunk)
            chains.append((path, node.n_valid, node.reclaimable,
                           alloc.ref_count(node.page)))
    chains.sort()
    return {
        "n_free": len(alloc._free),
        "n_reclaimable": 0 if cache is None else cache.n_reclaimable,
        "n_live": len(alloc._ref),
        "n_owned_requests": sum(1 for pages in alloc._owned.values() if pages),
        "chains": chains,
    }


def diff_fingerprints(a: Dict[str, Any], b: Dict[str, Any], *,
                      label_a: str = "a", label_b: str = "b") -> List[str]:
    """Human-readable differences between two fingerprints ([] if none)."""
    diffs: List[str] = []
    for key in _SCALAR_KEYS:
        if a[key] != b[key]:
            diffs.append(f"{key}: {label_a}={a[key]} {label_b}={b[key]}")
    ca = {c[0]: c[1:] for c in a["chains"]}
    cb = {c[0]: c[1:] for c in b["chains"]}
    for path in sorted(set(ca) | set(cb)):
        tag = f"chain {list(path[:8])}{'...' if len(path) > 8 else ''} (len {len(path)})"
        if path not in cb:
            diffs.append(f"{tag}: cached only in {label_a} {ca[path]}")
        elif path not in ca:
            diffs.append(f"{tag}: cached only in {label_b} {cb[path]}")
        elif ca[path] != cb[path]:
            diffs.append(f"{tag}: (n_valid, reclaimable, refs) "
                         f"{label_a}={ca[path]} {label_b}={cb[path]}")
    return diffs


def run_cross_mode(engine_factory: Callable[[str], Any],
                   requests_factory: Callable[[], Sequence[Any]],
                   modes: Iterable[str] = ("sequential", "splitwiser"),
                   max_steps: int = 100_000) -> Dict[str, Any]:
    """Run the same workload under each mode; diff streams *and* state.

    ``engine_factory(mode)`` builds a fresh engine for the mode;
    ``requests_factory()`` builds a fresh request list per run (requests
    are stateful).  Returns::

        {"modes": [...],
         "streams_match": bool,
         "state_diffs": {mode: [diff lines vs modes[0]]},
         "fingerprints": {mode: fingerprint}}
    """
    modes = list(modes)
    results: Dict[str, Dict[str, Any]] = {}
    for mode in modes:
        eng = engine_factory(mode)
        reqs = list(requests_factory())
        eng.run(reqs, max_steps=max_steps)
        results[mode] = {
            "streams": {r.rid: list(r.out_tokens) for r in reqs},
            "fingerprint": state_fingerprint(eng.alloc, eng.prefix_cache),
        }
    base = modes[0]
    report: Dict[str, Any] = {
        "modes": modes,
        "streams_match": True,
        "state_diffs": {},
        "fingerprints": {m: results[m]["fingerprint"] for m in modes},
    }
    for mode in modes[1:]:
        if results[mode]["streams"] != results[base]["streams"]:
            report["streams_match"] = False
        report["state_diffs"][mode] = diff_fingerprints(
            results[base]["fingerprint"], results[mode]["fingerprint"],
            label_a=base, label_b=mode)
    return report
