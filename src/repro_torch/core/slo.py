"""Per-request SLO surface: deadlines, tenants, and their resolution.

Splitwiser's phase split exists to serve latency-sensitive traffic on
constrained hardware, but the policy layer (``core/policies.py``) only
learned to price cache hits and occupancy — nothing knew what a request's
*deadline* was, so one tenant's burst could legally destroy another's
p99.  This module gives every request that vocabulary:

:class:`SLOParams`
    Travels with each :class:`~repro_torch.core.engine.Request` (like
    ``SamplingParams``): optional ``ttft_target`` / ``tbt_target``
    deadlines on the engine's virtual clock, and a ``tenant`` id.

:class:`~repro_torch.configs.base.TenantTier` (``ServeConfig.tenants``)
    Per-tenant tier defaults: targets a request inherits when its own
    ``SLOParams`` leaves them unset, an in-flight token ``quota_tokens``
    (the fairness lever: a tenant's burst queues behind its quota instead
    of starving everyone else), and a ``weight`` the chunk planner's
    carve order respects.

:func:`resolve_slo`
    Request-over-tier resolution into one :class:`EffectiveSLO` view —
    the single lookup the ``deadline`` policies, the chunk planner, the
    SLO metrics rollup, and the quota-honesty sanitizer check all share,
    so "what does this request owe and to whom" has exactly one answer.

Deadline semantics (all on the engine clock, virtual or wall):

* TTFT deadline  = ``arrival + ttft_target`` — binds until the first
  token is emitted;
* TBT deadline   = ``last_token_time + tbt_target`` — binds between
  consecutive tokens; a finished request attains its TBT target iff its
  *worst* inter-token gap met it.

A request with neither target resolved carries no deadline: its slack is
infinite, every ``deadline`` policy degenerates to the FCFS/latest
behaviour around it, and it is excluded from SLO-attainment fractions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional

from repro_torch.configs.base import TenantTier

DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class SLOParams:
    """Per-request service-level objectives (``Request.slo``).

    ``ttft_target`` / ``tbt_target`` are deadlines in engine-clock
    seconds (virtual seconds under a counting/work clock); ``None``
    inherits the request's tenant tier, and "no target anywhere" means
    the request carries no deadline at all.  ``tenant`` names the
    :class:`~repro_torch.configs.base.TenantTier` in ``ServeConfig.tenants``
    that supplies defaults, the in-flight token quota, and the planner
    weight ("default" when the operator configured no tiers).
    """
    ttft_target: Optional[float] = None
    tbt_target: Optional[float] = None
    tenant: str = DEFAULT_TENANT

    def __post_init__(self):
        for knob in ("ttft_target", "tbt_target"):
            value = getattr(self, knob)
            if value is not None and (
                    not isinstance(value, (int, float))
                    or isinstance(value, bool) or value <= 0):
                raise ValueError(
                    f"{knob} must be a positive number of engine-clock "
                    f"seconds or None, got {value!r}")
        if not isinstance(self.tenant, str) or not self.tenant:
            raise ValueError(
                f"tenant must be a non-empty string, got {self.tenant!r}")

    @property
    def has_target(self) -> bool:
        return self.ttft_target is not None or self.tbt_target is not None


class EffectiveSLO(NamedTuple):
    """A request's SLO after tier resolution (request overrides tier)."""
    tenant: str
    ttft_target: Optional[float]
    tbt_target: Optional[float]
    quota_tokens: Optional[int]     # tenant in-flight token quota (tier-only)
    weight: float                   # planner carve-order weight (tier-only)

    @property
    def has_deadline(self) -> bool:
        return self.ttft_target is not None or self.tbt_target is not None


_NO_SLO = EffectiveSLO(DEFAULT_TENANT, None, None, None, 1.0)


def resolve_slo(slo: Optional[SLOParams],
                tiers: Mapping[str, TenantTier]) -> EffectiveSLO:
    """Resolve a request's effective SLO: per-request targets win, unset
    ones fall back to the tenant's tier (when one is configured), quota
    and weight always come from the tier (they are tenant-scoped, not
    request-scoped)."""
    if slo is None:
        slo = SLOParams()
    tier = tiers.get(slo.tenant)
    if tier is None:
        if slo.tenant == DEFAULT_TENANT and not slo.has_target:
            return _NO_SLO
        return EffectiveSLO(slo.tenant, slo.ttft_target, slo.tbt_target,
                            None, 1.0)
    return EffectiveSLO(
        slo.tenant,
        slo.ttft_target if slo.ttft_target is not None else tier.ttft_target,
        slo.tbt_target if slo.tbt_target is not None else tier.tbt_target,
        tier.quota_tokens,
        tier.weight)


def request_footprint(req) -> int:
    """Token footprint a request charges against its tenant's in-flight
    quota: prompt plus full generation budget.  Deliberately the *grant*
    (``max_new_tokens``), not current progress — quotas bound what a
    tenant may hold concurrently, and a burst of long-budget requests
    reserves the pool whether or not the tokens exist yet."""
    return len(req.prompt) + req.sampling.max_new_tokens


def ttft_slack(req, eff: EffectiveSLO, now: float) -> float:
    """Seconds of TTFT slack at ``now`` (``inf`` when no TTFT target):
    how long admission can still defer this request before its first
    token is late."""
    if eff.ttft_target is None:
        return math.inf
    return (req.arrival or 0.0) + eff.ttft_target - now


def slo_outcome(ttft: Optional[float], worst_gap: Optional[float],
                eff: EffectiveSLO) -> Optional[bool]:
    """Did a finished request attain its SLO?  ``None`` when it carries
    no deadline (excluded from attainment fractions); otherwise every
    resolved target must hold — TTFT against the first-token latency,
    TBT against the *worst* inter-token gap (zero gaps trivially
    attain)."""
    if not eff.has_deadline:
        return None
    if eff.ttft_target is not None and (
            ttft is None or ttft > eff.ttft_target):
        return False
    if eff.tbt_target is not None and (
            worst_gap is not None and worst_gap > eff.tbt_target):
        return False
    return True
