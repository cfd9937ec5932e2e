"""Streaming results of the serving engine (vLLM-shaped).

``Engine.step()`` returns the step's :class:`TokenEvent` list,
``Engine.stream()`` yields them as they happen, and ``Engine.poll()``
drains the :class:`RequestOutput` of every request finished since the
last poll.  Events and outputs carry virtual-clock timestamps so
open-loop benchmarks read TTFT/TBT straight off the stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class TokenEvent:
    """One generated token, as observed on the stream."""
    rid: int
    token: int
    index: int                    # position in the request's output (0-based)
    t: float                      # engine-clock timestamp of emission
    first: bool                   # True for the request's very first token
    finish_reason: Optional[str] = None   # "length" | "stop" on the last token


@dataclass
class RequestOutput:
    """Final result of one request, drained via ``Engine.poll()``."""
    rid: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str            # "length" (budget) | "stop" (eos/stop token)
    n_preempted: int              # times evicted + resumed before finishing
    n_cached_tokens: int          # prefill tokens served by the prefix cache
    arrival: float
    token_times: List[float] = field(default_factory=list)
    t_done: float = 0.0
    tenant: str = "default"       # SLOParams.tenant (core/slo.py)
    # SLO verdict settled at finish: True/False for deadline-carrying
    # requests, None when no TTFT/TBT target resolved for it
    slo_attained: Optional[bool] = None

    @property
    def ttft(self) -> Optional[float]:
        return None if not self.token_times else self.token_times[0] - self.arrival

    @property
    def e2e(self) -> float:
        return self.t_done - self.arrival

    @property
    def tbt(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        gaps = [b - a for a, b in zip(self.token_times, self.token_times[1:],
                                      strict=False)]
        return sum(gaps) / len(gaps)
