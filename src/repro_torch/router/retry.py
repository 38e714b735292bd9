"""Retry / hedged-fallback policy: what the router does when a placed
request loses its replica or its deadline headroom mid-flight.

The primary decision (``Router.route*``) optimises accuracy within the
full budget.  This module covers the *second* decision, made under
duress: a replica died with the request queued on it, or service is
about to start and the believed μ no longer fits what is left of the
SLA.  The recovery pick is deliberately different in character from the
primary one — no accuracy maximisation, no exploration, no RNG:
:func:`cheapest_viable` takes the model with the smallest believed
total latency (``W_queue + μ``) that still fits the *remaining* budget
(``T_sla − 2·T_input − elapsed``).  Deterministic and draw-free, so
retries never perturb the seeded selection stream of the surviving
traffic.

:class:`RetryPolicy` bounds the damage: ``max_attempts`` counts every
placement including the first (``max_attempts=1`` disables recovery
entirely), and ``reroute_on_overrun`` gates the deadline-overrun hedge
(checked when service is about to start) separately from the
failure-driven path (always eligible while attempts remain).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.profiles import ProfileTable


@dataclass(frozen=True)
class RetryPolicy:
    """Bounds and switches for the recovery path.

    ``max_attempts``: total placements per request including the first
    (so 2 = one retry).  ``reroute_on_overrun``: also hedge at
    service-start when the believed service time overruns the remaining
    budget (plus ``overrun_margin_ms`` of slack before the hedge
    triggers — 0 hedges on any predicted miss).
    """
    max_attempts: int = 2
    reroute_on_overrun: bool = True
    overrun_margin_ms: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (it counts the "
                             "first placement)")
        if self.overrun_margin_ms < 0.0:
            raise ValueError("overrun_margin_ms must be non-negative")


def cheapest_viable(tab: ProfileTable,
                    waits: Optional[Dict[str, float]],
                    remaining_ms: float) -> int:
    """Index of the model with the smallest believed ``W_queue + μ``
    that fits ``remaining_ms``; −1 when none does (dead replicas
    surface ``inf`` waits, so a model with no live replica can never
    win).  First minimum wins ties — deterministic, no RNG."""
    best = -1
    best_cost = float("inf")
    for i, name in enumerate(tab.names):
        w = waits.get(name, 0.0) if waits is not None else 0.0
        cost = w + tab.mu[i]
        if cost < best_cost:
            best_cost = cost
            best = i
    if best < 0 or best_cost > remaining_ms:
        return -1
    return best
