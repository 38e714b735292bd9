"""Closed-loop replica autoscaling from router telemetry.

The ROADMAP loop this closes: ``Router.stats()`` (shed rate, fallback
rate, mean batch) plus the engine's queue-wait summary are exactly the
control signal a replica autoscaler needs.  ``QueueTargetAutoscaler``
consumes one epoch's *windowed* readings (the scenario harness builds a
fresh engine — and with it a fresh router — per epoch; long-running
routers get per-window deltas from ``Router.window_stats()`` without
zeroing, or the same effect via ``Router.reset()`` at each boundary)
and answers the replica count for the next epoch:

- **scale up** (by ``step``, capped at ``max_replicas``) when the epoch
  missed its queue target — mean queue wait above ``target_queue_ms``,
  the router shedding more than ``max_shed_rate`` of traffic, or the
  policy falling back (no model fit the budget) on more than
  ``max_fallback_rate`` of requests;
- **scale down** (by ``step``, floored at ``min_replicas``) only when
  the epoch was comfortably idle: no shedding, queue wait under a
  quarter of target, and mean replica utilization below
  ``low_utilization`` — hysteresis so the pool does not flap around the
  target.

The utilization read prefers ``LoadSimResult.mean_live_utilization``
(busy time over each replica's *alive* window).  Averaging the raw
``replica_utilization`` dict over all replicas dilutes the signal
*downward* when the epoch carried killed/decommissioned replicas — a
dead replica contributes ≈0 busy fraction, dragging the mean under
``low_utilization`` and promoting spurious scale-in while the survivors
are saturated (verified in ``tests/test_elastic.py``: the dilution
promotes spurious scale-in rather than blocking a legitimate one).
On static fault-free pools the two reads are bit-identical, so every
epoch-boundary golden is preserved.

This is the *degenerate* control path — one decision per epoch,
instantaneous and free.  ``AutoscalerSpec.control_interval_ms > 0``
instead arms the engine-side mid-run controllers
(``sim.elastic``): cold-start-paying provisioning, drain-based
scale-in, windowed per-tick telemetry.

The policy is deliberately a deterministic function of one epoch's
telemetry: scenario runs stay reproducible, and the SLA-vs-cost
trade-off it makes is auditable per epoch in ``BENCH_scenario_suite``
rows (replicas, attainment, shed rate per epoch).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.scenario.spec import AutoscalerSpec


@dataclass
class QueueTargetAutoscaler:
    """Queue-depth-target scaling policy over ``Router.stats()``."""
    spec: AutoscalerSpec

    def decide(self, n_replicas: int, router_stats: Dict[str, float],
               result) -> int:
        """Next epoch's replica count from this epoch's telemetry.

        ``router_stats`` is a windowed ``Router.stats()`` reading;
        ``result`` is the epoch's ``LoadSimResult``.
        """
        s = self.spec
        routed = max(router_stats.get("n_routed", 0), 1)
        shed_rate = router_stats.get("n_shed", 0) / routed
        fallback_rate = router_stats.get("n_fallback", 0) / routed
        overloaded = (result.mean_queue_wait > s.target_queue_ms
                      or shed_rate > s.max_shed_rate
                      or fallback_rate > s.max_fallback_rate)
        if overloaded:
            return min(n_replicas + s.step, s.max_replicas)
        # Prefer the alive-window-normalized read: the all-replica mean
        # is diluted toward 0 by dead (killed/decommissioned) replicas,
        # which would trigger spurious scale-in while the survivors are
        # saturated.  Falsy covers results predating the field (and the
        # genuinely-idle pool, where the fallback computes ~0 anyway).
        mean_util = getattr(result, "mean_live_utilization", None)
        if not mean_util:
            util = result.replica_utilization
            mean_util = float(np.mean(list(util.values()))) if util else 0.0
        idle = (shed_rate == 0.0
                and result.mean_queue_wait < 0.25 * s.target_queue_ms
                and mean_util < s.low_utilization)
        if idle:
            return max(n_replicas - s.step, s.min_replicas)
        return n_replicas
