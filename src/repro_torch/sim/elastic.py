"""Elastic replica lifecycle on the event queue: cold-start
provisioning, drain-based scale-in, and mid-run controllers.

PR 7 made replica *failure* a first-class event on the engine's
``EventQueue`` (kill/degrade/drain/recover with incarnation tokens);
this module is the symmetric robustness story for *capacity*.  Instead
of the epoch-boundary ``QueueTargetAutoscaler`` resizing the pool from
outside the engine — instantaneous, free, and blind to anything shorter
than an epoch — the engine itself runs a controller tick every
``control_interval_ms`` (a CONTROL event), reads one window of
telemetry (windowed ``Router.stats()`` deltas plus queue-wait
readings), and acts on its own queue:

- **scale-up** pushes a PROVISION event: each new replica is born in
  the ``WARMING`` health state (not accepting — its wait column is
  ``inf``, so the router never routes to it) and flips to ``UP`` only
  after ``cold_start_ms``.  Capacity is paid for from commission time
  but delivers nothing until the cold start completes — the realistic
  provisioning delay the paper's static-capacity assumption hides.
- **scale-in** reuses the fault machinery's ``drain`` state: the victim
  stops accepting, finishes every queued request, and only then
  decommissions (stops accruing cost).  Zero in-flight requests are
  lost, by construction.
- a replica cancelled *while still warming* has its incarnation token
  bumped, orphaning the pending ready event — it never serves.

Three controller kinds share one interface (``target(n, reading)`` —
the desired committed replica count, deterministic and draw-free so
seeded runs stay reproducible):

- ``step``: the ``QueueTargetAutoscaler`` thresholds verbatim, applied
  per tick instead of per epoch — the degenerate
  ``control_interval_ms == 0`` scenario path *is* the old epoch
  autoscaler, golden-pinned.
- ``proportional``: HPA-style — desired ≈ ``ceil(n · wait/target)``,
  so a 10× queue-wait overshoot is answered in one tick instead of
  one step per window; scale-in stays hysteretic (one replica per
  comfortable tick).
- ``cost_weighted``: a replica-second has a price
  (``cost_per_replica_s``), so scale-up must clear a higher bar (two
  consecutive hot windows, ramp capped at ``step`` per tick) and
  scale-in a lower one (idle threshold relaxed with the price) — the
  cheap-and-slightly-late end of the SLA-vs-cost frontier.

``benchmarks/elastic_controllers.py`` sweeps controller kind ×
``target_queue_ms`` × ``cold_start_ms`` into that frontier.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

CONTROLLER_KINDS = ("step", "proportional", "cost_weighted")


@dataclass(frozen=True)
class ElasticConfig:
    """Engine-side elastic lifecycle knobs (the scenario layer compiles
    ``AutoscalerSpec`` into one of these when ``control_interval_ms``
    is positive)."""
    kind: str = "step"
    control_interval_ms: float = 1000.0
    cold_start_ms: float = 0.0
    target_queue_ms: float = 50.0
    max_shed_rate: float = 0.02
    max_fallback_rate: float = 0.25
    min_replicas: int = 1
    max_replicas: int = 8
    step: int = 1
    low_utilization: float = 0.3
    cost_per_replica_s: float = 0.0
    # Consecutive pressure windows before scale-up acts.  A one-window
    # control reading is a handful of requests at low load — one request
    # queued behind a single slow inference trips any tight queue target
    # — so a transient never buys capacity; 1 restores act-immediately.
    confirm_windows: int = 2

    def __post_init__(self):
        if self.kind not in CONTROLLER_KINDS:
            raise ValueError(f"controller kind must be one of "
                             f"{CONTROLLER_KINDS}, got {self.kind!r}")
        if self.control_interval_ms <= 0.0:
            raise ValueError("control_interval_ms must be positive "
                             "(0 means the epoch-boundary path — build "
                             "no ElasticConfig at all)")
        if self.cold_start_ms < 0.0:
            raise ValueError("cold_start_ms must be non-negative")
        if self.target_queue_ms <= 0.0:
            raise ValueError("target_queue_ms must be positive")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.step < 1:
            raise ValueError("step must be >= 1")
        if self.cost_per_replica_s < 0.0:
            raise ValueError("cost_per_replica_s must be non-negative")
        if self.confirm_windows < 1:
            raise ValueError("confirm_windows must be >= 1")


@dataclass(frozen=True)
class ControlReading:
    """One control window's telemetry, as the engine's tick hands it to
    a controller: the queue-wait signal (max of the window's observed
    service-start waits and the instantaneous backlog estimate — the
    observed mean alone lags a load step by a queue's length), windowed
    router shed/fallback rates, and the busy fraction of serving
    capacity over the window."""
    mean_queue_wait_ms: float = 0.0
    shed_rate: float = 0.0
    fallback_rate: float = 0.0
    utilization: float = 0.0
    n_routed: int = 0


class _BaseController:
    """The confirm-and-act shell every controller kind shares: pressure
    (wait over target, or shed/fallback over their caps) must persist
    for ``confirm_windows`` consecutive readings before scale-up acts —
    a one-window reading at low load is a handful of requests, and one
    of them queued behind a single slow inference trips any tight
    target.  Scale-in carries its own hysteresis (each kind's ``_idle``
    test) and acts immediately: reclaiming an idle replica late only
    costs replica-seconds, never SLA."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self._hot = 0

    def _confirm(self) -> int:
        return self.cfg.confirm_windows

    def _pressure(self, r: ControlReading) -> bool:
        cfg = self.cfg
        return (r.mean_queue_wait_ms > cfg.target_queue_ms
                or r.shed_rate > cfg.max_shed_rate
                or r.fallback_rate > cfg.max_fallback_rate)

    def target(self, n: int, r: ControlReading) -> int:
        if self._pressure(r):
            self._hot += 1
            if self._hot < self._confirm():
                return n
            return min(max(self._up(n, r), n + 1), self.cfg.max_replicas)
        self._hot = 0
        if self._idle(r):
            return max(self._down(n), self.cfg.min_replicas)
        return n


class StepController(_BaseController):
    """``QueueTargetAutoscaler``'s thresholds, per tick: up by ``step``
    when the window missed its queue target, down by ``step`` only when
    comfortably idle — hysteresis so the pool does not flap."""

    def _up(self, n: int, r: ControlReading) -> int:
        return n + self.cfg.step

    def _idle(self, r: ControlReading) -> bool:
        cfg = self.cfg
        return (r.shed_rate == 0.0
                and r.mean_queue_wait_ms < 0.25 * cfg.target_queue_ms
                and r.utilization < cfg.low_utilization)

    def _down(self, n: int) -> int:
        return n - self.cfg.step


class ProportionalController(_BaseController):
    """HPA-style proportional scaling: desired ≈
    ``ceil(n · wait/target)``, so the answer to a K× overshoot is K×
    the capacity in ONE confirmed tick.  Shedding with a low wait still
    forces at least one step up (a shed request never queued, so it
    left no wait signal).  Scale-in stays one replica per comfortable
    tick — the asymmetry is deliberate: under-capacity costs SLA misses
    now, over-capacity only costs replica-seconds."""

    def _up(self, n: int, r: ControlReading) -> int:
        ratio = r.mean_queue_wait_ms / self.cfg.target_queue_ms
        return int(math.ceil(n * max(ratio, 1.0)))

    def _idle(self, r: ControlReading) -> bool:
        cfg = self.cfg
        return (r.mean_queue_wait_ms < 0.25 * cfg.target_queue_ms
                and r.shed_rate == 0.0
                and r.utilization < cfg.low_utilization)

    def _down(self, n: int) -> int:
        return n - 1


class CostWeightedController(_BaseController):
    """Proportional control with a price on replica-seconds: a positive
    ``cost_per_replica_s`` raises the scale-up bar (at least two
    confirmed hot windows) and caps the ramp at ``step`` per tick,
    while scale-in triggers at a relaxed idle threshold that grows with
    the price — the cheap-and-slightly-late end of the SLA-vs-cost
    frontier.  With a zero price it is a capped-ramp proportional
    controller."""

    def __init__(self, cfg: ElasticConfig):
        super().__init__(cfg)
        self._patience = max(cfg.confirm_windows,
                             2 if cfg.cost_per_replica_s > 0.0 else 1)
        self._idle_util = min(1.0, cfg.low_utilization
                              * (1.0 + cfg.cost_per_replica_s))

    def _confirm(self) -> int:
        return self._patience

    def _up(self, n: int, r: ControlReading) -> int:
        ratio = r.mean_queue_wait_ms / self.cfg.target_queue_ms
        return min(int(math.ceil(n * max(ratio, 1.0))), n + self.cfg.step)

    def _idle(self, r: ControlReading) -> bool:
        cfg = self.cfg
        return (r.mean_queue_wait_ms < 0.5 * cfg.target_queue_ms
                and r.shed_rate == 0.0
                and r.utilization < self._idle_util)

    def _down(self, n: int) -> int:
        return n - self.cfg.step


def make_controller(cfg: ElasticConfig):
    """Controller factory: ``cfg.kind`` → a fresh controller instance
    (cost_weighted is stateful — never share one across runs)."""
    if cfg.kind == "step":
        return StepController(cfg)
    if cfg.kind == "proportional":
        return ProportionalController(cfg)
    return CostWeightedController(cfg)
