"""Fault injection: environment events scheduled on the event queue.

The engine's world was fair-weather — replicas never failed, the
ground-truth latency process never moved, and the network stayed at its
seeded distribution.  These records describe the three ways it can now
misbehave mid-run, each scheduled as a ``FAULT`` event on the same
:class:`~repro_torch.sim.events.EventQueue` that drives the request lifecycle
(so faults interleave deterministically with traffic under a seed):

- :class:`ReplicaFault` — replica lifecycle: ``kill`` (drop in-flight +
  queued work, stop accepting; the engine re-routes the victims through
  the router's retry path), ``degrade`` (slow by ``factor``; keeps
  serving), ``drain`` (no new work, finish the queue), ``recover``
  (back to full speed, accepting).
- :class:`LatencyDrift` — the ground-truth service process for one
  model shifts: μ/σ multiplied (absolute vs the seeded truth, not
  cumulative — a later ``mu_mult=1.0`` event is the recovery).
- :class:`NetworkDrift` — the uplink/downlink RTT scales by
  ``rtt_mult`` (absolute vs the seeded network model).

None of these records touches the RNG; a run with no faults configured
schedules no events and is bit-identical to the pre-fault engine.
The declarative layer (``scenario/spec.py`` ``FaultSpec``/``DriftSpec``)
compiles down to these via ``scenario.build.build_faults``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Union

from repro_torch.sim.events import FAULT, EventQueue

REPLICA_FAULT_KINDS = ("kill", "degrade", "drain", "recover")


@dataclass(frozen=True)
class ReplicaFault:
    """One replica-lifecycle transition at ``at_ms``."""
    at_ms: float
    kind: str                # kill | degrade | drain | recover
    replica: str             # replica name, e.g. "r0" or "InceptionV3/0"
    factor: float = 2.0      # degrade slowdown: speed -> base_speed/factor

    def __post_init__(self):
        if self.kind not in REPLICA_FAULT_KINDS:
            raise ValueError(f"kind must be one of {REPLICA_FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if not self.replica:
            raise ValueError("ReplicaFault needs a replica name")
        if self.at_ms < 0.0:
            raise ValueError("at_ms must be non-negative")
        if self.factor <= 0.0:
            raise ValueError("factor must be positive")


@dataclass(frozen=True)
class LatencyDrift:
    """The true service-latency process of ``model`` shifts at
    ``at_ms``: multipliers are absolute vs the seeded (μ, σ)."""
    at_ms: float
    model: str
    mu_mult: float = 1.0
    sigma_mult: float = 1.0

    def __post_init__(self):
        if not self.model:
            raise ValueError("LatencyDrift needs a model name")
        if self.at_ms < 0.0:
            raise ValueError("at_ms must be non-negative")
        if self.mu_mult <= 0.0 or self.sigma_mult <= 0.0:
            raise ValueError("mu_mult/sigma_mult must be positive")


@dataclass(frozen=True)
class NetworkDrift:
    """The uplink/downlink transfer time scales by ``rtt_mult`` at
    ``at_ms`` (absolute vs the seeded network model)."""
    at_ms: float
    rtt_mult: float = 1.0

    def __post_init__(self):
        if self.at_ms < 0.0:
            raise ValueError("at_ms must be non-negative")
        if self.rtt_mult <= 0.0:
            raise ValueError("rtt_mult must be positive")


FaultEvent = Union[ReplicaFault, LatencyDrift, NetworkDrift]


def schedule_faults(evq: EventQueue,
                    faults: Iterable[FaultEvent]) -> int:
    """Push every fault record as a ``FAULT`` event at its ``at_ms``.
    Returns the number scheduled (0 leaves the queue untouched — the
    no-fault run stays bit-identical)."""
    n = 0
    for f in faults:
        evq.push(f.at_ms, FAULT, f)
        n += 1
    return n
