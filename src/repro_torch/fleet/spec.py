"""Fleet specs: the multi-cell layer over the Scenario API.

A *fleet* is N serving cells (regions / availability zones), each a
complete single-cell deployment — its own zoo subset, replica topology
and mobile-uplink model — joined by an inter-cell network with a known
round-trip time.  :class:`FleetSpec` rides on
:class:`~repro_torch.scenario.spec.DeploymentSpec` as an optional field, so a
fleet scenario is an ordinary :class:`~repro_torch.scenario.spec.Scenario`
that still round-trips through plain dicts / JSON / TOML; single-cell
dicts (no ``fleet`` key) are untouched.

Per-cell knobs default to "inherit from the scenario" (empty subset /
topology, zero replicas, ``network=None``), so the common case — a
homogeneous fleet — is just a list of names with weights and time-zone
phases.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.scenario.spec import NetworkSpec, TOPOLOGIES, _require


@dataclass(frozen=True)
class CellSpec:
    """One serving cell.

    ``weight`` sets the share of the user population whose sticky hash
    lands here; ``phase`` ∈ [0, 1) offsets this cell's diurnal load by a
    fraction of the trace day (its time zone).  ``subset`` / ``topology``
    / ``replicas`` / ``network`` override the scenario-level deployment
    when non-empty / non-zero / non-None — a fleet can mix a big cell
    running the full zoo with edge cells holding only the fast variants.
    """
    name: str
    weight: float = 1.0
    phase: float = 0.0
    subset: Tuple[str, ...] = ()     # () = scenario's subset
    topology: str = ""               # "" = scenario's topology
    replicas: int = 0                # 0 = scenario's replica count
    network: Optional[NetworkSpec] = None  # None = scenario's uplink

    def __post_init__(self):
        _require(bool(self.name), "CellSpec needs a non-empty name")
        _require(self.weight > 0.0,
                 f"cell {self.name!r}: weight must be positive")
        _require(0.0 <= self.phase < 1.0,
                 f"cell {self.name!r}: phase must be in [0, 1), "
                 f"got {self.phase}")
        _require(self.topology in ("",) + TOPOLOGIES,
                 f"cell {self.name!r}: topology must be '' (inherit) or "
                 f"one of {TOPOLOGIES}, got {self.topology!r}")
        _require(self.replicas >= 0,
                 f"cell {self.name!r}: replicas must be >= 0 (0 inherits)")


@dataclass(frozen=True)
class FleetSpec:
    """The fleet: cells plus the inter-cell network and spill policy.

    ``rtt_ms`` is the inter-cell round trip a spilled request pays on
    top of its mobile uplink; the frontend judges the remote budget as
    ``T_sla − 2·T_input − RTT_xcell − W_queue(m)``, so spilling is never
    silently optimistic.  ``spill_threshold_ms``: also consider spilling
    (not only when the home cell has *no* viable variant) once the home
    cell's load signal exceeds this queue-wait level; 0 keeps the
    conservative no-viable-variant-only trigger.  ``epoch_ms`` is the
    shared rebalancing clock of the fleet engine; ``n_users`` the sticky
    user population; ``trace_path`` an optional Azure-Functions-style
    rate trace (CSV/JSON) replayed per cell at its ``phase`` offset.
    """
    cells: Tuple[CellSpec, ...] = (CellSpec("cell0"),)
    rtt_ms: float = 40.0
    spill: bool = True
    spill_threshold_ms: float = 0.0
    n_users: int = 10_000
    epoch_ms: float = 10_000.0
    trace_path: str = ""

    def __post_init__(self):
        if self.cells and not isinstance(self.cells, tuple):
            object.__setattr__(self, "cells", tuple(self.cells))
        _require(len(self.cells) >= 1, "FleetSpec needs at least one cell")
        names = [c.name for c in self.cells]
        _require(len(names) == len(set(names)),
                 f"duplicate cell names: {names}")
        _require(self.rtt_ms >= 0.0, "rtt_ms must be non-negative")
        _require(self.spill_threshold_ms >= 0.0,
                 "spill_threshold_ms must be non-negative")
        _require(self.n_users >= 1, "n_users must be >= 1")
        _require(self.epoch_ms > 0.0, "epoch_ms must be positive")

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetSpec":
        """Inverse of the ``dataclasses.asdict`` form embedded in
        ``Scenario.to_dict()``."""
        d = dict(d)
        cells = []
        for c in d.get("cells", ()):
            c = dict(c)
            if c.get("network") is not None:
                c["network"] = NetworkSpec(**c["network"])
            if "subset" in c:
                c["subset"] = tuple(c["subset"])
            cells.append(CellSpec(**c))
        if cells:
            d["cells"] = tuple(cells)
        else:
            d.pop("cells", None)
        return cls(**d)
