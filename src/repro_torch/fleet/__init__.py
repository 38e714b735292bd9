"""Sharded multi-cell fleet simulation.

``FleetSpec`` (cells + inter-cell network) rides on the Scenario API;
``FleetFrontend`` places requests (sticky hashing, honest spill);
``FleetEngine`` steps the per-cell serving simulators on a shared
rebalancing clock; ``fleet.device`` runs all cells' selection batches
as one (cell × batch × pool) launch of the stacked selection kernel.
"""
from repro_torch.fleet.device import (StackedPools, select_fleet,
                                      stack_cell_tables)
from repro_torch.fleet.engine import (FleetEngine, FleetEpoch, FleetResult,
                                      cell_view)
from repro_torch.fleet.frontend import FleetFrontend, SpillPlan
from repro_torch.fleet.spec import CellSpec, FleetSpec

__all__ = [
    "CellSpec", "FleetSpec", "FleetFrontend", "SpillPlan", "FleetEngine",
    "FleetEpoch", "FleetResult", "cell_view", "StackedPools",
    "stack_cell_tables", "select_fleet",
]
