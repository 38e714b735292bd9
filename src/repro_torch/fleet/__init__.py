"""Multi-cell fleet layer.

Only the specs are ported so far: ``FleetSpec`` (cells plus the
inter-cell network) rides on the Scenario API, so fleet scenarios
register and round-trip as data.  The frontend, the fleet engine and
the stacked device selection arrive with the fleet slice of the port;
until then ``ScenarioHarness.run`` refuses a multi-cell fleet.
"""
from repro_torch.fleet.spec import CellSpec, FleetSpec

__all__ = ["CellSpec", "FleetSpec"]
