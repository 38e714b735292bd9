"""Scenario API: declarative workload/deployment specs over the whole
serving stack.

One :class:`Scenario` — a validated, dict-round-trippable dataclass
tree (:class:`WorkloadSpec` / :class:`NetworkSpec` /
:class:`DeploymentSpec` / :class:`PolicySpec`) — describes an entire
experiment; ``build()`` compiles it into runnable harnesses over the
three entry points (closed-loop simulator, discrete-event engine, live
pool executor), which expose the same construction as ``from_scenario``
adapters.  The registry holds named scenarios (steady / diurnal / burst
/ class_mix / scale_up) that ``benchmarks/scenario_suite.py`` runs; the
autoscaler closes the replica loop from ``Router.stats()`` telemetry.

>>> from repro_torch.scenario import get_scenario, build
>>> out = build(get_scenario("steady")).run()
>>> out.result.sla_attainment
"""
from repro_torch.scenario.autoscale import QueueTargetAutoscaler
from repro_torch.scenario.build import (EpochResult, ScenarioHarness,
                                  ScenarioResult, build, build_closed_loop,
                                  build_engine, build_executor, build_faults,
                                  build_retry)
from repro_torch.scenario.registry import (drift_scenario, faulty_scenario,
                                     fleet_scenario, get_scenario,
                                     list_scenarios, register)
from repro_torch.scenario.spec import (AutoscalerSpec, DeploymentSpec, DriftSpec,
                                 FaultSpec, NetworkSpec, PolicySpec,
                                 RetrySpec, Scenario, SlaClass, WorkloadSpec)

__all__ = [
    "Scenario", "WorkloadSpec", "NetworkSpec", "DeploymentSpec",
    "PolicySpec", "SlaClass", "AutoscalerSpec",
    "FaultSpec", "DriftSpec", "RetrySpec",
    "build", "build_engine", "build_closed_loop", "build_executor",
    "build_faults", "build_retry",
    "ScenarioHarness", "ScenarioResult", "EpochResult",
    "QueueTargetAutoscaler",
    "register", "get_scenario", "list_scenarios",
    "drift_scenario", "faulty_scenario", "fleet_scenario",
]
