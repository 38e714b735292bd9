"""Closed-loop ModiPick simulator (reproduces the paper's §4 experiments).

This is now a thin closed-loop driver over the unified
``repro_torch.router.Router``: the paper's loop is exactly
``ClosedLoopArrivals`` over a single shared replica, routed through the
same Router object as the discrete-event engine and the live executor,
and the engine replays it draw-for-draw — same RNG, same order (uplink
sample → selection → true latency → EWMA feedback → cold-model probe),
so seeded results are unchanged by the refactor.  Open-loop traffic,
FIFO queues, heterogeneous replicas, queue-aware selection and admission
control live in ``repro_torch.sim.engine.ServingSimulator``; an ``admission``
controller set here is passed straight through to the Router.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import Policy
from repro_torch.core.profiles import ProfileStore
from repro_torch.core.zoo import ZooEntry
from repro_torch.router.admission import AdmissionController


@dataclass
class SimResult:
    policy: str
    t_sla: float
    n: int
    sla_attainment: float       # fraction of requests meeting the SLA
    mean_accuracy: float        # expected accuracy of selected models
    mean_latency: float         # end-to-end ms
    p99_latency: float
    model_usage: Dict[str, float]  # fraction of requests per model

    @property
    def violation_rate(self) -> float:
        return 1.0 - self.sla_attainment


@dataclass
class Simulator:
    entries: Sequence[ZooEntry]
    network: NetworkModel
    seed: int = 0
    alpha: float = 0.1
    cold_age: int = 500
    cold_probe: bool = True
    # latency-spike process: with prob p, a request takes spike_mult × μ —
    # models the co-tenant interference the paper motivates exploration with
    spike_prob: float = 0.0
    spike_mult: float = 10.0
    # pluggable router-side admission (repro_torch.router.admission); None is
    # AdmitAll — the paper's closed loop never sheds.
    admission: Optional[AdmissionController] = None

    @classmethod
    def from_scenario(cls, scenario) -> "Simulator":
        """Adapter: build the paper's closed-loop driver from a
        declarative :class:`repro_torch.scenario.Scenario` (the scenario's
        workload must be ``closed_loop``)."""
        from repro_torch.scenario.build import build_closed_loop
        return build_closed_loop(scenario)

    def _engine(self):
        from repro_torch.sim.engine import ServingSimulator
        from repro_torch.sim.replica import shared_replicas
        return ServingSimulator(
            entries=list(self.entries), network=self.network,
            replicas=shared_replicas(1), seed=self.seed, alpha=self.alpha,
            cold_age=self.cold_age, cold_probe=self.cold_probe,
            spike_prob=self.spike_prob, spike_mult=self.spike_mult,
            admission=self.admission)

    def run(self, policy: Policy, t_sla: float, n_requests: int = 10_000,
            warm: bool = True, store: Optional[ProfileStore] = None
            ) -> SimResult:
        from repro_torch.sim.arrivals import ClosedLoopArrivals
        engine = self._engine()
        res = engine.run(policy, t_sla, n_requests,
                         arrivals=ClosedLoopArrivals(),
                         warm=warm, store=store)
        self.router = engine.router  # the run's Router (telemetry/tests)
        return SimResult(
            policy=res.policy,
            t_sla=res.t_sla,
            n=res.n_completed,
            sla_attainment=res.sla_attainment,
            mean_accuracy=res.mean_accuracy,
            mean_latency=res.mean_latency,
            p99_latency=res.p99_latency,
            model_usage=res.model_usage,
        )


def sla_sweep(sim: Simulator, policy_fn, slas: Sequence[float],
              n_requests: int = 10_000) -> List[SimResult]:
    """policy_fn(t_sla) -> Policy (static greedy needs the SLA at build)."""
    return [sim.run(policy_fn(s), s, n_requests) for s in slas]
