"""The fleet engine: N per-cell serving simulators on a shared clock.

Execution model — epoch-stepped, like the autoscaler harness but across
space instead of time:

1. The sticky frontend assigns every request a home cell; each cell
   gets its own arrival timeline (Poisson at its weighted share, a
   phase-shifted diurnal synthesizer, or a phase-shifted replay of the
   fleet's rate trace — its time zone).
2. Time advances in ``FleetSpec.epoch_ms`` windows.  Per window the
   frontend re-plans: all cells' pending requests are judged against
   all cells in ONE stacked launch
   (:func:`~repro_torch.fleet.device.select_fleet`), and requests whose home
   cell cannot serve them spill to the cheapest viable remote cell,
   paying the inter-cell RTT inside their own budget.
3. Each cell's :class:`~repro_torch.sim.engine.ServingSimulator` runs its
   window to completion (cells drain at epoch boundaries — the same
   consecutive-observation-window semantics as multi-epoch scenarios),
   with spilled-in requests carrying ``extra_input_for = RTT/2`` so
   ``2·T_input`` grows by exactly the RTT.  Profile stores persist per
   cell across epochs; the load signal the next plan sees is each
   cell's mean queue wait from the window just run.

A 1-cell fleet with no trace runs *passthrough*: the scenario executes
on the ordinary single-cell harness path, bit-identical to the same
scenario without a ``FleetSpec`` (the parity guarantee the golden test
pins).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fleet.device import stack_cell_tables
from repro_torch.fleet.frontend import FleetFrontend
from repro_torch.fleet.spec import CellSpec, FleetSpec
from repro_torch.scenario.spec import Scenario
from repro_torch.sim.arrivals import TraceArrivals, diurnal_trace, load_trace
from repro_torch.sim.engine import LoadSimResult

_CELL_SEED_STRIDE = 1_000_003
_FLEET_TRACE_SALT = 0xF1EE7
_PLAN_SEED_STRIDE = 7919


def cell_view(scenario: Scenario, cell: CellSpec) -> Scenario:
    """The single-cell Scenario a fleet cell runs: the fleet scenario
    with this cell's overrides applied and the fleet field dropped."""
    dep = scenario.deployment
    replicas = cell.replicas or dep.replicas
    topology = cell.topology or dep.topology
    # Explicit shared-pool speeds only survive when the cell keeps the
    # declared shape (build_replicas applies the same rule on resize).
    speeds = dep.speeds if (topology == dep.topology
                            and replicas == dep.replicas) else ()
    return dataclasses.replace(
        scenario,
        name=f"{scenario.name}:{cell.name}",
        network=cell.network if cell.network is not None else
        scenario.network,
        deployment=dataclasses.replace(
            dep, fleet=None, subset=cell.subset or dep.subset,
            topology=topology, replicas=replicas, speeds=speeds))


def _resolve_trace_path(path: str) -> str:
    """Relative trace paths resolve against the repo root (where
    ``examples/`` lives), falling back to the cwd."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))
    cand = os.path.join(root, path)
    return cand if os.path.exists(cand) else path


@dataclass
class FleetEpoch:
    """One rebalancing window across the whole fleet."""
    epoch: int
    result: LoadSimResult            # merged across cells (exact arrays)
    cell_results: List[Optional[LoadSimResult]]
    router_stats: Dict[str, float]   # summed across cells
    n_assigned: np.ndarray           # (C,) requests served per cell
    n_spilled: int
    load_ms: np.ndarray              # (C,) load signal the plan used


@dataclass
class FleetResult:
    """A full fleet run: per-epoch merged results plus fleet headlines."""
    scenario: Scenario
    epochs: List[FleetEpoch] = field(default_factory=list)

    @property
    def n_cells(self) -> int:
        fl = self.scenario.deployment.fleet
        return fl.n_cells if fl is not None else 1

    @property
    def n_arrived(self) -> int:
        return sum(e.result.n_arrived for e in self.epochs)

    @property
    def n_completed(self) -> int:
        return sum(e.result.n_completed for e in self.epochs)

    @property
    def n_spilled(self) -> int:
        return sum(e.n_spilled for e in self.epochs)

    @property
    def spill_rate(self) -> float:
        return self.n_spilled / max(self.n_arrived, 1)

    @property
    def locality(self) -> float:
        """Fraction of requests served by their home cell."""
        return 1.0 - self.spill_rate

    @property
    def sla_attainment(self) -> float:
        return self._pooled("sla_attainment", "n_arrived")

    @property
    def mean_accuracy(self) -> float:
        return self._pooled("mean_accuracy", "n_completed")

    @property
    def mean_latency(self) -> float:
        return self._pooled("mean_latency", "n_completed")

    @property
    def mean_queue_wait(self) -> float:
        return self._pooled("mean_queue_wait", "n_completed")

    def _pooled(self, attr: str, weight: str) -> float:
        n = sum(getattr(e.result, weight) for e in self.epochs)
        return sum(getattr(e.result, attr) * getattr(e.result, weight)
                   for e in self.epochs) / max(n, 1)

    def as_scenario_result(self):
        """Adapt to :class:`~repro_torch.scenario.build.ScenarioResult` so
        every ScenarioResult consumer (the benchmark suite, frontier
        scripts) reads a fleet run unchanged."""
        from repro_torch.scenario.build import EpochResult, ScenarioResult
        fl = self.scenario.deployment.fleet
        n_rep = sum((c.replicas or self.scenario.deployment.replicas)
                    for c in fl.cells) if fl is not None else \
            self.scenario.deployment.replicas
        out = ScenarioResult(scenario=self.scenario, fleet=self)
        for e in self.epochs:
            out.epochs.append(EpochResult(
                epoch=e.epoch, n_replicas=n_rep, result=e.result,
                router_stats=dict(e.router_stats)))
        return out


class FleetEngine:
    """Run one fleet scenario end to end.  With a ``mesh`` (a cell
    mesh, ``launch/mesh.py``), each epoch's selection runs sharded over
    it (``fleet.device.select_fleet``)."""

    def __init__(self, scenario: Scenario, *, mesh=None):
        fleet = scenario.deployment.fleet
        if fleet is None:
            raise ValueError(f"scenario {scenario.name!r} has no FleetSpec")
        self.scenario = scenario
        self.fleet: FleetSpec = fleet
        self.mesh = mesh
        self.frontend = FleetFrontend(scenario)
        self.cells = [cell_view(scenario, c) for c in fleet.cells]
        self.gamma = float(scenario.policy.kwargs.get("gamma", 1.0))

    # -- arrival synthesis ---------------------------------------------
    def _cell_times(self, c: int, n_c: int, share: float) -> np.ndarray:
        """Cell ``c``'s arrival timestamps: its weighted share of the
        fleet rate, shaped by the trace/diurnal profile at the cell's
        time-zone phase."""
        sc, wl = self.scenario, self.scenario.workload
        cell = self.fleet.cells[c]
        seed = (sc.seed ^ _FLEET_TRACE_SALT) + _CELL_SEED_STRIDE * c
        rate = max(wl.rate_rps * share, 1e-9)
        if self.fleet.trace_path:
            tr = load_trace(_resolve_trace_path(self.fleet.trace_path),
                            n=n_c, rate_rps=rate, period_ms=wl.period_ms,
                            phase=cell.phase, seed=seed)
            return np.asarray(tr.times_ms)
        if wl.arrival == "diurnal":
            tr = diurnal_trace(n_c, rate, period_ms=wl.period_ms,
                               amplitude=wl.amplitude,
                               phase=2.0 * np.pi * cell.phase, seed=seed)
            return np.asarray(tr.times_ms)
        # poisson: render the stream up front so it slices into epochs
        rng = np.random.default_rng(seed)
        return np.cumsum(rng.exponential(1000.0 / rate, size=n_c))

    def _cap_rps(self, stacked) -> np.ndarray:
        """Analytic per-cell capacity prior in req/s from the pooled
        profiles: per_model topology runs every variant on its own
        replica set, so rates add (Σ replicas/μ); shared topologies get
        the uniform-mix rate.  Observed throughput refines this upward
        (e.g. when load skews picks toward fast variants)."""
        mu = stacked.mu_host.astype(np.float64)         # (C, npad)
        cap = np.empty(self.fleet.n_cells, dtype=np.float64)
        for c in range(self.fleet.n_cells):
            m = mu[c][mu[c] < 1e29]       # drop PAD_MU sentinels
            if m.size == 0:
                cap[c] = np.inf           # no profiles yet: unknown
                continue
            dep = self.cells[c].deployment
            rep = max(dep.replicas, 1)
            rates = 1000.0 / m            # req/s per dedicated replica
            cap[c] = rep * (rates.sum()
                            if dep.topology in ("", "per_model")
                            else rates.mean())
        return cap

    # -- passthrough parity ----------------------------------------------
    def _is_passthrough(self) -> bool:
        return (self.fleet.n_cells == 1 and not self.fleet.trace_path
                and self.scenario.workload.arrival in ("poisson",
                                                       "closed_loop"))

    # -- execution -------------------------------------------------------
    def run(self) -> FleetResult:
        if self._is_passthrough():
            return self._run_passthrough()
        return self._run_fleet()

    def _run_passthrough(self) -> FleetResult:
        """1-cell, generative arrivals: execute on the ordinary
        single-cell harness path — bit-identical (pick for pick, shed
        for shed) to the same scenario without a FleetSpec."""
        from repro_torch.scenario.build import ScenarioHarness
        sr = ScenarioHarness(self.scenario).run()
        out = FleetResult(scenario=self.scenario)
        C = 1
        for ep in sr.epochs:
            out.epochs.append(FleetEpoch(
                epoch=ep.epoch, result=ep.result,
                cell_results=[ep.result],
                router_stats=dict(ep.router_stats),
                n_assigned=np.array([ep.result.n_arrived]),
                n_spilled=0, load_ms=np.zeros(C)))
        return out

    def _run_fleet(self) -> FleetResult:
        from repro_torch.scenario.build import build_engine, build_policy
        from repro_torch.scenario.build import ScenarioHarness

        sc, fleet = self.scenario, self.fleet
        wl = sc.workload
        C = fleet.n_cells
        n = wl.n_requests
        rids = np.arange(n, dtype=np.int64)
        home = self.frontend.home_of_requests(rids)

        # Per-cell arrival timelines, written back into one global
        # times[] column (request i arrives at its home cell's clock).
        w = np.array([c.weight for c in fleet.cells], dtype=np.float64)
        share = w / w.sum()
        times = np.zeros(n, dtype=np.float64)
        for c in range(C):
            mask = home == c
            n_c = int(mask.sum())
            if n_c:
                times[mask] = np.sort(self._cell_times(c, n_c, share[c]))

        harnesses = [ScenarioHarness(cv) for cv in self.cells]
        stores = [h.store() for h in harnesses]
        policies = [build_policy(cv) for cv in self.cells]

        horizon = float(times.max())
        n_epochs = int(horizon // fleet.epoch_ms) + 1
        load = np.zeros(C, dtype=np.float64)
        tput_rps = np.zeros(C, dtype=np.float64)  # observed peak service rate
        out = FleetResult(scenario=sc)

        for e in range(n_epochs):
            t0 = e * fleet.epoch_ms
            emask = (times >= t0) & (times < t0 + fleet.epoch_ms)
            erids = rids[emask]
            if erids.size == 0:
                continue
            etimes = times[emask]
            stacked = stack_cell_tables(
                [s.table() for s in stores],
                self.frontend.device(erids.size))
            plan_load = load.copy()
            cap_req = np.maximum(self._cap_rps(stacked), tput_rps) \
                * fleet.epoch_ms / 1000.0
            plan = self.frontend.plan(
                erids, plan_load, stacked, cap_req=cap_req,
                gamma=self.gamma,
                seed=sc.seed + _PLAN_SEED_STRIDE * e, mesh=self.mesh)

            cell_results: List[Optional[LoadSimResult]] = [None] * C
            n_assigned = np.zeros(C, dtype=np.int64)
            merged = _EpochMerger()
            for c in range(C):
                cmask = plan.assigned == c
                n_assigned[c] = int(cmask.sum())
                if not n_assigned[c]:
                    load[c] *= 0.5   # idle window: decay, don't forget
                    continue
                order = np.argsort(etimes[cmask], kind="stable")
                ctimes = etimes[cmask][order]
                extra = plan.rtt_extra_ms[cmask][order] / 2.0
                eng = build_engine(
                    self.cells[c],
                    seed=sc.seed + _CELL_SEED_STRIDE * c + e)
                res = eng.run(policies[c], wl.t_sla_ms, int(n_assigned[c]),
                              arrivals=TraceArrivals(ctimes - t0),
                              store=stores[c],
                              extra_input_for=extra)
                cell_results[c] = res
                merged.add(eng, res, fleet.cells[c].name)
                # Queues drain at epoch boundaries, so last window's
                # mean wait overstates next-window congestion; damp it
                # (EWMA) instead of chasing it raw.
                load[c] = 0.5 * load[c] + 0.5 * res.mean_queue_wait
                tput_rps[c] = max(
                    tput_rps[c],
                    res.n_completed / max(res.horizon_ms / 1000.0, 1e-9))
            out.epochs.append(FleetEpoch(
                epoch=e, result=merged.result(wl.t_sla_ms),
                cell_results=cell_results,
                router_stats=merged.router_stats,
                n_assigned=n_assigned,
                n_spilled=plan.n_spilled,
                load_ms=plan_load))
        return out


class _EpochMerger:
    """Exact cross-cell merge of one epoch: concatenates the cells' raw
    completion columns so percentiles and means are computed over the
    union, not averaged from per-cell summaries."""

    def __init__(self):
        self.e2e: List[np.ndarray] = []
        self.wait: List[np.ndarray] = []
        self.acc: List[np.ndarray] = []
        self.met = 0
        self.n_arrived = 0
        self.n_completed = 0
        self.n_rejected = 0
        self.n_retries = 0
        self.peak_depth = 0
        self.horizon = 1e-9
        self.usage: Dict[str, float] = {}
        self.util: Dict[str, float] = {}
        self.router_stats: Dict[str, float] = {}
        self._batch_sum = 0.0
        self._policy = ""

    def add(self, eng, res: LoadSimResult, cell_name: str) -> None:
        self._policy = res.policy
        cols = eng._cols
        ci = np.asarray(eng._completed_rids, dtype=np.int64)
        if len(ci):
            t_in = cols.t_input[ci]
            wait = cols.sstart[ci] - cols.enqueue[ci]
            e2e = 2.0 * t_in + wait + cols.service[ci]
            self.met += int((e2e <= cols.t_sla[ci]).sum())
            acc_by_id = np.array([en.top1 / 100.0 for en in eng.entries])
            self.e2e.append(e2e)
            self.wait.append(wait)
            self.acc.append(acc_by_id[cols.model[ci]])
        self.n_arrived += res.n_arrived
        self.n_completed += res.n_completed
        self.n_rejected += res.n_rejected
        self.n_retries += res.n_retries
        self.peak_depth = max(self.peak_depth, res.peak_queue_depth)
        self.horizon = max(self.horizon, res.horizon_ms)
        for name, frac in res.model_usage.items():
            self.usage[name] = self.usage.get(name, 0.0) \
                + frac * res.n_completed
        for name, u in res.replica_utilization.items():
            self.util[f"{cell_name}/{name}"] = u
        stats = eng.router.stats() if eng.router is not None else {}
        for k, v in stats.items():
            if k == "mean_batch":
                self._batch_sum += v * stats.get("n_batches", 0)
            elif isinstance(v, (int, float)):
                self.router_stats[k] = self.router_stats.get(k, 0) + v

    def result(self, t_sla: float) -> LoadSimResult:
        nb = self.router_stats.get("n_batches", 0)
        if nb:
            self.router_stats["mean_batch"] = self._batch_sum / nb
        if not self.n_completed:
            return LoadSimResult(
                policy=self._policy, t_sla=t_sla,
                n_arrived=self.n_arrived, n_completed=0,
                n_rejected=self.n_rejected, sla_attainment=0.0,
                mean_accuracy=0.0, mean_latency=0.0, p50_latency=0.0,
                p99_latency=0.0, mean_queue_wait=0.0, p99_queue_wait=0.0,
                peak_queue_depth=self.peak_depth, model_usage={},
                replica_utilization=dict(self.util),
                horizon_ms=self.horizon, n_retries=self.n_retries)
        e2e = np.concatenate(self.e2e)
        wait = np.concatenate(self.wait)
        acc = np.concatenate(self.acc)
        return LoadSimResult(
            policy=self._policy, t_sla=t_sla,
            n_arrived=self.n_arrived, n_completed=self.n_completed,
            n_rejected=self.n_rejected,
            sla_attainment=self.met / max(self.n_arrived, 1),
            mean_accuracy=float(acc.mean()),
            mean_latency=float(e2e.mean()),
            p50_latency=float(np.percentile(e2e, 50)),
            p99_latency=float(np.percentile(e2e, 99)),
            p95_latency=float(np.percentile(e2e, 95)),
            mean_queue_wait=float(wait.mean()),
            p99_queue_wait=float(np.percentile(wait, 99)),
            p95_queue_wait=float(np.percentile(wait, 95)),
            peak_queue_depth=self.peak_depth,
            model_usage={k: v / self.n_completed
                         for k, v in sorted(self.usage.items())},
            replica_utilization=dict(self.util),
            horizon_ms=self.horizon,
            n_retries=self.n_retries)
