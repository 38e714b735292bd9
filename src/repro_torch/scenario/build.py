"""Compile a :class:`~repro_torch.scenario.spec.Scenario` into runnable
harnesses over the three entry points.

``build(scenario)`` returns a :class:`ScenarioHarness`; the factory
functions it rides (``build_engine`` / ``build_closed_loop`` /
``build_executor``) are also what the entry points' ``from_scenario``
adapters delegate to, so the declarative spec and the historical kwargs
construct *identical* objects — a steady/Poisson scenario matching the
seeded engine goldens reproduces them bit-identically.

``ScenarioHarness.run()`` executes the whole scenario: single-epoch
scenarios are one engine run; multi-epoch scenarios carry the profile
store across epochs, slice the workload (rate schedule, or an even split
of a synthesized trace), and — when the deployment declares an
:class:`~repro_torch.scenario.spec.AutoscalerSpec` — let the
:class:`~repro_torch.scenario.autoscale.QueueTargetAutoscaler` resize the
replica pool between epochs from the previous epoch's ``Router.stats()``
window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import Policy, make_policy
from repro_torch.core.profiles import ModelProfile
from repro_torch.core.zoo import PROTOTYPE_POOL, TABLE2, ZooEntry, make_store
from repro_torch.router.admission import AdmissionController, make_admission
from repro_torch.router.retry import RetryPolicy
from repro_torch.scenario.autoscale import QueueTargetAutoscaler
from repro_torch.scenario.spec import Scenario
from repro_torch.sim.faults import (FaultEvent, LatencyDrift, NetworkDrift,
                              ReplicaFault)
from repro_torch.sim.arrivals import (ArrivalProcess, ClosedLoopArrivals,
                                PoissonArrivals, TraceArrivals, burst_trace,
                                diurnal_trace)
from repro_torch.sim.replica import (ReplicaPool, per_model_replicas,
                               shared_replicas)

# Class labels are assigned from a seed stream decoupled from the
# engine's, so a labelled run replays the same service/network draws.
_CLASS_SEED_SALT = 0x5C3
# Likewise for synthesized arrival traces: an unsalted seed would feed
# the thinning sampler and the engine the *same* PCG64 stream,
# correlating inter-arrival gaps with network/service noise.
_TRACE_SEED_SALT = 0xA221
# And for input-class/feature assignment (the premodel workload mix):
# its own stream keeps classed runs replaying the same arrival,
# network and service draws as their unclassed twins.
_INPUT_SEED_SALT = 0x1C7F


# ----------------------------------------------------------------------
# leaf factories
# ----------------------------------------------------------------------

def build_entries(scenario: Scenario) -> List[ZooEntry]:
    dep = scenario.deployment
    zoo = list(TABLE2 if dep.zoo == "table2" else PROTOTYPE_POOL)
    if not dep.subset:
        return zoo
    by_name = {e.name: e for e in zoo}
    missing = [n for n in dep.subset if n not in by_name]
    if missing:
        raise ValueError(f"subset names {missing} not in the {dep.zoo} zoo "
                         f"(members: {sorted(by_name)})")
    return [by_name[n] for n in dep.subset]


def build_network(scenario: Scenario) -> NetworkModel:
    net = scenario.network
    return NetworkModel(net.mean_ms, net.std_ms, net.floor_ms)


def build_policy(scenario: Scenario) -> Policy:
    return make_policy(scenario.policy.policy, **scenario.policy.kwargs)


def build_admission(scenario: Scenario) -> Optional[AdmissionController]:
    dep = scenario.deployment
    if dep.admission == "none":
        return None             # Router defaults to AdmitAll
    return make_admission(dep.admission, **dep.admission_kwargs)


def build_replicas(scenario: Scenario,
                   n_replicas: Optional[int] = None) -> ReplicaPool:
    dep = scenario.deployment
    n = dep.replicas if n_replicas is None else n_replicas
    if dep.topology == "shared":
        # Explicit speeds only make sense at the declared count; an
        # autoscaler-resized pool falls back to homogeneous replicas.
        speeds = list(dep.speeds) if (dep.speeds and n == dep.replicas) \
            else None
        return shared_replicas(n, speeds=speeds,
                               max_queue_depth=dep.max_queue_depth)
    return per_model_replicas(build_entries(scenario),
                              replicas_per_model=n,
                              max_queue_depth=dep.max_queue_depth)


def build_faults(scenario: Scenario) -> List[FaultEvent]:
    """Compile the deployment's declarative fault/drift specs into the
    engine's ``sim.faults`` records, sorted by fire time."""
    dep = scenario.deployment
    out: List[FaultEvent] = []
    for f in dep.faults:
        out.append(ReplicaFault(at_ms=f.at_ms, kind=f.kind,
                                replica=f.replica, factor=f.factor))
    for s in dep.drifts:
        if s.kind == "latency":
            out.append(LatencyDrift(at_ms=s.at_ms, model=s.model,
                                    mu_mult=s.mu_mult,
                                    sigma_mult=s.sigma_mult))
        else:
            out.append(NetworkDrift(at_ms=s.at_ms, rtt_mult=s.rtt_mult))
    out.sort(key=lambda e: e.at_ms)
    return out


def build_retry(scenario: Scenario) -> Optional[RetryPolicy]:
    r = scenario.deployment.retry
    if r is None:
        return None
    return RetryPolicy(max_attempts=r.max_attempts,
                       reroute_on_overrun=r.reroute_on_overrun,
                       overrun_margin_ms=r.overrun_margin_ms)


def build_arrival_times(scenario: Scenario) -> Optional[np.ndarray]:
    """Full-run timestamps for trace-shaped workloads (trace / diurnal /
    burst); None for the generative processes (poisson / closed_loop)."""
    wl = scenario.workload
    if wl.arrival == "trace":
        return np.asarray(wl.times_ms, dtype=np.float64)
    if wl.arrival == "diurnal":
        return np.asarray(diurnal_trace(
            wl.n_requests, wl.rate_rps, period_ms=wl.period_ms,
            amplitude=wl.amplitude,
            seed=scenario.seed ^ _TRACE_SEED_SALT).times_ms)
    if wl.arrival == "burst":
        return np.asarray(burst_trace(
            wl.n_requests, wl.rate_rps, burst_rate_rps=wl.burst_rate_rps,
            burst_every_ms=wl.burst_every_ms, burst_len_ms=wl.burst_len_ms,
            seed=scenario.seed ^ _TRACE_SEED_SALT).times_ms)
    return None


# ----------------------------------------------------------------------
# entry-point adapters (the from_scenario implementations)
# ----------------------------------------------------------------------

def build_elastic(scenario: Scenario):
    """Compile the deployment's ``AutoscalerSpec`` into the engine's
    ``sim.elastic.ElasticConfig`` — None when there is no autoscaler or
    its ``control_interval_ms`` is 0 (the epoch-boundary degenerate
    path, which builds no engine-side controller at all and so keeps
    those goldens bit-identical)."""
    asc = scenario.deployment.autoscaler
    if asc is None or asc.control_interval_ms == 0.0:
        return None
    from repro_torch.sim.elastic import ElasticConfig
    return ElasticConfig(
        kind=asc.kind, control_interval_ms=asc.control_interval_ms,
        cold_start_ms=asc.cold_start_ms,
        target_queue_ms=asc.target_queue_ms,
        max_shed_rate=asc.max_shed_rate,
        max_fallback_rate=asc.max_fallback_rate,
        min_replicas=asc.min_replicas, max_replicas=asc.max_replicas,
        step=asc.step, low_utilization=asc.low_utilization,
        cost_per_replica_s=asc.cost_per_replica_s)


def build_engine(scenario: Scenario, *, n_replicas: Optional[int] = None,
                 seed: Optional[int] = None):
    """Scenario -> ``sim.engine.ServingSimulator`` (any workload)."""
    from repro_torch.sim.engine import ServingSimulator
    pol = scenario.policy
    dep = scenario.deployment
    return ServingSimulator(
        build_entries(scenario), build_network(scenario),
        build_replicas(scenario, n_replicas),
        seed=scenario.seed if seed is None else seed,
        alpha=pol.alpha, cold_age=pol.cold_age, cold_probe=pol.cold_probe,
        spike_prob=dep.spike_prob, spike_mult=dep.spike_mult,
        queue_aware=pol.queue_aware, admission=build_admission(scenario),
        batch_window_ms=dep.batch_window_ms, backend=pol.backend,
        faults=build_faults(scenario), retry=build_retry(scenario),
        elastic=build_elastic(scenario))


def build_closed_loop(scenario: Scenario):
    """Scenario -> ``core.simulate.Simulator`` (closed-loop workloads)."""
    from repro_torch.core.simulate import Simulator
    if scenario.workload.arrival != "closed_loop":
        raise ValueError(
            "core.simulate.Simulator replays the paper's closed loop; "
            f"scenario {scenario.name!r} has "
            f"arrival={scenario.workload.arrival!r} — build the "
            "discrete-event engine for open-loop workloads")
    pol = scenario.policy
    dep = scenario.deployment
    return Simulator(
        entries=build_entries(scenario), network=build_network(scenario),
        seed=scenario.seed, alpha=pol.alpha, cold_age=pol.cold_age,
        cold_probe=pol.cold_probe, spike_prob=dep.spike_prob,
        spike_mult=dep.spike_mult, admission=build_admission(scenario))


def build_executor(scenario: Scenario, variants, **overrides):
    """Scenario -> ``serving.executor.PoolExecutor`` over a real pool."""
    from repro_torch.serving.executor import PoolExecutor
    pol = scenario.policy
    kw = dict(seed=scenario.seed, alpha=pol.alpha,
              queue_aware=pol.queue_aware,
              admission=build_admission(scenario), backend=pol.backend)
    kw.update(overrides)
    return PoolExecutor(list(variants), build_network(scenario),
                        build_policy(scenario), **kw)


# ----------------------------------------------------------------------
# the runnable harness
# ----------------------------------------------------------------------

@dataclass
class EpochResult:
    """One epoch of a scenario run."""
    epoch: int
    n_replicas: int
    result: object               # sim.engine.LoadSimResult
    router_stats: dict


@dataclass
class ScenarioResult:
    """A full scenario run: per-epoch results plus pooled headlines."""
    scenario: Scenario
    epochs: List[EpochResult] = field(default_factory=list)
    # The full FleetResult when the scenario ran on the multi-cell
    # fleet engine (spill counters, per-cell slices); None for the
    # single-cell path.
    fleet: Optional[object] = None

    @property
    def result(self):
        """The last epoch's engine result (the whole run when
        single-epoch)."""
        return self.epochs[-1].result

    @property
    def replica_history(self) -> List[int]:
        return [e.n_replicas for e in self.epochs]

    @property
    def attainment_history(self) -> List[float]:
        return [e.result.sla_attainment for e in self.epochs]

    @property
    def sla_attainment(self) -> float:
        """Arrival-weighted attainment across epochs."""
        return self._pooled("sla_attainment", "n_arrived")

    # Latency/accuracy/queue statistics only cover completed requests,
    # so their run-level pooling weights by completions.
    @property
    def mean_latency(self) -> float:
        return self._pooled("mean_latency", "n_completed")

    @property
    def mean_accuracy(self) -> float:
        return self._pooled("mean_accuracy", "n_completed")

    @property
    def mean_queue_wait(self) -> float:
        return self._pooled("mean_queue_wait", "n_completed")

    def _pooled(self, attr: str, weight: str) -> float:
        n = sum(getattr(e.result, weight) for e in self.epochs)
        return sum(getattr(e.result, attr) * getattr(e.result, weight)
                   for e in self.epochs) / max(n, 1)


class ScenarioHarness:
    """A compiled scenario: entry-point factories plus ``run()``."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self._class_names, self._class_slas, self._class_ids = \
            self._assign_classes()
        self._input_ids, self._input_feats, self._input_scales = \
            self._assign_input_classes()
        # Synthesized diurnal/burst traces are per-run constants; render
        # once here instead of re-thinning per epoch.
        self._times = build_arrival_times(scenario)

    # -- per-request SLA-class assignment ------------------------------
    def _assign_classes(self):
        wl = self.scenario.workload
        if not wl.classes:
            return (), np.empty(0), np.empty(0, dtype=np.int64)
        names = tuple(c.name for c in wl.classes)
        slas = np.array([c.t_sla_ms for c in wl.classes])
        w = np.array([c.weight for c in wl.classes])
        rng = np.random.default_rng(self.scenario.seed ^ _CLASS_SEED_SALT)
        ids = rng.choice(len(names), size=wl.n_requests, p=w / w.sum())
        return names, slas, ids

    def sla_for(self, offset: int = 0) -> Optional[Callable[[int], float]]:
        """Per-request SLA override from the class mix (None without
        one).  ``offset`` re-bases request ids for epoch slices."""
        if not self._class_names:
            return None
        return lambda rid: float(self._class_slas[
            self._class_ids[offset + rid]])

    def class_for(self, offset: int = 0) -> Optional[Callable[[int], str]]:
        if not self._class_names:
            return None
        return lambda rid: self._class_names[self._class_ids[offset + rid]]

    # -- per-request input-class assignment (the premodel workload) ----
    def _assign_input_classes(self):
        wl = self.scenario.workload
        if not wl.input_classes:
            return (np.empty(0, dtype=np.int64), np.empty((0, 0)),
                    np.empty(0))
        w = np.array([c.weight for c in wl.input_classes])
        centers = np.array([c.feature_center for c in wl.input_classes],
                           dtype=np.float64)
        noise = np.array([c.feature_noise for c in wl.input_classes])
        scales = np.array([c.latency_scale for c in wl.input_classes])
        rng = np.random.default_rng(self.scenario.seed ^ _INPUT_SEED_SALT)
        ids = rng.choice(len(w), size=wl.n_requests, p=w / w.sum())
        feats = centers[ids] + noise[ids, None] * rng.standard_normal(
            (wl.n_requests, centers.shape[1]))
        return ids, feats, scales[ids]

    def input_features(self, offset: int, n: int) -> Optional[np.ndarray]:
        """This epoch slice's (n, d) feature rows (None without an
        input-class mix)."""
        if not len(self._input_ids):
            return None
        return self._input_feats[offset:offset + n]

    def service_scales(self, offset: int, n: int) -> Optional[np.ndarray]:
        """This epoch slice's true per-request service-time multipliers
        (None without an input-class mix)."""
        if not len(self._input_ids):
            return None
        return self._input_scales[offset:offset + n]

    def premodel(self):
        """A fresh premodel classifier per run (None when the policy
        says "none").  Carried across epochs by ``run()`` like the
        profile store, so what it learned keeps paying off."""
        pol = self.scenario.policy
        wl = self.scenario.workload
        if pol.premodel == "none" or not wl.input_classes:
            return None
        from repro_torch.premodel import make_classifier
        centers = tuple(c.feature_center for c in wl.input_classes)
        return make_classifier(pol.premodel, len(wl.input_classes),
                               len(centers[0]), centers=centers)

    # -- entry-point factories -----------------------------------------
    def engine(self, n_replicas: Optional[int] = None,
               seed: Optional[int] = None):
        return build_engine(self.scenario, n_replicas=n_replicas, seed=seed)

    def closed_loop(self):
        return build_closed_loop(self.scenario)

    def executor(self, variants, **overrides):
        return build_executor(self.scenario, variants, **overrides)

    def store(self):
        pol = self.scenario.policy
        wl = self.scenario.workload
        entries = build_entries(self.scenario)
        q = pol.latency_quantile
        if pol.premodel != "none" and wl.input_classes:
            from repro_torch.premodel import ConditionalProfileStore
            store = ConditionalProfileStore(
                [ModelProfile(name=e.name, accuracy=e.top1 / 100.0)
                 for e in entries],
                n_classes=len(wl.input_classes), q=q,
                alpha=pol.alpha, cold_age=pol.cold_age)
        elif q is not None:
            from repro_torch.premodel import QuantileProfileStore
            store = QuantileProfileStore(
                [ModelProfile(name=e.name, accuracy=e.top1 / 100.0)
                 for e in entries],
                q=q, alpha=pol.alpha, cold_age=pol.cold_age)
        else:
            return make_store(entries, alpha=pol.alpha,
                              cold_age=pol.cold_age, warm=pol.warm,
                              profile=pol.profile, window=pol.window,
                              stale_after=pol.stale_after,
                              explore_bonus=pol.explore_bonus)
        if pol.warm:
            # Same 1000-request warm-up as make_store: the trackers stay
            # cold, so quantile presentation starts at the Gaussian
            # μ + z_q·σ of the seeded truth and hands over to measured
            # quantiles as observations arrive.
            for e in entries:
                p = store[e.name]
                p.mu = e.mu_ms
                p.var = e.sigma_ms ** 2
                p.n_obs = 1000
            store.invalidate()
        return store

    # -- workload slicing ----------------------------------------------
    def epoch_sizes(self) -> List[int]:
        wl = self.scenario.workload
        base, extra = divmod(wl.n_requests, wl.epochs)
        return [base + (1 if e < extra else 0) for e in range(wl.epochs)]

    def arrivals(self, epoch: int = 0) -> ArrivalProcess:
        """The arrival process for one epoch (the whole run when
        single-epoch)."""
        wl = self.scenario.workload
        if wl.arrival == "closed_loop":
            return ClosedLoopArrivals(think_ms=wl.think_ms)
        if wl.arrival == "poisson":
            rate = (wl.rate_schedule[epoch] if wl.rate_schedule
                    else wl.rate_rps)
            return PoissonArrivals(rate)
        times = self._times
        sizes = self.epoch_sizes()
        lo = sum(sizes[:epoch])
        chunk = times[lo:lo + sizes[epoch]]
        # Each epoch replays its slice from t=0: epochs are consecutive
        # observation windows, not one shared timeline.
        return TraceArrivals(chunk - chunk[0])

    # -- execution -----------------------------------------------------
    def run(self) -> ScenarioResult:
        """Run the scenario end to end on the discrete-event engine."""
        sc = self.scenario
        wl = sc.workload
        fl = sc.deployment.fleet
        if fl is not None and (fl.n_cells > 1 or fl.trace_path):
            # Multi-cell (or trace-replaying) fleets run on the fleet
            # engine; a 1-cell generative fleet stays on this path —
            # that is the bit-identity guarantee the parity golden pins.
            from repro_torch.fleet.engine import FleetEngine
            return FleetEngine(sc).run().as_scenario_result()
        policy = build_policy(sc)
        store = self.store()
        premodel = self.premodel()
        asc = sc.deployment.autoscaler
        # Epoch-boundary autoscaling only when there is no mid-run
        # controller: with control_interval_ms > 0 the engine's own
        # elastic tick owns the pool size, and the harness merely
        # carries the committed count into the next epoch's engine.
        mid_run = asc is not None and asc.control_interval_ms > 0.0
        scaler = (QueueTargetAutoscaler(asc)
                  if asc is not None and not mid_run else None)
        n_replicas = sc.deployment.replicas
        out = ScenarioResult(scenario=sc)
        offset = 0
        for epoch, n_epoch in enumerate(self.epoch_sizes()):
            # Epoch 0 runs at the scenario seed (bit-identical to the
            # equivalent single-epoch run); later epochs shift it so the
            # windows draw fresh network/service noise.
            eng = self.engine(n_replicas=n_replicas,
                              seed=sc.seed + epoch)
            res = eng.run(policy, wl.t_sla_ms, n_epoch,
                          arrivals=self.arrivals(epoch),
                          warm=sc.policy.warm, store=store,
                          sla_for=self.sla_for(offset),
                          class_for=self.class_for(offset),
                          feature_for=self.input_features(offset, n_epoch),
                          premodel=premodel,
                          service_scale_for=self.service_scales(
                              offset, n_epoch))
            stats = eng.router.stats()
            out.epochs.append(EpochResult(epoch=epoch, n_replicas=n_replicas,
                                          result=res, router_stats=stats))
            if scaler is not None:
                n_replicas = scaler.decide(n_replicas, stats, res)
            elif mid_run:
                n_replicas = min(max(eng.committed_replica_count(),
                                     asc.min_replicas), asc.max_replicas)
            offset += n_epoch
        return out


def build(scenario: Scenario) -> ScenarioHarness:
    """Compile a scenario; ``Scenario.build()`` delegates here."""
    return ScenarioHarness(scenario)
