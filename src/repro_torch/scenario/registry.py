"""Named-scenario registry: the library of declarative experiments.

``register()`` any :class:`~repro_torch.scenario.spec.Scenario` under its
name; ``get_scenario()`` / ``list_scenarios()`` look them up.  The
built-ins cover the shapes the ROADMAP calls for, and every one is run
at toy scale by ``benchmarks/run.py --smoke`` (tier-1's bit-rot guard)
and at full scale by ``benchmarks/scenario_suite.py``:

- ``steady`` — open-loop Poisson at a rate the pool absorbs; the
  config mirrors the seeded queue-aware engine golden, so the Scenario
  path is pinned bit-identical to the historical kwargs path;
- ``diurnal`` — sinusoidal day/night load through the diurnal trace
  synthesizer: the pool is sized for the valley, the peak exercises
  queue-aware spreading;
- ``burst`` — flash-crowd square wave with SLA-aware admission:
  shed-vs-degrade under a 20x load spike;
- ``class_mix`` — interactive/batch SLA mix under overload with
  class-aware admission: weighted shedding protects the interactive
  class at the batch class's expense;
- ``scale_up`` — a 10x load step under a queue-target autoscaler: SLA
  attainment collapses at the step and recovers as replicas are added,
  with no manual pool edits;
- ``elastic_step`` / ``elastic_proportional`` / ``elastic_cost_weighted``
  — the same 10x step under *mid-run* controllers ticking on the event
  queue (``sim.elastic``): cold-start-paying provisioning, drain-based
  scale-in, and the SLA-vs-replica-seconds frontier swept by
  ``benchmarks/elastic_controllers.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.scenario.spec import (AutoscalerSpec, DeploymentSpec, DriftSpec,
                                 FaultSpec, InputClassSpec, NetworkSpec,
                                 PolicySpec, RetrySpec, Scenario, SlaClass,
                                 WorkloadSpec)

_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario, *, replace: bool = False) -> Scenario:
    """Add a scenario under its name; re-registration requires
    ``replace=True`` (guards against accidental shadowing)."""
    if scenario.name in _REGISTRY and not replace:
        raise ValueError(f"scenario {scenario.name!r} already registered "
                         "(pass replace=True to overwrite)")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(registered: {', '.join(sorted(_REGISTRY))})")


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# ----------------------------------------------------------------------
# built-ins
# ----------------------------------------------------------------------

# The load-sweep network model used by every serving benchmark.
_NET = NetworkSpec(mean_ms=50.0, std_ms=25.0)

# Mirrors the seeded golden `test_golden_queue_aware_open_loop_unchanged`
# (engine kwargs: seed=3, per-model replicas, queue-aware ModiPick,
# Poisson 30 rps, 600 requests, 250 ms SLA) — the round-trip test pins
# the Scenario path bit-identical to it.
register(Scenario(
    name="steady",
    workload=WorkloadSpec(arrival="poisson", rate_rps=30.0,
                          n_requests=600, t_sla_ms=250.0),
    network=_NET,
    deployment=DeploymentSpec(topology="per_model"),
    policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                      queue_aware=True),
    seed=3))

register(Scenario(
    name="diurnal",
    workload=WorkloadSpec(arrival="diurnal", rate_rps=12.0,
                          period_ms=20_000.0, amplitude=0.9,
                          n_requests=1500, t_sla_ms=250.0),
    network=_NET,
    deployment=DeploymentSpec(topology="per_model"),
    policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                      queue_aware=True),
    seed=5))

register(Scenario(
    name="burst",
    workload=WorkloadSpec(arrival="burst", rate_rps=4.0,
                          burst_rate_rps=80.0, burst_every_ms=10_000.0,
                          burst_len_ms=1_500.0, n_requests=1500,
                          t_sla_ms=250.0),
    network=_NET,
    deployment=DeploymentSpec(topology="per_model", admission="sla_aware"),
    policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                      queue_aware=True),
    seed=5))

# One shared replica at 60 rps is genuinely saturated.  Class-blind
# admission sheds the *interactive* class first (its tighter budget goes
# non-viable first); class-aware weighted shedding inverts that — batch
# (protect 0.35) drains early, interactive keeps most of its attainment.
register(Scenario(
    name="class_mix",
    workload=WorkloadSpec(
        arrival="poisson", rate_rps=60.0, n_requests=1500, t_sla_ms=250.0,
        classes=(SlaClass("interactive", t_sla_ms=250.0, weight=0.5),
                 SlaClass("batch", t_sla_ms=400.0, weight=0.5))),
    network=_NET,
    deployment=DeploymentSpec(
        topology="shared", replicas=1,
        admission="class_aware",
        admission_kwargs={"classes": {
            "interactive": {"protect": 1.0},
            "batch": {"protect": 0.35, "max_share": 0.6},
        }}),
    policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                      queue_aware=True),
    seed=7))

register(Scenario(
    name="scale_up",
    workload=WorkloadSpec(arrival="poisson", rate_rps=4.0,
                          rate_schedule=(4.0, 40.0, 40.0, 40.0, 40.0),
                          epochs=5, n_requests=2000, t_sla_ms=250.0),
    network=_NET,
    deployment=DeploymentSpec(
        topology="shared", replicas=1,
        autoscaler=AutoscalerSpec(target_queue_ms=25.0, max_shed_rate=0.02,
                                  min_replicas=1, max_replicas=8, step=2)),
    policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                      queue_aware=True),
    seed=9))


# ----------------------------------------------------------------------
# the elastic family (mid-run controllers on the event queue)
# ----------------------------------------------------------------------

def elastic_scenario(*, kind: str = "proportional",
                     control_interval_ms: float = 1_000.0,
                     cold_start_ms: float = 500.0,
                     target_queue_ms: float = 25.0,
                     cost_per_replica_s: float = 0.0,
                     n_requests: int = 2000, epochs: int = 5,
                     seed: int = 9, name: Optional[str] = None) -> Scenario:
    """The ``scale_up`` 10x load step under a MID-RUN elastic controller
    (``sim.elastic``): identical workload shape, network, policy and
    seed as the epoch-boundary ``scale_up`` registry entry, so the two
    paths are an apples-to-apples comparison — same arrival draws, only
    the control law differs.  The controller ticks every
    ``control_interval_ms`` inside each epoch, scale-up pays
    ``cold_start_ms`` per WARMING replica, and scale-in drains before
    decommissioning (zero in-flight requests lost)."""
    return Scenario(
        name=name or f"elastic_{kind}",
        workload=WorkloadSpec(
            arrival="poisson", rate_rps=4.0,
            rate_schedule=(4.0,) + (40.0,) * (epochs - 1),
            epochs=epochs, n_requests=n_requests, t_sla_ms=250.0),
        network=_NET,
        deployment=DeploymentSpec(
            topology="shared", replicas=1,
            autoscaler=AutoscalerSpec(
                target_queue_ms=target_queue_ms, max_shed_rate=0.02,
                min_replicas=1, max_replicas=8, step=2,
                kind=kind, control_interval_ms=control_interval_ms,
                cold_start_ms=cold_start_ms,
                cost_per_replica_s=cost_per_replica_s)),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True),
        seed=seed)


register(elastic_scenario(kind="step", name="elastic_step"))
register(elastic_scenario(kind="proportional", name="elastic_proportional"))
register(elastic_scenario(kind="cost_weighted", cost_per_replica_s=0.5,
                          name="elastic_cost_weighted"))


# ----------------------------------------------------------------------
# the drift/faulty family (fault injection & drift resilience)
# ----------------------------------------------------------------------

# A tight (low-variance) uplink so the drift experiment's budget is
# sharp: 2·40 = 80 ms of network under a 250 ms SLA leaves a 170 ms
# budget — NasNet-Large (μ 112.61) fits, its 2x-drifted self (225.22)
# does not, and a drifted pick's true e2e (~305 ms) is a certain miss.
_DRIFT_NET = NetworkSpec(mean_ms=40.0, std_ms=10.0)


def drift_scenario(*, mu_mult: float = 2.0, profile: str = "window",
                   n_requests: int = 2400, rate_rps: float = 12.0,
                   drift_at_ms: float = 40_000.0,
                   recover_at_ms: float = 120_000.0,
                   window: int = 64, stale_after: int = 250,
                   seed: int = 11, name: Optional[str] = None) -> Scenario:
    """Mid-run latency drift on the most accurate model, with recovery.

    NasNet-Large's true μ is multiplied by ``mu_mult`` at
    ``drift_at_ms`` and restored at ``recover_at_ms``.  Replicas are
    per-model and plentiful (queue waits ~0), so the *only* signal that
    the world changed is the observed inference latency — exactly the
    telemetry a profile estimator owns.  ``profile`` picks the arm:
    ``"window"`` (self-healing sliding window + staleness exploration)
    recovers; ``"frozen"`` (the ablation) keeps routing on the seeded
    profile and stays degraded.  Cold probing is off so re-discovery is
    attributable to the staleness bonus alone.
    """
    return Scenario(
        name=name or f"drift_{profile}",
        workload=WorkloadSpec(arrival="poisson", rate_rps=rate_rps,
                              n_requests=n_requests, t_sla_ms=250.0),
        network=_DRIFT_NET,
        deployment=DeploymentSpec(
            topology="per_model", replicas=4,
            drifts=(DriftSpec(kind="latency", at_ms=drift_at_ms,
                              model="NasNet-Large", mu_mult=mu_mult),
                    DriftSpec(kind="latency", at_ms=recover_at_ms,
                              model="NasNet-Large", mu_mult=1.0)),
            retry=RetrySpec(max_attempts=2)),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True, cold_probe=False,
                          profile=profile, window=window,
                          stale_after=stale_after),
        seed=seed)


def faulty_scenario(*, retry: bool = True, n_requests: int = 1500,
                    rate_rps: float = 15.0,
                    kill_at_ms: float = 20_000.0,
                    revive_at_ms: float = 60_000.0,
                    degrade_at_ms: float = 45_000.0,
                    degrade_factor: float = 2.5,
                    recover_at_ms: float = 75_000.0,
                    seed: int = 13, name: Optional[str] = None) -> Scenario:
    """Replica-lifecycle churn on a shared pool: one replica killed
    mid-run (its in-flight and queued requests hit the recovery path),
    a second degraded, both eventually restored.  ``retry=False``
    disables the recovery path — the victims are simply rejected
    (the retry-ablation arm)."""
    return Scenario(
        name=name or ("faulty" if retry else "faulty_noretry"),
        workload=WorkloadSpec(arrival="poisson", rate_rps=rate_rps,
                              n_requests=n_requests, t_sla_ms=250.0),
        network=_DRIFT_NET,
        deployment=DeploymentSpec(
            topology="shared", replicas=3,
            admission="sla_aware",
            faults=(FaultSpec(kind="kill", replica="r0", at_ms=kill_at_ms),
                    FaultSpec(kind="degrade", replica="r1",
                              at_ms=degrade_at_ms, factor=degrade_factor),
                    FaultSpec(kind="recover", replica="r0",
                              at_ms=revive_at_ms),
                    FaultSpec(kind="recover", replica="r1",
                              at_ms=recover_at_ms)),
            retry=RetrySpec(max_attempts=3) if retry else None),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True),
        seed=seed)


register(drift_scenario(name="drift"))
register(drift_scenario(profile="frozen", name="drift_frozen"))
register(faulty_scenario(name="faulty"))


# ----------------------------------------------------------------------
# the fleet family (sharded multi-cell serving)
# ----------------------------------------------------------------------

def fleet_scenario(*, n_cells: int = 4, rate_rps: float = 120.0,
                   n_requests: int = 20_000, rtt_ms: float = 40.0,
                   spill: bool = True, spill_threshold_ms: float = 0.0,
                   replicas: int = 1, subset: tuple = (),
                   trace_path: str = "",
                   rotate_phases: bool = False,
                   weights: Optional[tuple] = None,
                   epoch_ms: float = 10_000.0, period_ms: float = 60_000.0,
                   t_sla_ms: float = 250.0, seed: int = 17,
                   name: Optional[str] = None) -> Scenario:
    """A multi-cell fleet over the steady per-model deployment.

    ``rate_rps`` is the FLEET-wide offered load; each cell receives its
    weighted share on its own arrival timeline.  ``rotate_phases``
    spreads the cells' diurnal peaks evenly around the day (cell i at
    phase i/n — the time-zone ring), which only matters with a
    ``trace_path`` or diurnal workload.  ``spill_threshold_ms`` arms
    load-triggered spill on top of the default no-viable-variant
    trigger."""
    from repro_torch.fleet.spec import CellSpec, FleetSpec
    w = weights if weights is not None else (1.0,) * n_cells
    cells = tuple(
        CellSpec(name=f"cell{i}", weight=w[i],
                 phase=(i / n_cells) if rotate_phases else 0.0)
        for i in range(n_cells))
    return Scenario(
        name=name or f"fleet_{n_cells}cell",
        workload=WorkloadSpec(arrival="poisson", rate_rps=rate_rps,
                              n_requests=n_requests, t_sla_ms=t_sla_ms,
                              period_ms=period_ms),
        network=_NET,
        deployment=DeploymentSpec(
            topology="per_model", replicas=replicas, subset=subset,
            fleet=FleetSpec(cells=cells, rtt_ms=rtt_ms, spill=spill,
                            spill_threshold_ms=spill_threshold_ms,
                            epoch_ms=epoch_ms, trace_path=trace_path)),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True),
        seed=seed)


# ----------------------------------------------------------------------
# the premodel family (input-conditional profiles & tail-SLA budgets)
# ----------------------------------------------------------------------

def premodel_scenario(*, premodel: str = "centroid",
                      easy_scale: float = 0.25, hard_scale: float = 3.0,
                      easy_weight: float = 0.5, feature_noise: float = 0.2,
                      n_requests: int = 4000, rate_rps: float = 12.0,
                      t_sla_ms: float = 250.0, seed: int = 23,
                      name: Optional[str] = None) -> Scenario:
    """Heterogeneous-difficulty inputs under one SLA: half the requests
    are easy (true service = ``easy_scale`` x the model's draw), half
    hard (``hard_scale`` x), separable by a cheap 1-D feature.

    The tight uplink (2·40 = 80 ms under a 250 ms SLA) leaves a 170 ms
    budget.  Unconditional profiles see each model as the bimodal
    mixture — the inflated spread pushes every accurate model out of
    eligibility and the router converges to one mid-tier compromise for
    *everyone*.  With ``premodel="centroid"`` (or the ``"oracle"``
    ablation) the conditional store routes easy inputs to the most
    accurate model while hard inputs keep the mid-tier pick — strictly
    more accuracy at the same attainment.  ``premodel="none"`` is the
    unconditional arm over the *identical* workload (same salted
    class/feature/scale assignment, same arrival and service draws)."""
    return Scenario(
        name=name or f"premodel_{premodel}",
        workload=WorkloadSpec(
            arrival="poisson", rate_rps=rate_rps, n_requests=n_requests,
            t_sla_ms=t_sla_ms,
            input_classes=(
                InputClassSpec("easy", weight=easy_weight,
                               latency_scale=easy_scale,
                               feature_center=(0.0,),
                               feature_noise=feature_noise),
                InputClassSpec("hard", weight=1.0 - easy_weight,
                               latency_scale=hard_scale,
                               feature_center=(1.0,),
                               feature_noise=feature_noise))),
        network=_DRIFT_NET,
        deployment=DeploymentSpec(topology="per_model", replicas=2),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True, premodel=premodel),
        seed=seed)


def tail_sla_scenario(*, quantile: Optional[float] = 0.95,
                      spike_prob: float = 0.2, spike_mult: float = 3.5,
                      n_requests: int = 3000, rate_rps: float = 15.0,
                      t_sla_ms: float = 250.0, seed: int = 29,
                      name: Optional[str] = None) -> Scenario:
    """Co-tenant latency spikes vs the budget the router believes.

    A fifth of inferences run 3.5x slow — far more probability mass
    than a p95 budget tolerates.  The mean arm (``quantile=None``)
    keeps spiky mid-heavy models eligible (their EWMA mean + σ still
    fits the 170 ms budget) and eats a tail of certain SLA misses; the
    quantile arm presents each model's streaming p95, which lands in
    the spike region and excludes exactly the models whose spikes
    cannot fit — buying back the tail attainment."""
    return Scenario(
        name=name or ("tail_sla" if quantile is not None
                      else "tail_sla_mean"),
        workload=WorkloadSpec(arrival="poisson", rate_rps=rate_rps,
                              n_requests=n_requests, t_sla_ms=t_sla_ms),
        network=_DRIFT_NET,
        deployment=DeploymentSpec(topology="per_model", replicas=2,
                                  spike_prob=spike_prob,
                                  spike_mult=spike_mult),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0},
                          queue_aware=True, latency_quantile=quantile),
        seed=seed)


register(premodel_scenario(name="premodel_mix"))
register(tail_sla_scenario(name="tail_sla"))
register(tail_sla_scenario(quantile=None, name="tail_sla_mean"))


# Balanced 4-cell fleet at the steady per-cell operating point (each
# cell sees ~30 rps — the seeded golden's load): the healthy baseline.
register(fleet_scenario(n_cells=4, rate_rps=120.0, n_requests=20_000,
                        seed=17, name="fleet_steady"))

# Six time zones replaying the same recorded day (Azure-Functions-style
# rate trace, peak ≈ 2.1× mean), peaks rotated 4 h apart.  Cells run a
# mid/heavy zoo slice sized for the *valley* (≈144 rps capacity vs a
# ≈180 rps peak), so at any instant the cell at local evening runs hot
# while the antipodal cells idle — the shape cross-cell spill exists
# for.  Load-triggered spill is armed at a 40 ms queue-wait signal.
register(fleet_scenario(n_cells=6, rate_rps=510.0, n_requests=30_000,
                        subset=("DenseNet", "NasNet-Mobile", "InceptionV3",
                                "InceptionV4", "NasNet-Large"),
                        trace_path="examples/azure_functions_day.csv",
                        rotate_phases=True, spill_threshold_ms=40.0,
                        epoch_ms=5_000.0, seed=19, name="fleet_diurnal"))
