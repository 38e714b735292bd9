"""The declarative Scenario spec: one plain-data tree describing an
entire ModiPick experiment.

Every experiment in this repo used to be wired by hand — a dozen kwargs
spread over three entry points (``core.simulate.Simulator``,
``sim.engine.ServingSimulator``, ``serving.executor.PoolExecutor``).  A
:class:`Scenario` captures the same degrees of freedom as one validated,
serializable record:

- :class:`WorkloadSpec` — what arrives: the arrival process (closed
  loop, Poisson, explicit trace, or the diurnal/burst synthesizers),
  how many requests, the SLA, an optional per-class SLA mix
  (:class:`SlaClass` weights), and an optional per-epoch rate schedule
  (the load-step shape the autoscaler study needs);
- :class:`NetworkSpec` — the mobile uplink model (§4's truncated
  normal);
- :class:`DeploymentSpec` — what serves: zoo subset, replica topology
  and speeds, queue caps, admission mode, lookahead batching window,
  and the optional :class:`AutoscalerSpec` closing the replica loop;
- :class:`PolicySpec` — what decides: policy + kwargs, queue-aware
  budgets, vectorized backend, and the profile-learning knobs.

Specs are frozen dataclasses that validate at construction and
round-trip losslessly through plain dicts (``to_dict``/``from_dict``):
every leaf is JSON/TOML-representable, so a scenario can live in a
config file, a benchmark registry, or a service request body.
``scenario.build()`` (``repro_torch.scenario.build``) compiles the spec into
runnable harnesses over any of the three entry points.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, TYPE_CHECKING, Tuple

if TYPE_CHECKING:                    # pragma: no cover - type-only import
    from repro_torch.fleet.spec import FleetSpec

ARRIVAL_KINDS = ("closed_loop", "poisson", "trace", "diurnal", "burst")
TOPOLOGIES = ("per_model", "shared")
ZOOS = ("table2", "prototype")
ADMISSION_MODES = ("none", "admit_all", "depth_cap", "sla_aware",
                   "class_aware")
FAULT_KINDS = ("kill", "degrade", "drain", "recover")
DRIFT_KINDS = ("latency", "network")
PROFILE_MODES = ("ewma", "window", "frozen")
PREMODEL_MODES = ("none", "centroid", "oracle")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class SlaClass:
    """One class in a per-request SLA mix: requests are labelled
    ``name``, carry ``t_sla_ms``, and arrive in proportion to
    ``weight``."""
    name: str
    t_sla_ms: float
    weight: float = 1.0

    def __post_init__(self):
        _require(bool(self.name), "SlaClass needs a non-empty name")
        _require(self.t_sla_ms > 0.0,
                 f"SlaClass {self.name!r}: t_sla_ms must be positive")
        _require(self.weight > 0.0,
                 f"SlaClass {self.name!r}: weight must be positive")


@dataclass(frozen=True)
class InputClassSpec:
    """One input class in a heterogeneous-difficulty workload: requests
    of this class arrive in proportion to ``weight``, their true
    service time is the model's draw times ``latency_scale`` (easy
    inputs < 1, hard inputs > 1), and each carries a cheap feature
    vector drawn at ``feature_center`` ± ``feature_noise`` — what the
    premodel classifier sees."""
    name: str
    weight: float = 1.0
    latency_scale: float = 1.0
    feature_center: Tuple[float, ...] = ()
    feature_noise: float = 0.25

    def __post_init__(self):
        _require(bool(self.name), "InputClassSpec needs a non-empty name")
        _require(self.weight > 0.0,
                 f"input class {self.name!r}: weight must be positive")
        _require(self.latency_scale > 0.0,
                 f"input class {self.name!r}: latency_scale must be "
                 "positive")
        _require(len(self.feature_center) > 0,
                 f"input class {self.name!r}: feature_center must be "
                 "non-empty")
        _require(self.feature_noise >= 0.0,
                 f"input class {self.name!r}: feature_noise must be "
                 "non-negative")


@dataclass(frozen=True)
class WorkloadSpec:
    """What arrives, how fast, and under which SLAs."""
    arrival: str = "poisson"
    n_requests: int = 1000
    t_sla_ms: float = 250.0          # run-level SLA / reporting label
    rate_rps: float = 10.0           # poisson / diurnal / burst base rate
    rate_schedule: Tuple[float, ...] = ()  # per-epoch poisson rates
    epochs: int = 1
    think_ms: float = 0.0            # closed_loop
    times_ms: Tuple[float, ...] = ()  # trace (n_requests derives from it)
    period_ms: float = 60_000.0      # diurnal day length
    amplitude: float = 0.8           # diurnal swing, [0, 1)
    burst_rate_rps: float = 0.0      # burst peak
    burst_every_ms: float = 10_000.0
    burst_len_ms: float = 1_000.0
    classes: Tuple[SlaClass, ...] = ()  # per-class SLA mix ((): single SLA)
    # Per-input-class difficulty mix ((): homogeneous inputs — the
    # historical workload).  Drives true service-time scaling and the
    # feature vectors the premodel classifies on.
    input_classes: Tuple[InputClassSpec, ...] = ()

    def __post_init__(self):
        _require(self.arrival in ARRIVAL_KINDS,
                 f"arrival must be one of {ARRIVAL_KINDS}, "
                 f"got {self.arrival!r}")
        _require(self.n_requests > 0, "n_requests must be positive")
        _require(self.t_sla_ms > 0.0, "t_sla_ms must be positive")
        _require(self.epochs >= 1, "epochs must be >= 1")
        if self.arrival in ("poisson", "diurnal", "burst"):
            _require(self.rate_rps > 0.0,
                     f"{self.arrival} arrivals need rate_rps > 0")
        if self.arrival == "trace":
            _require(len(self.times_ms) > 0,
                     "trace arrivals need explicit times_ms")
            # A trace IS the workload: its length defines the request
            # count (n_requests is derived, never independently set).
            object.__setattr__(self, "n_requests", len(self.times_ms))
        if self.arrival == "diurnal":
            _require(0.0 <= self.amplitude < 1.0,
                     f"amplitude must be in [0, 1), got {self.amplitude}")
            _require(self.period_ms > 0.0, "period_ms must be positive")
        if self.arrival == "burst":
            _require(self.burst_rate_rps >= self.rate_rps,
                     "burst_rate_rps must be >= rate_rps")
            _require(0.0 < self.burst_len_ms <= self.burst_every_ms,
                     "need 0 < burst_len_ms <= burst_every_ms")
        if self.rate_schedule:
            _require(self.arrival == "poisson",
                     "rate_schedule only applies to poisson arrivals")
            _require(len(self.rate_schedule) == self.epochs,
                     f"rate_schedule has {len(self.rate_schedule)} entries "
                     f"for {self.epochs} epochs")
            _require(all(r > 0.0 for r in self.rate_schedule),
                     "rate_schedule rates must be positive")
        _require(self.n_requests >= self.epochs,
                 f"n_requests ({self.n_requests}) must cover every epoch "
                 f"({self.epochs}) — empty epochs are not runnable")
        names = [c.name for c in self.classes]
        _require(len(names) == len(set(names)),
                 f"duplicate SLA class names: {names}")
        if self.input_classes:
            inames = [c.name for c in self.input_classes]
            _require(len(inames) == len(set(inames)),
                     f"duplicate input class names: {inames}")
            dims = {len(c.feature_center) for c in self.input_classes}
            _require(len(dims) == 1,
                     "every input class must use the same feature "
                     f"dimensionality, got {sorted(dims)}")


@dataclass(frozen=True)
class NetworkSpec:
    """Mobile uplink model: truncated normal, ms (Fig. 1 / §4)."""
    mean_ms: float = 57.87           # campus WiFi (Table: CAMPUS_WIFI)
    std_ms: float = 30.78
    floor_ms: float = 0.1

    def __post_init__(self):
        _require(self.mean_ms > 0.0, "mean_ms must be positive")
        _require(self.std_ms >= 0.0, "std_ms must be non-negative")


CONTROLLER_KINDS = ("step", "proportional", "cost_weighted")


@dataclass(frozen=True)
class AutoscalerSpec:
    """Closed-loop replica scaling targets.

    ``control_interval_ms == 0`` (the default) keeps the historical
    epoch-boundary path: ``QueueTargetAutoscaler.decide`` resizes the
    pool between epochs, instantaneously and for free.  A positive
    interval arms the *mid-run* elastic lifecycle
    (``sim.elastic.ElasticConfig``): a controller of ``kind`` ticks on
    the engine's event queue every interval, scale-up pays
    ``cold_start_ms`` per replica (WARMING -> UP), scale-in drains
    before decommissioning, and replica-seconds are priced at
    ``cost_per_replica_s`` on the bench frontier."""
    target_queue_ms: float = 50.0    # scale up above this mean queue wait
    max_shed_rate: float = 0.02      # ... or above this router shed rate
    max_fallback_rate: float = 0.25  # ... or above this router fallback rate
    min_replicas: int = 1
    max_replicas: int = 8
    step: int = 1                    # replicas added/removed per decision
    low_utilization: float = 0.3     # scale down below this mean busy frac
    kind: str = "step"               # controller family (mid-run path)
    control_interval_ms: float = 0.0  # 0 = epoch-boundary (historical)
    cold_start_ms: float = 0.0       # WARMING -> UP delay per new replica
    cost_per_replica_s: float = 0.0  # frontier price per replica-second

    def __post_init__(self):
        _require(self.target_queue_ms > 0.0, "target_queue_ms must be > 0")
        _require(0.0 <= self.max_shed_rate <= 1.0,
                 "max_shed_rate must be in [0, 1]")
        _require(0.0 <= self.max_fallback_rate <= 1.0,
                 "max_fallback_rate must be in [0, 1]")
        _require(1 <= self.min_replicas <= self.max_replicas,
                 "need 1 <= min_replicas <= max_replicas")
        _require(self.step >= 1, "step must be >= 1")
        _require(self.kind in CONTROLLER_KINDS,
                 f"controller kind must be one of {CONTROLLER_KINDS}, "
                 f"got {self.kind!r}")
        _require(self.control_interval_ms >= 0.0,
                 "control_interval_ms must be non-negative "
                 "(0 = epoch-boundary scaling)")
        _require(self.cold_start_ms >= 0.0,
                 "cold_start_ms must be non-negative")
        _require(self.cost_per_replica_s >= 0.0,
                 "cost_per_replica_s must be non-negative")
        if self.control_interval_ms == 0.0:
            _require(self.kind == "step",
                     f"controller kind {self.kind!r} needs a mid-run tick "
                     "(control_interval_ms > 0); the epoch-boundary path "
                     "is the step policy")
            _require(self.cold_start_ms == 0.0,
                     "cold_start_ms needs control_interval_ms > 0 "
                     "(epoch-boundary scaling is instantaneous by "
                     "construction)")


@dataclass(frozen=True)
class FaultSpec:
    """One replica-lifecycle fault (``sim.faults.ReplicaFault``):
    ``kind`` transition on ``replica`` at ``at_ms`` into the run
    (engine timeline; ``factor`` is the degrade slowdown)."""
    kind: str
    replica: str
    at_ms: float
    factor: float = 2.0

    def __post_init__(self):
        _require(self.kind in FAULT_KINDS,
                 f"fault kind must be one of {FAULT_KINDS}, "
                 f"got {self.kind!r}")
        _require(bool(self.replica), "FaultSpec needs a replica name")
        _require(self.at_ms >= 0.0, "at_ms must be non-negative")
        _require(self.factor > 0.0, "factor must be positive")


@dataclass(frozen=True)
class DriftSpec:
    """One ground-truth drift event: ``latency`` shifts one model's
    service process (μ/σ multiplied vs the seeded truth — absolute, not
    cumulative, so ``mu_mult=1.0`` later is the recovery); ``network``
    scales the RTT by ``rtt_mult``."""
    kind: str = "latency"
    at_ms: float = 0.0
    model: str = ""                  # latency drifts only
    mu_mult: float = 1.0
    sigma_mult: float = 1.0
    rtt_mult: float = 1.0            # network drifts only

    def __post_init__(self):
        _require(self.kind in DRIFT_KINDS,
                 f"drift kind must be one of {DRIFT_KINDS}, "
                 f"got {self.kind!r}")
        _require(self.at_ms >= 0.0, "at_ms must be non-negative")
        if self.kind == "latency":
            _require(bool(self.model), "latency drift needs a model name")
            _require(self.mu_mult > 0.0 and self.sigma_mult > 0.0,
                     "mu_mult/sigma_mult must be positive")
        else:
            _require(self.rtt_mult > 0.0, "rtt_mult must be positive")


@dataclass(frozen=True)
class RetrySpec:
    """Router recovery policy (``router.retry.RetryPolicy``):
    ``max_attempts`` total placements per request including the first;
    ``reroute_on_overrun`` arms the deadline-overrun hedge at service
    start, with ``overrun_margin_ms`` slack before it triggers."""
    max_attempts: int = 2
    reroute_on_overrun: bool = True
    overrun_margin_ms: float = 0.0

    def __post_init__(self):
        _require(self.max_attempts >= 1,
                 "max_attempts must be >= 1 (it counts the first "
                 "placement)")
        _require(self.overrun_margin_ms >= 0.0,
                 "overrun_margin_ms must be non-negative")


@dataclass(frozen=True)
class DeploymentSpec:
    """What serves: zoo subset, replica topology, admission, batching."""
    zoo: str = "table2"              # "table2" | "prototype"
    subset: Tuple[str, ...] = ()     # () = the whole zoo
    topology: str = "per_model"      # "per_model" | "shared"
    replicas: int = 1                # per model, or total when shared
    speeds: Tuple[float, ...] = ()   # shared only; () = all 1.0
    max_queue_depth: Optional[int] = None
    admission: str = "none"
    admission_kwargs: Dict[str, Any] = field(default_factory=dict)
    batch_window_ms: float = 0.0
    spike_prob: float = 0.0          # co-tenant latency spikes
    spike_mult: float = 10.0
    autoscaler: Optional[AutoscalerSpec] = None
    # Fault injection & recovery (() / None = the fair-weather world;
    # runs stay bit-identical to the pre-fault engine).
    faults: Tuple[FaultSpec, ...] = ()
    drifts: Tuple[DriftSpec, ...] = ()
    retry: Optional[RetrySpec] = None
    # Multi-cell fleet layer (``repro_torch.fleet``): None = a single cell,
    # the historical deployment.  The cell list, inter-cell RTT and
    # spill policy live in the FleetSpec; per-cell overrides fall back
    # to this deployment's zoo/topology/replicas.
    fleet: Optional["FleetSpec"] = None

    def __post_init__(self):
        _require(self.zoo in ZOOS,
                 f"zoo must be one of {ZOOS}, got {self.zoo!r}")
        _require(self.topology in TOPOLOGIES,
                 f"topology must be one of {TOPOLOGIES}, "
                 f"got {self.topology!r}")
        _require(self.replicas >= 1, "replicas must be >= 1")
        if self.speeds:
            _require(self.topology == "shared",
                     "speeds only apply to the shared topology")
            _require(len(self.speeds) == self.replicas,
                     f"{len(self.speeds)} speeds for {self.replicas} "
                     "replicas")
        _require(self.admission in ADMISSION_MODES,
                 f"admission must be one of {ADMISSION_MODES}, "
                 f"got {self.admission!r}")
        _require(self.max_queue_depth is None or self.max_queue_depth >= 1,
                 "max_queue_depth must be >= 1 (or None)")
        _require(self.batch_window_ms >= 0.0,
                 "batch_window_ms must be non-negative")
        _require(0.0 <= self.spike_prob <= 1.0,
                 "spike_prob must be in [0, 1]")


# Kwargs a bare PolicySpec(policy=...) resolves to: the repo-wide
# benchmark settings (ModiPick's 20 ms window, StaticGreedy frozen at
# the suite's default SLA).
_POLICY_DEFAULT_KWARGS: Dict[str, Dict[str, Any]] = {
    "modipick": {"t_threshold": 20.0},
    "related_random": {"t_threshold": 20.0},
    "related_accurate": {"t_threshold": 20.0},
    "static_greedy": {"t_sla": 250.0},
}


@dataclass(frozen=True)
class PolicySpec:
    """What decides, and how its profiles learn.  Empty ``kwargs``
    normalize to the policy's defaults (``_POLICY_DEFAULT_KWARGS``) at
    construction, so specs always serialize fully resolved."""
    policy: str = "modipick"
    kwargs: Dict[str, Any] = field(default_factory=dict)
    queue_aware: bool = False
    backend: Optional[str] = None    # policy_vec backend override
    alpha: float = 0.1               # EWMA step for profile updates
    cold_age: int = 500
    cold_probe: bool = True
    warm: bool = True                # seed profiles at the true (mu, sigma)
    # Profile estimator family (``core.zoo.make_store``): "ewma" (the
    # paper's), "window" (sliding window + staleness exploration — the
    # self-healing mode), "frozen" (drift-ablation baseline).  The
    # window knobs are ignored outside "window" mode.
    profile: str = "ewma"
    window: int = 64
    stale_after: int = 400
    explore_bonus: float = 0.9
    # Tail-aware budgets: present each model's latency as this quantile
    # of its observed distribution instead of the EWMA mean (None = the
    # paper's mean-based presentation).  Eligibility, utilities and
    # SLA-aware admission all judge against the presented value, so a
    # 0.95 here makes the whole pipeline rank models by their p95.
    latency_quantile: Optional[float] = None
    # Premodel input classifier: "none" (historical), "centroid" (online
    # nearest-centroid learned from the feature stream), "oracle" (frozen
    # true-center ablation).  Anything but "none" needs
    # workload.input_classes, and ``build`` refuses it until the premodel
    # slice of the port lands.
    premodel: str = "none"

    def __post_init__(self):
        from repro_torch.core.policy import POLICIES, make_policy
        from repro_torch.core.policy_vec import VALID_BACKENDS
        _require(self.policy in POLICIES,
                 f"policy must be one of {tuple(sorted(POLICIES))}, "
                 f"got {self.policy!r}")
        _require(self.backend is None or self.backend in VALID_BACKENDS,
                 f"backend must be None or one of "
                 f"{', '.join(VALID_BACKENDS)}, got {self.backend!r}")
        _require(0.0 < self.alpha <= 1.0, "alpha must be in (0, 1]")
        _require(self.cold_age >= 1, "cold_age must be >= 1")
        _require(self.profile in PROFILE_MODES,
                 f"profile must be one of {PROFILE_MODES}, "
                 f"got {self.profile!r}")
        _require(self.window >= 2, "window must be >= 2")
        _require(self.stale_after >= 1, "stale_after must be >= 1")
        _require(0.0 <= self.explore_bonus < 1.0,
                 "explore_bonus must be in [0, 1)")
        if self.latency_quantile is not None:
            _require(0.5 <= self.latency_quantile < 1.0,
                     "latency_quantile must be in [0.5, 1), "
                     f"got {self.latency_quantile}")
        _require(self.premodel in PREMODEL_MODES,
                 f"premodel must be one of {PREMODEL_MODES}, "
                 f"got {self.premodel!r}")
        if self.premodel != "none" or self.latency_quantile is not None:
            _require(self.profile == "ewma",
                     "premodel / latency_quantile stores extend the EWMA "
                     f"profile family (profile={self.profile!r})")
        if not self.kwargs:
            object.__setattr__(
                self, "kwargs",
                dict(_POLICY_DEFAULT_KWARGS.get(self.policy, {})))
        try:
            # fail at construction, not at build()/run() time
            make_policy(self.policy, **self.kwargs)
        except TypeError as e:
            raise ValueError(
                f"kwargs {self.kwargs!r} do not construct policy "
                f"{self.policy!r}: {e}") from e


@dataclass(frozen=True)
class Scenario:
    """One named, self-contained experiment description."""
    name: str
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    network: NetworkSpec = field(default_factory=NetworkSpec)
    deployment: DeploymentSpec = field(default_factory=DeploymentSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    seed: int = 0

    def __post_init__(self):
        _require(bool(self.name), "Scenario needs a non-empty name")
        asc = self.deployment.autoscaler
        if asc is not None:
            if asc.control_interval_ms == 0.0:
                _require(self.workload.epochs > 1,
                         "an epoch-boundary autoscaler needs "
                         "workload.epochs > 1 (it acts between epochs; "
                         "set control_interval_ms > 0 for a mid-run "
                         "controller)")
            else:
                # Mid-run provisioning creates shared replicas (they
                # serve the whole zoo); a per_model pool would change
                # topology semantics mid-run.
                _require(self.deployment.topology == "shared",
                         "a mid-run controller "
                         "(control_interval_ms > 0) needs the shared "
                         "topology (provisioned replicas serve every "
                         "model)")
        if self.deployment.faults or self.deployment.drifts:
            # Fault times reference one engine timeline; multi-epoch
            # runs re-zero time per epoch, which would replay every
            # fault each epoch.
            _require(self.workload.epochs == 1,
                     "fault/drift injection needs workload.epochs == 1 "
                     "(fault times reference the single-run timeline)")
        if self.policy.premodel != "none":
            _require(bool(self.workload.input_classes),
                     "a premodel classifier needs workload.input_classes "
                     "(it has nothing to classify otherwise)")
        fl = self.deployment.fleet
        if fl is not None and fl.n_cells > 1:
            # The fleet engine owns the clock (FleetSpec.epoch_ms) and
            # synthesizes per-cell arrivals, so the workload must be a
            # generative open-loop shape with a single logical epoch.
            _require(self.workload.epochs == 1,
                     "a multi-cell fleet needs workload.epochs == 1 "
                     "(FleetSpec.epoch_ms is the rebalancing clock)")
            _require(self.workload.arrival in ("poisson", "diurnal"),
                     "a multi-cell fleet needs poisson or diurnal "
                     f"arrivals, got {self.workload.arrival!r}")
            _require(self.deployment.autoscaler is None,
                     "fleet + autoscaler is not supported (cells have "
                     "fixed replica topologies); run one elastic "
                     "scenario per cell instead — a shared-topology "
                     "Scenario with autoscaler.control_interval_ms > 0 "
                     "gives each cell its own mid-run controller")
            _require(not self.deployment.faults
                     and not self.deployment.drifts,
                     "fleet + fault/drift injection is not supported")
            _require(not self.workload.classes,
                     "fleet + per-class SLA mixes is not supported yet")
            _require(not self.workload.input_classes,
                     "fleet + input-class mixes is not supported yet")
            _require(self.policy.latency_quantile is None,
                     "fleet + quantile budgets is not supported yet")

    # -- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form: nested dicts/lists of JSON/TOML scalars."""
        return _plain(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Scenario":
        """Inverse of :meth:`to_dict`:
        ``Scenario.from_dict(s.to_dict()) == s``."""
        d = dict(d)
        unknown = set(d) - {"name", "workload", "network", "deployment",
                            "policy", "seed"}
        _require(not unknown,
                 f"unknown scenario keys: {sorted(unknown)} (a typo'd "
                 "section would otherwise be silently dropped)")
        wl = dict(d.get("workload", {}))
        if "classes" in wl:
            wl["classes"] = tuple(SlaClass(**c) for c in wl["classes"])
        if "input_classes" in wl:
            wl["input_classes"] = tuple(
                InputClassSpec(**{**c, "feature_center":
                                  tuple(c.get("feature_center", ()))})
                for c in wl["input_classes"])
        _tupled(wl, "rate_schedule", "times_ms")
        dep = dict(d.get("deployment", {}))
        if dep.get("autoscaler") is not None:
            dep["autoscaler"] = AutoscalerSpec(**dep["autoscaler"])
        if "faults" in dep:
            dep["faults"] = tuple(FaultSpec(**f) for f in dep["faults"])
        if "drifts" in dep:
            dep["drifts"] = tuple(DriftSpec(**s) for s in dep["drifts"])
        if dep.get("retry") is not None:
            dep["retry"] = RetrySpec(**dep["retry"])
        if dep.get("fleet") is not None:
            from repro_torch.fleet.spec import FleetSpec
            dep["fleet"] = FleetSpec.from_dict(dep["fleet"])
        _tupled(dep, "subset", "speeds")
        return cls(
            name=d["name"],
            workload=WorkloadSpec(**wl),
            network=NetworkSpec(**d.get("network", {})),
            deployment=DeploymentSpec(**dep),
            policy=PolicySpec(**d.get("policy", {})),
            seed=int(d.get("seed", 0)))

    @classmethod
    def from_file(cls, path) -> "Scenario":
        """Load a scenario from a ``.toml`` or ``.json`` config file
        (anything else is parsed as JSON).  Fault/drift/retry specs
        round-trip like every other field."""
        p = str(path)
        if p.endswith(".toml"):
            try:
                import tomllib          # 3.11+
            except ImportError:         # pragma: no cover - env-dependent
                import tomli as tomllib
            with open(p, "rb") as f:
                return cls.from_dict(tomllib.load(f))
        import json
        with open(p, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    # -- compilation ---------------------------------------------------
    def build(self):
        """Compile into a runnable
        :class:`repro_torch.scenario.build.ScenarioHarness`."""
        from repro_torch.scenario.build import build
        return build(self)


def _plain(x: Any) -> Any:
    """asdict leaves tuples as tuples; JSON/TOML want lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _tupled(d: Dict[str, Any], *keys: str) -> None:
    for k in keys:
        if k in d:
            d[k] = tuple(d[k])
