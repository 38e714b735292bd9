"""The discrete-event serving simulator.

Request lifecycle (all times ms):

    ARRIVAL ── uplink (T_input) ──▶ ENQUEUE ── FIFO wait ──▶ service
            ── inference ──▶ FINISH ── downlink (T_input) ──▶ DEPART

At ENQUEUE the engine hands the request to the unified
``repro_torch.router.Router`` — admission verdict, budget math and model
selection all live there.  Consecutive same-timestamp ENQUEUE events
(plus an optional ``batch_window_ms`` speculative lookahead) are grouped
into ONE ``route_batch_arrays`` call: budget/class columns in, decision
columns out, no per-request objects on the hot path.  A singleton batch
takes the scalar selection route, which is draw-for-draw identical to
the historical per-request call — seeded runs with continuous
(never-colliding) event times are bit-identical to the pre-router
engine.  Multi-request batches are routed with intra-batch load
charging by default (``charge_batches=True``): the engine hands the
router its live per-replica wait columns
(``ReplicaPool.charged_state``) and each admitted pick's μ is charged
to its chosen replica before the next request of the batch is judged,
so simultaneous bursts spread across the pool instead of piling onto
one stale-idle model; the charged replica is also where the engine
places the request.  ``charge_batches=False`` restores the historical
one-frozen-snapshot batch semantics.  Queue-aware mode presents the
policy with per-model budgets ``T_sla - 2*T_input - W_queue(m)`` via
the router's shifted store view.  The admitted request joins the FIFO
of its replica, and — exactly like the live serving path — the profile
store receives the *inference* latency at FINISH and the observed queue
wait at service start (telemetry mirroring ``serving/batcher.py``).

Hot-path representation (the million-request regime): per-request state
lives in preallocated structure-of-arrays columns indexed by request id
— no per-request dataclass is ever constructed inside the event loop.
Replica FIFOs hold request indices (``sim/replica.py`` bound mode), the
per-batch ``W_queue`` snapshot computes each replica's wait once, and
per-request SLA/class assignments are materialized into columns up
front (they never touch the RNG, so labelled runs stay draw-for-draw
identical).  ``completed_requests``/``rejected_requests`` materialize
:class:`SimRequest` views lazily from the columns for inspection;
``_summarise`` and the per-class slices are vectorized reductions over
the same columns.

Per-request SLAs are first-class: ``run(..., sla_for=...)`` assigns each
request its own ``t_sla_ms`` (heterogeneous mixes become one more column
of the batched budget vector) and attainment is scored per request.

Driven by ``ClosedLoopArrivals`` over a single shared replica this
engine replays the paper's §4 closed loop draw-for-draw —
``core/simulate.Simulator`` is now a thin wrapper around it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import Policy
from repro_torch.core.profiles import ProfileStore
from repro_torch.core.zoo import ZooEntry, make_store, true_profiles
from repro_torch.router import AdmissionController, Router
from repro_torch.router.retry import RetryPolicy
from repro_torch.sim.arrivals import ArrivalProcess, ClosedLoopArrivals
from repro_torch.sim.elastic import ControlReading, ElasticConfig, make_controller
from repro_torch.sim.events import (ARRIVAL, CONTROL, DEPART, ENQUEUE, FAULT,
                              FINISH, PROVISION, EventQueue)
from repro_torch.sim.faults import (FaultEvent, LatencyDrift, NetworkDrift,
                              ReplicaFault, schedule_faults)
from repro_torch.sim.replica import (DEGRADED, UP, WARMING, GaussianServiceModel,
                               Replica, ReplicaPool, shared_replicas)


@dataclass
class SimRequest:
    rid: int
    arrival_ms: float
    t_input_ms: float = 0.0
    t_sla_ms: float = 0.0
    sla_class: str = ""
    model: str = ""
    replica: str = ""
    fallback: bool = False
    rejected: bool = False
    reject_reason: str = ""
    enqueue_ms: float = 0.0
    service_start_ms: float = 0.0
    service_ms: float = 0.0
    finish_ms: float = 0.0
    depart_ms: float = 0.0
    retries: int = 0          # recovery re-placements (attempts - 1)

    @property
    def queue_wait_ms(self) -> float:
        return self.service_start_ms - self.enqueue_ms

    @property
    def e2e_ms(self) -> float:
        # Component sum (not event-time subtraction): uplink + FIFO wait
        # + inference + downlink.  Bit-identical to the legacy closed
        # loop's ``2*T_input + T_inf`` at zero queue wait.
        return 2.0 * self.t_input_ms + self.queue_wait_ms + self.service_ms


class _Columns:
    """Preallocated SoA record arrays for one run's request state.
    Index == request id; every field of the historical ``SimRequest``
    dataclass is one contiguous column."""

    __slots__ = ("arrival", "t_input", "t_sla", "enqueue", "sstart",
                 "service", "finish", "depart", "model", "replica",
                 "cls", "icls", "fallback", "rejected", "reason", "retries")

    def __init__(self, n: int):
        z = lambda dt: np.zeros(n, dtype=dt)
        self.arrival = z(np.float64)
        self.t_input = z(np.float64)
        self.t_sla = z(np.float64)
        self.enqueue = z(np.float64)
        self.sstart = z(np.float64)
        self.service = z(np.float64)
        self.finish = z(np.float64)
        self.depart = z(np.float64)
        self.model = np.full(n, -1, dtype=np.int32)     # model id, -1 = none
        self.replica = np.full(n, -1, dtype=np.int32)   # pool index
        self.cls = z(np.int32)                          # class-label code
        self.icls = np.full(n, -1, dtype=np.int32)      # premodel input class
        self.fallback = z(bool)
        self.rejected = z(bool)
        self.reason = z(np.int16)                       # reject-reason code
        self.retries = z(np.int16)                      # recovery re-placements


@dataclass
class LoadSimResult:
    policy: str
    t_sla: float
    n_arrived: int
    n_completed: int
    n_rejected: int
    sla_attainment: float        # met / arrived (rejections are misses)
    mean_accuracy: float         # over completed requests
    mean_latency: float          # e2e ms over completed
    p50_latency: float
    p99_latency: float
    mean_queue_wait: float
    p99_queue_wait: float
    peak_queue_depth: int
    model_usage: Dict[str, float]          # fraction of completed
    replica_utilization: Dict[str, float]  # busy time / horizon
    horizon_ms: float = 0.0
    # Per-SLA-class slice (populated when any request carried a class
    # label): class -> {n_arrived, n_rejected, attainment, accuracy,
    # shed_rate, mean_latency}.  Attainment counts rejections as misses,
    # exactly like the run-level number.
    per_class: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # Recovery re-placements across all requests (replica failure or
    # deadline-overrun hedges that found a viable fallback) — 0 for
    # fault-free runs.
    n_retries: int = 0
    # Tail percentiles between the median and the p99 (the tail-SLA
    # study's operating point); defaulted so positional constructions
    # and serialized results predating them keep working.
    p95_latency: float = 0.0
    p95_queue_wait: float = 0.0
    # Elastic lifecycle cost accounting: committed replica time
    # integrated over the horizon (seconds — the frontier's cost axis;
    # a static pool reports exactly n × horizon), provision and
    # drain-decommission counts, and utilization normalized by each
    # replica's *alive* window instead of the whole horizon (the
    # scale-in guard's undiluted signal — identical to the
    # replica_utilization mean on static fault-free pools).
    replica_seconds: float = 0.0
    mean_live_utilization: float = 0.0
    n_provisioned: int = 0
    n_decommissioned: int = 0

    @property
    def violation_rate(self) -> float:
        return 1.0 - self.sla_attainment


class ServingSimulator:
    """Event-driven serving over a pool of heterogeneous replicas."""

    def __init__(self, entries: Sequence[ZooEntry], network: NetworkModel,
                 replicas: Optional[Union[ReplicaPool, List[Replica]]] = None,
                 *, seed: int = 0, alpha: float = 0.1, cold_age: int = 500,
                 cold_probe: bool = True, spike_prob: float = 0.0,
                 spike_mult: float = 10.0, queue_aware: bool = False,
                 admission: Optional[AdmissionController] = None,
                 batch_window_ms: float = 0.0,
                 backend: Optional[str] = None,
                 charge_batches: bool = True,
                 faults: Sequence[FaultEvent] = (),
                 retry: Optional[RetryPolicy] = None,
                 elastic: Optional[ElasticConfig] = None):
        self.entries = list(entries)
        self.network = network
        if replicas is None:
            replicas = shared_replicas(1)
        self.pool = (replicas if isinstance(replicas, ReplicaPool)
                     else ReplicaPool(replicas))
        self.seed = seed
        self.alpha = alpha
        self.cold_age = cold_age
        self.cold_probe = cold_probe
        self.spike_prob = spike_prob
        self.spike_mult = spike_mult
        self.queue_aware = queue_aware
        self.admission = admission
        # policy_vec backend override for batched route_batch selection
        self.backend = backend
        # Speculative lookahead for route_batch grouping: consecutive
        # ENQUEUE events within this window of the first one are routed
        # together against one queue snapshot.  0.0 batches only exact
        # timestamp ties (simultaneous arrivals), which keeps runs with
        # continuous event times bit-identical to per-request routing.
        self.batch_window_ms = batch_window_ms
        # Intra-batch load charging (default): each admitted pick's μ is
        # charged to its chosen replica before the next request of the
        # batch is judged, so simultaneous bursts don't pile onto one
        # idle-looking model off a stale W_queue snapshot.  False keeps
        # the historical one-snapshot batch semantics (the ablation
        # baseline, and the mode pinned by pre-charging goldens).
        self.charge_batches = charge_batches
        # Fault injection (``sim/faults.py``): environment events pushed
        # onto the run's queue; () keeps the fair-weather world and the
        # seeded goldens bit-identical.  ``retry`` arms the recovery
        # path (re-route on replica failure / deadline overrun); None
        # means a lost request is simply rejected.
        self.faults = tuple(faults)
        self.retry = retry
        # Elastic replica lifecycle (``sim/elastic.py``): a mid-run
        # controller ticking on the event queue, provisioning WARMING
        # replicas and drain-decommissioning idle ones.  None keeps the
        # static pool and every seeded golden bit-identical (the
        # controller path is draw-free, but None skips it entirely).
        self.elastic = elastic
        self._n_provisioned = 0
        self._n_decommissioned = 0
        # The constructed pool size: run() truncates back to it so
        # replicas provisioned by a previous run never leak into the
        # next one (pool.reset() alone would resurrect them as UP).
        self._base_pool_n = len(self.pool.replicas)
        self.router: Optional[Router] = None  # built per run()
        # Post-run SoA state (lazy SimRequest materialization).
        self._cols: Optional[_Columns] = None
        self._completed_rids: List[int] = []
        self._rejected_rids: List[int] = []
        self._model_names: List[str] = []
        self._replica_names: List[str] = []
        self._class_labels: List[str] = [""]
        self._reasons: List[str] = [""]
        self._completed_objs: Optional[List[SimRequest]] = None
        self._rejected_objs: Optional[List[SimRequest]] = None

    @classmethod
    def from_scenario(cls, scenario, *,
                      n_replicas: Optional[int] = None) -> "ServingSimulator":
        """Adapter: build an engine from a declarative
        :class:`repro_torch.scenario.Scenario` (``n_replicas`` overrides the
        deployment's replica count — the autoscaler knob)."""
        from repro_torch.scenario.build import build_engine
        return build_engine(scenario, n_replicas=n_replicas)

    # ------------------------------------------------------------------
    def run(self, policy: Policy, t_sla: float,
            n_requests: int = 10_000,
            arrivals: Optional[ArrivalProcess] = None,
            warm: bool = True,
            store: Optional[ProfileStore] = None,
            sla_for: Optional[Callable[[int], float]] = None,
            class_for: Optional[Callable[[int], str]] = None,
            extra_input_for=None,
            feature_for=None,
            premodel=None,
            service_scale_for=None
            ) -> LoadSimResult:
        """Simulate ``n_requests``.  ``sla_for(rid)`` (optional) assigns
        per-request SLAs; ``t_sla`` remains the reporting label and the
        default for requests without an override.  ``class_for(rid)``
        (optional) labels each request with an SLA class — the label
        rides ``InferenceRequest.sla_class`` into class-aware admission
        and slices the summary's ``per_class`` rows.  Both are
        materialized into SoA columns before the event loop starts
        (batched, in rid order); they never touch the RNG, so labelled
        runs stay draw-for-draw identical to unlabelled ones under the
        same seed.

        ``extra_input_for`` (optional; a ``(n,)`` array or an
        ``rid -> ms`` callable) adds a deterministic per-request
        constant to the *sampled* uplink time — the fleet layer's
        cross-cell spill penalty (half the inter-cell RTT on each
        direction, so ``2·T_input`` grows by exactly ``RTT_xcell`` and
        every downstream budget — admission, queue-aware selection,
        SLA scoring — judges the spilled request honestly).  Applied
        after the network draw, so the RNG stream is untouched and
        ``None`` (or all-zero) runs are bit-identical to the
        historical engine.

        The premodel hooks (all optional, all RNG-neutral):
        ``feature_for`` (an ``(n, d)`` array or an ``rid -> features``
        callable) attaches cheap request features, materialized into a
        column before the loop; ``premodel`` (an object with
        ``classify``/``update``) maps them to input-class ids at
        ENQUEUE, flips the store's class cursor for the selection, and
        attributes the FINISH latency observation to the request's
        class (the ``store`` must then be a
        ``premodel.conditional.ConditionalProfileStore``);
        ``service_scale_for`` (an ``(n,)`` array or callable) multiplies
        the *sampled* inference time by a per-request constant — the
        ground-truth easy/hard input effect, applied after the draw so
        ``None`` (or all-ones) runs are bit-identical."""
        arrivals = arrivals or ClosedLoopArrivals()
        rng = np.random.default_rng(self.seed)
        store = store or make_store(self.entries, alpha=self.alpha,
                                    cold_age=self.cold_age, warm=warm)
        truth = true_profiles(self.entries)
        svc = GaussianServiceModel(truth, spike_prob=self.spike_prob,
                                   spike_mult=self.spike_mult)
        # trace_detail=False: the event loop consumes only variant +
        # fallback, so decisions skip stage-tuple materialization.
        router = Router(store, policy, admission=self.admission,
                        queue_aware=self.queue_aware, backend=self.backend,
                        trace_detail=False)
        self.router = router
        del self.pool.replicas[self._base_pool_n:]
        self.pool.reset()

        n = n_requests
        names = list(truth)
        model_ids = {nm: i for i, nm in enumerate(names)}
        profiles = [store.profiles[nm] for nm in names]
        cols = _Columns(n)
        # Batched SLA/class materialization (RNG-free, rid order).
        if sla_for is None:
            cols.t_sla.fill(t_sla)
        else:
            cols.t_sla[:] = [float(sla_for(i)) for i in range(n)]
        labels: List[str] = [""]
        if class_for is not None:
            code_of: Dict[str, int] = {"": 0}
            cls_col = cols.cls
            for i in range(n):
                lab = str(class_for(i))
                code = code_of.get(lab)
                if code is None:
                    code = code_of[lab] = len(labels)
                    labels.append(lab)
                cls_col[i] = code
        class_names = [lab if lab else None for lab in labels]
        if extra_input_for is None:
            extra_in = None
        elif callable(extra_input_for):
            extra_in = np.fromiter((float(extra_input_for(i))
                                    for i in range(n)), np.float64, count=n)
        else:
            extra_in = np.asarray(extra_input_for, dtype=np.float64)
            if extra_in.shape != (n,):
                raise ValueError(f"extra_input_for array has shape "
                                 f"{extra_in.shape}, expected ({n},)")
        # Premodel columns (RNG-free, rid order, like sla_for/class_for).
        if feature_for is None:
            feats = None
        elif callable(feature_for):
            feats = np.asarray([feature_for(i) for i in range(n)],
                               dtype=np.float64)
        else:
            feats = np.asarray(feature_for, dtype=np.float64)
            if len(feats) != n:
                raise ValueError(f"feature_for array has {len(feats)} "
                                 f"rows, expected {n}")
        if premodel is not None:
            if feats is None:
                raise ValueError("premodel needs feature_for")
            if not hasattr(store, "observe_class"):
                raise ValueError("premodel routing needs a "
                                 "ConditionalProfileStore (got "
                                 f"{type(store).__name__})")
        if service_scale_for is None:
            svc_scale = None
        elif callable(service_scale_for):
            svc_scale = np.fromiter(
                (float(service_scale_for(i)) for i in range(n)),
                np.float64, count=n)
        else:
            svc_scale = np.asarray(service_scale_for, dtype=np.float64)
            if svc_scale.shape != (n,):
                raise ValueError(f"service_scale_for array has shape "
                                 f"{svc_scale.shape}, expected ({n},)")

        # Replica binding: int queues + live per-model μ for the O(1)
        # wait estimates (the index-based free-list replacing the
        # per-event object walks).
        mu_now: List[float] = [p.mu for p in profiles]
        self.pool.bind(names, cols.model, mu_now)
        replica_index = {id(r): i for i, r in enumerate(self.pool.replicas)}

        reasons: List[str] = [""]
        reason_code: Dict[str, int] = {"": 0}

        evq = EventQueue()
        completed: List[int] = []
        rejected: List[int] = []
        n_issued = 0
        if n > 0:
            evq.push(arrivals.first(rng), ARRIVAL, 0)
            n_issued = 1

        # Fault schedule: validated against this run's topology, then
        # pushed as FAULT events.  () schedules nothing — the queue and
        # every RNG stream are exactly the fair-weather run's.
        replica_by_name = {r.name: r for r in self.pool.replicas}
        for f in self.faults:
            if isinstance(f, ReplicaFault) and f.replica not in replica_by_name:
                raise ValueError(f"fault targets unknown replica "
                                 f"{f.replica!r} (pool: "
                                 f"{sorted(replica_by_name)})")
            if isinstance(f, LatencyDrift) and f.model not in truth:
                raise ValueError(f"drift targets unknown model "
                                 f"{f.model!r} (zoo: {names})")
        schedule_faults(evq, self.faults)
        net_scale = 1.0           # live RTT multiplier (NetworkDrift)
        # Elastic lifecycle (``sim/elastic.py``): the controller tick
        # rides the same queue as faults and requests.  The whole path
        # is draw-free — it never touches the RNG — and ``None`` skips
        # it entirely, keeping static-pool seeded runs bit-identical.
        elastic = self.elastic
        controller = make_controller(elastic) if elastic is not None \
            else None
        self._n_provisioned = 0
        self._n_decommissioned = 0
        track_wait = elastic is not None
        win_wait = [0.0, 0]       # window's observed start-waits (sum, n)
        last_busy = [0.0]         # pool busy-ms integral at the last tick
        drain_pending: Dict[int, Replica] = {}   # id -> draining victim
        tmpl_depth = self.pool.replicas[0].max_queue_depth
        if elastic is not None and n > 0:
            evq.push(elastic.control_interval_ms, CONTROL, None)
        retry = self.retry
        retries_c = cols.retries
        check_overrun = retry is not None and retry.reroute_on_overrun
        overrun_margin = retry.overrun_margin_ms if retry is not None else 0.0

        arrival_c, t_input_c, t_sla_c = cols.arrival, cols.t_input, cols.t_sla
        enq_c, sstart_c, service_c = cols.enqueue, cols.sstart, cols.service
        finish_c, depart_c = cols.finish, cols.depart
        model_c, replica_c, cls_c = cols.model, cols.replica, cols.cls
        icls_c = cols.icls
        fallback_c, rejected_c, reason_c = cols.fallback, cols.rejected, \
            cols.reason
        closed_loop = arrivals.closed_loop
        needs_waits = router.queue_aware or router.admission.needs_w_queue

        def start_service(replica: Replica, now: float) -> None:
            # With an armed overrun hedge, requests whose believed
            # service time no longer fits their remaining budget are
            # diverted to the recovery path instead of being served into
            # a certain miss; the loop walks the FIFO until one request
            # is serveable.  Without a retry policy the loop body runs
            # exactly once — op-for-op the historical single-pop path.
            pending_div: List[int] = []
            while replica.queue:
                rid = replica.pop_request()
                # A speculatively-routed request (lookahead batching) may
                # be popped before its uplink completes; service cannot
                # start before the input is on the server.  No-op without
                # lookahead.
                t_enq = enq_c[rid]
                t0 = now if now >= t_enq else t_enq
                mid = model_c[rid]
                if check_overrun:
                    remaining = (t_sla_c[rid] - 2.0 * t_input_c[rid]
                                 - (t0 - t_enq))
                    # The hedge consults the store's *live* belief (not
                    # the FINISH-synced mu_now cache): a staleness-decayed
                    # presented μ is an explicit invitation to re-probe,
                    # and vetoing it here would exile the model forever.
                    if profiles[mid].mu / replica.speed > \
                            remaining + overrun_margin:
                        pending_div.append(rid)
                        continue
                sstart_c[rid] = t0
                store.observe_queue(names[mid], t0 - t_enq)
                if track_wait:
                    win_wait[0] += t0 - t_enq
                    win_wait[1] += 1
                t_inf = svc.sample(rng, names[mid], replica.speed)
                if svc_scale is not None:
                    # The TRUE input class's latency effect (easy inputs
                    # run fast, hard ones slow) — a post-draw multiply,
                    # so the RNG stream matches scale-free runs.
                    t_inf *= svc_scale[rid]
                service_c[rid] = t_inf
                replica.current = rid
                replica.busy_until = t0 + t_inf
                evq.push(t0 + t_inf, FINISH, (replica, rid, replica.gen))
                break
            # Diversions are flushed after the serve decision so a
            # re-placement landing back on this replica re-enters
            # ``start_service`` against settled state (recursion is
            # bounded by the per-request attempt budget).
            for rid in pending_div:
                reroute(rid, now, "deadline overrun")

        def place(rid: int, mid: int, now: float) -> None:
            """Recovery placement: enqueue ``rid`` on the best live
            replica of model ``mid`` (reject when none survives)."""
            model_c[rid] = mid
            replica = self.pool.best_for(names[mid], now, store)
            if replica is None:
                reject(rid, "no live replica for " + names[mid],
                       max(now, enq_c[rid]), now)
                return
            replica_c[rid] = replica_index[id(replica)]
            if replica.full():
                reject(rid, "replica queue full", max(now, enq_c[rid]), now)
                return
            replica.enqueue(rid, mid)
            depth = replica.depth()
            if depth > replica.peak_depth:
                replica.peak_depth = depth
            if replica.current is None:
                start_service(replica, now)

        def reroute(rid: int, now: float, why: str) -> None:
            """Recovery path: replica failure or deadline overrun.  With
            attempts left, re-route to the cheapest still-viable model
            within the *remaining* budget (deterministic, draw-free —
            ``router.retry``); otherwise the request is rejected."""
            if retry is None or retries_c[rid] + 1 >= retry.max_attempts:
                reject(rid, why + (" (attempts exhausted)"
                                   if retry is not None else ""),
                       max(now, enq_c[rid]), now)
                return
            remaining = (t_sla_c[rid] - 2.0 * t_input_c[rid]
                         - (now - enq_c[rid]))
            mid = router.reroute_one(
                remaining, w_queue_map=self.pool.waits_by_name(now, store))
            if mid < 0:
                reject(rid, why + "; no viable model within the "
                       "remaining budget", max(now, enq_c[rid]), now)
                return
            retries_c[rid] += 1
            place(rid, int(mid), now)

        def issue_next_closed_loop(now: float) -> None:
            nonlocal n_issued
            if closed_loop and n_issued < n:
                evq.push(arrivals.next_after(rng, now, n_issued),
                         ARRIVAL, n_issued)
                n_issued += 1

        def reject(rid: int, reason: str, depart_ms: float,
                   now: float) -> None:
            rejected_c[rid] = True
            code = reason_code.get(reason)
            if code is None:
                code = reason_code[reason] = len(reasons)
                reasons.append(reason)
            reason_c[rid] = code
            depart_c[rid] = depart_ms
            rejected.append(rid)
            issue_next_closed_loop(now)

        # -- elastic lifecycle actions (scale decisions act here) -------
        def try_decommission(replica: Replica, now: float) -> None:
            """Drain-based scale-in completes: the victim's queue is
            empty and nothing is in flight — stop accruing cost.  Every
            request it held has finished; zero are lost."""
            if (id(replica) in drain_pending and replica.current is None
                    and not replica.queue):
                del drain_pending[id(replica)]
                replica.decommission(now)
                self._n_decommissioned += 1

        def provision(count: int, now: float) -> None:
            """Scale-up: ``count`` replicas born WARMING (not accepting,
            ``inf`` wait columns) — each flips to UP only when its ready
            event fires after ``cold_start_ms``."""
            for _ in range(count):
                r = Replica(name=f"e{self._n_provisioned}", models=(),
                            speed=1.0, max_queue_depth=tmpl_depth)
                r.start_warming(now)
                idx = self.pool.add_replica(r)
                replica_index[id(r)] = idx
                replica_by_name[r.name] = r
                self._n_provisioned += 1
                if elastic.cold_start_ms > 0.0:
                    evq.push(now + elastic.cold_start_ms, PROVISION,
                             ("ready", r, r.gen))
                else:
                    r.warm_ready()

        def scale_in(count: int, now: float) -> None:
            """Scale-in: cancel still-WARMING replicas first (newest
            first — they never served, and the bumped incarnation
            orphans their pending ready events), then drain the
            least-loaded accepting replicas; a drained victim
            decommissions only once its queue is empty."""
            warming = [r for r in reversed(self.pool.replicas)
                       if r.health == WARMING]
            for r in warming[:count]:
                r.gen += 1
                r.decommission(now)
                self._n_decommissioned += 1
            count -= min(count, len(warming))
            if count <= 0:
                return
            victims = sorted((r.depth(), -i, r) for i, r in
                             enumerate(self.pool.replicas) if r.accepting)
            for _, _, r in victims[:count]:
                r.drain()
                drain_pending[id(r)] = r
                try_decommission(r, now)    # already idle → gone now

        while evq:
            ev = evq.pop()
            now = ev.time

            if ev.kind == ARRIVAL:
                rid = ev.data
                arrival_c[rid] = now
                t_in = float(self.network.sample_one(rng))
                # NetworkDrift: scale after the draw so the RNG stream
                # is untouched (drift-free runs multiply by nothing).
                if net_scale != 1.0:
                    t_in *= net_scale
                if extra_in is not None:
                    # Cross-cell spill penalty: constant add after the
                    # draw, same RNG-neutrality rule as NetworkDrift.
                    t_in += extra_in[rid]
                t_input_c[rid] = t_in
                evq.push(now + t_in, ENQUEUE, rid)
                if not closed_loop and n_issued < n:
                    t_next = arrivals.next_after(rng, now, n_issued)
                    if t_next is not None:
                        evq.push(t_next, ARRIVAL, n_issued)
                        n_issued += 1

            elif ev.kind == ENQUEUE:
                # Group consecutive ENQUEUEs inside the batching window
                # into ONE route_batch call (vectorized selection).
                rid = ev.data
                enq_c[rid] = now
                batch: List[int] = [rid]
                limit = now + self.batch_window_ms
                while evq:
                    head = evq.peek()
                    if head.kind != ENQUEUE or head.time > limit:
                        break
                    nxt = evq.pop()
                    enq_c[nxt.data] = nxt.time
                    batch.append(nxt.data)
                # One charged-wait state per batch: every replica's wait
                # computed exactly once, handed to the router as live
                # per-replica columns (the router charges each admitted
                # pick's μ into it before judging the next request).
                # A batch of one has nothing within it to charge — and
                # uncharged batches judge one frozen snapshot — so both
                # take the cheap name->wait map instead of building a
                # per-replica ledger (the singleton path dominates
                # continuous-arrival runs; keep it allocation-lean).
                state = w_map = None
                if needs_waits:
                    if self.charge_batches and len(batch) > 1:
                        state = self.pool.charged_state(now)
                    else:
                        w_map = self.pool.waits_by_name(now, store)
                if premodel is not None:
                    # Classify at ENQUEUE — the premodel sees the
                    # feature vector the device sent, before selection.
                    # The stored id is the *belief at routing time*
                    # (classify before update), so the FINISH
                    # observation lands on the class that was routed on.
                    for r in batch:
                        icls_c[r] = premodel.classify(feats[r])
                        premodel.update(feats[r])
                if len(batch) == 1:
                    # Scalar fast path: tuple out, no BatchDecisions
                    # column set allocated per request (continuous
                    # arrivals make every batch a singleton, ~1M/run).
                    if premodel is not None:
                        store.set_class(int(icls_c[rid]))
                    try:
                        mid, fb, _w, reason = router.route_one(
                            t_sla_c[rid], t_input_c[rid], rng,
                            w_queue_map=w_map,
                            sla_class=(None if router._admits_all else
                                       class_names[cls_c[rid]]),
                            depth_fn=lambda m: min(r.depth() for r in
                                                   self.pool.candidates(m)))
                    finally:
                        if premodel is not None:
                            store.set_class(-1)
                    if mid < 0:
                        reject(rid, reason, enq_c[rid], now)
                        continue
                    model_c[rid] = mid
                    fallback_c[rid] = fb
                    replica = self.pool.best_for(names[mid], now, store)
                    if replica is None:
                        reject(rid, "no live replica for " + names[mid],
                               now, now)
                        continue
                    replica_c[rid] = replica_index[id(replica)]
                    if replica.full():
                        reject(rid, "replica queue full", now, now)
                        continue
                    replica.enqueue(rid, mid)
                    depth = replica.depth()
                    if depth > replica.peak_depth:
                        replica.peak_depth = depth
                    if replica.current is None:
                        start_service(replica, now)
                    continue
                # Array-in/array-out routing: budget/class columns in,
                # decision columns out — no per-request objects.
                if premodel is not None:
                    # Class-conditional batch: per-request class rows
                    # gathered from the stacked (K × pool) snapshot in
                    # one device call (snapshot wait semantics — the
                    # classed path has no charging ledger).
                    res = router.route_batch_classed(
                        t_sla_c[batch], t_input_c[batch], icls_c[batch],
                        rng,
                        w_queue_map=(state.as_map() if state is not None
                                     else w_map),
                        depth_fn=lambda m: min(r.depth() for r in
                                               self.pool.candidates(m)))
                else:
                    res = router.route_batch_arrays(
                        t_sla_c[batch], t_input_c[batch], rng,
                        sla_class=(None if router._admits_all else
                                   [class_names[cls_c[r]] for r in batch]),
                        charged=state, w_queue_map=w_map,
                        depth_fn=lambda m: min(r.depth() for r in
                                               self.pool.candidates(m)),
                        charge=self.charge_batches)
                pool_replicas = self.pool.replicas
                for j, rid in enumerate(batch):
                    if not res.admitted[j]:
                        # Router-side shed: no selection spent, no
                        # replica touched.
                        reject(rid, res.reason_of(j), enq_c[rid], now)
                        continue
                    mid = int(res.model_idx[j])
                    model_c[rid] = mid
                    fallback_c[rid] = res.fallback[j]
                    ridx = int(res.replica_idx[j])
                    if ridx >= 0 and pool_replicas[ridx].accepting:
                        # Charged placement: the replica the router's
                        # ledger charged this pick to.
                        replica = pool_replicas[ridx]
                    else:
                        # No charged placement — or the ledger's argmin
                        # landed on a dead replica (every candidate at
                        # inf): fall back to the live-pool pick.
                        replica = self.pool.best_for(names[mid], now,
                                                     store)
                        if replica is None:
                            reject(rid, "no live replica for " + names[mid],
                                   max(now, enq_c[rid]), now)
                            continue
                        ridx = replica_index[id(replica)]
                    replica_c[rid] = ridx
                    if replica.full():
                        # == now without lookahead; a speculatively-routed
                        # request cannot depart before its own enqueue.
                        reject(rid, "replica queue full",
                               max(now, enq_c[rid]), now)
                        continue
                    replica.enqueue(rid, mid)
                    depth = replica.depth()
                    if depth > replica.peak_depth:
                        replica.peak_depth = depth
                    if replica.current is None:
                        start_service(replica, now)

            elif ev.kind == FINISH:
                replica, rid, gen = ev.data
                if gen != replica.gen:
                    # Stale completion: the replica was killed (and its
                    # incarnation bumped) after this FINISH was pushed;
                    # the victim has already been rerouted or rejected.
                    continue
                finish_c[rid] = now
                replica.current = None
                replica.n_served += 1
                t_inf = float(service_c[rid])
                replica.busy_ms += t_inf
                mid = model_c[rid]
                if premodel is not None and icls_c[rid] >= 0:
                    # Class-attributed telemetry: feeds the request's
                    # believed class AND the pooled estimate.
                    store.observe_class(int(icls_c[rid]), names[mid], t_inf)
                else:
                    store.observe(names[mid], t_inf)
                mu_now[mid] = profiles[mid].mu
                # Cold-model refresh (§3.3): probe one stale model
                # out-of-band, as in the original closed loop.
                if self.cold_probe:
                    cold = store.cold_models()
                    if cold:
                        probe = cold[int(rng.integers(len(cold)))]
                        store.observe(probe, svc.sample(rng, probe))
                        mu_now[model_ids[probe]] = store.profiles[probe].mu
                        store.profiles[probe].last_selected = store.step
                evq.push(now + t_input_c[rid], DEPART, rid)
                if replica.queue:
                    start_service(replica, now)
                if drain_pending and replica.current is None \
                        and not replica.queue:
                    try_decommission(replica, now)

            elif ev.kind == DEPART:
                rid = ev.data
                depart_c[rid] = now
                completed.append(rid)
                if closed_loop and n_issued < n:
                    evq.push(arrivals.next_after(rng, now, n_issued),
                             ARRIVAL, n_issued)
                    n_issued += 1

            elif ev.kind == FAULT:
                f = ev.data
                if isinstance(f, ReplicaFault):
                    r = replica_by_name[f.replica]
                    if f.kind == "kill":
                        # Collect the in-flight request and the FIFO
                        # *before* the transition (kill() clears both and
                        # bumps the incarnation, orphaning the stale
                        # FINISH), then push every victim through the
                        # recovery path.
                        victims: List[int] = []
                        if r.current is not None:
                            victims.append(int(r.current))
                        while r.queue:
                            victims.append(r.pop_request())
                        r.kill(now)
                        for vid in victims:
                            reroute(vid, now, "replica failure")
                    elif f.kind == "degrade":
                        r.degrade(f.factor)
                    elif f.kind == "drain":
                        r.drain()
                    else:   # recover
                        r.recover(now)
                elif isinstance(f, LatencyDrift):
                    svc.set_drift(f.model, f.mu_mult, f.sigma_mult)
                else:       # NetworkDrift
                    net_scale = f.rtt_mult

            elif ev.kind == CONTROL:
                # Mid-run controller tick: one window of telemetry in,
                # one desired committed-replica count out.  Entirely
                # draw-free — the RNG stream is untouched.
                for r in list(drain_pending.values()):
                    try_decommission(r, now)
                wstats = router.window_stats()
                routed = max(int(wstats["n_routed"]), 1)
                # The observed start-wait mean lags a load step by a
                # queue's length (requests still waiting left no sample
                # yet), so pair it with the instantaneous backlog
                # estimate and act on whichever is worse.  The backlog
                # excludes each replica's in-service remainder: a lone
                # busy server with an empty queue is healthy, not a
                # scale-up signal.
                inst = []
                for r, w in zip(self.pool.replicas,
                                self.pool.wait_columns(now)):
                    if w == float("inf"):
                        continue
                    if r.current is not None:
                        w -= max(0.0, r.busy_until - now)
                    inst.append(w)
                obs = win_wait[0] / win_wait[1] if win_wait[1] else 0.0
                wait_sig = max(obs, float(np.mean(inst)) if inst else 0.0)
                serving = [r for r in self.pool.replicas
                           if r.health in (UP, DEGRADED)]
                busy_now = sum(r.busy_ms for r in self.pool.replicas)
                util = ((busy_now - last_busy[0])
                        / (max(len(serving), 1)
                           * elastic.control_interval_ms))
                reading = ControlReading(
                    mean_queue_wait_ms=wait_sig,
                    shed_rate=wstats["n_shed"] / routed,
                    fallback_rate=wstats["n_fallback"] / routed,
                    utilization=util,
                    n_routed=int(wstats["n_routed"]))
                # WARMING replicas count as committed capacity — they
                # are already paid for and about to come up; excluding
                # them would double-provision through every cold start.
                n_ctl = len(serving) + sum(
                    1 for r in self.pool.replicas if r.health == WARMING)
                desired = controller.target(n_ctl, reading)
                if desired > n_ctl:
                    evq.push(now, PROVISION, ("create", desired - n_ctl))
                elif desired < n_ctl:
                    scale_in(n_ctl - desired, now)
                last_busy[0] = busy_now
                win_wait[0] = 0.0
                win_wait[1] = 0
                if len(completed) + len(rejected) < n:
                    evq.push(now + elastic.control_interval_ms,
                             CONTROL, None)

            elif ev.kind == PROVISION:
                if ev.data[0] == "create":
                    provision(ev.data[1], now)
                else:
                    _, r, gen = ev.data
                    if r.gen == gen:
                        # Cold start complete: WARMING -> UP.  A bumped
                        # incarnation means the replica was cancelled
                        # while warming — it never serves.
                        r.warm_ready()

        # Per-run request records stay inspectable (per-SLA-class slicing
        # in tests and frontier studies reads them after run()) —
        # materialized lazily from the columns on first access.
        self._cols = cols
        self._completed_rids = completed
        self._rejected_rids = rejected
        self._model_names = names
        self._replica_names = [r.name for r in self.pool.replicas]
        self._class_labels = labels
        self._reasons = reasons
        self._completed_objs = None
        self._rejected_objs = None
        return self._summarise_cols(router.name, t_sla, truth, cols,
                                    completed, rejected, labels)

    # ------------------------------------------------------------------
    # lazy SimRequest materialization from the SoA columns
    # ------------------------------------------------------------------
    def _make_request(self, rid: int) -> SimRequest:
        c = self._cols
        mid = int(c.model[rid])
        rep = int(c.replica[rid])
        return SimRequest(
            rid=rid,
            arrival_ms=float(c.arrival[rid]),
            t_input_ms=float(c.t_input[rid]),
            t_sla_ms=float(c.t_sla[rid]),
            sla_class=self._class_labels[int(c.cls[rid])],
            model=self._model_names[mid] if mid >= 0 else "",
            replica=self._replica_names[rep] if rep >= 0 else "",
            fallback=bool(c.fallback[rid]),
            rejected=bool(c.rejected[rid]),
            reject_reason=self._reasons[int(c.reason[rid])],
            enqueue_ms=float(c.enqueue[rid]),
            service_start_ms=float(c.sstart[rid]),
            service_ms=float(c.service[rid]),
            finish_ms=float(c.finish[rid]),
            depart_ms=float(c.depart[rid]),
            retries=int(c.retries[rid]))

    @property
    def completed_requests(self) -> List[SimRequest]:
        if self._completed_objs is None:
            self._completed_objs = [self._make_request(r)
                                    for r in self._completed_rids]
        return self._completed_objs

    @property
    def rejected_requests(self) -> List[SimRequest]:
        if self._rejected_objs is None:
            self._rejected_objs = [self._make_request(r)
                                   for r in self._rejected_rids]
        return self._rejected_objs

    # ------------------------------------------------------------------
    def attainment_timeline(self, bucket_ms: float = 10_000.0
                            ) -> List[Dict[str, float]]:
        """Post-run time series over ``bucket_ms`` windows of enqueue
        time: one row per bucket with SLA attainment (rejections count
        as misses, like the run-level number), shed rate, mean accuracy
        over the bucket's completions, and recovery re-placements.  The
        dip-and-recovery chart of ``benchmarks/drift_resilience.py``
        reads this directly."""
        c = self._cols
        assert c is not None, "attainment_timeline requires a prior run()"
        ci = np.asarray(self._completed_rids, dtype=np.int64)
        rj = np.asarray(self._rejected_rids, dtype=np.int64)
        last = 0.0
        if len(ci):
            last = float(c.enqueue[ci].max())
        if len(rj):
            last = max(last, float(c.enqueue[rj].max()))
        n_b = int(last // bucket_ms) + 1
        total = np.zeros(n_b)
        met = np.zeros(n_b)
        shed = np.zeros(n_b)
        acc = np.zeros(n_b)
        done = np.zeros(n_b)
        retr = np.zeros(n_b)
        acc_by_id = np.array([e.top1 / 100.0 for e in self.entries])
        if len(ci):
            b = (c.enqueue[ci] // bucket_ms).astype(np.int64)
            e2e = (2.0 * c.t_input[ci] + (c.sstart[ci] - c.enqueue[ci])
                   + c.service[ci])
            np.add.at(total, b, 1.0)
            np.add.at(done, b, 1.0)
            np.add.at(met, b, (e2e <= c.t_sla[ci]).astype(np.float64))
            np.add.at(acc, b, acc_by_id[c.model[ci]])
            np.add.at(retr, b, c.retries[ci].astype(np.float64))
        if len(rj):
            b = (c.enqueue[rj] // bucket_ms).astype(np.int64)
            np.add.at(total, b, 1.0)
            np.add.at(shed, b, 1.0)
            np.add.at(retr, b, c.retries[rj].astype(np.float64))
        rows: List[Dict[str, float]] = []
        for i in range(n_b):
            n_i = total[i]
            if n_i == 0:
                continue
            rows.append({
                "t_ms": i * bucket_ms,
                "n": int(n_i),
                "attainment": float(met[i] / n_i),
                "shed_rate": float(shed[i] / n_i),
                "accuracy": float(acc[i] / done[i]) if done[i] else 0.0,
                "retries": int(retr[i]),
            })
        return rows

    # ------------------------------------------------------------------
    # SoA summary: every statistic is a vectorized reduction over the
    # request columns (sliced in completion order, matching the
    # historical per-object iteration element for element).
    # ------------------------------------------------------------------
    def _summarise(self, policy_name, t_sla, truth, completed, rejected
                   ) -> LoadSimResult:
        """Back-compat entry point over ``SimRequest`` object lists
        (tests and external harnesses call it directly): packs the
        objects into columns and defers to the vectorized summary."""
        objs = list(completed) + list(rejected)
        cols = _Columns(len(objs))
        model_ids = {name: i for i, name in enumerate(truth)}
        labels: List[str] = [""]
        code_of = {"": 0}
        for i, r in enumerate(objs):
            cols.arrival[i] = r.arrival_ms
            cols.t_input[i] = r.t_input_ms
            cols.t_sla[i] = r.t_sla_ms
            cols.enqueue[i] = r.enqueue_ms
            cols.sstart[i] = r.service_start_ms
            cols.service[i] = r.service_ms
            cols.finish[i] = r.finish_ms
            cols.depart[i] = r.depart_ms
            cols.model[i] = model_ids.get(r.model, -1)
            cols.rejected[i] = r.rejected
            code = code_of.get(r.sla_class)
            if code is None:
                code = code_of[r.sla_class] = len(labels)
                labels.append(r.sla_class)
            cols.cls[i] = code
        return self._summarise_cols(policy_name, t_sla, truth, cols,
                                    list(range(len(completed))),
                                    list(range(len(completed), len(objs))),
                                    labels)

    def _summarise_cols(self, policy_name, t_sla, truth, cols: _Columns,
                        completed: List[int], rejected: List[int],
                        labels: List[str]) -> LoadSimResult:
        n_arrived = len(completed) + len(rejected)
        acc_of = {name: e.top1 / 100.0 for name, e in truth.items()}
        rj = np.asarray(rejected, dtype=np.int64)
        per_class = self._per_class_cols(cols, completed, rejected, labels,
                                         truth, acc_of)
        n_retries = int(cols.retries.sum())
        if not completed:
            if len(rj):
                first = float(cols.arrival[rj].min())
                last = float(cols.depart[rj].max())
            else:
                first = last = 0.0
            rep_s, live_util = self._elastic_cost(first, last)
            return LoadSimResult(
                policy=policy_name, t_sla=t_sla,
                n_arrived=n_arrived, n_completed=0, n_rejected=len(rejected),
                sla_attainment=0.0, mean_accuracy=0.0, mean_latency=0.0,
                p50_latency=0.0, p99_latency=0.0, mean_queue_wait=0.0,
                p99_queue_wait=0.0, peak_queue_depth=0, model_usage={},
                replica_utilization={}, per_class=per_class,
                n_retries=n_retries,
                replica_seconds=rep_s, mean_live_utilization=live_util,
                n_provisioned=self._n_provisioned,
                n_decommissioned=self._n_decommissioned)
        model_ids = {name: i for i, name in enumerate(truth)}
        ci = np.asarray(completed, dtype=np.int64)
        t_input = cols.t_input[ci]
        wait = cols.sstart[ci] - cols.enqueue[ci]
        service = cols.service[ci]
        model = cols.model[ci]
        # Component sum, identical to SimRequest.e2e_ms per element.
        e2e = 2.0 * t_input + wait + service
        # Scored against each request's own SLA (identical to the scalar
        # comparison when every request carries the run-level t_sla).
        met = int((e2e <= cols.t_sla[ci]).sum())
        acc_by_id = np.array([e.top1 / 100.0 for e in truth.values()])
        counts = np.bincount(model, minlength=len(model_ids))
        usage = {name: int(counts[i]) for name, i in model_ids.items()
                 if counts[i]}
        # Horizon spans *every* request the pool saw — rejected ones
        # included, so utilization is not inflated under heavy shedding
        # (a shed request still occupies wall-clock on the timeline).
        first = float(cols.arrival[ci].min())
        last = float(cols.depart[ci].max())
        if len(rj):
            first = min(first, float(cols.arrival[rj].min()))
            last = max(last, float(cols.depart[rj].max()))
        horizon = max(last - first, 1e-9)
        rep_s, live_util = self._elastic_cost(first, last)
        return LoadSimResult(
            policy=policy_name, t_sla=t_sla,
            n_arrived=n_arrived, n_completed=len(completed),
            n_rejected=len(rejected),
            sla_attainment=met / max(n_arrived, 1),
            mean_accuracy=float(np.mean(acc_by_id[model])),
            mean_latency=float(e2e.mean()),
            p50_latency=float(np.percentile(e2e, 50)),
            p99_latency=float(np.percentile(e2e, 99)),
            p95_latency=float(np.percentile(e2e, 95)),
            mean_queue_wait=float(wait.mean()),
            p99_queue_wait=float(np.percentile(wait, 99)),
            p95_queue_wait=float(np.percentile(wait, 95)),
            peak_queue_depth=max(r.peak_depth for r in self.pool.replicas),
            model_usage={k: v / len(completed)
                         for k, v in sorted(usage.items())},
            replica_utilization={r.name: r.busy_ms / horizon
                                 for r in self.pool.replicas},
            horizon_ms=horizon,
            per_class=per_class,
            n_retries=n_retries,
            replica_seconds=rep_s, mean_live_utilization=live_util,
            n_provisioned=self._n_provisioned,
            n_decommissioned=self._n_decommissioned)

    def _elastic_cost(self, first: float, last: float):
        """Replica-seconds (committed window ∩ horizon, minus dead time,
        summed over the pool — the frontier's cost axis) and the
        alive-window-normalized mean utilization.  On a static
        fault-free pool: exactly n × horizon and the plain mean of
        ``replica_utilization``."""
        alive = [r.alive_ms(first, last) for r in self.pool.replicas]
        live = [r.busy_ms / a for r, a in zip(self.pool.replicas, alive)
                if a > 1e-9]
        return (sum(alive) / 1000.0,
                float(np.mean(live)) if live else 0.0)

    def committed_replica_count(self) -> int:
        """Replicas still accruing cost and able to (eventually) serve —
        UP, DEGRADED, or WARMING.  The scenario harness carries this
        across epochs when a mid-run controller resizes the pool."""
        return sum(1 for r in self.pool.replicas
                   if r.health in (UP, DEGRADED, WARMING))

    @staticmethod
    def _per_class_cols(cols: _Columns, completed: List[int],
                        rejected: List[int], labels: List[str],
                        truth, acc_of) -> Dict[str, Dict[str, float]]:
        """Class-sliced attainment/accuracy/shed rows, vectorized over
        the record columns; {} when no request carried a class label
        (the common single-class run)."""
        ci = np.asarray(completed, dtype=np.int64)
        rj = np.asarray(rejected, dtype=np.int64)
        cc = cols.cls[ci] if len(ci) else np.empty(0, np.int32)
        rc = cols.cls[rj] if len(rj) else np.empty(0, np.int32)
        seen = set(np.unique(cc)) | set(np.unique(rc))
        seen = {int(c) for c in seen if labels[int(c)]}
        if not seen:
            return {}
        acc_by_id = np.array([acc_of[name] for name in truth])
        t_input = cols.t_input[ci]
        wait = cols.sstart[ci] - cols.enqueue[ci]
        e2e = 2.0 * t_input + wait + cols.service[ci]
        met_mask = e2e <= cols.t_sla[ci]
        out: Dict[str, Dict[str, float]] = {}
        # All arrived requests carry a code (unlabelled == code 0 == "");
        # classes are reported in sorted label order, like the legacy
        # per-object slicing.
        present = sorted({labels[int(c)] for c in
                          set(np.unique(cc)) | set(np.unique(rc))})
        for lab in present:
            code = labels.index(lab)
            dmask = cc == code
            n_done = int(dmask.sum())
            n_shed = int((rc == code).sum())
            n_cls = n_done + n_shed
            out[lab or "default"] = {
                "n_arrived": n_cls,
                "n_rejected": n_shed,
                "shed_rate": n_shed / max(n_cls, 1),
                "attainment": int(met_mask[dmask].sum()) / max(n_cls, 1),
                "accuracy": (float(np.mean(acc_by_id[cols.model[ci][dmask]]))
                             if n_done else 0.0),
                "mean_latency": (float(np.mean(e2e[dmask]))
                                 if n_done else 0.0),
            }
        return out


def rate_sweep(sim: ServingSimulator, policy_fn, rates_rps: Sequence[float],
               t_sla: float, n_requests: int = 2000) -> List[LoadSimResult]:
    """Arrival-rate sweep: SLA attainment vs offered load.

    ``policy_fn()`` builds a fresh policy per point (stateful policies
    like ``StaticGreedy`` must not leak across runs)."""
    from repro_torch.sim.arrivals import PoissonArrivals
    return [sim.run(policy_fn(), t_sla, n_requests,
                    arrivals=PoissonArrivals(rate))
            for rate in rates_rps]
