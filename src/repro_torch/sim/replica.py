"""Replicas: FIFO-queued serving endpoints over a heterogeneous pool.

A ``Replica`` models one serving endpoint (the paper's per-model GPU
endpoint): a single server with a FIFO queue, a speed factor
(heterogeneity), and an optional queue-depth cap (admission control).
``ReplicaPool`` routes a selected model to the least-loaded capable
replica and answers the queue-wait estimates
``W_queue(m)`` that the queue-aware policy consumes.

Hot-path representation: the discrete-event engine ``bind()``s the pool
to its SoA request columns at run start, after which queues hold plain
request *indices* (ints into the engine's record arrays) instead of
request objects, and the wait estimate walks an int deque against a
model-id column and a current-μ list — no dict lookups, no attribute
chasing.  Each replica additionally tracks per-model queue counts, so
beyond ``EXACT_WALK_MAX`` queued requests the estimate switches to the
O(n_models) closed form ``Σ counts[m]·μ(m)/speed`` (identical up to
float associativity; the element-order walk is kept below the threshold
so moderate-load seeded runs stay bit-identical to the historical
object walk).  Unbound pools (constructed directly in tests) keep the
legacy object-queue behaviour.

``GaussianServiceModel`` is the ground-truth latency process shared with
the closed-loop simulator: truncated normal per model plus the optional
co-tenant spike process of ``core/simulate.py``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import ProfileStore
from repro_torch.core.zoo import ZooEntry
from repro_torch.router.charging import ChargedWaits

# Queue depth up to which the wait estimate walks the FIFO element by
# element (bit-identical to the historical per-object walk); deeper
# queues use the per-model-count closed form, which differs only by
# float-addition associativity but turns the saturated-load estimate
# from O(depth) into O(n_models).
EXACT_WALK_MAX = 64

# Replica health states (fault injection, ``sim/faults.py``; elastic
# lifecycle, ``sim/elastic.py``): UP and DEGRADED accept new work;
# WARMING is provisioned but still cold-starting (accepts nothing,
# serves nothing — it becomes UP only after ``cold_start_ms``);
# DRAINING finishes its queue but accepts nothing; DOWN serves nothing.
# ``Replica.accepting`` caches the accepts-new-work predicate so the
# wait-column hot path reads one bool.
UP = "up"
DEGRADED = "degraded"
WARMING = "warming"
DRAINING = "draining"
DOWN = "down"
HEALTH_STATES = (UP, DEGRADED, WARMING, DRAINING, DOWN)

_INF = float("inf")


@dataclass
class GaussianServiceModel:
    """True per-model inference latency: N(mu, sigma) truncated at a
    floor, optionally hit by a multiplicative co-tenant spike."""
    truth: Dict[str, ZooEntry]
    spike_prob: float = 0.0
    spike_mult: float = 10.0
    floor_ms: float = 0.05

    # Mid-run latency drift (``sim/faults.py`` LatencyDrift): absolute
    # multipliers vs the seeded truth, keyed by model name.  The shared
    # ZooEntry truth objects are never mutated; empty dicts take the
    # historical branch, so no-drift runs are draw-for-draw identical.
    mu_scale: Dict[str, float] = field(default_factory=dict)
    sigma_scale: Dict[str, float] = field(default_factory=dict)

    def sample(self, rng: np.random.Generator, model: str,
               speed: float = 1.0) -> float:
        e = self.truth[model]
        if self.mu_scale or self.sigma_scale:
            mu = e.mu_ms * self.mu_scale.get(model, 1.0)
            sg = e.sigma_ms * self.sigma_scale.get(model, 1.0)
            t = max(self.floor_ms, rng.normal(mu, sg))
        else:
            t = max(self.floor_ms, rng.normal(e.mu_ms, e.sigma_ms))
        if self.spike_prob > 0 and rng.random() < self.spike_prob:
            t *= self.spike_mult
        return t / speed

    def set_drift(self, model: str, mu_mult: float = 1.0,
                  sigma_mult: float = 1.0) -> None:
        """Apply a latency drift (absolute vs the seeded truth); 1.0
        removes the scale so a fully-recovered process is again the
        branch-free historical sampler."""
        if model not in self.truth:
            raise KeyError(f"unknown model {model!r}")
        if mu_mult == 1.0:
            self.mu_scale.pop(model, None)
        else:
            self.mu_scale[model] = float(mu_mult)
        if sigma_mult == 1.0:
            self.sigma_scale.pop(model, None)
        else:
            self.sigma_scale[model] = float(sigma_mult)


@dataclass
class Replica:
    """One FIFO-queued server.  ``models=()`` means it serves the whole
    zoo (shared endpoint); otherwise only the named models.

    When the owning pool is ``bind()``-ed, ``queue`` holds request
    indices (ints) and ``current`` the in-service request index; unbound
    replicas carry request objects, the legacy interface."""
    name: str
    models: Tuple[str, ...] = ()
    speed: float = 1.0
    max_queue_depth: Optional[int] = None

    queue: Deque = field(default_factory=deque, repr=False)
    current: Optional[object] = field(default=None, repr=False)
    busy_until: float = 0.0
    n_served: int = 0
    busy_ms: float = 0.0
    peak_depth: int = 0

    # Health (fault injection): ``accepting`` caches "takes new work"
    # so the wait-column hot path reads one bool per replica.  ``gen``
    # is the incarnation token: a kill bumps it, invalidating FINISH
    # events issued against the dead incarnation.
    health: str = UP
    accepting: bool = True
    gen: int = 0
    base_speed: Optional[float] = field(default=None, repr=False)

    # Elastic lifecycle cost accounting (``sim/elastic.py``): a replica
    # accrues cost from ``commission_ms`` (0.0 for the static pool the
    # run started with) until ``decommission_ms`` (None = still
    # committed at run end).  ``down_ms_total``/``down_since`` subtract
    # mid-run dead time (kill → recover windows) so the live-window
    # utilization the autoscaler reads is not diluted by intervals a
    # replica could not have served.
    commission_ms: float = 0.0
    decommission_ms: Optional[float] = None
    down_ms_total: float = 0.0
    down_since: Optional[float] = field(default=None, repr=False)

    # SoA binding (set by ReplicaPool.bind); None == legacy object mode.
    _model_of: Optional[Sequence[int]] = field(default=None, repr=False,
                                               init=False)
    _mu: Optional[List[float]] = field(default=None, repr=False, init=False)
    _counts: Optional[List[int]] = field(default=None, repr=False, init=False)

    def serves(self, model: str) -> bool:
        return not self.models or model in self.models

    # -- health transitions (fault injection) ---------------------------
    def kill(self, now: Optional[float] = None) -> None:
        """Hard failure: drop out of service.  The caller (engine FAULT
        handler) reads ``current`` and drains ``queue`` *before* calling
        this, then re-routes the victims; bumping ``gen`` invalidates
        the in-flight FINISH event.  ``now`` (when the caller knows the
        simulation clock) starts the dead-time window that live-window
        utilization subtracts; legacy no-arg calls skip the tracking."""
        self.health = DOWN
        self.accepting = False
        self.gen += 1
        self.current = None
        self.busy_until = 0.0
        if now is not None and self.down_since is None:
            self.down_since = now

    def degrade(self, factor: float) -> None:
        """Slow down by ``factor`` (co-tenant pressure, thermal
        throttling): still serving, still accepting.  Repeated degrades
        compound against the *base* speed, not each other."""
        if self.base_speed is None:
            self.base_speed = self.speed
        self.speed = self.base_speed / factor
        self.health = DEGRADED

    def drain(self) -> None:
        """Stop accepting new work; finish what is queued."""
        self.health = DRAINING
        self.accepting = False

    def recover(self, now: Optional[float] = None) -> None:
        """Back to full speed and accepting (from any state)."""
        if self.base_speed is not None:
            self.speed = self.base_speed
            self.base_speed = None
        self.health = UP
        self.accepting = True
        if now is not None and self.down_since is not None:
            self.down_ms_total += max(0.0, now - self.down_since)
            self.down_since = None

    # -- elastic lifecycle (``sim/elastic.py``) -------------------------
    def start_warming(self, now: float) -> None:
        """Provisioned but cold-starting: committed (accruing cost from
        ``now``) yet serving nothing until :meth:`warm_ready`."""
        self.health = WARMING
        self.accepting = False
        self.commission_ms = now

    def warm_ready(self) -> None:
        """Cold start complete: start accepting.  The caller (engine
        PROVISION handler) checks the incarnation token first, so a
        replica cancelled while warming never flips to UP."""
        if self.health == WARMING:
            self.health = UP
            self.accepting = True

    def decommission(self, now: float) -> None:
        """Leave the pool for good: stop accruing cost at ``now``.  Only
        legal on an idle replica — drain-based scale-in finishes the
        queue first, so no in-flight request is ever lost to a
        decommission."""
        assert self.current is None and not self.queue, \
            f"decommission of non-idle replica {self.name!r}"
        self.health = DOWN
        self.accepting = False
        self.decommission_ms = now

    def committed(self) -> bool:
        """Accruing cost: provisioned (even if still warming or
        draining) and not yet decommissioned/killed."""
        return self.decommission_ms is None and self.health != DOWN

    def alive_ms(self, first_ms: float, last_ms: float) -> float:
        """The committed window overlapped with ``[first_ms, last_ms]``,
        minus mid-run dead time — the denominator for live-window
        utilization and the replica-seconds cost integral.  Static
        always-up replicas report exactly the horizon."""
        start = max(first_ms, self.commission_ms)
        end = last_ms if self.decommission_ms is None \
            else min(last_ms, self.decommission_ms)
        alive = max(0.0, end - start) - self.down_ms_total
        if self.down_since is not None:     # still down at run end
            alive -= max(0.0, end - max(self.down_since, start))
        return max(alive, 0.0)

    def depth(self) -> int:
        return len(self.queue) + (1 if self.current is not None else 0)

    def full(self) -> bool:
        return (self.max_queue_depth is not None
                and self.depth() >= self.max_queue_depth)

    # -- SoA fast path --------------------------------------------------
    def enqueue(self, rid: int, mid: int) -> None:
        """Queue request ``rid`` (model id ``mid``) — bound mode only."""
        self.queue.append(rid)
        self._counts[mid] += 1

    def pop_request(self) -> int:
        """Dequeue the next request index — bound mode only."""
        rid = self.queue.popleft()
        self._counts[self._model_of[rid]] -= 1
        return rid

    def estimated_wait(self, now: float, store: ProfileStore) -> float:
        """Queue-wait estimate using what the router knows: the profile
        store's mean latency per queued model plus the in-flight
        remainder.  This is W_queue(m) for any model routed here."""
        w = max(0.0, self.busy_until - now) if self.current is not None else 0.0
        mu = self._mu
        if mu is not None:
            q = self.queue
            s = self.speed
            if len(q) <= EXACT_WALK_MAX:
                mo = self._model_of
                for rid in q:
                    w += mu[mo[rid]] / s
            else:
                for m, c in enumerate(self._counts):
                    if c:
                        w += c * (mu[m] / s)
            return w
        for req in self.queue:
            w += store[req.model].mu / self.speed
        return w

    def reset(self) -> None:
        self.queue.clear()
        self.current = None
        self.busy_until = 0.0
        self.n_served = 0
        self.busy_ms = 0.0
        self.peak_depth = 0
        self.health = UP
        self.accepting = True
        self.gen = 0
        self.commission_ms = 0.0
        self.decommission_ms = None
        self.down_ms_total = 0.0
        self.down_since = None
        if self.base_speed is not None:
            self.speed = self.base_speed
            self.base_speed = None
        self._model_of = None
        self._mu = None
        self._counts = None


class ReplicaPool:
    def __init__(self, replicas: List[Replica]):
        assert replicas, "need at least one replica"
        self.replicas = list(replicas)
        # model name -> capable replicas (and their pool indices), in
        # pool order (the tie-break order ``min`` preserved
        # historically).  Built on bind(); a None cache falls back to a
        # per-call scan.
        self._cands: Optional[Dict[str, List[Replica]]] = None
        self._cand_idx: Optional[Dict[str, List[int]]] = None
        # Charged-state caches (bind()): model order, candidate index
        # arrays in that order, the speed column, the live μ list.
        self._names: Optional[Tuple[str, ...]] = None
        self._cand_arrays: Optional[List[np.ndarray]] = None
        self._speeds: Optional[np.ndarray] = None
        self._mu_now: Optional[List[float]] = None

    def bind(self, model_names: Sequence[str], model_of: Sequence[int],
             mu_now: List[float]) -> None:
        """Attach the engine's SoA columns for one run: ``model_of`` maps
        request index -> model id (written by the engine as requests are
        routed), ``mu_now`` is the live model-id -> current-μ list the
        engine keeps in sync with the profile store.  Also freezes the
        model -> candidate-replica index (the topology is static within
        a run)."""
        n_models = len(model_names)
        for r in self.replicas:
            r._model_of = model_of
            r._mu = mu_now
            r._counts = [0] * n_models
        self._cands = {}
        self._cand_idx = {}
        for name in model_names:
            ix = [i for i, r in enumerate(self.replicas) if r.serves(name)]
            if not ix:
                raise KeyError(f"no replica serves model {name!r}")
            self._cands[name] = [self.replicas[i] for i in ix]
            self._cand_idx[name] = ix
        self._names = tuple(model_names)
        self._cand_arrays = [np.asarray(self._cand_idx[n], dtype=np.int64)
                             for n in model_names]
        self._speeds = np.array([r.speed for r in self.replicas])
        self._mu_now = mu_now

    def add_replica(self, r: Replica) -> int:
        """Mid-run pool extension (elastic scale-up): append ``r`` and —
        when the pool is bound — splice it into every bind-frozen SoA
        cache (candidate lists/arrays, speed column, per-replica count
        vector) so the wait-column and charged-state hot paths see the
        newcomer without a rebind.  Returns the new pool index."""
        idx = len(self.replicas)
        self.replicas.append(r)
        if self._cands is not None:
            r._model_of = self.replicas[0]._model_of
            r._mu = self._mu_now
            r._counts = [0] * len(self._names)
            for j, name in enumerate(self._names):
                if r.serves(name):
                    self._cands[name].append(r)
                    self._cand_idx[name].append(idx)
                    self._cand_arrays[j] = np.append(self._cand_arrays[j],
                                                     np.int64(idx))
            self._speeds = np.append(self._speeds, r.speed)
        return idx

    def candidates(self, model: str) -> List[Replica]:
        if self._cands is not None:
            try:
                return self._cands[model]
            except KeyError:
                raise KeyError(f"no replica serves model {model!r}")
        out = [r for r in self.replicas if r.serves(model)]
        if not out:
            raise KeyError(f"no replica serves model {model!r}")
        return out

    def best_for(self, model: str, now: float,
                 store: ProfileStore) -> Optional[Replica]:
        """Least-estimated-wait capable *accepting* replica (ties: pool
        order, matching the historical ``min``).  ``None`` when every
        capable replica is down/draining — the caller rejects or
        re-routes."""
        cands = self.candidates(model)
        if len(cands) == 1:
            r = cands[0]
            return r if r.accepting else None
        best = None
        best_w = _INF
        for r in cands:
            if not r.accepting:
                continue
            w = r.estimated_wait(now, store)
            if w < best_w:
                best_w = w
                best = r
        return best

    def queue_wait(self, model: str, now: float,
                   store: ProfileStore) -> float:
        """W_queue(m): wait at the replica that would serve ``model``."""
        return min(r.estimated_wait(now, store)
                   for r in self.candidates(model))

    def wait_columns(self, now: float) -> List[float]:
        """Every replica's wait estimate computed exactly once (the
        estimate inlined — same ops, same floats as ``estimated_wait``)
        — the per-replica column behind both the frozen
        ``waits_by_name`` snapshot and the live ``charged_state``.
        Requires ``bind()`` (the engine's per-run setup)."""
        assert self._cands is not None, "wait_columns requires bind()"
        ws = []
        for r in self.replicas:
            if not r.accepting:
                ws.append(_INF)
                continue
            w = max(0.0, r.busy_until - now) if r.current is not None \
                else 0.0
            q = r.queue
            if q:
                mu, s = r._mu, r.speed
                if len(q) <= EXACT_WALK_MAX:
                    mo = r._model_of
                    for rid in q:
                        w += mu[mo[rid]] / s
                else:
                    for m, c in enumerate(r._counts):
                        if c:
                            w += c * (mu[m] / s)
            ws.append(w)
        return ws

    def charged_state(self, now: float) -> ChargedWaits:
        """The intra-batch charging ledger for one routing batch:
        per-replica wait columns plus the bind-frozen candidate
        topology, speeds and the engine's live μ list — the same floats
        ``waits_by_name`` reduces into its frozen dict, but mutable, so
        the router can charge each admitted pick before judging the
        next request of the batch."""
        assert self._cand_arrays is not None, "charged_state requires bind()"
        return ChargedWaits(self.wait_columns(now), self._cand_arrays,
                            self._speeds, self._mu_now, self._names)

    def waits_by_name(self, now: float, store: ProfileStore
                      ) -> Dict[str, float]:
        """One frozen routing snapshot: :meth:`wait_columns` reduced per
        model over its cached candidate indices — what ``queue_wait``
        would produce per model, without re-walking shared queues once
        per pool member.  Requires ``bind()``."""
        ws = self.wait_columns(now)
        out = {}
        for m, ix in self._cand_idx.items():
            w = ws[ix[0]]
            for j in ix[1:]:
                if ws[j] < w:
                    w = ws[j]
            out[m] = w
        return out

    def reset(self) -> None:
        for r in self.replicas:
            r.reset()
        self._cands = None
        self._cand_idx = None
        self._names = None
        self._cand_arrays = None
        self._speeds = None
        self._mu_now = None


def shared_replicas(n: int = 1, *, speeds: Optional[List[float]] = None,
                    max_queue_depth: Optional[int] = None) -> ReplicaPool:
    """``n`` replicas that each serve every model (shared endpoints)."""
    speeds = speeds or [1.0] * n
    assert len(speeds) == n
    return ReplicaPool([
        Replica(name=f"r{i}", models=(), speed=s,
                max_queue_depth=max_queue_depth)
        for i, s in enumerate(speeds)])


def per_model_replicas(entries: List[ZooEntry], *,
                       replicas_per_model: int = 1,
                       speed: float = 1.0,
                       max_queue_depth: Optional[int] = None) -> ReplicaPool:
    """The paper's topology: a dedicated endpoint per zoo member."""
    out = []
    for e in entries:
        for k in range(replicas_per_model):
            out.append(Replica(name=f"{e.name}/{k}", models=(e.name,),
                               speed=speed, max_queue_depth=max_queue_depth))
    return ReplicaPool(out)
