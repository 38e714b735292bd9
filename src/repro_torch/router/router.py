"""The unified Router: one request/decision surface for every substrate.

ModiPick's entire runtime contribution is a single decision — pick the
model that maximises accuracy within ``T_budget = T_sla − 2·T_input
(− W_queue)`` — and this object is that decision's only implementation.
In the reference the closed-loop paper simulator, the discrete-event
engine and the live pool executor all route through a :class:`Router`;
in this package the live pool executor (``serving.executor``) does, and
the simulators follow with later slices.

Two entry surfaces share one implementation:

- :meth:`Router.route_batch_arrays` — the array-native hot path: budget
  / SLA-class / input-time *columns* in, a :class:`BatchDecisions`
  column set (picked model indices, admission verdicts, charged replica
  placements) out.  No per-request ``InferenceRequest`` /
  ``RouterDecision`` object is constructed.  This is what the
  discrete-event engine calls.
- :meth:`Router.route` / :meth:`Router.route_batch` — the object
  schema (``InferenceRequest`` → ``RouterDecision``) for callers that
  want the full budget breakdown and stage traces; a thin adapter over
  the array core.

Intra-batch load charging (the staleness fix)
---------------------------------------------
A batch routed against one frozen ``W_queue`` snapshot degenerates: all
B requests see the same idle-looking accurate models and pile onto
them.  When the caller hands over a :class:`ChargedWaits` state (the
engine builds one per batch from its replica pool), the batch is routed
*sequentially-greedily*: each admitted pick's mean service time μ is
charged to its chosen replica before the next request is judged, so
request ``i+1`` sees waits that include requests ``0..i`` — admission
verdicts and selection budgets both consult the charged waits, making
shedding honest under bursts.  The charged batch is pick-for-pick what
B sequential singleton ``route`` calls (the trusted scalar path) would
produce.  ``charge=False`` keeps the historical one-snapshot semantics
(the speculative-lookahead contract, and the ablation baseline).

Per batch, the router:

1. resolves the wait telemetry once — a live :class:`ChargedWaits`
   state, a frozen ``w_queue_map`` snapshot, a ``w_queue_fn`` estimator,
   or the store's own EWMA queue telemetry;
2. runs the pluggable :class:`AdmissionController` per request *before*
   selection — shed requests never spend a selection (nor a charge);
3. selects for the admitted requests: a singleton batch rides the scalar
   ``policy.select_traced``/``select_lean`` (draw-for-draw identical to
   the historical per-request call sites, which is what keeps seeded
   single-SLA goldens bit-identical); a charged batch rides the same
   scalar core sequentially (or the device-resident charged pass,
   ``kernels.policy_select.select_charged``, on a device backend: the
   ``charged_select`` kernel on ``cuda``, its plain PyTorch version on
   ``cpu``); an uncharged batch rides the vectorized
   ``policy_vec.select_batch_traced``.

Queue-aware mode presents the policy with the shifted-μ store view
(``router.queueaware.shifted_store``), exactly as the per-call-site
wrappers used to.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import policy_vec
from repro_torch.core.policy import ModiPick, Policy, budget
from repro_torch.core.profiles import ProfileStore

from repro_torch.router.admission import (AdmissionController, AdmitAll, DepthFn,
                                    SlaAwareAdmission)
from repro_torch.router.api import (BatchDecisions, BudgetBreakdown,
                              InferenceRequest, RouterDecision)
from repro_torch.router.charging import ChargedWaits
from repro_torch.router.queueaware import WQueueFn, shifted_store
from repro_torch.router.retry import cheapest_viable


class Router:
    """Substrate-independent SLA-aware model router.

    Owns the :class:`ProfileStore` (profiles, queue telemetry, selection
    bookkeeping), a pluggable :class:`Policy` and a pluggable
    :class:`AdmissionController`.
    """

    def __init__(self, store: ProfileStore, policy: Policy, *,
                 admission: Optional[AdmissionController] = None,
                 queue_aware: bool = False,
                 backend: Optional[str] = None,
                 trace_detail: bool = True):
        self.store = store
        self.policy = policy
        self.admission = admission if admission is not None else AdmitAll()
        # Controllers that never overrode the base no-op verdict can be
        # skipped wholesale on the batch hot path (method identity, so
        # any subclass with a real ``admit`` is detected automatically).
        self._admits_all = (type(self.admission).admit
                            is AdmissionController.admit)
        self.queue_aware = queue_aware
        self.backend = backend
        # False: batched decisions carry chosen + fallback only (no
        # per-request eligible/probs tuples) — the event-loop hot-path
        # mode.  Singleton batches always return the full scalar trace.
        self.trace_detail = trace_detail
        base_name = getattr(policy, "name", str(policy))
        self.name = f"qa_{base_name}" if queue_aware else base_name
        # Router-side telemetry no pre-router entry point could express.
        self.n_routed = 0
        self.n_admitted = 0
        self.n_shed = 0
        self.n_fallback = 0
        self.n_batches = 0
        # Recovery path (router.retry): re-route requests and outcomes.
        self.n_retries = 0
        self.n_retry_routed = 0
        self.n_retry_exhausted = 0
        # window_stats() baseline: the lifetime counters at the last
        # window boundary (empty == window starts at construction).
        self._win_base: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # object surface (adapters over the array core)
    # ------------------------------------------------------------------
    def route(self, request: InferenceRequest, rng: np.random.Generator, *,
              w_queue_fn: Optional[WQueueFn] = None,
              depth_fn: Optional[DepthFn] = None) -> RouterDecision:
        """Route one request (a batch of one: scalar selection path)."""
        return self.route_batch([request], rng, w_queue_fn=w_queue_fn,
                                depth_fn=depth_fn)[0]

    def route_batch(self, requests: Sequence[InferenceRequest],
                    rng: np.random.Generator, *,
                    w_queue_fn: Optional[WQueueFn] = None,
                    depth_fn: Optional[DepthFn] = None,
                    w_queue_map: Optional[Dict[str, float]] = None,
                    charge: bool = False
                    ) -> List[RouterDecision]:
        """Route a batch of requests; returns one decision per request.

        ``w_queue_fn`` maps a model name to its estimated queue wait
        (ms) *now*; when omitted in queue-aware mode the store's own
        EWMA queue telemetry is used.  ``w_queue_map`` hands over the
        whole snapshot at once — a complete name -> wait mapping of
        clamped non-negative floats.  By default all requests in the
        batch see the same snapshot (the historical speculative-lookahead
        contract); ``charge=True`` switches to intra-batch load charging
        — each admitted pick's μ is charged to its model's queue before
        the next request is judged (see :meth:`route_batch_arrays`, the
        array-native entry this adapter wraps).
        """
        reqs = list(requests)
        if not reqs:
            return []
        res = self.route_batch_arrays(
            [r.t_sla_ms for r in reqs], [r.t_input_ms for r in reqs], rng,
            w_queue_fn=w_queue_fn, w_queue_map=w_queue_map,
            depth_fn=depth_fn, charge=charge, _requests=reqs)
        decisions: List[RouterDecision] = []
        traces = res.traces or [None] * len(reqs)
        for i, req in enumerate(reqs):
            bd = BudgetBreakdown(t_sla_ms=req.t_sla_ms,
                                 t_network_ms=2.0 * req.t_input_ms,
                                 w_queue_ms=float(res.w_queue_ms[i]))
            if res.admitted[i]:
                decisions.append(RouterDecision(
                    request=req, variant=res.names[int(res.model_idx[i])],
                    admitted=True, budget=bd, trace=traces[i]))
            else:
                decisions.append(RouterDecision(
                    request=req, variant="", admitted=False,
                    reject_reason=res.reason_of(i), budget=bd))
        return decisions

    # ------------------------------------------------------------------
    # array-native core
    # ------------------------------------------------------------------
    def route_batch_arrays(self, t_sla_ms, t_input_ms,
                           rng: np.random.Generator, *,
                           sla_class: Optional[Sequence[Optional[str]]] = None,
                           charged: Optional[ChargedWaits] = None,
                           w_queue_map: Optional[Dict[str, float]] = None,
                           w_queue_fn: Optional[WQueueFn] = None,
                           depth_fn: Optional[DepthFn] = None,
                           charge: bool = True,
                           _requests: Optional[Sequence[InferenceRequest]]
                           = None) -> BatchDecisions:
        """Array-in/array-out routing: the hot-path entry point.

        ``t_sla_ms`` / ``t_input_ms``: (B,) per-request columns (the
        budget is ``T_sla − 2·T_input`` per row); ``sla_class``: optional
        (B,) label column consumed by class-aware admission.  Wait
        telemetry, in precedence order: ``charged`` (a live
        :class:`ChargedWaits` replica-column state — required for true
        per-replica charging and placement), ``w_queue_map`` (frozen
        name → wait snapshot), ``w_queue_fn``, the store's EWMA.

        With ``charge=True`` (default) and more than one request, the
        batch is routed sequentially-greedily against the charged waits;
        a snapshot-only wait source is promoted to model-granularity
        pseudo-replica charging.  A batch of one always rides the
        scalar path, bit-identical to :meth:`route` — charging cannot
        perturb it (there is nothing within the batch to charge
        against).

        Returns a :class:`BatchDecisions` column set.  No per-request
        objects are created unless a non-trivial admission controller
        needs a request record to judge (``_requests`` lets the object
        adapter pass the real ones through).
        """
        t_sla = np.asarray(t_sla_ms, dtype=np.float64)
        t_input = np.asarray(t_input_ms, dtype=np.float64)
        B = len(t_sla)
        tab = self.store.table()
        want_traces = _requests is not None
        res = BatchDecisions.empty(B, tab.names, traces=want_traces)
        if B == 0:
            return res

        # -- resolve the wait telemetry once per batch ------------------
        needs_waits = self.queue_aware or self.admission.needs_w_queue
        state: Optional[ChargedWaits] = None
        waits: Optional[Dict[str, float]] = None
        if needs_waits:
            if charged is not None:
                state = charged
            elif w_queue_map is not None:
                waits = w_queue_map
            else:
                # No injected snapshot: query per model, falling back to
                # the store's own EWMA queue telemetry (0 until the
                # first observation) absent an estimator.
                fn = w_queue_fn or self.store.queue_wait
                waits = {n: max(0.0, float(fn(n)))
                         for n in self.store.profiles}

        if B == 1:
            self._route_singleton(
                res, float(t_sla[0]), float(t_input[0]), rng, state, waits,
                depth_fn,
                _requests[0] if _requests is not None else None,
                sla_class[0] if sla_class is not None else None)
        elif charge and needs_waits:
            if state is None:
                # Snapshot-only telemetry: charge at model granularity
                # (each model its own queue — the per-model-endpoint
                # topology) so the fix does not require a replica pool.
                state = ChargedWaits.per_model(
                    tab.names, [waits[n] for n in tab.names], tab.mu)
            self._route_charged(res, t_sla, t_input, rng, state, depth_fn,
                                _requests, sla_class)
        else:
            self._route_snapshot(res, t_sla, t_input, rng,
                                 state.as_map() if state is not None
                                 else waits,
                                 depth_fn, _requests, sla_class)

        self.n_batches += 1
        self.n_routed += B
        n_admitted = int(res.admitted.sum())
        self.n_admitted += n_admitted
        self.n_shed += B - n_admitted
        return res

    # ------------------------------------------------------------------
    def _admission_request(self, requests, sla_class, i,
                           t_sla: float, t_input: float) -> InferenceRequest:
        if requests is not None:
            return requests[i]
        return InferenceRequest(
            t_sla_ms=t_sla, t_input_ms=t_input, rid=i,
            sla_class=sla_class[i] if sla_class is not None else None)

    def _shed(self, res: BatchDecisions, i: int, reason: str,
              w_min: float) -> None:
        try:
            code = res.reasons.index(reason)
        except ValueError:
            code = len(res.reasons)
            res.reasons.append(reason)
        res.reject_code[i] = code
        res.w_queue_ms[i] = w_min

    def _route_scalar(self, t_sla, t_input, rng, waits, depth_fn,
                      request, cls):
        """The scalar core — draw-for-draw identical to the historical
        per-request call sites (python-float budget math, one shifted
        view, ``select_traced``/``select_lean``).  Returns
        ``(mid, fallback, w_queue_ms, reason, trace)`` with ``mid == -1``
        (and the shed reason) when admission rejects."""
        b0 = budget(t_sla, t_input)
        w_fn = waits.__getitem__ if waits is not None else None
        if not self._admits_all:
            req = (request if request is not None else
                   self._admission_request(None, (cls,), 0, t_sla, t_input))
            ok, reason = self.admission.admit(req, b0, self.store.table(),
                                              w_fn, depth_fn)
            if not ok:
                return (-1, False,
                        min(waits.values()) if waits else 0.0, reason, None)
        # ``waits`` is already the clamped per-batch snapshot, so the
        # shifted view reuses it instead of re-querying.
        sel_store = (shifted_store(self.store, w_fn, shifts=waits)
                     if (self.queue_aware and w_fn is not None)
                     else self.store)
        select = (self.policy.select_traced if self.trace_detail
                  else self.policy.select_lean)
        trace = select(sel_store, b0, rng)
        self.store.mark_selected(trace.chosen)
        mid = self.store.table().index[trace.chosen]
        return (mid, trace.fallback,
                waits[trace.chosen] if waits else 0.0, None, trace)

    def route_one(self, t_sla_ms: float, t_input_ms: float,
                  rng: np.random.Generator, *,
                  w_queue_map: Optional[Dict[str, float]] = None,
                  w_queue_fn: Optional[WQueueFn] = None,
                  depth_fn: Optional[DepthFn] = None,
                  sla_class: Optional[str] = None):
        """Scalar fast path for hot event loops: one request in, a plain
        ``(model_idx, fallback, w_queue_ms, reject_reason)`` tuple out —
        no column set, no per-request objects.  ``model_idx == -1``
        means shed.  Same floats, same RNG draws as a batch of one
        through :meth:`route_batch_arrays` (which allocates a
        :class:`BatchDecisions` the caller of a singleton batch rarely
        wants — the engine's continuous-arrival runs are ~all singleton
        batches)."""
        waits = None
        if self.queue_aware or self.admission.needs_w_queue:
            if w_queue_map is not None:
                waits = w_queue_map
            else:
                fn = w_queue_fn or self.store.queue_wait
                waits = {n: max(0.0, float(fn(n)))
                         for n in self.store.profiles}
        mid, fb, w_q, reason, _ = self._route_scalar(
            float(t_sla_ms), float(t_input_ms), rng, waits, depth_fn,
            None, sla_class)
        self.n_batches += 1
        self.n_routed += 1
        if mid < 0:
            self.n_shed += 1
        else:
            self.n_admitted += 1
            if fb:
                self.n_fallback += 1
        return mid, fb, w_q, reason

    def _route_singleton(self, res, t_sla, t_input, rng, state, waits,
                         depth_fn, request, cls) -> None:
        """Batch-of-one adapter over :meth:`_route_scalar` writing into
        a :class:`BatchDecisions` column set."""
        if state is not None:
            waits = state.as_map()
        mid, fb, w_q, reason, trace = self._route_scalar(
            t_sla, t_input, rng, waits, depth_fn, request, cls)
        if mid < 0:
            self._shed(res, 0, reason, w_q)
            return
        res.model_idx[0] = mid
        res.admitted[0] = True
        res.fallback[0] = fb
        res.w_queue_ms[0] = w_q
        if fb:
            self.n_fallback += 1
        if res.traces is not None:
            res.traces[0] = trace

    def _route_snapshot(self, res, t_sla, t_input, rng, waits, depth_fn,
                        requests, sla_class) -> None:
        """The historical one-snapshot batch: every request judged and
        selected against the same waits (speculative-lookahead
        contract; the ``snapshot`` ablation arm)."""
        B = len(t_sla)
        budgets = t_sla - 2.0 * t_input
        tab = self.store.table()
        w_fn = waits.__getitem__ if waits is not None else None
        if self._admits_all:
            # The base no-op verdict: skip the per-request call.
            admitted = list(range(B))
        else:
            admitted = []
            w_min = min(waits.values()) if waits else 0.0
            for i in range(B):
                req = self._admission_request(requests, sla_class, i,
                                              float(t_sla[i]),
                                              float(t_input[i]))
                ok, reason = self.admission.admit(req, float(budgets[i]),
                                                  tab, w_fn, depth_fn)
                if ok:
                    admitted.append(i)
                else:
                    self._shed(res, i, reason, w_min)
        if not admitted:
            return
        # ``waits`` is already the clamped per-batch snapshot, so the
        # shifted view reuses it instead of re-querying.
        sel_store = (shifted_store(self.store, w_fn, shifts=waits)
                     if (self.queue_aware and w_fn is not None)
                     else self.store)
        if len(admitted) == 1:
            # Scalar path: draw-for-draw identical to a historical
            # per-request ``select_traced`` call site.  Without trace
            # detail the lean core skips the eligible/probs tuple
            # materialisation — same stages, same RNG stream.
            i = admitted[0]
            select = (self.policy.select_traced if self.trace_detail
                      else self.policy.select_lean)
            traces = [select(sel_store, float(budgets[i]), rng)]
        else:
            traces = policy_vec.select_batch_traced(
                self.policy, sel_store, budgets[admitted], rng,
                backend=self.backend, detail=self.trace_detail)
        for i, trace in zip(admitted, traces):
            self.store.mark_selected(trace.chosen)
            res.model_idx[i] = tab.index[trace.chosen]
            res.admitted[i] = True
            res.fallback[i] = trace.fallback
            res.w_queue_ms[i] = waits[trace.chosen] if waits else 0.0
            if trace.fallback:
                self.n_fallback += 1
            if res.traces is not None:
                res.traces[i] = trace

    def _route_charged(self, res, t_sla, t_input, rng, state: ChargedWaits,
                       depth_fn, requests, sla_class) -> None:
        """Sequential-greedy charged routing: request ``i`` is admitted
        and selected against waits that already include the charges of
        requests ``0..i-1`` — pick-for-pick what B sequential singleton
        ``route`` calls with live wait updates would produce."""
        B = len(t_sla)
        budgets = t_sla - 2.0 * t_input
        tab = self.store.table()
        if self._use_charged_scan(B):
            self._route_charged_device(res, budgets, rng, state)
            return
        names = tab.names
        index = tab.index
        select = (self.policy.select_traced if self.trace_detail
                  else self.policy.select_lean)
        check_admission = not self._admits_all
        for i in range(B):
            wq = state.model_waits()
            # The live charged snapshot this request is judged against —
            # same keys, same clamped floats a singleton route would
            # build, but including every charge so far.
            waits = dict(zip(names, wq.tolist()))
            if check_admission:
                req = self._admission_request(requests, sla_class, i,
                                              float(t_sla[i]),
                                              float(t_input[i]))
                ok, reason = self.admission.admit(
                    req, float(budgets[i]), tab, waits.__getitem__,
                    depth_fn)
                if not ok:
                    self._shed(res, i, reason, float(wq.min()))
                    continue
            sel_store = (shifted_store(self.store, waits.__getitem__,
                                       shifts=waits)
                         if self.queue_aware else self.store)
            trace = select(sel_store, float(budgets[i]), rng)
            self.store.mark_selected(trace.chosen)
            mid = index[trace.chosen]
            res.model_idx[i] = mid
            res.admitted[i] = True
            res.fallback[i] = trace.fallback
            res.w_queue_ms[i] = float(wq[mid])
            if trace.fallback:
                self.n_fallback += 1
            if res.traces is not None:
                res.traces[i] = trace
            # Charge the pick before the next request is judged; the
            # returned replica is where a placement-consistent caller
            # should enqueue it.
            ridx = state.charge(mid)
            if not state.pseudo:
                res.replica_idx[i] = ridx

    # ------------------------------------------------------------------
    # premodel surface (class-conditional batch routing)
    # ------------------------------------------------------------------
    def route_batch_classed(self, t_sla_ms, t_input_ms, cls,
                            rng: np.random.Generator, *,
                            w_queue_map: Optional[Dict[str, float]] = None,
                            depth_fn: Optional[DepthFn] = None
                            ) -> BatchDecisions:
        """Array-native batch routing with per-request input-class ids.

        The store must be a ``premodel.conditional.
        ConditionalProfileStore``: each request is selected against its
        class's shrunk profile view.  With a ModiPick policy the whole
        batch is judged in ONE stacked selection — each request reads
        its class's row of the (K × n) class tables
        (``kernels.policy_select.select_classed``) — on the device
        ``policy_vec.selection_device`` names: the kernel on ``cuda``,
        its plain version on the CPU for ``cpu`` and ``numpy``;
        other policies ride the scalar core per request with the class
        cursor set.  Admission judges against the POOLED table (snapshot
        semantics — the premodel refines *selection*, not the
        shed-or-serve verdict), and queue-wait shifts apply uniformly to
        every class row (waits live at replicas, not input classes).
        """
        t_sla = np.asarray(t_sla_ms, dtype=np.float64)
        t_input = np.asarray(t_input_ms, dtype=np.float64)
        cls = np.asarray(cls, dtype=np.int32)
        B = len(t_sla)
        store = self.store
        pooled = store.pooled_table()
        res = BatchDecisions.empty(B, pooled.names)
        if B == 0:
            return res

        waits: Optional[Dict[str, float]] = None
        if self.queue_aware or self.admission.needs_w_queue:
            if w_queue_map is not None:
                waits = w_queue_map
            else:
                waits = {n: max(0.0, float(store.queue_wait(n)))
                         for n in store.profiles}
        w_fn = waits.__getitem__ if waits is not None else None

        budgets = t_sla - 2.0 * t_input
        if self._admits_all:
            admitted = list(range(B))
        else:
            admitted = []
            w_min = min(waits.values()) if waits else 0.0
            for i in range(B):
                req = self._admission_request(None, None, i,
                                              float(t_sla[i]),
                                              float(t_input[i]))
                ok, reason = self.admission.admit(req, float(budgets[i]),
                                                  pooled, w_fn, depth_fn)
                if ok:
                    admitted.append(i)
                else:
                    self._shed(res, i, reason, w_min)
        if admitted:
            if type(self.policy) is ModiPick:
                self._route_classed_device(res, admitted, budgets, cls, rng,
                                           waits, pooled)
            else:
                self._route_classed_scalar(res, admitted, budgets, cls,
                                           rng, waits)
        self.n_batches += 1
        self.n_routed += B
        n_admitted = int(res.admitted.sum())
        self.n_admitted += n_admitted
        self.n_shed += B - n_admitted
        return res

    def _route_classed_device(self, res, admitted, budgets, cls, rng, waits,
                              pooled) -> None:
        from repro_torch.kernels import policy_select
        store = self.store
        names = pooled.names
        shifts = ([waits[n] for n in names]
                  if (self.queue_aware and waits is not None) else None)
        idx = np.asarray(admitted, dtype=np.int64)
        device = policy_vec.selection_device(self.backend, len(admitted))
        picks, has_base = policy_select.select_classed(
            store.stacked_pool(device), cls[idx], budgets[idx],
            budgets[idx] - self.policy.t_threshold, shifts=shifts,
            gamma=self.policy.gamma,
            seed=int(rng.integers(np.iinfo(np.int64).max)))
        for j, i in enumerate(admitted):
            mid = int(picks[j])
            store.mark_selected(names[mid])
            res.model_idx[i] = mid
            res.admitted[i] = True
            res.fallback[i] = not has_base[j]
            res.w_queue_ms[i] = waits[names[mid]] if waits else 0.0
            if not has_base[j]:
                self.n_fallback += 1

    def _route_classed_scalar(self, res, admitted, budgets, cls, rng,
                              waits) -> None:
        """Per-request scalar fallback for non-ModiPick policies: the
        class cursor flips the store's presented table around the
        historical scalar core."""
        store = self.store
        w_fn = waits.__getitem__ if waits is not None else None
        select = (self.policy.select_traced if self.trace_detail
                  else self.policy.select_lean)
        for i in admitted:
            store.set_class(int(cls[i]))
            try:
                sel_store = (shifted_store(store, w_fn, shifts=waits)
                             if (self.queue_aware and w_fn is not None)
                             else store)
                trace = select(sel_store, float(budgets[i]), rng)
                mid = store.table().index[trace.chosen]
            finally:
                store.set_class(-1)
            store.mark_selected(trace.chosen)
            res.model_idx[i] = mid
            res.admitted[i] = True
            res.fallback[i] = trace.fallback
            res.w_queue_ms[i] = waits[trace.chosen] if waits else 0.0
            if trace.fallback:
                self.n_fallback += 1

    # -- device path ---------------------------------------------------
    def _use_charged_scan(self, B: int) -> bool:
        """The device charged pass engages under the same backend policy
        as the uncharged fused pipeline (ModiPick, a batch of at least
        ``DEVICE_MIN_BATCH`` on a card, or a device backend named
        explicitly), for controllers whose verdict is the pure viability
        test the pass can evaluate per request."""
        if type(self.policy) is not ModiPick or not self.queue_aware \
                or self.trace_detail:
            return False
        if not (self._admits_all
                or type(self.admission) is SlaAwareAdmission):
            return False
        return (policy_vec.resolve_backend(self.backend, B)
                in policy_vec.DEVICE_BACKENDS)

    def _route_charged_device(self, res, budgets, rng,
                              state: ChargedWaits) -> None:
        from repro_torch.kernels import policy_select
        adm = self.admission
        if self._admits_all:
            adm_limit, slack, include_mu = None, 0.0, False
        else:
            adm_limit = budgets
            slack = adm.slack_ms
            include_mu = adm.include_service_time
        tab = self.store.table()
        backend = policy_vec.resolve_backend(self.backend, len(budgets))
        out = policy_select.select_charged(
            tab.device_pool(backend), budgets,
            budgets - self.policy.t_threshold,
            state, gamma=self.policy.gamma,
            adm_limit=adm_limit, adm_slack=slack,
            adm_include_mu=include_mu,
            seed=int(rng.integers(np.iinfo(np.int64).max)))
        picks, admitted, has_base, replica, w_chosen = out
        names = tab.names
        for i in range(len(budgets)):
            if not admitted[i]:
                self._shed(res, i,
                           "W_queue exceeds the remaining budget for "
                           "every model", float(w_chosen[i]))
                continue
            mid = int(picks[i])
            self.store.mark_selected(names[mid])
            res.model_idx[i] = mid
            res.admitted[i] = True
            res.fallback[i] = not has_base[i]
            res.w_queue_ms[i] = float(w_chosen[i])
            if not state.pseudo:
                res.replica_idx[i] = int(replica[i])
        self.n_fallback += int((res.admitted & res.fallback).sum())

    # ------------------------------------------------------------------
    # recovery surface (router.retry)
    # ------------------------------------------------------------------
    def reroute_one(self, remaining_budget_ms: float, *,
                    w_queue_map: Optional[Dict[str, float]] = None) -> int:
        """Recovery pick for one in-flight request: the cheapest
        still-viable model (smallest believed ``W_queue + μ`` fitting
        the *remaining* budget — see ``router.retry.cheapest_viable``).
        Returns the model index, or −1 when nothing fits (the request
        is dropped as a deadline miss).  Deterministic and draw-free:
        retries never perturb the seeded primary-selection stream."""
        self.n_retries += 1
        mid = cheapest_viable(self.store.table(), w_queue_map,
                              float(remaining_budget_ms))
        if mid < 0:
            self.n_retry_exhausted += 1
            return -1
        self.n_retry_routed += 1
        self.store.mark_selected(self.store.table().names[mid])
        return mid

    def reroute(self, decision: RouterDecision,
                remaining_budget_ms: float, *,
                w_queue_map: Optional[Dict[str, float]] = None
                ) -> RouterDecision:
        """Object-path recovery: a new :class:`RouterDecision` with
        ``attempts`` bumped and the abandoned variant appended to
        ``fallback_chain``.  Not admitted (``variant == ""``) when no
        model fits the remaining budget."""
        chain = decision.fallback_chain + ((decision.variant,)
                                           if decision.variant else ())
        mid = self.reroute_one(remaining_budget_ms,
                               w_queue_map=w_queue_map)
        bd = BudgetBreakdown(
            t_sla_ms=decision.budget.t_sla_ms,
            t_network_ms=decision.budget.t_network_ms,
            w_queue_ms=(w_queue_map.get(
                self.store.table().names[mid], 0.0)
                if (mid >= 0 and w_queue_map is not None) else 0.0))
        if mid < 0:
            return RouterDecision(
                request=decision.request, variant="", admitted=False,
                budget=bd, reject_reason="no viable model within the "
                "remaining budget", attempts=decision.attempts + 1,
                fallback_chain=chain)
        return RouterDecision(
            request=decision.request,
            variant=self.store.table().names[mid], admitted=True,
            budget=bd, attempts=decision.attempts + 1,
            fallback_chain=chain)

    # ------------------------------------------------------------------
    def observe(self, name: str, latency_ms: float) -> None:
        """Feed a measured inference latency back into the profiles."""
        self.store.observe(name, latency_ms)

    def observe_queue(self, name: str, wait_ms: float) -> None:
        """Feed an observed queue wait back into the profiles."""
        self.store.observe_queue(name, wait_ms)

    def reset(self) -> None:
        """Zero the ``stats()`` counters (and the admission controller's
        windowed state, e.g. class-share quotas).

        Counters are lifetime by default; a closed-loop consumer that
        needs *windowed* rates — the queue-target autoscaler reading
        shed/fallback rates per epoch — calls ``reset()`` at each window
        boundary so ``stats()`` reflects only the traffic since."""
        self.n_routed = 0
        self.n_admitted = 0
        self.n_shed = 0
        self.n_fallback = 0
        self.n_batches = 0
        self.n_retries = 0
        self.n_retry_routed = 0
        self.n_retry_exhausted = 0
        self._win_base = {}
        self.admission.reset()

    def window_stats(self) -> Dict[str, float]:
        """One control window's counter deltas: ``stats()`` since the
        previous ``window_stats()`` call (or construction/``reset()``),
        WITHOUT zeroing the lifetime counters — the mid-run elastic
        controller reads per-tick rates while epoch-level consumers keep
        seeing their lifetime totals.  ``mean_batch`` is recomputed from
        the window's own deltas."""
        cur = self.stats()
        base = self._win_base
        out = {k: cur[k] - base.get(k, 0.0) for k in cur
               if k != "mean_batch"}
        out["mean_batch"] = (out["n_routed"] / out["n_batches"]
                             if out["n_batches"] else 0.0)
        self._win_base = cur
        return out

    def stats(self) -> Dict[str, float]:
        """Router-side counters: routed/admitted/shed/fallback/batches
        plus the mean routed batch size.  Lifetime totals since
        construction or the last ``reset()`` — see ``reset()`` for
        windowed consumption."""
        return {
            "n_routed": self.n_routed,
            "n_admitted": self.n_admitted,
            "n_shed": self.n_shed,
            "n_fallback": self.n_fallback,
            "n_batches": self.n_batches,
            "n_retries": self.n_retries,
            "n_retry_routed": self.n_retry_routed,
            "n_retry_exhausted": self.n_retry_exhausted,
            "mean_batch": (self.n_routed / self.n_batches
                           if self.n_batches else 0.0),
        }
