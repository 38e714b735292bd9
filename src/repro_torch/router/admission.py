"""Admission control: decide *whether* to serve before deciding *what*
serves it.

The discrete-event engine historically only had a substrate-level knob —
``Replica.max_queue_depth`` sheds a request after selection, once its
replica's FIFO is full.  Router-side admission runs *before* selection,
against the same telemetry the policy sees, so a request that cannot
possibly meet its SLA is rejected without spending a selection (or a
replica slot) on it:

- :class:`AdmitAll` — the default; every request proceeds to selection
  (substrate caps, if any, still apply downstream).  With this
  controller the router is behaviourally identical to the pre-router
  call sites.
- :class:`DepthCapAdmission` — router-side mirror of the hard cap:
  reject when every model's least-loaded serving queue is at depth.
- :class:`SlaAwareAdmission` — the ROADMAP item: reject when
  ``W_queue(m)`` already exceeds the remaining budget
  ``T_sla − 2·T_input`` for *every* model, i.e. no pool member can
  start serving inside the SLA no matter what the policy picks.
  ``include_service_time=True`` additionally charges each model's mean
  inference time μ(m), shedding requests that could *start* but not
  *finish* in time.

Controllers return ``(admitted, reason)``; the reason string lands in
``RouterDecision.reject_reason`` and, from there, in shed-vs-degrade
frontier reports.

W_queue telemetry within a batch: under charged batch routing (the
``route_batch_arrays`` default) the ``w_queue_fn`` a controller sees for
request *i* reads the :class:`~repro_torch.router.charging.ChargedWaits`
ledger *after* picks 0..i−1 of the same batch were charged — admission
judges the load the batch itself is creating, so shedding stays honest
under simultaneous bursts.  Under ``charge=False`` (and in the
historical object path) every request in the batch sees the same frozen
snapshot, which under-sheds exactly when shedding matters most.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.profiles import ProfileTable

from repro_torch.router.api import InferenceRequest
from repro_torch.router.queueaware import WQueueFn

DepthFn = Callable[[str], int]


class AdmissionController:
    """Base controller: admit everything."""
    name = "admit_all"
    # Routers snapshot W_queue telemetry once per batch only when either
    # queue-aware selection or the controller actually consumes it.
    needs_w_queue = False

    def admit(self, request: InferenceRequest, t_budget_ms: float,
              table: ProfileTable, w_queue_fn: Optional[WQueueFn] = None,
              depth_fn: Optional[DepthFn] = None) -> Tuple[bool, str]:
        return True, ""

    def reset(self) -> None:
        """Clear any windowed state (share counters etc.).  Stateless
        controllers are no-ops; ``Router.reset()`` calls this so epoch
        windows start clean."""


class AdmitAll(AdmissionController):
    """Explicit alias for the default behaviour."""


@dataclass
class DepthCapAdmission(AdmissionController):
    """Reject when the least-loaded serving queue of every model is at
    ``max_depth`` — router-side back-pressure applied before selection.

    Depth telemetry is a per-``route_batch`` snapshot: requests admitted
    earlier in the same batch are not yet queued when later ones are
    judged, so a simultaneous burst can sail past the cap wholesale.
    This controller is advisory load-shedding, not a hard bound — pair
    it with ``Replica.max_queue_depth`` (enforced per request at
    placement time) when the cap must hold exactly."""
    max_depth: int

    name = "depth_cap"

    def admit(self, request, t_budget_ms, table, w_queue_fn=None,
              depth_fn=None) -> Tuple[bool, str]:
        if depth_fn is None:
            return True, ""
        if any(depth_fn(n) < self.max_depth for n in table.names):
            return True, ""
        return False, f"every serving queue at depth >= {self.max_depth}"


@dataclass
class SlaAwareAdmission(AdmissionController):
    """Reject when no model can meet the request's remaining budget.

    A model ``m`` is viable when ``W_queue(m) + slack < T_budget``
    (plus ``μ(m)`` when ``include_service_time``).  A request whose
    budget is already non-positive — the network alone ate the SLA — is
    always shed: every ``W_queue ≥ 0`` exceeds it.

    The reference's charged device pass inlines this exact viability
    test against its in-scan charged waits, which is why the Router's
    device charged path dispatches only for this controller (or
    :class:`AdmitAll`) — their verdicts are reproducible inside the
    kernel.  The port has not carried that pass yet.
    """
    slack_ms: float = 0.0
    include_service_time: bool = False

    name = "sla_aware"
    needs_w_queue = True

    def admit(self, request, t_budget_ms, table, w_queue_fn=None,
              depth_fn=None) -> Tuple[bool, str]:
        if w_queue_fn is None:
            return True, ""      # no telemetry: nothing to shed against
        for i, name in enumerate(table.names):
            cost = float(w_queue_fn(name)) + self.slack_ms
            if self.include_service_time:
                cost += float(table.mu[i])
            if cost < t_budget_ms:
                return True, ""
        return False, "W_queue exceeds the remaining budget for every model"


@dataclass(frozen=True)
class ClassPolicy:
    """Per-SLA-class admission terms.

    ``protect`` scales how much of the remaining budget the class may
    spend queueing before it is shed: a model is viable for the class
    when ``W_queue(m) + slack < protect · T_budget``.  ``protect=1.0``
    is exactly :class:`SlaAwareAdmission` viability (shed only requests
    that cannot make the SLA at all); ``protect<1`` sheds the class
    pre-emptively once queues eat that fraction of its budget — weighted
    shedding that frees capacity for protected classes.

    ``max_share`` (optional) is an admitted-traffic quota: once queues
    are non-trivially backed up (``W_queue`` pressure), the class may
    not exceed this fraction of the controller's admissions in the
    current window.
    """
    protect: float = 1.0
    max_share: Optional[float] = None

    def __post_init__(self):
        if not 0.0 < self.protect <= 1.0:
            raise ValueError(f"protect must be in (0, 1], got {self.protect}")
        if self.max_share is not None and not 0.0 < self.max_share <= 1.0:
            raise ValueError(
                f"max_share must be in (0, 1], got {self.max_share}")


@dataclass
class ClassAwareAdmission(AdmissionController):
    """SLA-class-differentiated shedding: protect "interactive" by
    shedding "batch" first.

    ``InferenceRequest.sla_class`` picks the request's
    :class:`ClassPolicy` (``default`` for unknown/unset classes).  Two
    mechanisms compose, both judged against the same per-batch telemetry
    snapshot every other controller sees:

    - **weighted viability** — class ``c`` needs a model with
      ``W_queue(m) + slack < protect(c) · T_budget``, so low-``protect``
      classes shed earlier as queues build, leaving headroom for
      protected ones;
    - **admitted-share quota** — under pressure (minimum ``W_queue``
      above ``pressure_ms``), a class with ``max_share`` set may not
      exceed that fraction of this window's admissions.

    The share window is the controller's lifetime until ``reset()`` —
    autoscaler epochs (and ``Router.reset()``) clear it.
    """
    classes: Mapping[str, Union[ClassPolicy, Mapping]] = field(
        default_factory=dict)
    default: Union[ClassPolicy, Mapping] = field(default_factory=ClassPolicy)
    slack_ms: float = 0.0
    pressure_ms: float = 0.0

    name = "class_aware"
    needs_w_queue = True

    def __post_init__(self):
        coerce = lambda p: p if isinstance(p, ClassPolicy) else ClassPolicy(**p)
        self.classes = {c: coerce(p) for c, p in dict(self.classes).items()}
        self.default = coerce(self.default)
        self.reset()

    def reset(self) -> None:
        self.n_admitted = 0
        self.admitted_by_class: Dict[str, int] = {}

    def admit(self, request, t_budget_ms, table, w_queue_fn=None,
              depth_fn=None) -> Tuple[bool, str]:
        cls = request.sla_class or ""
        cp = self.classes.get(cls, self.default)
        if w_queue_fn is None:
            self._record(cls)
            return True, ""      # no telemetry: nothing to shed against
        waits = [float(w_queue_fn(n)) for n in table.names]
        if not any(w + self.slack_ms < cp.protect * t_budget_ms
                   for w in waits):
            return False, (f"W_queue exceeds {cp.protect:g}x the remaining "
                           f"budget for every model (class {cls or 'default'!r})")
        if cp.max_share is not None and min(waits) > self.pressure_ms \
                and self.n_admitted > 0:
            share = (self.admitted_by_class.get(cls, 0) + 1) \
                / (self.n_admitted + 1)
            if share > cp.max_share:
                return False, (f"class {cls or 'default'!r} over its "
                               f"{cp.max_share:g} admitted-share quota "
                               f"under queue pressure")
        self._record(cls)
        return True, ""

    def _record(self, cls: str) -> None:
        self.n_admitted += 1
        self.admitted_by_class[cls] = self.admitted_by_class.get(cls, 0) + 1


_MODES = {
    "none": AdmitAll,
    "admit_all": AdmitAll,
    "sla_aware": SlaAwareAdmission,
    "class_aware": ClassAwareAdmission,
}


def make_admission(mode: str, **kwargs) -> AdmissionController:
    """Build a controller from a mode string (``none`` / ``admit_all`` /
    ``depth_cap`` / ``sla_aware`` / ``class_aware``) — the benchmark,
    CLI and ``DeploymentSpec.admission`` axis."""
    if mode == "depth_cap":
        return DepthCapAdmission(**kwargs)
    try:
        return _MODES[mode](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown admission mode {mode!r} "
            f"(valid: none, admit_all, depth_cap, sla_aware, class_aware)")
