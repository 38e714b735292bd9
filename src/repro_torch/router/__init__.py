"""Unified Router API: one request/decision surface over every serving
substrate (closed-loop simulator, discrete-event engine, live executor).

The package owns ModiPick's runtime decision end to end:

- ``api``: the canonical :class:`InferenceRequest` /
  :class:`RouterDecision` schema (per-request SLAs are first-class);
- ``admission``: pluggable SLA-aware admission control
  (:class:`SlaAwareAdmission` sheds requests no pool member can serve
  inside the remaining budget);
- ``queueaware``: the shifted-μ store view that folds ``W_queue(m)``
  into Eq. 1 budgets without touching any policy;
- ``charging``: the :class:`ChargedWaits` intra-batch ledger — the
  per-replica wait state the router charges each admitted pick into so
  a burst is not judged against one stale snapshot;
- ``router``: the :class:`Router` object — batched, admission-gated,
  substrate-independent selection with the array-native
  ``route_batch_arrays`` hot path (:class:`BatchDecisions` columns out).
"""
from repro_torch.router.admission import (AdmissionController, AdmitAll,
                                    ClassAwareAdmission, ClassPolicy,
                                    DepthCapAdmission, SlaAwareAdmission,
                                    make_admission)
from repro_torch.router.api import (BatchDecisions, BudgetBreakdown,
                              InferenceRequest, RouterDecision)
from repro_torch.router.charging import ChargedWaits
from repro_torch.router.queueaware import (QueueAwareSelector, queue_aware_budget,
                                     shifted_store)
from repro_torch.router.retry import RetryPolicy, cheapest_viable
from repro_torch.router.router import Router

__all__ = [
    "AdmissionController", "AdmitAll", "ClassAwareAdmission", "ClassPolicy",
    "DepthCapAdmission", "SlaAwareAdmission", "make_admission",
    "BatchDecisions", "BudgetBreakdown", "ChargedWaits",
    "InferenceRequest", "RouterDecision", "QueueAwareSelector",
    "queue_aware_budget", "shifted_store", "Router",
    "RetryPolicy", "cheapest_viable",
]
