"""Canonical request/decision schema for the unified Router API.

Every entry point (the closed-loop paper simulator, the discrete-event
engine, the live pool executor) expresses ModiPick's runtime decision
through the same two records:

- :class:`InferenceRequest` — what the device sends: arrival time, its
  *own* SLA (heterogeneous per-request SLAs are first-class, not a
  run-level constant), the measured/estimated uplink transfer, and an
  optional SLA class label for slicing results.
- :class:`RouterDecision` — what the router answers: the chosen variant,
  the full budget breakdown (Eq. 1 plus the queue-wait correction), the
  admission verdict, and the stage trace (base model, exploration set,
  probabilities) where the selection path produces one.

Times are milliseconds throughout, matching the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.policy import SelectionTrace


@dataclass(slots=True)
class InferenceRequest:
    """One inference request as the router sees it."""
    t_sla_ms: float                   # this request's SLA (end-to-end)
    t_input_ms: float                 # one-way input transfer (measured)
    rid: int = 0
    arrival_ms: float = 0.0
    sla_class: Optional[str] = None   # optional label, e.g. "interactive"
    # Cheap premodel features (input size, resolution bucket, ...): what
    # the premodel classifier maps to an input-class id.  Empty for
    # feature-less workloads — the historical path.
    features: Tuple[float, ...] = ()


@dataclass(slots=True)
class BudgetBreakdown:
    """Where the SLA went: network, cross-cell transit, queueing, and
    what is left for inference.  ``t_budget_ms`` is Eq. 1
    (``T_sla − 2·T_input``) minus any inter-cell RTT the fleet frontend
    spent spilling the request to a remote cell
    (``rtt_xcell_ms`` — 0 for home-cell service, so single-cell budgets
    are unchanged); ``t_effective_ms`` additionally charges the queue
    wait of the model the decision routed to (the queue-aware budget):
    ``T_sla − 2·T_input − RTT_xcell − W_queue(m)``."""
    t_sla_ms: float
    t_network_ms: float               # 2 · T_input (conservative, Eq. 1)
    w_queue_ms: float = 0.0           # W_queue of the chosen model
    rtt_xcell_ms: float = 0.0         # inter-cell spill RTT (fleet only)

    @property
    def t_budget_ms(self) -> float:
        return self.t_sla_ms - self.t_network_ms - self.rtt_xcell_ms

    @property
    def t_effective_ms(self) -> float:
        return self.t_budget_ms - self.w_queue_ms


@dataclass(slots=True)
class BatchDecisions:
    """Array-native answer of ``Router.route_batch_arrays``: one column
    per decision field, index-aligned with the input budget columns — no
    per-request object is materialised on the hot path.

    ``model_idx[i]`` is the chosen model's position in ``names`` (−1
    where the request was shed), ``replica_idx[i]`` the pool index of
    the replica the intra-batch charging placed the pick on (−1 when no
    replica topology was charged — snapshot mode, pseudo-replica
    charging, or a shed request), ``w_queue_ms[i]`` the chosen model's
    charged wait at decision time (for shed rows: the minimum wait over
    the pool, matching ``BudgetBreakdown``'s convention).
    ``reject_code[i]`` indexes ``reasons`` (code 0 == "" == admitted).
    ``traces`` is populated only for object-path consumers
    (``route_batch`` wraps them into :class:`RouterDecision`s); array
    consumers read the columns.
    """
    names: Tuple[str, ...]
    model_idx: np.ndarray            # (B,) int32; -1 = shed
    admitted: np.ndarray             # (B,) bool
    fallback: np.ndarray             # (B,) bool
    replica_idx: np.ndarray          # (B,) int32; -1 = caller places
    w_queue_ms: np.ndarray           # (B,) float64
    reject_code: np.ndarray          # (B,) int16 into reasons
    reasons: List[str]
    traces: Optional[List[Optional[SelectionTrace]]] = None

    @classmethod
    def empty(cls, n: int, names: Tuple[str, ...],
              traces: bool = False) -> "BatchDecisions":
        return cls(names=tuple(names),
                   model_idx=np.full(n, -1, dtype=np.int32),
                   admitted=np.zeros(n, dtype=bool),
                   fallback=np.zeros(n, dtype=bool),
                   replica_idx=np.full(n, -1, dtype=np.int32),
                   w_queue_ms=np.zeros(n, dtype=np.float64),
                   reject_code=np.zeros(n, dtype=np.int16),
                   reasons=[""],
                   traces=[None] * n if traces else None)

    def reason_of(self, i: int) -> str:
        return self.reasons[int(self.reject_code[i])]

    def __len__(self) -> int:
        return len(self.model_idx)


@dataclass(slots=True)
class RouterDecision:
    """The router's answer for one request.

    ``attempts`` counts placements including the first; a recovery
    re-route (replica failure or deadline-overrun hedge — see
    ``router.retry``) returns a new decision with ``attempts`` bumped
    and the abandoned variant appended to ``fallback_chain``."""
    request: InferenceRequest
    variant: str                      # "" when the request was shed
    admitted: bool
    budget: BudgetBreakdown
    reject_reason: str = ""
    trace: Optional[SelectionTrace] = None
    attempts: int = 1
    fallback_chain: Tuple[str, ...] = ()

    @property
    def fallback(self) -> bool:
        return self.trace.fallback if self.trace is not None else False

    @property
    def base(self) -> Optional[str]:
        return self.trace.base if self.trace is not None else None

    @property
    def eligible(self) -> Tuple[str, ...]:
        return self.trace.eligible if self.trace is not None else ()

    @property
    def probs(self) -> Tuple[float, ...]:
        return self.trace.probs if self.trace is not None else ()
