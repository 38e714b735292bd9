"""Intra-batch load charging: the mutable wait state behind
``Router.route_batch_arrays``.

The staleness degeneracy this fixes: a burst of B simultaneous requests
judged against ONE ``W_queue`` snapshot all see the same (idle-looking)
accurate models, pile onto them, and attainment collapses — the
``batched`` rows of ``BENCH_engine_throughput.json`` sat at ~0.16 while
the singleton path held ~0.998.  ModiPick's queue-aware budget
``T_budget(m) = T_sla − 2·T_input − W_queue(m)`` only masks load if the
waits it reasons about include the requests routed *moments* earlier —
within the same batch, not just previous batches.

:class:`ChargedWaits` is that within-batch ledger: per-replica wait
columns plus the static model → candidate-replica topology.  After every
admitted pick the router charges the pick's mean service time μ(m) to
the replica that will serve it, so request ``i+1`` of the batch is
admitted and selected against waits that already include requests
``0..i`` — exactly what B sequential singleton routes (the trusted
scalar path) would have seen.  The charged batch is therefore
pick-for-pick the sequential oracle, at array-column cost.

Two constructors:

- :meth:`ChargedWaits.per_model` — one pseudo-replica per model, built
  from a name → wait snapshot.  The fallback when the caller only has
  model-level telemetry (e.g. the live executor's ``w_queue_fn``).
- the reference's engine builds the real thing from its bound
  ``ReplicaPool`` via
  ``ReplicaPool.charged_state(now)``: per-replica wait columns, cached
  candidate indices, speeds and the live μ list — the same floats its
  ``waits_by_name`` snapshot used to hand over as a frozen dict.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ChargedWaits:
    """Per-replica wait columns + model topology, charged as a batch is
    routed.

    ``rep_wait[r]`` is replica ``r``'s estimated wait *now* (ms, ≥ 0);
    ``cand[m]`` the pool indices of the replicas that can serve model
    ``m`` (pool order — the historical ``min`` tie-break); ``speed[r]``
    replica ``r``'s speed factor; ``mu[m]`` the *current* profile mean
    used as the charge amount (a live list is fine — the engine shares
    its ``mu_now`` column).
    """

    __slots__ = ("rep_wait", "cand", "speed", "mu", "names", "pseudo")

    def __init__(self, rep_wait: Sequence[float],
                 cand: Sequence[Sequence[int]],
                 speed: Sequence[float],
                 mu: Sequence[float],
                 names: Sequence[str],
                 pseudo: bool = False):
        self.rep_wait = np.maximum(
            np.asarray(rep_wait, dtype=np.float64), 0.0)
        self.cand: List[np.ndarray] = [np.asarray(c, dtype=np.int64)
                                       for c in cand]
        self.speed = np.asarray(speed, dtype=np.float64)
        self.mu = mu
        self.names: Tuple[str, ...] = tuple(names)
        # Pseudo-replica states (per_model) carry indices that mean
        # nothing to a real pool — consumers must not place by them.
        self.pseudo = pseudo
        if len(self.cand) != len(self.names):
            raise ValueError("one candidate list per model required")
        for name, c in zip(self.names, self.cand):
            if len(c) == 0:
                raise ValueError(f"no replica serves model {name!r}")

    @classmethod
    def per_model(cls, names: Sequence[str], waits: Sequence[float],
                  mu: Sequence[float]) -> "ChargedWaits":
        """Model-granularity charging: each model is its own queue (the
        paper's per-model-endpoint topology).  Built from a model-level
        wait snapshot when no replica topology is known."""
        n = len(names)
        return cls(waits, [(i,) for i in range(n)], np.ones(n), mu, names,
                   pseudo=True)

    # ------------------------------------------------------------------
    def model_waits(self) -> np.ndarray:
        """(n_models,) ``W_queue(m)``: each model's wait at its current
        least-loaded capable replica — the same min-reduction (and the
        same floats) as ``ReplicaPool.waits_by_name``, but live."""
        rw = self.rep_wait
        return np.array([rw[c].min() for c in self.cand])

    def wait_of(self, mid: int) -> float:
        return float(self.rep_wait[self.cand[mid]].min())

    def as_map(self) -> Dict[str, float]:
        """Frozen name → wait snapshot of the current state (what the
        pre-charging path handed to the router whole)."""
        return dict(zip(self.names, self.model_waits().tolist()))

    def charge(self, mid: int) -> int:
        """Charge one admitted pick of model ``mid``: add μ(mid)/speed
        to its least-loaded capable replica (ties: pool order, matching
        ``ReplicaPool.best_for``) and return that replica's pool index —
        the caller can place the request there without re-deriving the
        choice."""
        c = self.cand[mid]
        if len(c) == 1:
            r = int(c[0])
        else:
            r = int(c[int(np.argmin(self.rep_wait[c]))])
        self.rep_wait[r] += float(self.mu[mid]) / float(self.speed[r])
        return r
