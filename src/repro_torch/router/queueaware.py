"""Queue-aware ModiPick: fold server load into the latency budget.

The paper's budget (Eq. 1) only charges the network:

    T_budget = T_sla - 2 * T_input

Under concurrent traffic a request additionally waits ``W_queue(m)`` in
the FIFO of the replica that will serve model ``m``, so the effective
budget is per-model:

    T_budget(m) = T_sla - 2 * T_input - W_queue(m)

Rather than rewrite every policy to take per-model budgets, we use the
equivalent shift: a model fits a budget reduced by ``W_queue(m)`` iff the
model with mean ``mu + W_queue(m)`` fits the plain Eq. 1 budget (sigma is
unaffected — queueing shifts the location of the latency distribution the
router reasons about, not the inference jitter).  ``QueueAwareSelector``
therefore presents any unmodified ``Policy`` with a shifted *view* of the
profile store and plain ``T_budget``.  With ``W_queue == 0`` the view is
the store itself, so selection reduces *exactly* to Eq. 1 — the paper's
behaviour is the zero-load special case.

This module is substrate-independent (it lives under ``repro_torch.router``
and is consumed by the simulator, the discrete-event engine and the live
executor alike).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.policy import Policy, SelectionTrace, budget
from repro_torch.core.profiles import ModelProfile, ProfileStore, ProfileTable


@functools.lru_cache(maxsize=8)
def _shared_zeros(n: int) -> np.ndarray:
    """Read-only zeros shared by every shifted view of an ``n``-model
    pool (a view's ``queue_mu`` is zero by construction and never
    written)."""
    z = np.zeros(n)
    z.setflags(write=False)
    return z

WQueueFn = Callable[[str], float]


def queue_aware_budget(t_sla: float, t_input: float, w_queue: float) -> float:
    """T_budget(m) = T_sla - 2*T_input - W_queue(m).  Reduces to Eq. 1
    when ``w_queue == 0``."""
    return budget(t_sla, t_input) - w_queue


class _ShiftedView(ProfileStore):
    """Lazy shifted view of a :class:`ProfileStore`.

    Selection only ever touches the view's :class:`ProfileTable`
    snapshot, so that is all the constructor builds (reusing the base
    snapshot's cached accuracy order — a mu shift cannot reorder it).
    The per-profile dict of shifted :class:`ModelProfile` objects is
    materialised lazily, only if a consumer actually dereferences
    ``view.profiles`` / ``view[name]`` — the selection hot path never
    does, which removes the per-batch dataclass churn the eager view
    used to pay."""

    def __init__(self, store: ProfileStore, shifts: Dict[str, float]):
        # Deliberately NOT chaining to ProfileStore.__init__: the view
        # shares the base's configuration and builds its table directly.
        self.alpha = store.alpha
        self.cold_age = store.cold_age
        self.step = store.step
        self.base = store.base
        self._shift_src = store
        self.version = 0
        self._shifts = shifts
        base = store.table()
        # Shifted snapshot assembled directly (same fields
        # ``ProfileTable.shifted`` would produce, same IEEE doubles —
        # python float adds match the elementwise array add): accuracy,
        # sigma, the cached order and the name index are shared with the
        # base exactly as before; μ is new; queue_mu is zero because the
        # shift has consumed it.
        b_mu, b_sig, _, b_acc, b_ord, b_names = base.scalar_cache()
        mu_l = [m + shifts[n] for m, n in zip(b_mu, b_names)]
        fastest = 0
        best = mu_l[0]
        for i in range(1, len(mu_l)):
            if mu_l[i] < best:
                best = mu_l[i]
                fastest = i
        tab = ProfileTable.__new__(ProfileTable)
        tab.names = base.names
        tab.index = base.index
        tab.accuracy = base.accuracy
        tab.mu = np.asarray(mu_l)
        tab.sigma = base.sigma
        tab.queue_mu = _shared_zeros(len(mu_l))
        tab.acc_order = base.acc_order
        tab.fastest = fastest
        tab._device = None
        # Scalar-path cache derived from the base's by the same float
        # adds; sigma is copied (the base list is patched in place by
        # telemetry), accuracy/order/names can't drift and are shared.
        sig_l = b_sig[:]
        tab._scalar = (mu_l, sig_l,
                       [m + g for m, g in zip(mu_l, sig_l)],
                       b_acc, b_ord, b_names)
        self._table = tab
        self._profiles: Dict[str, ModelProfile] = None

    @property
    def profiles(self) -> Dict[str, ModelProfile]:
        if self._profiles is None:
            self._profiles = {
                p.name: ModelProfile(name=p.name, accuracy=p.accuracy,
                                     mu=p.mu + self._shifts[p.name],
                                     var=p.var, n_obs=p.n_obs,
                                     last_selected=p.last_selected)
                for p in self._shift_src.profiles.values()}
        return self._profiles

    def _refresh(self, name: str, p: ModelProfile) -> None:
        # Observing on a view must stay view-local (the historical copy
        # semantics): the prebuilt snapshot shares the BASE table's
        # sigma array and a read-only zeros queue_mu, so instead of
        # patching in place, drop it — the next ``table()`` rebuilds
        # from the view's own (lazily copied) profiles.
        self._table = None


def shifted_store(store: ProfileStore, w_queue_fn: WQueueFn, *,
                  shifts: Optional[Dict[str, float]] = None) -> ProfileStore:
    """View of ``store`` with each model's mean shifted by its estimated
    queue wait.  Returns ``store`` itself when every shift is zero, so
    the zero-load path is bit-identical to plain selection.

    The view's ``ProfileTable`` is derived from the base store's cached
    snapshot: a mu shift cannot change the accuracy order, so the view
    reuses it instead of re-sorting the pool on every selection.

    ``shifts`` (optional) hands over an already-clamped name -> wait
    snapshot — the Router builds exactly one per batch — so the view
    does not re-query ``w_queue_fn`` per model."""
    if shifts is None:
        shifts = {n: max(0.0, float(w_queue_fn(n)))
                  for n in store.profiles}
    if not any(shifts.values()):
        return store
    return _ShiftedView(store, shifts)


class QueueAwareSelector:
    """Wrap any ``Policy`` with per-model queue-wait awareness.

    ``select_traced(store, t_budget, w_queue_fn, rng)`` evaluates the
    wrapped policy against the shifted store view; the returned trace's
    names refer to the real store's models.
    """

    def __init__(self, policy: Policy):
        self.policy = policy
        self.name = f"qa_{policy.name}"

    def select_traced(self, store: ProfileStore, t_budget: float,
                      w_queue_fn: WQueueFn,
                      rng: np.random.Generator) -> SelectionTrace:
        return self.policy.select_traced(
            shifted_store(store, w_queue_fn), t_budget, rng)

    def select(self, store: ProfileStore, t_budget: float,
               w_queue_fn: WQueueFn, rng: np.random.Generator) -> str:
        return self.select_traced(store, t_budget, w_queue_fn, rng).chosen
