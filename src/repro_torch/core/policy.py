"""Model-selection policies: ModiPick's three-stage algorithm (§3.3) plus
the paper's baselines (§3.2 static/dynamic greedy; §4.4 pure random,
related random, related accurate).

Every policy implements ``select(store, t_budget, rng) -> model name``
and ``select_batch(store, t_budgets, rng) -> names`` (the vectorized
fan-out in ``core.policy_vec``).  The scalar path is a batch-of-1 view
over the store's :class:`~repro_torch.core.profiles.ProfileTable` snapshot —
the accuracy-descending order is cached on the store and invalidated by
its dirty flag, so nothing here re-sorts the pool per request.

Time units are milliseconds throughout, matching the paper.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.profiles import ProfileStore, ProfileTable

EPS = 1e-9


def budget(t_sla: float, t_input: float) -> float:
    """Eq. 1: T_budget = T_sla − 2·T_input (conservative network estimate)."""
    return t_sla - 2.0 * t_input


@dataclass
class SelectionTrace:
    """Full decision record (base model, exploration set, probabilities) —
    used by tests and the decomposition benchmark."""
    chosen: str
    base: Optional[str] = None
    eligible: Tuple[str, ...] = ()
    probs: Tuple[float, ...] = ()
    fallback: bool = False


class Policy:
    name = "policy"

    def select(self, store: ProfileStore, t_budget: float,
               rng: np.random.Generator) -> str:
        return self.select_traced(store, t_budget, rng).chosen

    def select_traced(self, store: ProfileStore, t_budget: float,
                      rng: np.random.Generator) -> SelectionTrace:
        raise NotImplementedError

    def select_batch(self, store: ProfileStore, t_budgets,
                     rng: np.random.Generator, *,
                     backend: Optional[str] = None) -> List[str]:
        """Vectorized selection for a batch of budgets; see
        ``repro_torch.core.policy_vec.select_batch``."""
        from repro_torch.core import policy_vec
        return policy_vec.select_batch(self, store, t_budgets, rng,
                                       backend=backend)

    def select_lean(self, store: ProfileStore, t_budget: float,
                    rng: np.random.Generator) -> SelectionTrace:
        """Hot-path scalar selection: identical pick and RNG consumption
        to :meth:`select_traced`, but the returned trace carries only
        ``chosen`` + ``fallback`` (no eligible/probs tuples).  Policies
        without a cheaper core just run the full trace."""
        return self.select_traced(store, t_budget, rng)


def _fastest(store: ProfileStore) -> str:
    tab = store.table()
    return tab.names[tab.fastest]


class StaticGreedy(Policy):
    """§3.2.1: development-time pick — most accurate model whose average
    inference time fits the *SLA itself* (no network correction).  The
    chosen model is frozen the first time the policy sees a store,
    exactly like a developer hard-coding an endpoint.  Presenting a
    *different* store re-freezes against it (each store is a different
    dev-time profiling run), so one policy instance can be reused across
    ``rate_sweep`` points without leaking the previous run's pick;
    ``reset()`` forces the next call to re-freeze.  Store identity
    follows ``store.base``, so the per-selection shifted views built by
    queue-aware wrapping do not thaw the pick."""
    name = "static_greedy"

    def __init__(self, t_sla: float):
        self.t_sla = t_sla
        self._frozen: Optional[str] = None
        self._frozen_store: Optional[ProfileStore] = None

    def reset(self) -> None:
        self._frozen = None
        self._frozen_store = None

    def freeze_pick(self, tab: ProfileTable) -> str:
        """Dev-time choice against a snapshot: most accurate model with
        μ ≤ T_sla, else the fastest."""
        for i in tab.acc_order:
            if tab.mu[i] <= self.t_sla:
                return tab.names[i]
        return tab.names[tab.fastest]

    def select_traced(self, store, t_budget, rng) -> SelectionTrace:
        root = getattr(store, "base", store)
        if self._frozen is None or self._frozen_store is not root:
            self._frozen = self.freeze_pick(root.table())
            self._frozen_store = root
        return SelectionTrace(chosen=self._frozen)


class DynamicGreedy(Policy):
    """§3.2.2: runtime pick — most accurate model with μ ≤ T_budget."""
    name = "dynamic_greedy"

    def select_traced(self, store, t_budget, rng) -> SelectionTrace:
        tab = store.table()
        for i in tab.acc_order:
            if tab.mu[i] <= t_budget:
                return SelectionTrace(chosen=tab.names[i])
        return SelectionTrace(chosen=tab.names[tab.fastest], fallback=True)

    def select_lean(self, store, t_budget, rng) -> SelectionTrace:
        """Same greedy walk over the snapshot's python-float cache —
        identical comparisons, no numpy scalar boxing per step."""
        tab = store.table()
        mu, _, _, _, order, names = tab.scalar_cache()
        for i in order:
            if mu[i] <= t_budget:
                return SelectionTrace(chosen=names[i])
        return SelectionTrace(chosen=names[tab.fastest], fallback=True)


class ModiPick(Policy):
    """The paper's three-stage probabilistic selection (§3.3).

    t_threshold ∈ [0, T_D] controls the exploration window: T_U = T_budget,
    T_L = T_U − t_threshold.

    gamma: exponent on A(m) in the utility.  gamma=1.0 is Eq. 3 exactly as
    printed.  Reproduction note (EXPERIMENTS.md §Fig9): with gamma=1 two
    models sharing a latency profile split probability ∝ accuracy, so the
    adversarial NasNet-Fictional (A=0.50 vs 0.826) is picked ≈38% of the
    time — *not* the "low probability" the paper reports.  gamma≈4 recovers
    the paper's qualitative Fig. 9 behaviour (low-but-nonzero exploration
    of the fictional model); both settings are benchmarked.
    """
    name = "modipick"

    def __init__(self, t_threshold: float, gamma: float = 1.0):
        assert t_threshold >= 0.0
        self.t_threshold = t_threshold
        self.gamma = gamma

    # -- stage 1: greedy base pick (Eq. 2) ------------------------------
    def _base_index(self, tab: ProfileTable, t_u, t_l) -> Optional[int]:
        for i in tab.acc_order:
            if tab.mu[i] + tab.sigma[i] < t_u and tab.mu[i] - tab.sigma[i] < t_l:
                return int(i)
        return None

    def _base_model(self, store, t_u, t_l) -> Optional[str]:
        tab = store.table()
        i = self._base_index(tab, t_u, t_l)
        return None if i is None else tab.names[i]

    # -- stage 2: exploration set --------------------------------------
    def _eligible_indices(self, tab: ProfileTable, base_idx: int,
                          t_u, t_l) -> List[int]:
        half = abs(t_l - tab.mu[base_idx]) + tab.sigma[base_idx]
        lo, hi = t_l - half, t_l + half
        mask = (lo <= tab.mu) & (tab.mu <= hi) & (tab.mu + tab.sigma < t_u)
        out = [int(i) for i in np.flatnonzero(mask)]
        if base_idx not in out:  # base always eligible by construction
            out.append(base_idx)
        return out

    def _eligible(self, store, base: str, t_u, t_l) -> List[str]:
        tab = store.table()
        return [tab.names[i]
                for i in self._eligible_indices(tab, tab.index[base], t_u, t_l)]

    # -- stage 3: utility-weighted sampling (Eqs. 3–4) ------------------
    def _probs_indices(self, tab: ProfileTable, idxs: Sequence[int],
                       t_u, t_l) -> np.ndarray:
        mu, sigma = tab.mu[idxs], tab.sigma[idxs]
        num = t_u - (mu + sigma)  # > 0 by stage-2 constraint
        den = np.maximum(np.abs(t_l - mu), EPS)
        u = np.maximum(tab.accuracy[idxs], EPS) ** self.gamma * num / den
        total = u.sum()
        if not math.isfinite(total) or total <= 0:
            return np.full(len(u), 1.0 / len(u))
        return u / total

    def _probs(self, store, eligible: Sequence[str], t_u, t_l) -> np.ndarray:
        tab = store.table()
        return self._probs_indices(tab, [tab.index[n] for n in eligible],
                                   t_u, t_l)

    def select_traced(self, store, t_budget, rng) -> SelectionTrace:
        tab = store.table()
        t_u = t_budget
        t_l = t_u - self.t_threshold
        with obs.span("policy.base"):
            base_idx = self._base_index(tab, t_u, t_l)
        if base_idx is None:
            # best-effort fallback: fastest model (§3.3.1)
            return SelectionTrace(chosen=tab.names[tab.fastest], fallback=True)
        with obs.span("policy.window"):
            idxs = self._eligible_indices(tab, base_idx, t_u, t_l)
        with obs.span("policy.draw"):
            probs = self._probs_indices(tab, idxs, t_u, t_l)
            pick = int(rng.choice(len(idxs), p=probs))
        return SelectionTrace(chosen=tab.names[idxs[pick]],
                              base=tab.names[base_idx],
                              eligible=tuple(tab.names[i] for i in idxs),
                              probs=tuple(probs))

    def select_lean(self, store, t_budget, rng) -> SelectionTrace:
        """Bit-identical scalar hot path: every stage re-expressed over
        the snapshot's python-float ``scalar_cache`` and the categorical
        draw replicated from ``Generator.choice``'s internals (cumsum,
        tail-normalize, one uniform, right-bisect) — same IEEE doubles,
        same RNG consumption, same pick as :meth:`select_traced`, with
        no numpy dispatch or trace materialisation per request.  Pools
        wider than 8 fall back to the numpy stages (numpy's pairwise
        summation stops being replicable past its 8-lane unroll)."""
        tab = store.table()
        mu, sigma, musig, acc, order, names = tab.scalar_cache()
        t_u = t_budget
        t_l = t_u - self.t_threshold
        base_idx = -1
        for i in order:
            if musig[i] < t_u and mu[i] - sigma[i] < t_l:
                base_idx = i
                break
        if base_idx < 0:
            return SelectionTrace(chosen=names[tab.fastest], fallback=True)
        half = abs(t_l - mu[base_idx]) + sigma[base_idx]
        lo, hi = t_l - half, t_l + half
        idxs = [i for i in range(len(mu))
                if lo <= mu[i] <= hi and musig[i] < t_u]
        if base_idx not in idxs:  # base always eligible by construction
            idxs.append(base_idx)
        k = len(idxs)
        if k > 8:
            probs = self._probs_indices(tab, idxs, t_u, t_l)
            pick = int(rng.choice(k, p=probs))
            return SelectionTrace(chosen=names[idxs[pick]])
        # Eq. 3–4 utilities, element-for-element the ops of
        # ``_probs_indices`` (python floats are the same IEEE doubles;
        # pow(x, 1.0) == x exactly, so γ=1 skips the libm call).
        g = self.gamma
        if g == 1.0:
            u = [(acc[i] if acc[i] > EPS else EPS)
                 * (t_u - musig[i])
                 / (den if (den := abs(t_l - mu[i])) > EPS else EPS)
                 for i in idxs]
        else:
            u = [(acc[i] if acc[i] > EPS else EPS) ** g
                 * (t_u - musig[i])
                 / (den if (den := abs(t_l - mu[i])) > EPS else EPS)
                 for i in idxs]
        # numpy's small-n sum: sequential below 8, 8-lane tree at 8.
        if k == 8:
            total = ((u[0] + u[1]) + (u[2] + u[3])) \
                + ((u[4] + u[5]) + (u[6] + u[7]))
        else:
            total = 0.0
            for x in u:
                total += x
        if not math.isfinite(total) or total <= 0:
            u = [1.0 / k] * k
        else:
            u = [x / total for x in u]
        # Generator.choice(k, p=u) replica: cumsum, normalize by the
        # tail, one uniform, searchsorted-right.
        cdf = []
        t = 0.0
        for x in u:
            t += x
            cdf.append(t)
        last = cdf[-1]
        if last != 1.0:
            cdf = [c / last for c in cdf]
        pick = bisect_right(cdf, rng.random())
        if pick >= k:  # float tail guard, as searchsorted clips
            pick = k - 1
        return SelectionTrace(chosen=names[idxs[pick]])


class PureRandom(Policy):
    """§4.4 stage-1 counterpart: uniform over all managed models."""
    name = "pure_random"

    def select_traced(self, store, t_budget, rng) -> SelectionTrace:
        tab = store.table()
        return SelectionTrace(chosen=tab.names[int(rng.integers(len(tab)))])


class _ExplorationSetPolicy(ModiPick):
    """Shares ModiPick stages 1–2, replaces stage 3."""

    def _pick_from(self, store, eligible, rng) -> str:
        raise NotImplementedError

    # ModiPick's lean core runs ModiPick's stage 3 — subclasses replace
    # stage 3, so they must fall back to their own full trace.
    select_lean = Policy.select_lean

    def select_traced(self, store, t_budget, rng) -> SelectionTrace:
        tab = store.table()
        t_u = t_budget
        t_l = t_u - self.t_threshold
        base_idx = self._base_index(tab, t_u, t_l)
        if base_idx is None:
            return SelectionTrace(chosen=tab.names[tab.fastest], fallback=True)
        eligible = [tab.names[i]
                    for i in self._eligible_indices(tab, base_idx, t_u, t_l)]
        return SelectionTrace(chosen=self._pick_from(store, eligible, rng),
                              base=tab.names[base_idx],
                              eligible=tuple(eligible))


class RelatedRandom(_ExplorationSetPolicy):
    """§4.4 stage-3 counterpart: uniform over the exploration set M_E."""
    name = "related_random"

    def _pick_from(self, store, eligible, rng) -> str:
        return eligible[int(rng.integers(len(eligible)))]


class RelatedAccurate(_ExplorationSetPolicy):
    """§4.4 stage-3 counterpart: most accurate model in M_E."""
    name = "related_accurate"

    def _pick_from(self, store, eligible, rng) -> str:
        return max(eligible, key=lambda n: store[n].accuracy)


# Name -> class registry: the declarative-config axis (policies built
# from strings, mirroring ``router.admission.make_admission``).
POLICIES = {
    "static_greedy": StaticGreedy,
    "dynamic_greedy": DynamicGreedy,
    "modipick": ModiPick,
    "pure_random": PureRandom,
    "related_random": RelatedRandom,
    "related_accurate": RelatedAccurate,
}


def make_policy(name: str, **kwargs) -> Policy:
    """Build a policy from its registry name (``modipick``,
    ``dynamic_greedy``, ...) and constructor kwargs."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r} "
                         f"(valid: {', '.join(sorted(POLICIES))})")
    return cls(**kwargs)
