"""Model performance profiles: EWMA μ/σ per model + cold-model refresh.

Faithful to ModiPick §3.3 "Practical considerations": profiles are
exponentially-weighted moving averages of observed inference latency, so
they track drift (co-tenant interference, server load) without unbounded
history; models not selected recently are flagged for periodic re-probing
so one bad sample cannot permanently exile an accurate model.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def _valid_sample(x: float) -> bool:
    """A usable latency/wait sample: finite and non-negative.  NaN fails
    the comparison, ±inf fails ``isfinite`` — fault-injected failure
    signals (inf waits from dead replicas) must never reach the EWMA."""
    return x >= 0.0 and math.isfinite(x)


@dataclass
class ModelProfile:
    name: str
    accuracy: float            # A(m): quality score in [0, 1]
    mu: float = 0.0            # EWMA mean inference time (ms)
    var: float = 0.0           # EWMA variance (ms²)
    n_obs: int = 0
    last_selected: int = 0     # request counter at last selection
    queue_mu: float = 0.0      # EWMA queue wait (ms) at this model's replica
    queue_obs: int = 0

    @property
    def sigma(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def update(self, latency_ms: float, alpha: float) -> None:
        if self.n_obs == 0:
            self.mu = latency_ms
            self.var = 0.0
        else:
            delta = latency_ms - self.mu
            self.mu += alpha * delta
            # EW variance (West 1979 incremental form)
            self.var = (1.0 - alpha) * (self.var + alpha * delta * delta)
        self.n_obs += 1

    def update_queue(self, wait_ms: float, alpha: float) -> None:
        """EWMA of the queue wait observed in front of this model's
        replica — the telemetry behind queue-aware budgets."""
        if self.queue_obs == 0:
            self.queue_mu = wait_ms
        else:
            self.queue_mu += alpha * (wait_ms - self.queue_mu)
        self.queue_obs += 1


class ProfileTable:
    """Structure-of-arrays snapshot of a :class:`ProfileStore`.

    Selection math (``core.policy`` / ``core.policy_vec``) runs over
    contiguous ``mu``/``sigma``/``accuracy``/``queue_mu`` arrays instead
    of a dict of dataclasses, and the accuracy-descending order — which
    every greedy stage needs — is computed once per snapshot instead of
    re-sorted per call.  Array positions follow the store's insertion
    order, so index ``i`` everywhere means "the i-th managed model".
    """

    __slots__ = ("names", "index", "accuracy", "mu", "sigma", "queue_mu",
                 "acc_order", "fastest", "_device", "_scalar")

    def __init__(self, names: Tuple[str, ...], accuracy: np.ndarray,
                 mu: np.ndarray, sigma: np.ndarray, queue_mu: np.ndarray,
                 acc_order: Optional[np.ndarray] = None,
                 index: Optional[Dict[str, int]] = None):
        self.names = tuple(names)
        self.index: Dict[str, int] = (
            index if index is not None
            else {n: i for i, n in enumerate(self.names)})
        self.accuracy = accuracy
        self.mu = mu
        self.sigma = sigma
        self.queue_mu = queue_mu
        # Stable sort ties on insertion order — matches
        # ``sorted(profiles, key=lambda p: -p.accuracy)`` exactly.
        self.acc_order = (np.argsort(-accuracy, kind="stable")
                          if acc_order is None else acc_order)
        self.fastest = int(np.argmin(mu))
        self._device = None
        self._scalar = None

    @classmethod
    def from_store(cls, store: "ProfileStore") -> "ProfileTable":
        ps = list(store.profiles.values())
        return cls(
            names=tuple(p.name for p in ps),
            accuracy=np.array([p.accuracy for p in ps], dtype=np.float64),
            mu=np.array([p.mu for p in ps], dtype=np.float64),
            sigma=np.array([p.sigma for p in ps], dtype=np.float64),
            queue_mu=np.array([p.queue_mu for p in ps], dtype=np.float64),
        )

    def shifted(self, shifts: np.ndarray) -> "ProfileTable":
        """Table with ``mu + shifts`` (the queue-aware view: waits folded
        into the location of the latency distribution).  Accuracy — and
        therefore the cached order — is unchanged; ``queue_mu`` is zeroed
        because the shift has consumed it.  The name index is shared
        with the base table (same names, same positions)."""
        return ProfileTable(self.names, self.accuracy, self.mu + shifts,
                            self.sigma, np.zeros_like(self.queue_mu),
                            acc_order=self.acc_order, index=self.index)

    def device_pool(self, device="cuda"):
        """Device-side operands of the fused selection pipeline
        (``kernels.policy_select.DevicePool``) on ``device``, built once
        per snapshot — the freeze-time upload that keeps per-call
        dispatch free of host-side shape work."""
        pool = self._device
        if pool is None or pool.device != torch.device(device):
            from repro_torch.kernels.policy_select import DevicePool
            pool = DevicePool(self.mu, self.sigma, self.accuracy,
                              self.acc_order, self.fastest, device=device)
            self._device = pool
        return pool

    def refresh(self, i: int, mu: float, sigma: float,
                queue_mu: float) -> None:
        """In-place profile update for position ``i`` — the observe hot
        path.  Accuracy never drifts, so ``acc_order`` is untouched;
        ``fastest`` is re-derived, the device-side padding is dropped
        (rebuilt lazily on the next fused selection) and the scalar-path
        float lists are patched to match."""
        self.mu[i] = mu
        self.sigma[i] = sigma
        self.queue_mu[i] = queue_mu
        # argmin only when the write can actually move the minimum:
        # a faster-than-fastest value, a tie that could re-rank by
        # index, or an update of the current minimum itself.
        if i == self.fastest or mu <= self.mu[self.fastest]:
            self.fastest = int(np.argmin(self.mu))
        self._device = None
        s = self._scalar
        if s is not None:
            m, g = float(mu), float(sigma)
            s[0][i] = m
            s[1][i] = g
            s[2][i] = m + g

    def scalar_cache(self):
        """Python-float views for the scalar selection hot path:
        ``(mu, sigma, mu_plus_sigma, accuracy, acc_order, names)`` as
        plain lists — element-for-element the same IEEE doubles as the
        numpy columns (``tolist`` round-trips exactly; the ``mu+sigma``
        list matches the elementwise array add the batched path uses)."""
        if self._scalar is None:
            mu = self.mu.tolist()
            sigma = self.sigma.tolist()
            self._scalar = (mu, sigma, (self.mu + self.sigma).tolist(),
                            self.accuracy.tolist(),
                            self.acc_order.tolist(), list(self.names))
        return self._scalar

    def __len__(self) -> int:
        return len(self.names)


class ProfileStore:
    """Pool of model profiles with ModiPick's maintenance rules."""

    # Class-level default so derived views that bypass ``__init__``
    # (``router.queueaware._ShiftedView``) still read 0; the in-place
    # increment creates the instance attribute on first rejection.
    n_rejected_samples = 0

    def __init__(self, models: Iterable[ModelProfile], *, alpha: float = 0.1,
                 cold_age: int = 500):
        self.profiles: Dict[str, ModelProfile] = {m.name: m for m in models}
        self.alpha = alpha
        self.cold_age = cold_age
        self.step = 0
        # Monotone mutation counter: derived snapshots beyond the one
        # cached table (per-class tables, stacked device pools) compare
        # against it to detect staleness without subscribing to every
        # observe call.  Bumped on accepted telemetry and invalidation.
        self.version = 0
        self._table: Optional[ProfileTable] = None
        # Identity root for derived views: ``router.queueaware.shifted_store``
        # points its per-selection views back at the store they shadow, so
        # store-identity semantics (StaticGreedy's freeze) survive wrapping.
        self.base: "ProfileStore" = self

    def names(self) -> List[str]:
        return list(self.profiles)

    def __getitem__(self, name: str) -> ModelProfile:
        return self.profiles[name]

    def table(self) -> ProfileTable:
        """SoA snapshot, rebuilt lazily after ``observe``/``observe_queue``
        (dirty flag) rather than re-derived per selection.  Callers that
        mutate ``ModelProfile`` fields directly must call
        :meth:`invalidate` themselves."""
        if self._table is None:
            self._table = ProfileTable.from_store(self)
        return self._table

    def invalidate(self) -> None:
        self.version += 1
        self._table = None

    def observe(self, name: str, latency_ms: float) -> None:
        if not _valid_sample(latency_ms):
            self.n_rejected_samples += 1
            return
        p = self.profiles[name]
        p.update(latency_ms, self.alpha)
        self.version += 1
        self._refresh(name, p)

    def observe_queue(self, name: str, wait_ms: float) -> None:
        if not _valid_sample(wait_ms):
            self.n_rejected_samples += 1
            return
        p = self.profiles[name]
        p.update_queue(wait_ms, self.alpha)
        self.version += 1
        # Queue telemetry touches only the queue_mu column: μ/σ, the
        # accuracy order, ``fastest`` and the device/scalar caches are
        # all unaffected, so the patch is a single element write.
        t = self._table
        if t is not None:
            t.queue_mu[t.index[name]] = p.queue_mu

    def _refresh(self, name: str, p: ModelProfile) -> None:
        """Telemetry hot path: patch the cached SoA snapshot in place
        (same floats a full rebuild would produce — accuracy, and with
        it the cached order, never drifts) instead of throwing the whole
        table away per observation."""
        if self._table is not None:
            self._table.refresh(self._table.index[name], p.mu, p.sigma,
                                p.queue_mu)

    def queue_wait(self, name: str) -> float:
        """Estimated queue wait W_queue(m) from telemetry (0 until the
        first observation)."""
        return self.profiles[name].queue_mu

    def mark_selected(self, name: str) -> None:
        self.step += 1
        self.profiles[name].last_selected = self.step

    def cold_models(self) -> List[str]:
        """Models whose profile is stale and due a re-probe."""
        return [
            m.name for m in self.profiles.values()
            if m.n_obs == 0 or (self.step - m.last_selected) > self.cold_age
        ]

    def warm_up(self, name: str, samples: Iterable[float]) -> None:
        for s in samples:
            self.observe(name, s)

    def snapshot(self) -> Dict[str, dict]:
        return {
            n: {"mu": p.mu, "sigma": p.sigma, "accuracy": p.accuracy,
                "n_obs": p.n_obs, "queue_mu": p.queue_mu}
            for n, p in self.profiles.items()
        }


class WindowedProfileStore(ProfileStore):
    """Sliding-window estimator with staleness-driven exploration — the
    self-healing profile mode for drifting worlds.

    Two failure modes of the EWMA base class under drift motivate this
    subclass (Taylor et al. 2018; ROADMAP item 3):

    - *Slow tracking*: an EWMA with small α takes hundreds of samples
      to cross an eligibility threshold after a step change.  Here μ/σ
      come from the last ``window`` samples only, and a window whose
      newest sample is older than ``stale_after`` selections is cleared
      before the next observation lands — after a long exile the first
      fresh sample speaks for the *current* world, not a mixture.
    - *Permanent exile*: once a drifted model's believed μ exceeds
      every budget it is never selected, never observed, and never
      forgiven — even after the drift recovers.  A UCB-style bonus
      fixes that: for a model unobserved for more than ``stale_after``
      selections, the *presented* μ decays linearly from the raw
      window estimate down to ``(1 − explore_bonus)·μ_raw`` over
      ``explore_ramp`` further selections.  Eventually the optimistic
      μ re-enters some budget, the model is re-probed, and the first
      real observation snaps the profile back to measured truth
      (still drifted → re-exiled; recovered → re-discovered).

    The presented (table) μ is the decayed one; the raw window estimate
    is kept separately so the decay is idempotent, not compounding.
    """

    def __init__(self, models: Iterable[ModelProfile], *,
                 alpha: float = 0.1, cold_age: int = 500,
                 window: int = 64, stale_after: int = 400,
                 explore_bonus: float = 0.9,
                 explore_ramp: Optional[int] = None):
        super().__init__(models, alpha=alpha, cold_age=cold_age)
        if window < 2:
            raise ValueError("window must be >= 2")
        if stale_after < 1:
            raise ValueError("stale_after must be >= 1")
        if not 0.0 <= explore_bonus < 1.0:
            raise ValueError("explore_bonus must be in [0, 1)")
        self.window = window
        self.stale_after = stale_after
        self.explore_bonus = explore_bonus
        self.explore_ramp = (explore_ramp if explore_ramp is not None
                             else stale_after)
        names = list(self.profiles)
        self._win: Dict[str, Deque[float]] = {n: deque() for n in names}
        self._sum: Dict[str, float] = {n: 0.0 for n in names}
        self._sumsq: Dict[str, float] = {n: 0.0 for n in names}
        self._raw: Dict[str, Tuple[float, float]] = {n: (0.0, 0.0)
                                                     for n in names}
        # Step (selection counter) at the last accepted observation.
        self._seen: Dict[str, int] = {n: 0 for n in names}

    def warm_seed(self, name: str, mu: float, var: float,
                  n_obs: int = 1000) -> None:
        """Install a trusted offline profile (the zoo's seeded truth)
        without fabricating window samples: the raw estimate is set
        directly and the window stays empty, so the first live sample
        after a drift is not diluted by synthetic history."""
        p = self.profiles[name]
        p.mu, p.var, p.n_obs = mu, var, n_obs
        self._raw[name] = (mu, var)
        self._seen[name] = self.step
        self.version += 1
        self._refresh(name, p)

    def observe(self, name: str, latency_ms: float) -> None:
        if not _valid_sample(latency_ms):
            self.n_rejected_samples += 1
            return
        win = self._win[name]
        if win and (self.step - self._seen[name]) > self.stale_after:
            # Returning from exile: the buffered samples describe a
            # world at least one drift epoch old.  Start fresh.
            win.clear()
            self._sum[name] = 0.0
            self._sumsq[name] = 0.0
        win.append(latency_ms)
        self._sum[name] += latency_ms
        self._sumsq[name] += latency_ms * latency_ms
        if len(win) > self.window:
            old = win.popleft()
            self._sum[name] -= old
            self._sumsq[name] -= old * old
        n = len(win)
        mu = self._sum[name] / n
        var = max(0.0, self._sumsq[name] / n - mu * mu)
        self._raw[name] = (mu, var)
        self._seen[name] = self.step
        p = self.profiles[name]
        p.mu, p.var = mu, var
        p.n_obs += 1
        self.version += 1
        self._refresh(name, p)

    def mark_selected(self, name: str) -> None:
        super().mark_selected(name)
        self._present_stale()

    def _present_stale(self) -> None:
        """Sweep the exploration decay: for every model whose last
        accepted observation is more than ``stale_after`` selections
        old, present an optimistically-shrunk μ.  O(models) per
        selection — the zoo is a handful of entries."""
        for name, (raw_mu, _) in self._raw.items():
            p = self.profiles[name]
            if p.n_obs == 0:
                continue      # never observed: the cold-probe path owns it
            age = self.step - self._seen[name]
            if age <= self.stale_after:
                presented = raw_mu
            else:
                frac = min(1.0, (age - self.stale_after)
                           / float(self.explore_ramp))
                presented = raw_mu * (1.0 - self.explore_bonus * frac)
            if presented != p.mu:
                p.mu = presented
                self._refresh(name, p)

    def staleness(self, name: str) -> int:
        """Selections since this model's last accepted observation."""
        return self.step - self._seen[name]


class FrozenProfileStore(ProfileStore):
    """Ablation baseline: profiles never move after construction.

    Observations are validated (rejects still counted — the hardening
    contract holds everywhere) and then dropped; cold-model re-probing
    is disabled.  Under drift this arm keeps routing on the seeded
    (μ, σ) forever — the degradation the adaptive stores are measured
    against in ``benchmarks/drift_resilience.py``."""

    def observe(self, name: str, latency_ms: float) -> None:
        if not _valid_sample(latency_ms):
            self.n_rejected_samples += 1

    def observe_queue(self, name: str, wait_ms: float) -> None:
        if not _valid_sample(wait_ms):
            self.n_rejected_samples += 1

    def cold_models(self) -> List[str]:
        return []
