"""Per-input-class conditional profiles with hierarchical shrinkage.

One unconditional latency profile per model is the wrong granularity
when the workload mixes easy and hard inputs: the mixture's μ and σ
describe *neither* class (the bimodal spread inflates σ until nothing
accurate is ever eligible).  :class:`ConditionalProfileStore` keeps K
per-class profile sets over the shared zoo alongside the pooled
(unconditional) set it inherits, and *presents* whichever the active
input class asks for:

- **Hierarchical shrinkage.**  A class with few observations should not
  route on noise.  The presented per-class estimate is the classic
  empirical-Bayes blend toward the pooled estimate,
  ``w = n_k / (n_k + tau)``; ``μ̂_k = w·μ_k + (1−w)·μ_pool`` (and the
  same for the variance).  A cold class (n_k = 0) is *exactly* the
  pooled, warm-seeded profile; a warm class converges to its own
  measured truth.
- **Active-class cursor.**  ``set_class(k)`` flips which table
  ``table()`` returns; −1 (the default, never set on premodel-off
  paths) returns the pooled table, so every existing consumer — the
  Router's scalar core, ``shifted_store`` views, admission — works
  unchanged and premodel-off runs are bit-identical to history.
- **Stacked device snapshot.**  ``stacked_pool(device)`` freezes all K
  class tables into ``(K × n)`` operands on one device (the
  fleet-stacking trick from ``fleet.device.StackedPools``), so a
  premodel batch is judged in ONE launch: each request reads its
  class's pool row inside the stacked selection kernel
  (``kernels.policy_select.select_classed``).
- **Tail composition.**  With ``q`` set, per-(class, model)
  :class:`~repro_torch.premodel.quantile.P2Quantile` trackers present the
  class-conditional latency quantile (falling back to the pooled
  tracker, then to the Gaussian ``μ̂ + z_q·σ̂`` of the shrunk estimate)
  — conditional and tail-aware routing compose.

Pooled telemetry keeps flowing no matter the class: ``observe_class``
feeds both the class profile and the pooled one, probes and queue
telemetry feed pooled only, and the engine's load charging keeps
reading the pooled EWMA means.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.profiles import (ModelProfile, ProfileStore,
                                       ProfileTable, _valid_sample)
from repro_torch.premodel.quantile import P2Quantile, z_score


class StackedClassPools:
    """(K, n) per-class mu/sigma on one device, at the pool's natural
    width — the premodel analogue of ``fleet.device.StackedPools``.
    Accuracy (and with it the stage-1 rank) never varies by class, so
    ``acc``/``rank`` stay (n,) and every class row shares them."""

    __slots__ = ("k", "n", "device", "mu", "sigma", "acc", "rank")

    def __init__(self, tables: List[ProfileTable], device="cuda"):
        pools = [t.device_pool(device) for t in tables]
        self.k = len(pools)
        self.n = pools[0].n
        self.device = pools[0].device
        self.mu = torch.stack([p.mu for p in pools])
        self.sigma = torch.stack([p.sigma for p in pools])
        self.acc = pools[0].acc
        self.rank = pools[0].rank


class ConditionalProfileStore(ProfileStore):
    """K per-class profile sets + the pooled set, behind one store."""

    def __init__(self, models: Iterable[ModelProfile], *, n_classes: int,
                 tau: float = 16.0, q: Optional[float] = None,
                 min_obs: int = 8, alpha: float = 0.1,
                 cold_age: int = 500) -> None:
        super().__init__(models, alpha=alpha, cold_age=cold_age)
        if n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        if tau < 0.0:
            raise ValueError("shrinkage tau must be >= 0")
        self.n_classes = int(n_classes)
        self.tau = float(tau)
        self.q = float(q) if q is not None else None
        self.min_obs = int(min_obs)
        self._z = z_score(self.q) if self.q is not None else 0.0
        self.class_profiles: List[Dict[str, ModelProfile]] = [
            {name: ModelProfile(name=name, accuracy=p.accuracy)
             for name, p in self.profiles.items()}
            for _ in range(self.n_classes)]
        if self.q is not None:
            self.pool_trackers: Optional[Dict[str, P2Quantile]] = {
                name: P2Quantile(self.q) for name in self.profiles}
            self.class_trackers: Optional[List[Dict[str, P2Quantile]]] = [
                {name: P2Quantile(self.q) for name in self.profiles}
                for _ in range(self.n_classes)]
        else:
            self.pool_trackers = None
            self.class_trackers = None
        self.active = -1
        self._class_tables: List[Optional[ProfileTable]] = (
            [None] * self.n_classes)
        self._class_ver = [-1] * self.n_classes
        self._stacked: Optional[StackedClassPools] = None
        self._stacked_ver = -1

    # -- the cursor -----------------------------------------------------
    def set_class(self, cls: int) -> None:
        """Select which class's table :meth:`table` presents; −1 is the
        pooled (historical) view.  Premodel-off paths never call this,
        which is what keeps them bit-identical."""
        if not -1 <= cls < self.n_classes:
            raise ValueError(f"class id {cls} out of range "
                             f"[-1, {self.n_classes})")
        self.active = int(cls)

    # -- estimates ------------------------------------------------------
    def shrunk(self, cls: int, name: str) -> Tuple[float, float]:
        """Shrinkage-blended ``(μ, var)`` for (class, model):
        ``w = n_k/(n_k + tau)`` toward the pooled estimate."""
        pp = self.profiles[name]
        cp = self.class_profiles[cls][name]
        if self.tau == 0.0:
            w = 1.0 if cp.n_obs > 0 else 0.0
        else:
            w = cp.n_obs / (cp.n_obs + self.tau)
        return (w * cp.mu + (1.0 - w) * pp.mu,
                w * cp.var + (1.0 - w) * pp.var)

    def presented_class(self, cls: int, name: str) -> Tuple[float, float]:
        """The ``(μ, σ)`` the class-``cls`` table carries for ``name``.
        Mean mode: the shrunk estimate.  Quantile mode: the warmest
        available tracker (class, then pooled), else the Gaussian
        ``μ̂ + z_q·σ̂`` of the shrunk estimate — always with σ = 0 (the
        quantile already carries the tail pessimism)."""
        mu, var = self.shrunk(cls, name)
        if self.q is None:
            return mu, math.sqrt(max(var, 0.0))
        tr = self.class_trackers[cls][name]
        if tr.n >= self.min_obs:
            v = tr.value()
            if v is not None:
                return float(v), 0.0
        ptr = self.pool_trackers[name]
        if ptr.n >= self.min_obs:
            v = ptr.value()
            if v is not None:
                return float(v), 0.0
        return mu + self._z * math.sqrt(max(var, 0.0)), 0.0

    def _pooled_presented(self, name: str) -> float:
        """Quantile-mode pooled μ (mirrors ``QuantileProfileStore``)."""
        ptr = self.pool_trackers[name]
        if ptr.n >= self.min_obs:
            v = ptr.value()
            if v is not None:
                return float(v)
        p = self.profiles[name]
        return float(p.mu + self._z * p.sigma)

    # -- telemetry ------------------------------------------------------
    def observe(self, name: str, latency_ms: float) -> None:
        """Pooled-only observation (probes, class-unattributed samples)."""
        if self.pool_trackers is not None and name in self.pool_trackers \
                and _valid_sample(latency_ms):
            self.pool_trackers[name].observe(float(latency_ms))
        super().observe(name, latency_ms)

    def observe_class(self, cls: int, name: str, latency_ms: float) -> None:
        """Class-attributed observation: feeds the class profile (and
        tracker), then the pooled set via :meth:`observe`."""
        if not _valid_sample(latency_ms):
            self.n_rejected_samples += 1
            return
        cp = self.class_profiles[cls][name]
        cp.update(latency_ms, self.alpha)
        if self.class_trackers is not None:
            self.class_trackers[cls][name].observe(float(latency_ms))
        self.observe(name, latency_ms)

    # -- presentation ---------------------------------------------------
    def _refresh(self, name: str, p: ModelProfile) -> None:
        if self._table is None:
            return
        if self.q is None:
            super()._refresh(name, p)
        else:
            self._table.refresh(self._table.index[name],
                                self._pooled_presented(name), 0.0,
                                p.queue_mu)

    def table(self) -> ProfileTable:
        if self.active >= 0:
            return self.class_table(self.active)
        if self.q is None:
            return super().table()
        if self._table is None:
            t = ProfileTable.from_store(self)
            for i, name in enumerate(t.names):
                t.refresh(i, self._pooled_presented(name), 0.0,
                          self.profiles[name].queue_mu)
            self._table = t
        return self._table

    def pooled_table(self) -> ProfileTable:
        """The unconditional view regardless of the cursor — batch
        admission judges against it (snapshot semantics)."""
        if self.active < 0:
            return self.table()
        active, self.active = self.active, -1
        try:
            return self.table()
        finally:
            self.active = active

    def class_table(self, cls: int) -> ProfileTable:
        """The class-``cls`` shrunk (or quantile-presented) snapshot,
        cached against the store's mutation ``version``."""
        if self._class_tables[cls] is not None \
                and self._class_ver[cls] == self.version:
            return self._class_tables[cls]
        names = tuple(self.profiles)
        mu = np.empty(len(names), dtype=np.float64)
        sigma = np.empty(len(names), dtype=np.float64)
        for i, name in enumerate(names):
            mu[i], sigma[i] = self.presented_class(cls, name)
        t = ProfileTable(
            names,
            np.array([p.accuracy for p in self.profiles.values()],
                     dtype=np.float64),
            mu, sigma,
            np.array([p.queue_mu for p in self.profiles.values()],
                     dtype=np.float64))
        self._class_tables[cls] = t
        self._class_ver[cls] = self.version
        return t

    def stacked_pool(self, device="cuda") -> StackedClassPools:
        """All K class tables as one (K × n) snapshot on ``device`` for
        the stacked selection kernel, rebuilt only when telemetry moved
        (or another device is asked for)."""
        if self._stacked is None or self._stacked_ver != self.version \
                or self._stacked.device != torch.device(device):
            self._stacked = StackedClassPools(
                [self.class_table(k) for k in range(self.n_classes)],
                device)
            self._stacked_ver = self.version
        return self._stacked

    def class_obs(self, cls: int) -> int:
        """Accepted class-attributed observations (diagnostics)."""
        return sum(p.n_obs for p in self.class_profiles[cls].values())
