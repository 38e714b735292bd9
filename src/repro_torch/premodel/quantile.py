"""Streaming latency quantiles and the tail-presenting profile store.

Routing on mean latency is optimistic exactly when it matters: a model
whose μ fits the budget but whose p95 does not will miss tail-tight
SLAs on every spike.  MDInference's answer is to route on a predicted
*duration quantile*.  Two pieces implement that here:

- :class:`P2Quantile` — the Jain & Chlamtac (1985) P² algorithm: a
  constant-memory streaming estimate of one quantile from five markers,
  no sample buffer.  Exact (order-statistic) for the first five
  observations, piecewise-parabolic afterwards.
- :class:`QuantileProfileStore` — a :class:`~repro_torch.core.profiles.
  ProfileStore` whose *presented* table μ is the tracked latency
  quantile instead of the EWMA mean.  Everything downstream — Eq. 2
  eligibility, the stage-2 window, ``T_budget`` checks,
  ``SlaAwareAdmission``'s ``W_queue + μ < T_budget`` viability test —
  reads ``table.mu`` and therefore becomes tail-aware with zero Router
  changes.  The underlying :class:`~repro_torch.core.profiles.ModelProfile`
  EWMAs keep tracking the true mean (engine load charging and queue
  estimates read ``profiles[m].mu`` directly and must stay mean-based).

Until a model has ``min_obs`` accepted observations the presented value
falls back to the Gaussian approximation ``μ + z_q·σ`` from the
(possibly warm-seeded) EWMA state, so cold models are judged
pessimistically but sanely rather than on a five-sample order
statistic.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

from repro_torch.core.profiles import (ModelProfile, ProfileStore,
                                       ProfileTable, _valid_sample)


class P2Quantile:
    """Jain & Chlamtac's P² streaming estimator for one quantile ``q``.

    Five markers track (min, q/2, q, (1+q)/2, max); desired positions
    advance by (0, q/2, q, (1+q)/2, 1) per observation and interior
    markers are nudged toward them with a piecewise-parabolic (fallback
    linear) height adjustment.  O(1) memory, O(1) per observation.
    """

    __slots__ = ("q", "n", "_heights", "_pos", "_desired", "_incr")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._heights: list = []          # marker heights (sorted)
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2 * q, 1.0 + 4 * q, 3.0 + 2 * q, 5.0]
        self._incr = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        h = self._heights
        if self.n <= 5:
            h.append(x)
            h.sort()
            return
        # Locate the marker cell containing x; extremes clamp to it.
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        pos = self._pos
        for i in range(k + 1, 5):
            pos[i] += 1.0
        des = self._desired
        inc = self._incr
        for i in range(5):
            des[i] += inc[i]
        # Nudge the three interior markers toward their desired spots.
        for i in (1, 2, 3):
            d = des[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, d)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, d)
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i]) /
            (pos[i + 1] - pos[i]) +
            (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1]) /
            (pos[i] - pos[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        j = i + (1 if d > 0 else -1)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    def value(self) -> Optional[float]:
        """Current estimate, or ``None`` before any observation.

        With five or fewer samples this is the nearest-rank order
        statistic of what has been seen."""
        h = self._heights
        if not h:
            return None
        if self.n <= 5:
            idx = min(len(h) - 1, max(0, round(self.q * (len(h) - 1))))
            return h[int(idx)]
        return h[2]


def z_score(q: float) -> float:
    """Standard-normal inverse CDF at ``q`` — the Gaussian ``μ + z·σ``
    fallback while a quantile tracker is cold (stdlib, no scipy)."""
    return statistics.NormalDist().inv_cdf(q)


class QuantileProfileStore(ProfileStore):
    """A ProfileStore that *presents* per-model latency as a quantile.

    ``observe`` feeds both the inherited EWMA (``ModelProfile.mu`` stays
    the true mean) and a per-model :class:`P2Quantile`.  The presented
    table carries the tracked quantile in the μ column and 0 in the σ
    column — the quantile already *is* the pessimism Eq. 2 adds via
    μ+σ — so eligibility becomes ``q_lat < T_U`` and SLA-aware
    admission's viability test becomes ``W_queue + q_lat < T_budget``:
    exactly the tail-SLA check, with no Router changes.
    """

    def __init__(self, models: Iterable[ModelProfile], *, q: float = 0.95,
                 min_obs: int = 8, alpha: float = 0.1,
                 cold_age: int = 500) -> None:
        super().__init__(models, alpha=alpha, cold_age=cold_age)
        if not 0.0 < q < 1.0:
            raise ValueError(f"latency quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.min_obs = int(min_obs)
        self._z = z_score(self.q)
        self.trackers: Dict[str, P2Quantile] = {
            name: P2Quantile(self.q) for name in self.profiles}

    def presented_mu(self, name: str) -> float:
        """The latency this store routes on for ``name``: the tracked
        quantile when warm, ``μ + z_q·σ`` from the EWMA otherwise."""
        tr = self.trackers[name]
        if tr.n >= self.min_obs:
            v = tr.value()
            if v is not None:
                return float(v)
        p = self.profiles[name]
        return float(p.mu + self._z * p.sigma)

    def observe(self, name: str, latency_ms: float) -> None:
        if name in self.trackers and _valid_sample(latency_ms):
            self.trackers[name].observe(float(latency_ms))
        super().observe(name, latency_ms)

    # -- presentation ---------------------------------------------------
    def _refresh(self, name: str, p: ModelProfile) -> None:
        t = self._table
        if t is not None:
            t.refresh(t.index[name], self.presented_mu(name), 0.0,
                      p.queue_mu)

    def table(self) -> ProfileTable:
        if self._table is None:
            t = ProfileTable.from_store(self)
            for i, name in enumerate(t.names):
                t.refresh(i, self.presented_mu(name), 0.0,
                          self.profiles[name].queue_mu)
            self._table = t
        return self._table
