"""Mobile network models, seeded with the paper's empirical measurements.

The paper simulates input-transfer time from campus-WiFi stats
(μ=57.87ms, σ=30.78ms for a 330KB image) and sweeps the coefficient of
variation (CV = σ/μ) from 0% to 100% in §4.3.  Latencies are sampled from
a truncated normal (≥ 0.1ms floor), matching the paper's setup.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NetworkModel:
    mean_ms: float
    std_ms: float
    floor_ms: float = 0.1

    @property
    def cv(self) -> float:
        return self.std_ms / max(self.mean_ms, 1e-9)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        x = rng.normal(self.mean_ms, self.std_ms, size=n)
        return np.maximum(x, self.floor_ms)

    def sample_one(self, rng: np.random.Generator) -> float:
        """Scalar draw — one standard normal off the stream, exactly
        like ``sample(rng, 1)[0]``, without the length-1 array churn."""
        x = rng.normal(self.mean_ms, self.std_ms)
        return x if x > self.floor_ms else self.floor_ms

    @staticmethod
    def from_cv(mean_ms: float, cv: float) -> "NetworkModel":
        return NetworkModel(mean_ms=mean_ms, std_ms=mean_ms * cv)


def campus_wifi() -> NetworkModel:
    from repro_torch.core.zoo import CAMPUS_WIFI
    return NetworkModel(CAMPUS_WIFI["mean"], CAMPUS_WIFI["std"])


def prototype_wifi() -> NetworkModel:
    from repro_torch.core.zoo import PROTOTYPE_WIFI
    return NetworkModel(PROTOTYPE_WIFI["mean"], PROTOTYPE_WIFI["std"])
