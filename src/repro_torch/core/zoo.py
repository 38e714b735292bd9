"""The paper's model zoo (Table 2) and measured reference points.

Latency/σ measured by the authors on an EC2 p2.xlarge GPU server over
1,000 runs; accuracies are ImageNet top-1 from the original publications.
``NASNET_FICTIONAL`` is the adversarial pool member used in §4.4 (same
latency profile as NasNet Large, accuracy 50%).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.profiles import ModelProfile


@dataclass(frozen=True)
class ZooEntry:
    name: str
    top1: float        # %
    mu_ms: float
    sigma_ms: float


TABLE2: List[ZooEntry] = [
    ZooEntry("SqueezeNet", 49.0, 4.91, 0.06),
    ZooEntry("MobileNetV1-0.25", 49.7, 3.21, 0.08),
    ZooEntry("MobileNetV1-0.5", 63.2, 4.21, 0.06),
    ZooEntry("DenseNet", 64.2, 25.49, 0.14),
    ZooEntry("MobileNetV1-0.75", 68.3, 4.67, 0.07),
    ZooEntry("MobileNetV1-1.0", 71.0, 5.43, 0.11),
    ZooEntry("NasNet-Mobile", 73.9, 21.18, 0.17),
    ZooEntry("InceptionResNetV2", 77.5, 50.85, 0.33),
    ZooEntry("InceptionV3", 77.9, 31.11, 0.19),
    ZooEntry("InceptionV4", 80.1, 59.21, 0.22),
    ZooEntry("NasNet-Large", 82.6, 112.61, 0.36),
]

NASNET_FICTIONAL = ZooEntry("NasNet-Fictional", 50.0, 112.61, 0.36)

# Prototype pool (§4.1): two retrained models on the small dataset.
PROTOTYPE_POOL: List[ZooEntry] = [
    ZooEntry("MobileNetV1-0.25", 88.9, 3.21, 0.08),
    ZooEntry("InceptionV3", 94.3, 31.11, 0.19),
]

# Fig. 1 / §4: empirical mobile network stats (ms, one-way input transfer).
CAMPUS_WIFI = {"mean": 57.87, "std": 30.78}
PROTOTYPE_WIFI = {"mean": 63.0, "std": 30.0}

# Fig. 3: on-device reference latencies (ms) on a MotoX.
ON_DEVICE = {"MobileNetV1-0.25": 150.0, "MobileNetV1-1.0": 435.0,
             "InceptionV4": 3900.0}
# Fig. 3: server-side InceptionV4 on p2.xlarge ≈ 59 ms.


def true_profiles(entries: List[ZooEntry]) -> Dict[str, ZooEntry]:
    return {e.name: e for e in entries}


def make_store(entries: List[ZooEntry], *, alpha: float = 0.1,
               cold_age: int = 500, warm: bool = True,
               profile: str = "ewma", window: int = 64,
               stale_after: int = 400, explore_bonus: float = 0.9):
    """Build a ProfileStore; ``warm`` seeds profiles at the true (μ, σ)
    like the paper's 1000-request warm-up.

    ``profile`` picks the estimator family: ``"ewma"`` (the paper's
    EWMA store — the default, and the only mode existing call sites
    see), ``"window"`` (sliding-window + staleness exploration —
    ``WindowedProfileStore``), ``"frozen"`` (never updates — the
    drift-ablation baseline).  The window knobs are ignored outside
    ``"window"`` mode."""
    from repro_torch.core.profiles import (FrozenProfileStore, ProfileStore,
                                     WindowedProfileStore)
    profiles = []
    for e in entries:
        p = ModelProfile(name=e.name, accuracy=e.top1 / 100.0)
        profiles.append(p)
    if profile == "window":
        store = WindowedProfileStore(
            profiles, alpha=alpha, cold_age=cold_age, window=window,
            stale_after=stale_after, explore_bonus=explore_bonus)
    elif profile == "frozen":
        store = FrozenProfileStore(profiles, alpha=alpha, cold_age=cold_age)
    elif profile == "ewma":
        store = ProfileStore(profiles, alpha=alpha, cold_age=cold_age)
    else:
        raise ValueError(f"unknown profile mode {profile!r} "
                         "(expected ewma|window|frozen)")
    if warm:
        for e in entries:
            if isinstance(store, WindowedProfileStore):
                store.warm_seed(e.name, e.mu_ms, e.sigma_ms ** 2,
                                n_obs=1000)
            else:
                p = store[e.name]
                p.mu = e.mu_ms
                p.var = e.sigma_ms ** 2
                p.n_obs = 1000
        store.invalidate()  # direct field writes bypass the dirty flag
    return store
