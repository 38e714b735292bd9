"""The premodel: cheap request features → input-class id.

Taylor et al.'s premodel is a tiny model *in front of* model selection:
from features that cost microseconds to compute (input size, resolution
bucket, modality flags) it predicts which class of input is arriving,
and the router then selects against that class's conditional profiles.
Two implementations:

- :class:`NearestCentroidClassifier` — the online learner.  Sequential
  (MacQueen-style) k-means: the first ``n_classes`` observations seed
  the centroids, every later observation moves its nearest centroid
  toward it with a count-decaying learning rate.  Unsupervised on
  purpose: the classifier's job is to partition feature space into
  stable, self-consistent class ids; the
  :class:`~repro_torch.premodel.conditional.ConditionalProfileStore` then
  *learns what each partition means* from observed latency outcomes.
  No ground-truth labels are ever consumed, so the premodel deploys on
  workloads where the easy/hard structure is latent.
- :class:`OracleClassifier` — the frozen ablation: nearest *true*
  feature center, known a priori, never updated.  The gap between the
  two isolates how much of the premodel win survives having to discover
  the classes online.

Both are deterministic given the feature stream (no internal RNG), so
premodel runs stay reproducible and the RNG-neutrality discipline of
the engine is preserved.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


class NearestCentroidClassifier:
    """Online nearest-centroid (sequential k-means) input classifier.

    ``classify`` returns the nearest centroid's id (0 until the first
    observation seeds one); ``update`` folds the feature vector into
    the model.  Seeding takes the first ``n_classes`` observations
    verbatim — if two land in the same latent cluster, the
    count-decaying mean update lets the slightly-closer duplicate
    capture the unclaimed cluster and converge onto it.
    """

    def __init__(self, n_classes: int, n_features: int, *,
                 min_lr: float = 0.02) -> None:
        if n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        if n_features < 1:
            raise ValueError("n_features must be >= 1")
        self.k = int(n_classes)
        self.d = int(n_features)
        self.min_lr = float(min_lr)
        self.centroids = np.zeros((self.k, self.d), dtype=np.float64)
        self.counts = np.zeros(self.k, dtype=np.int64)
        self.n_seeded = 0
        self.n_updates = 0

    def classify(self, features: Sequence[float]) -> int:
        if self.n_seeded == 0:
            return 0
        x = np.asarray(features, dtype=np.float64)
        d2 = ((self.centroids[:self.n_seeded] - x) ** 2).sum(axis=1)
        return int(np.argmin(d2))

    def update(self, features: Sequence[float]) -> int:
        """Fold one observed feature vector in; returns the class id it
        was assigned to (seeded centroids claim their own slot)."""
        x = np.asarray(features, dtype=np.float64)
        self.n_updates += 1
        if self.n_seeded < self.k:
            c = self.n_seeded
            self.centroids[c] = x
            self.counts[c] = 1
            self.n_seeded += 1
            return c
        c = self.classify(x)
        self.counts[c] += 1
        lr = max(1.0 / float(self.counts[c]), self.min_lr)
        self.centroids[c] += lr * (x - self.centroids[c])
        return c


class OracleClassifier:
    """Frozen nearest-true-center classifier — the premodel ablation.

    Knows the scenario's ground-truth feature centers and never learns;
    the online classifier is measured against it."""

    def __init__(self, centers: Iterable[Sequence[float]]) -> None:
        self.centers = np.asarray(list(centers), dtype=np.float64)
        if self.centers.ndim != 2 or len(self.centers) < 1:
            raise ValueError("centers must be a non-empty (K, d) array")
        self.k = len(self.centers)
        self.d = self.centers.shape[1]

    def classify(self, features: Sequence[float]) -> int:
        x = np.asarray(features, dtype=np.float64)
        return int(np.argmin(((self.centers - x) ** 2).sum(axis=1)))

    def update(self, features: Sequence[float]) -> int:
        return self.classify(features)


def make_classifier(kind: str, n_classes: int, n_features: int,
                    centers: Optional[Iterable[Sequence[float]]] = None):
    """``"centroid"`` → online learner, ``"oracle"`` → frozen ablation
    (requires the true ``centers``), ``"none"`` → ``None``."""
    if kind == "none":
        return None
    if kind == "centroid":
        return NearestCentroidClassifier(n_classes, n_features)
    if kind == "oracle":
        if centers is None:
            raise ValueError("oracle classifier needs the true feature "
                             "centers")
        return OracleClassifier(centers)
    raise ValueError(f"unknown premodel kind {kind!r} "
                     "(expected none|centroid|oracle)")
