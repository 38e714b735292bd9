"""Premodel: feature-conditioned, tail-aware profiles in front of the
Router.

ModiPick (the source paper) routes every request against ONE
unconditional latency/accuracy profile per model.  Two follow-up lines
of work motivate this package:

- **Premodel** (Taylor et al., "Adaptive Selection of Deep Learning
  Models on Embedded Systems"; Marco et al.): cheap, instantly
  computable request features — input size, resolution bucket, modality
  — predict *which* model suffices for a given input.  Easy inputs can
  ride a cheap model at no accuracy loss; hard inputs genuinely need
  the big one.  A tiny classifier in front of model selection converts
  that signal into per-input-class routing.
- **MDInference** (Ogden & Guo): the sequel framing is duration
  *prediction* — under tail-tight SLAs, routing on mean latency is
  systematically optimistic; the estimate that matters is p95/p99 of
  ``W_queue + inference``.

The three pieces map onto the existing architecture without touching
the Router's decision logic:

- :mod:`repro_torch.premodel.classifier` — features → input-class id.
  :class:`~repro_torch.premodel.classifier.NearestCentroidClassifier`
  learns online (sequential k-means);
  :class:`~repro_torch.premodel.classifier.OracleClassifier` is the
  frozen ablation that knows the true class geometry.
- :mod:`repro_torch.premodel.conditional` —
  :class:`~repro_torch.premodel.conditional.ConditionalProfileStore`, K
  per-class profile sets over the shared zoo with hierarchical
  shrinkage toward the pooled unconditional estimate, an active-class
  cursor so the scalar route path works unchanged, and a stacked
  ``(K × pool)`` snapshot for the one-launch batched path.
- :mod:`repro_torch.premodel.quantile` —
  :class:`~repro_torch.premodel.quantile.P2Quantile` streaming
  estimators and
  :class:`~repro_torch.premodel.quantile.QuantileProfileStore`, which
  *presents* per-model latency as the tracked quantile (mean + z·σ
  Gaussian fallback until enough samples) so budget checks and
  ``SlaAwareAdmission`` judge tails, not means — with zero Router
  changes.

Everything here is opt-in: a run with no features and
``latency_quantile=None`` never constructs these objects and executes
the historical path op-for-op (all seeded goldens stay bit-identical).
"""
from repro_torch.premodel.classifier import (NearestCentroidClassifier,
                                             OracleClassifier,
                                             make_classifier)
from repro_torch.premodel.conditional import ConditionalProfileStore
from repro_torch.premodel.quantile import P2Quantile, QuantileProfileStore

__all__ = [
    "NearestCentroidClassifier",
    "OracleClassifier",
    "make_classifier",
    "ConditionalProfileStore",
    "P2Quantile",
    "QuantileProfileStore",
]
