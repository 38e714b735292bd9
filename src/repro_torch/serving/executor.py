"""Pool executor: the live serving path, as a thin execution shell
around the unified ``repro_torch.router.Router``.

Per request: simulate the mobile uplink (the paper's measured WiFi/LTE
distributions), hand the request to the Router (admission verdict,
Eq. 1 budget, queue-aware shifted view, policy selection), run real
prefill+decode on the chosen pool member, feed the measured wall time
back into the EWMA profiles, and score the SLA against the request's own
``t_sla`` — per-request SLA mixes need no special casing.

Straggler mitigation (execution-shell concerns, deliberately *not* in
the Router):
- primary: ModiPick's σ-aware probabilistic routing (a straggling variant
  sees its σ inflate and its selection probability collapse smoothly);
- secondary: hedged re-issue — when a request exceeds μ + hedge_k·σ of its
  variant's profile, it is re-issued on the fastest variant and the
  effective latency is min(straggler, detect + fast) (standard
  tail-at-scale hedging, emulated single-process).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import Policy
from repro_torch.core.profiles import ModelProfile, ProfileStore
from repro_torch.router import AdmissionController, InferenceRequest, Router
from repro_torch.serving.pool import Variant


@dataclass
class RequestResult:
    variant: str
    t_input_ms: float
    t_infer_ms: float
    t_e2e_ms: float
    t_sla_ms: float
    met_sla: bool
    quality: float
    hedged: bool = False
    w_queue_ms: float = 0.0     # queue-wait estimate charged at selection
    admitted: bool = True       # False: shed by router-side admission
    reject_reason: str = ""


@dataclass
class PoolExecutor:
    variants: List[Variant]
    network: NetworkModel
    policy: Policy
    seed: int = 0
    warmup_requests: int = 3
    hedge_k: float = 6.0        # hedge when t > μ + k·σ
    hedging: bool = False
    alpha: float = 0.2
    # queue-aware routing: budget becomes T_sla − 2·T_input − W_queue(m),
    # with W_queue from per-variant in-flight work + batcher telemetry
    # (or an injected estimator, e.g. a load-emulation model).
    queue_aware: bool = False
    w_queue_fn: Optional[Callable[[str], float]] = None
    # router-side admission control (None = admit everything)
    admission: Optional[AdmissionController] = None
    # policy_vec backend override for batched selection
    backend: Optional[str] = None

    @classmethod
    def from_scenario(cls, scenario, variants: List[Variant],
                      **overrides) -> "PoolExecutor":
        """Adapter: build the live execution shell from a declarative
        :class:`repro_torch.scenario.Scenario` — the scenario supplies the
        network/policy/admission/queue-aware surface, the caller supplies
        the real model pool (``variants``)."""
        from repro_torch.scenario.build import build_executor
        return build_executor(scenario, variants, **overrides)

    def __post_init__(self):
        self.by_name: Dict[str, Variant] = {v.name: v for v in self.variants}
        self.store = ProfileStore(
            [ModelProfile(name=v.name, accuracy=v.quality) for v in self.variants],
            alpha=self.alpha)
        self.router = Router(self.store, self.policy,
                             admission=self.admission,
                             queue_aware=self.queue_aware,
                             backend=self.backend)
        self.rng = np.random.default_rng(self.seed)
        self.results: List[RequestResult] = []

    def w_queue(self, name: str) -> float:
        """W_queue(m) estimate for variant ``name``."""
        if self.w_queue_fn is not None:
            return float(self.w_queue_fn(name))
        v = self.by_name[name]
        prof = self.store[name]
        if hasattr(v, "estimated_wait_ms"):
            return v.estimated_wait_ms(prof)
        return prof.queue_mu

    def warm_up(self, tokens: np.ndarray, n_decode: int = 2):
        """Paper §4: warm every model (compile + build profiles).  The
        first run per variant builds the kernels and fills the allocator's
        caches, and is discarded."""
        for v in self.variants:
            v.run(tokens, n_decode)  # compile; not a latency sample
            for _ in range(self.warmup_requests):
                ms = v.run(tokens, n_decode)
                self.store.observe(v.name, ms)

    def execute(self, tokens: np.ndarray, t_sla: float,
                n_decode: int = 2) -> RequestResult:
        t_input = float(self.network.sample(self.rng, 1)[0])
        request = InferenceRequest(rid=len(self.results), t_sla_ms=t_sla,
                                   t_input_ms=t_input)
        dec = self.router.route(request, self.rng, w_queue_fn=self.w_queue)
        if not dec.admitted:
            # Shed before any model ran: the downlink never happens, but
            # the uplink was already spent — charge it and score a miss.
            res = RequestResult(
                variant="", t_input_ms=t_input, t_infer_ms=0.0,
                t_e2e_ms=t_input, t_sla_ms=t_sla, met_sla=False,
                quality=0.0, w_queue_ms=dec.budget.w_queue_ms,
                admitted=False, reject_reason=dec.reject_reason)
            self.results.append(res)
            return res
        name = dec.variant
        v = self.by_name[name]
        v.inflight = getattr(v, "inflight", 0) + 1
        try:
            t_infer = v.run(tokens, n_decode)
        finally:
            v.inflight -= 1
        hedged = False
        prof = self.store[name]
        if self.hedging and prof.n_obs > 3 and \
                t_infer > prof.mu + self.hedge_k * prof.sigma:
            # re-issue on the fastest variant; overlap from detection point
            fast = min(self.store.profiles.values(), key=lambda p: p.mu)
            if fast.name != name:
                detect = prof.mu + self.hedge_k * prof.sigma
                t2 = self.by_name[fast.name].run(tokens, n_decode)
                t_infer = min(t_infer, detect + t2)
                hedged = True
        self.store.observe(name, t_infer)
        e2e = 2.0 * t_input + t_infer
        res = RequestResult(
            variant=name, t_input_ms=t_input, t_infer_ms=t_infer,
            t_e2e_ms=e2e, t_sla_ms=t_sla, met_sla=e2e <= t_sla,
            quality=v.quality, hedged=hedged,
            w_queue_ms=dec.budget.w_queue_ms)
        self.results.append(res)
        return res

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        if not self.results:
            return {}
        rs = self.results
        served = [r for r in rs if r.admitted]
        usage: Dict[str, int] = {}
        for r in served:
            usage[r.variant] = usage.get(r.variant, 0) + 1
        e2e = [r.t_e2e_ms for r in served]
        return {
            "n": len(rs),
            # shed requests count as SLA misses (met_sla is False);
            # latency/quality stats cover served requests, zero (like the
            # simulator's empty summary) when everything was shed
            "sla_attainment": sum(r.met_sla for r in rs) / len(rs),
            "mean_quality": float(np.mean([r.quality for r in served]))
            if served else 0.0,
            "mean_latency_ms": float(np.mean(e2e)) if served else 0.0,
            "p95_latency_ms": float(np.percentile(e2e, 95)) if served else 0.0,
            "p99_latency_ms": float(np.percentile(e2e, 99)) if served else 0.0,
            "hedged": sum(r.hedged for r in rs),
            "shed": len(rs) - len(served),
            "usage": {k: v / len(served) for k, v in sorted(usage.items())},
        }
