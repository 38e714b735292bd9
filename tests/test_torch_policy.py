"""The port's selection path against the reference: the Router on the
same store, budgets and rng (equal picks, equal budget breakdowns, equal
RNG stream afterwards), the PoolExecutor on the same fixed latency
tables (identical decisions and summary), and the batched entry point
``ModiPick.select_batch`` on the port's device backend (CPU here)."""
import numpy as np
import pytest

from repro.core.netmodel import NetworkModel as JNet
from repro.core.policy import (DynamicGreedy as JDynamic, ModiPick as JModi,
                               RelatedAccurate as JRelAcc)
from repro.core.profiles import ModelProfile as JProfile
from repro.core.profiles import ProfileStore as JStore
from repro.router import Router as JRouter
from repro.router import SlaAwareAdmission as JSla
from repro.serving.executor import PoolExecutor as JExecutor
from repro_torch.core import policy_vec
from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import DynamicGreedy, ModiPick, RelatedAccurate
from repro_torch.core.profiles import ModelProfile, ProfileStore
from repro_torch.kernels import policy_select
from repro_torch.router import ChargedWaits, Router, SlaAwareAdmission
from repro_torch.serving.executor import PoolExecutor

SPECS = [(0.91, 60.0, 6.0), (0.84, 35.0, 3.0), (0.75, 22.0, 2.5),
         (0.62, 9.0, 1.0), (0.55, 5.0, 0.5)]


def _stores(specs=SPECS):
    def build(profile_cls, store_cls):
        ps = []
        for i, (acc, mu, sigma) in enumerate(specs):
            p = profile_cls(name=f"m{i}", accuracy=acc)
            p.mu, p.var, p.n_obs = mu, sigma ** 2, 50
            ps.append(p)
        return store_cls(ps)
    return build(JProfile, JStore), build(ModelProfile, ProfileStore)


POLICIES = {
    "modipick": (lambda: JModi(20.0), lambda: ModiPick(20.0)),
    "related_accurate": (lambda: JRelAcc(15.0), lambda: RelatedAccurate(15.0)),
    "dynamic_greedy": (JDynamic, DynamicGreedy),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("queue_aware,admission", [(False, False),
                                                   (True, True)])
def test_router_route_matches_reference(policy, queue_aware, admission):
    jstore, store = _stores()
    jpol, pol = (f() for f in POLICIES[policy])
    waits = {"m0": 40.0, "m1": 10.0, "m2": 0.0, "m3": 5.0, "m4": 0.0}
    jr = JRouter(jstore, jpol, queue_aware=queue_aware,
                 admission=JSla() if admission else None)
    r = Router(store, pol, queue_aware=queue_aware,
               admission=SlaAwareAdmission() if admission else None)
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    draws = np.random.default_rng(9)
    from repro.router import InferenceRequest as JReq
    from repro_torch.router import InferenceRequest
    for i in range(300):
        t_sla = float(draws.uniform(30.0, 200.0))
        t_in = float(draws.uniform(2.0, 40.0))
        jd = jr.route(JReq(t_sla_ms=t_sla, t_input_ms=t_in, rid=i), jrng,
                      w_queue_fn=waits.__getitem__)
        d = r.route(InferenceRequest(t_sla_ms=t_sla, t_input_ms=t_in, rid=i),
                    rng, w_queue_fn=waits.__getitem__)
        assert (d.admitted, d.variant, d.fallback, d.reject_reason) == \
            (jd.admitted, jd.variant, jd.fallback, jd.reject_reason)
        assert d.budget.t_effective_ms == jd.budget.t_effective_ms
        if d.admitted:
            lat = float(draws.normal(SPECS[int(d.variant[1])][1], 2.0))
            jstore.observe(jd.variant, lat)
            store.observe(d.variant, lat)
    assert rng.random() == jrng.random()
    assert r.stats() == jr.stats()


@pytest.mark.parametrize("charge", [False, True])
def test_router_batch_on_numpy_backend_matches_reference(charge):
    jstore, store = _stores()
    jr = JRouter(jstore, JModi(20.0), queue_aware=True, backend="numpy")
    r = Router(store, ModiPick(20.0), queue_aware=True, backend="numpy")
    draws = np.random.default_rng(5)
    t_sla = draws.uniform(40.0, 200.0, 64)
    t_in = draws.uniform(2.0, 30.0, 64)
    waits = {"m0": 20.0, "m1": 0.0, "m2": 3.0, "m3": 0.0, "m4": 1.0}
    jrng, rng = np.random.default_rng(1), np.random.default_rng(1)
    jres = jr.route_batch_arrays(t_sla, t_in, jrng, w_queue_map=waits,
                                 charge=charge)
    res = r.route_batch_arrays(t_sla, t_in, rng, w_queue_map=waits,
                               charge=charge)
    np.testing.assert_array_equal(res.model_idx, jres.model_idx)
    np.testing.assert_array_equal(res.admitted, jres.admitted)
    np.testing.assert_array_equal(res.w_queue_ms, jres.w_queue_ms)
    assert rng.random() == jrng.random()


def test_auto_backend_keeps_large_charged_batches_off_the_stub(monkeypatch):
    """As in the reference, ``auto`` resolves the charged pass at the
    batch's size: with a card present, a charged batch of
    ``DEVICE_MIN_BATCH`` takes the device pass and a smaller one the
    sequential numpy path; without a card, every size stays on numpy."""
    monkeypatch.delenv("REPRO_TORCH_POLICY_BACKEND", raising=False)
    _, store = _stores()
    r = Router(store, ModiPick(20.0), queue_aware=True, backend="auto",
               trace_detail=False)
    B = policy_vec.DEVICE_MIN_BATCH
    monkeypatch.setattr(policy_vec.torch.cuda, "is_available", lambda: False)
    assert not r._use_charged_scan(B)
    monkeypatch.setattr(policy_vec.torch.cuda, "is_available", lambda: True)
    assert policy_vec.resolve_backend("auto", B) == "cuda"
    assert r._use_charged_scan(B)
    assert not r._use_charged_scan(B - 1)
    # only ModiPick, queue-aware, lean traces and in-pass admission
    for kw in (dict(queue_aware=False), dict(trace_detail=True)):
        args = {**dict(queue_aware=True, trace_detail=False), **kw}
        assert not Router(store, ModiPick(20.0), backend="auto",
                          **args)._use_charged_scan(B)
    assert not Router(store, DynamicGreedy(), queue_aware=True,
                      trace_detail=False)._use_charged_scan(B)


# ----------------------------------------------------------------------
# PoolExecutor: the same execution shell around the same decisions, on
# the reduced qwen2 variants with ``Variant.run`` replaced by a fixed
# latency table in both.
# ----------------------------------------------------------------------
def _pool(variant_cls, config_fn):
    """The reduced qwen2 family at three widths, unbuilt, each replaying
    the same fixed latency table instead of running its model."""
    rng = np.random.default_rng(11)
    base = config_fn("qwen2-1.5b")
    pool = []
    for w, mu in ((0.25, 8.0), (0.5, 20.0), (1.0, 55.0)):
        cfg = base.reduced().scaled(w, name=f"{base.name}-w{w:g}")
        v = variant_cls(name=cfg.name, cfg=cfg,
                        quality=base.quality * (0.6 + 0.4 * w))
        table = iter(np.tile(rng.normal(mu, mu * 0.1, 64), 8))
        v.run = lambda tokens, n_decode=2, t=table: float(next(t))
        pool.append(v)
    return pool


@pytest.mark.parametrize("kw", [dict(), dict(hedging=True, hedge_k=1.0),
                                dict(queue_aware=True)])
def test_executor_matches_reference_on_fixed_latencies(kw):
    from repro.configs.registry import get_config as jax_config
    from repro.serving.pool import Variant as JVariant
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.pool import Variant
    jex = JExecutor(_pool(JVariant, jax_config), JNet(15.0, 7.0),
                    JModi(20.0), seed=4, **kw)
    ex = PoolExecutor(_pool(Variant, get_config), NetworkModel(15.0, 7.0),
                      ModiPick(20.0), seed=4, **kw)
    tokens = np.zeros((4, 128), np.int32)
    jex.warm_up(tokens)
    ex.warm_up(tokens)
    for i in range(120):
        t_sla = 60.0 + 40.0 * (i % 3)
        a = jex.execute(tokens, t_sla=t_sla)
        b = ex.execute(tokens, t_sla=t_sla)
        # the port's result also carries the wait before execute (none)
        assert b.waited_ms == 0.0
        assert vars(a) == {k: x for k, x in vars(b).items()
                           if k != "waited_ms"}
    assert ex.summary() == jex.summary()


# ----------------------------------------------------------------------
# The batched entry point on the port's device backend.
# ----------------------------------------------------------------------
def test_select_batch_device_backend_draws_from_the_eligible_sets():
    _, store = _stores()
    pol = ModiPick(20.0)
    budgets = np.random.default_rng(2).uniform(0.0, 120.0, 5000)
    picks = pol.select_batch(store, budgets, np.random.default_rng(0),
                             backend="cpu")
    tab = store.table()
    base, has, elig, _ = policy_vec.modipick_masks(tab, budgets,
                                                   budgets - 20.0)
    idx = np.array([tab.index[p] for p in picks])
    assert elig[has, idx[has]].all()
    assert (idx[~has] == tab.fastest).all()
    # the device draw follows the numpy stage-3 law
    probs = policy_vec.modipick_probs(tab, budgets, budgets - 20.0, elig,
                                      pol.gamma)
    expect = probs[has].sum(axis=0) / has.sum()
    got = np.bincount(idx[has], minlength=len(tab)) / has.sum()
    np.testing.assert_allclose(got, expect, atol=0.03)


def test_select_fused_consumes_one_seed_and_is_deterministic():
    _, store = _stores()
    tab = store.table()
    t_u = np.linspace(5.0, 100.0, 700)
    pool = tab.device_pool("cpu")
    a = policy_select.select_fused(pool, t_u, t_u - 20.0, seed=42)
    b = policy_select.select_fused(pool, t_u, t_u - 20.0, seed=42)
    np.testing.assert_array_equal(a[0], b[0])
    assert tab.device_pool("cpu") is pool


def test_auto_backend_threshold_and_env(monkeypatch):
    assert policy_vec.resolve_backend(None, 10) == "numpy"
    assert policy_vec.DEVICE_MIN_BATCH == 4096
    monkeypatch.setenv("REPRO_TORCH_POLICY_BACKEND", "cpu")
    assert policy_vec.resolve_backend(None, 10) == "cpu"
    monkeypatch.setenv("REPRO_TORCH_POLICY_BACKEND", "jax")
    with pytest.raises(ValueError, match="REPRO_TORCH_POLICY_BACKEND"):
        policy_vec.resolve_backend(None, 10)


def test_device_backend_needs_a_card_unless_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, store = _stores()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModiPick(20.0).select_batch(store, np.full(16, 80.0),
                                    np.random.default_rng(0),
                                    backend="cuda")
