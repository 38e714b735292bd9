"""The port's premodel against the reference's (``repro.premodel``).

- the P² streaming quantile and ``z_score``, the quantile-presenting
  store, the two classifiers and ``make_classifier``, and the
  conditional store (shrinkage, the class cursor, the class tables, the
  stacked snapshot and its cache), each fed the same seeded stream on
  both sides: equal values;
- the classed selection (B4's classed form): ``select_classed`` on the
  CPU (the stacked kernel's plain version) equal to the reference's on
  its uniforms, with rows that have no base, a fallback that differs
  by class, queue shifts, and K = 1 and 3 classes;
- ``Router.route_batch_classed`` equal to the reference's, for ModiPick
  (the stacked selection, on the device ``policy_vec.selection_device``
  names) and for a policy on the scalar path, with and without SLA-aware
  admission;
- the premodel slice as a whole: the registered ``premodel_mix`` as 20
  simultaneous bursts of 200 through ``scenario.build(sc).run()``, on
  ``backend="cpu"`` and on the default, against the reference on
  ``backend="jax"``.

Tolerances: none — every value is compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.premodel as JP
import repro.scenario as J
import repro_torch.premodel as TP
import repro_torch.scenario as T
from repro.core.policy import DynamicGreedy as JGreedy
from repro.core.policy import ModiPick as JModiPick
from repro.core.profiles import ModelProfile as JProfile
from repro.core.zoo import TABLE2
from repro.kernels import policy_select as jsel
from repro.router import Router as JRouter
from repro.router import SlaAwareAdmission as JSla
from repro_torch.core.policy import DynamicGreedy, ModiPick
from repro_torch.core.profiles import ModelProfile
from repro_torch.kernels import policy_select
from repro_torch.router import Router, SlaAwareAdmission

NAMES = [e.name for e in TABLE2]


def _reference_uniforms(seed, n, device):
    """The reference's draws (``jax.random.uniform(PRNGKey(seed),
    (bpad,))``) as a torch tensor."""
    r = jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    return torch.from_numpy(np.array(r)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(policy_select, "uniforms", _reference_uniforms)


def _warm(store):
    for e in TABLE2:
        p = store[e.name]
        p.mu = e.mu_ms
        p.var = e.sigma_ms ** 2
        p.n_obs = 1000
    store.invalidate()
    return store


def _stores(cls_fn, profile_cls, **kw):
    return _warm(cls_fn([profile_cls(name=e.name, accuracy=e.top1 / 100.0)
                         for e in TABLE2], **kw))


def _pair(kind, **kw):
    """The same warmed store on both sides: ``kind`` is
    ``"ConditionalProfileStore"`` or ``"QuantileProfileStore"``."""
    return (_stores(getattr(JP, kind), JProfile, **kw),
            _stores(getattr(TP, kind), ModelProfile, **kw))


def _feed(stores, n, seed, classed=True):
    """The same seeded latency stream into every store: class-attributed
    where ``classed``, with one in ten samples pooled only and a few
    invalid samples that must be refused."""
    rng = np.random.default_rng(seed)
    k = stores[0].n_classes if classed else 1
    for i in range(n):
        e = TABLE2[rng.integers(len(TABLE2))]
        c = int(rng.integers(k))
        lat = e.mu_ms * (0.3 + 2.5 * c / max(k - 1, 1)) \
            * rng.lognormal(0.0, 0.2)
        if i % 97 == 0:
            lat = float("nan")
        for s in stores:
            if classed and i % 10:
                s.observe_class(c, e.name, lat)
            else:
                s.observe(e.name, lat)


def _tables_equal(a, b):
    assert a.names == b.names
    for col in ("mu", "sigma", "accuracy", "queue_mu"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=col)


# ----------------------------------------------------------------------
# P² quantiles, z, the quantile store
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q,dist", [(0.5, "normal"), (0.95, "normal"),
                                    (0.99, "exponential"), (0.1, "spiky")])
def test_p2_quantile_matches_reference(q, dist):
    rng = np.random.default_rng(int(q * 100))
    data = {"normal": lambda: rng.normal(100.0, 20.0, 3000),
            "exponential": lambda: rng.exponential(50.0, 3000),
            "spiky": lambda: rng.normal(40.0, 4.0, 3000)
            * np.where(rng.random(3000) < 0.2, 3.5, 1.0)}[dist]()
    got, want = TP.P2Quantile(q), JP.P2Quantile(q)
    assert got.value() is None and want.value() is None
    for i, v in enumerate(data):
        got.observe(v)
        want.observe(v)
        if i < 8 or i % 50 == 0:
            assert got.value() == want.value(), i
    assert got.value() == want.value()
    assert got.n == want.n == len(data)
    with pytest.raises(ValueError):
        TP.P2Quantile(1.0)


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99, 0.01])
def test_z_score_matches_reference(q):
    from repro.premodel.quantile import z_score as jz
    from repro_torch.premodel.quantile import z_score
    assert z_score(q) == jz(q)


def test_quantile_store_matches_reference():
    """Cold trackers present the Gaussian μ + z·σ, warm ones the
    tracked quantile, σ always 0; the raw EWMA keeps the mean."""
    want, got = _pair("QuantileProfileStore", q=0.95, min_obs=8)
    _tables_equal(got.table(), want.table())
    _feed((want, got), 1500, seed=4, classed=False)
    _tables_equal(got.table(), want.table())
    assert (got.table().sigma == 0.0).all()
    for name in NAMES:
        assert got.presented_mu(name) == want.presented_mu(name)
        assert got[name].mu == want[name].mu
    assert got.n_rejected_samples == want.n_rejected_samples > 0


# ----------------------------------------------------------------------
# classifiers
# ----------------------------------------------------------------------

def test_centroid_classifier_matches_reference():
    rng = np.random.default_rng(2)
    centers = np.array([[0.0, 0.0], [3.0, 3.0], [0.0, 4.0]])
    got = TP.NearestCentroidClassifier(3, 2)
    want = JP.NearestCentroidClassifier(3, 2)
    assert got.classify((1.0, 1.0)) == want.classify((1.0, 1.0)) == 0
    for k in range(600):
        x = centers[rng.integers(3)] + 0.4 * rng.standard_normal(2)
        assert got.classify(x) == want.classify(x)
        assert got.update(x) == want.update(x)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.n_seeded, got.n_updates) == (want.n_seeded, want.n_updates)


def test_oracle_classifier_and_dispatch_match_reference():
    centers = ((0.0,), (1.0,), (2.5,))
    got, want = TP.OracleClassifier(centers), JP.OracleClassifier(centers)
    for x in np.linspace(-1.0, 4.0, 41):
        assert got.classify((x,)) == want.classify((x,))
        assert got.update((x,)) == want.update((x,))
    assert TP.make_classifier("none", 2, 1) is None
    assert isinstance(TP.make_classifier("centroid", 2, 1),
                      TP.NearestCentroidClassifier)
    assert isinstance(TP.make_classifier("oracle", 2, 1, centers=centers),
                      TP.OracleClassifier)
    for bad in (dict(kind="bogus"), dict(kind="oracle")):
        with pytest.raises(ValueError):
            TP.make_classifier(bad["kind"], 2, 1)


# ----------------------------------------------------------------------
# the conditional store
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q", [None, 0.9])
@pytest.mark.parametrize("tau", [16.0, 0.0])
def test_conditional_store_matches_reference(q, tau):
    """Shrinkage toward the pooled estimate (a cold class is the pooled
    view), quantile presentation, and every class table equal after
    the same class-attributed stream."""
    want, got = _pair("ConditionalProfileStore", n_classes=3, tau=tau, q=q)
    for c in range(3):
        _tables_equal(got.class_table(c), want.class_table(c))
    _tables_equal(got.class_table(0), got.table())
    _feed((want, got), 2000, seed=5)
    _tables_equal(got.table(), want.table())
    for c in range(3):
        _tables_equal(got.class_table(c), want.class_table(c))
        assert got.class_obs(c) == want.class_obs(c) > 0
        for name in NAMES:
            assert got.shrunk(c, name) == want.shrunk(c, name)
            assert got.presented_class(c, name) == \
                want.presented_class(c, name)
    assert got.n_rejected_samples == want.n_rejected_samples > 0


def test_cursor_and_pooled_table_match_reference():
    want, got = _pair("ConditionalProfileStore", n_classes=2)
    _feed((want, got), 800, seed=6)
    for s in (want, got):
        s.set_class(1)
    _tables_equal(got.table(), want.table())
    _tables_equal(got.pooled_table(), want.pooled_table())
    assert got.active == want.active == 1
    assert not np.array_equal(got.table().mu, got.pooled_table().mu)
    got.set_class(-1)
    _tables_equal(got.table(), got.pooled_table())
    for bad in (2, -2):
        with pytest.raises(ValueError):
            got.set_class(bad)


def test_stacked_pool_matches_reference_and_caches():
    """The (K, n) snapshot holds the reference's operands at natural
    width; it is cached against the store's version and rebuilt when
    telemetry moves."""
    want, got = _pair("ConditionalProfileStore", n_classes=3)
    _feed((want, got), 600, seed=7)
    s, w = got.stacked_pool("cpu"), want.stacked_pool()
    assert (s.k, s.n) == (w.k, w.n) == (3, len(TABLE2))
    assert s.device == torch.device("cpu")
    for col in ("mu", "sigma", "acc", "rank"):
        np.testing.assert_array_equal(getattr(s, col).numpy(),
                                      np.asarray(getattr(w, col)),
                                      err_msg=col)
    assert s.mu.shape == (3, len(TABLE2)) and s.acc.shape == (len(TABLE2),)
    assert got.stacked_pool("cpu") is s
    got.observe_class(0, "InceptionV3", 40.0)
    s2 = got.stacked_pool("cpu")
    assert s2 is not s and got.stacked_pool("cpu") is s2


# ----------------------------------------------------------------------
# the classed selection
# ----------------------------------------------------------------------

def _inverted(k, side, profile_cls):
    """A store of k classes whose latency truths differ by class: class
    0 sees NasNet-Large fast and everything else slow, the others the
    reverse, scaled by class — so the eligible sets and the fastest
    model (the fallback) differ from row to row."""
    store = _stores(side.ConditionalProfileStore, profile_cls, n_classes=k,
                    tau=1.0)
    for c in range(k):
        for e in TABLE2:
            fast = (e.name == "NasNet-Large") == (c == 0)
            lat = (10.0 + 5.0 * c) if fast else (300.0 + 40.0 * c)
            for _ in range(200):
                store.observe_class(c, e.name, lat + e.mu_ms * 0.1)
    return store


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("B", [1, 97, 300])
def test_select_classed_matches_reference(reference_draws, k, shifted, B):
    want = _inverted(k, JP, JProfile)
    got = _inverted(k, TP, ModelProfile)
    rng = np.random.default_rng(k * 10 + B)
    t_u = rng.uniform(-20.0, 450.0, B)
    t_u[: B // 10] = 1.0                           # no base anywhere
    t_l = t_u - 20.0
    t_l[B // 10: B // 5] = t_u[B // 10: B // 5] + 60.0
    cls = rng.integers(0, k, B).astype(np.int32)
    shifts = rng.uniform(0.0, 40.0, len(TABLE2)) if shifted else None
    idx, has = policy_select.select_classed(got.stacked_pool("cpu"), cls,
                                            t_u, t_l, shifts=shifts, seed=9)
    widx, whas = jsel.select_classed(want.stacked_pool(), cls, t_u, t_l,
                                     shifts=shifts, seed=9)
    np.testing.assert_array_equal(has, whas)
    np.testing.assert_array_equal(idx, widx)
    assert idx.dtype == np.int32 and has.dtype == bool
    if B > 1:
        assert (~has).any() and has.any()
    if k == 3 and B > 1:
        # the fallback is each row's own fastest model
        assert len(set(idx[~has].tolist())) > 1


@pytest.mark.parametrize("n", [129, 200])
@pytest.mark.parametrize("shifted", [False, True])
def test_select_classed_wider_than_128_matches_reference(reference_draws, n,
                                                          shifted):
    """A pool wider than 128 models (the port has no cap): k = 3
    synthetic class rows through ``select_classed`` on both sides."""
    from types import SimpleNamespace

    from repro.kernels.policy_select import DevicePool as JPool
    rng = np.random.default_rng(n + shifted)
    k, B = 3, 300
    acc = rng.uniform(0.3, 0.9, n)
    order = np.argsort(-acc, kind="stable")
    mu = rng.uniform(5.0, 200.0, (k, n))
    sig = rng.uniform(0.0, 10.0, (k, n))
    jp = [JPool(mu[c], sig[c], acc, order, int(np.argmin(mu[c])))
          for c in range(k)]
    tp = [policy_select.DevicePool(mu[c], sig[c], acc, order,
                                   int(np.argmin(mu[c])), device="cpu")
          for c in range(k)]
    want_pool = SimpleNamespace(
        k=k, n=n, npad=jp[0].npad, mu=jnp.stack([p.mu for p in jp]),
        sigma=jnp.stack([p.sigma for p in jp]), acc=jp[0].acc,
        rank=jp[0].rank)
    got_pool = SimpleNamespace(
        k=k, n=n, device=torch.device("cpu"),
        mu=torch.stack([p.mu for p in tp]),
        sigma=torch.stack([p.sigma for p in tp]), acc=tp[0].acc,
        rank=tp[0].rank)
    t_u = rng.uniform(-20.0, 250.0, B)
    t_u[: B // 10] = 1.0                           # no base anywhere
    t_l = t_u - 20.0
    t_l[B // 10: B // 5] = t_u[B // 10: B // 5] + 60.0
    cls = rng.integers(0, k, B).astype(np.int32)
    shifts = rng.uniform(0.0, 40.0, n) if shifted else None
    idx, has = policy_select.select_classed(got_pool, cls, t_u, t_l,
                                            shifts=shifts, seed=4)
    widx, whas = jsel.select_classed(want_pool, cls, t_u, t_l,
                                     shifts=shifts, seed=4)
    np.testing.assert_array_equal(has, whas)
    np.testing.assert_array_equal(idx, widx)
    assert (~has).any() and has.any()


def test_select_classed_refuses_an_unknown_class():
    store = _stores(TP.ConditionalProfileStore, ModelProfile, n_classes=2)
    with pytest.raises(ValueError, match="class ids"):
        policy_select.select_classed(store.stacked_pool("cpu"), [0, 2],
                                     np.full(2, 100.0), np.full(2, 80.0))


@pytest.mark.parametrize("fallback", [False, True])
def test_stacked_plain_version_matches_reference_functions(fallback):
    """``ref.stacked_select_ref`` with per-row acc/rank (the fleet form)
    and with shared ones (the classed form) against the reference's
    jnp ``fleet_select_body`` (vmapped, −1 fallback) and
    ``_classed_select`` on the same uniforms."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(13)
    P, n, B = 4, 6, 64
    mu = rng.uniform(5.0, 200.0, (P, n)).astype(np.float32)
    sig = rng.uniform(0.0, 10.0, (P, n)).astype(np.float32)
    acc = rng.uniform(0.3, 0.9, n).astype(np.float32)
    rank = np.argsort(np.argsort(-acc)).astype(np.float32)
    row = rng.integers(0, P, B).astype(np.int32)
    t_u = rng.uniform(-10.0, 220.0, B).astype(np.float32)
    t_l = (t_u - 20.0).astype(np.float32)
    t_l[:8] = t_u[:8] + 50.0
    shifts = rng.uniform(0.0, 20.0, n).astype(np.float32)
    r01 = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (B,)))
    T_ = lambda x: torch.from_numpy(np.array(x))
    got, has = ref.stacked_select_ref(
        T_(mu), T_(sig), T_(acc), T_(rank), T_(row), T_(t_u), T_(t_l),
        T_(r01), shifts=T_(shifts), fallback=fallback)
    want, whas = jsel._classed_select(mu, sig, acc, rank, row, shifts, t_u,
                                      t_l, 3, gamma=1.0)
    np.testing.assert_array_equal(has.numpy(), np.asarray(whas))
    want = np.asarray(want)
    if not fallback:
        want = np.where(np.asarray(whas), want, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-row acc and rank: the fleet body, one row per cell, each cell
    # drawing from its own key
    acc2 = np.stack([np.roll(acc, c) for c in range(P)])
    rank2 = np.stack([np.roll(rank, c) for c in range(P)])
    per = B // P
    cell = np.repeat(np.arange(P, dtype=np.int32), per)
    keys = [jax.random.PRNGKey(100 + c) for c in range(P)]
    r01 = np.concatenate([np.asarray(jax.random.uniform(k, (per,)))
                          for k in keys])
    got, has = ref.stacked_select_ref(
        T_(mu), T_(sig), T_(acc2), T_(rank2), T_(cell), T_(t_u), T_(t_l),
        T_(r01), fallback=False)
    for c in range(P):
        sl = slice(c * per, (c + 1) * per)
        w = jsel.fleet_select_body(mu[c], sig[c], acc2[c], rank2[c], t_u[sl],
                                   t_l[sl], keys[c])
        np.testing.assert_array_equal(got[sl].numpy(), np.asarray(w))
    assert (got == -1).any() and (got >= 0).any()
    np.testing.assert_array_equal(has.numpy(), got.numpy() >= 0)


# ----------------------------------------------------------------------
# the Router's classed surface
# ----------------------------------------------------------------------

def _routers(policy, backend, admission):
    want = _inverted(2, JP, JProfile)
    got = _inverted(2, TP, ModelProfile)
    if type(policy) is ModiPick:
        jpol = JModiPick(t_threshold=policy.t_threshold)
    else:
        jpol = JGreedy()
    kw = dict(queue_aware=True, trace_detail=False)
    return (JRouter(want, jpol, admission=JSla() if admission else None,
                    **kw),
            Router(got, policy,
                   admission=SlaAwareAdmission() if admission else None,
                   backend=backend, **kw))


@pytest.mark.parametrize("policy,backend", [
    (ModiPick(t_threshold=20.0), None), (ModiPick(t_threshold=20.0), "cpu"),
    (ModiPick(t_threshold=20.0), "numpy"), (DynamicGreedy(), None)],
    ids=["modipick-auto", "modipick-cpu", "modipick-numpy", "greedy"])
@pytest.mark.parametrize("admission", [False, True],
                         ids=["admit_all", "sla_aware"])
def test_route_batch_classed_matches_reference(reference_draws, policy,
                                               backend, admission):
    want_r, got_r = _routers(policy, backend, admission)
    rng = np.random.default_rng(21)
    B = 160
    t_sla = rng.uniform(60.0, 600.0, B)
    t_in = rng.uniform(5.0, 60.0, B)
    cls = rng.integers(0, 2, B)
    waits = dict(zip(NAMES, rng.uniform(0.0, 80.0, len(NAMES)).tolist()))
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for w_map in (waits, None):
        want = want_r.route_batch_classed(t_sla, t_in, cls, rj,
                                          w_queue_map=w_map)
        got = got_r.route_batch_classed(t_sla, t_in, cls, rt,
                                        w_queue_map=w_map)
        for col in ("model_idx", "admitted", "fallback", "w_queue_ms",
                    "replica_idx", "reject_code"):
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col), err_msg=col)
        assert got.admitted.any()
        if admission:
            assert not got.admitted.all()
    assert got_r.stats() == want_r.stats()
    assert rt.integers(1 << 30) == rj.integers(1 << 30)
    assert got_r.store.active == -1
    assert got_r.route_batch_classed([], [], [], rt).model_idx.shape == (0,)


def test_route_batch_classed_on_cuda_needs_a_card(monkeypatch):
    """``backend="cuda"`` names the kernel: without a card it raises
    rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, r = _routers(ModiPick(t_threshold=20.0), "cuda", False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        r.route_batch_classed([300.0, 300.0], [20.0, 20.0], [0, 1],
                              np.random.default_rng(0))


# ----------------------------------------------------------------------
# the slice as a whole: premodel bursts through the Scenario API
# ----------------------------------------------------------------------

def premodel_bursts(side, backend, n_bursts=20, every_ms=2000.0):
    """The registered ``premodel_mix`` as ``n_bursts`` simultaneous bursts
    of 200 over a zero-jitter uplink, so that every burst is one classed
    Router batch."""
    sc = side.get_scenario("premodel_mix")
    times = np.repeat(np.arange(n_bursts) * every_ms, 200)
    return dataclasses.replace(
        sc, name="premodel_bursts",
        workload=dataclasses.replace(sc.workload, arrival="trace",
                                     n_requests=len(times),
                                     times_ms=tuple(times.tolist())),
        network=dataclasses.replace(sc.network, std_ms=0.0),
        policy=dataclasses.replace(sc.policy, backend=backend))


@pytest.mark.parametrize("backend", ["cpu", None])
def test_premodel_bursts_match_reference(reference_draws, monkeypatch,
                                         backend):
    calls = []
    wrapper = policy_select.stacked_select

    def record(*a, **kw):
        calls.append(a[4].shape[0])
        return wrapper(*a, **kw)

    monkeypatch.setattr(policy_select, "stacked_select", record)
    got = T.build(premodel_bursts(T, backend, n_bursts=8)).run()
    want = J.build(premodel_bursts(J, "jax", n_bursts=8)).run()
    assert calls == [200] * 8
    for g, w in zip(got.epochs, want.epochs):
        assert dataclasses.asdict(g.result) == dataclasses.asdict(w.result)
        assert g.router_stats == w.router_stats
    assert got.result.n_arrived == 1600


@pytest.mark.parametrize("name,store,premodel", [
    ("premodel_mix", "ConditionalProfileStore", "NearestCentroidClassifier"),
    ("tail_sla", "QuantileProfileStore", None),
    ("steady", "ProfileStore", None)])
def test_harness_premodel_and_store_match_reference(name, store, premodel):
    """``ScenarioHarness.premodel()`` and ``store()`` build the
    reference's classifier and store for each scenario kind, warmed to
    the same tables."""
    got, want = T.build(T.get_scenario(name)), J.build(J.get_scenario(name))
    assert type(got.store()).__name__ == type(want.store()).__name__ == store
    _tables_equal(got.store().table(), want.store().table())
    g, w = got.premodel(), want.premodel()
    assert (g is None) == (w is None) == (premodel is None)
    if premodel is not None:
        assert type(g).__name__ == type(w).__name__ == premodel
        assert (g.k, g.d) == (w.k, w.d)
    oracle = dataclasses.replace(
        T.get_scenario("premodel_mix"), policy=dataclasses.replace(
            T.get_scenario("premodel_mix").policy, premodel="oracle"))
    clf = T.build(oracle).premodel()
    assert isinstance(clf, TP.OracleClassifier)
    np.testing.assert_array_equal(clf.centers, [[0.0], [1.0]])
