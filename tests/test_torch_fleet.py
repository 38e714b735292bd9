"""The port's multi-cell fleet against the reference's (``repro.fleet``).

- ``StackedPools``: heterogeneous cell widths re-padded to the common
  width with the reference's sentinels (``PAD_MU``, σ 0, accuracy 1,
  ``PAD_RANK``), equal to the reference's operands, with the host copy
  of μ the frontend and the capacity prior read;
- ``select_fleet`` (B4's fleet form, the stacked kernel's plain version
  on the CPU) equal to the reference's ``select_fleet_stacked`` on its
  ``fold_in`` draws, over heterogeneous widths at B = 97 and B = 300;
- the frontend: sticky placement, ``budget_matrix``, and ``plan`` with
  spill (forced, capacity and load-triggered) equal to the reference's;
- the device rule: the frontend's device follows the scenario's policy
  backend, and ``cuda`` without a card raises;
- the 1-cell parity golden: a 1-cell zero-RTT fleet is the single-cell
  system (attainment 0.9983333333333333), through the harness and the
  fleet engine;
- a multi-cell fleet with spill off and one with a trace, epoch for
  epoch against the reference.

Tolerances: none — every value is compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleet as JF
import repro.scenario as J
import repro_torch.fleet as TF
import repro_torch.scenario as T
from repro.kernels import policy_select as jsel
from repro_torch.kernels import policy_select

GOLDEN_ATTAINMENT = 0.9983333333333333


def _reference_cell_uniforms(seed, C, n, device):
    """The reference's per-cell draws: ``jax.random.uniform`` on
    ``fold_in(PRNGKey(seed), c)`` for each cell c."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(C, dtype=jnp.uint32))
    r = jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=jnp.float32))(
        keys)
    return torch.from_numpy(np.array(r)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(policy_select, "cell_uniforms",
                        _reference_cell_uniforms)


def _with_fleet(sc, fleet):
    return dataclasses.replace(
        sc, deployment=dataclasses.replace(sc.deployment, fleet=fleet))


SUBSETS = ((), ("MobileNetV1-0.25", "SqueezeNet", "DenseNet"),
           ("DenseNet", "NasNet-Mobile", "InceptionV3", "InceptionV4"))


def _tables(side):
    """Three cells' warmed profile tables, widths 11, 3 and 4."""
    sc = side.fleet_scenario(n_cells=3, name="t_stacked")
    views = [JF.cell_view(sc, c) if side is J else TF.cell_view(sc, c)
             for c in sc.deployment.fleet.cells]
    views = [dataclasses.replace(v, deployment=dataclasses.replace(
        v.deployment, subset=s)) for v, s in zip(views, SUBSETS)]
    return [side.build(v).store().table() for v in views]


def test_stacked_pools_pad_as_the_reference():
    got = TF.stack_cell_tables(_tables(T), device="cpu")
    want = JF.stack_cell_tables(_tables(J))
    assert (got.C, got.npad) == (want.C, want.npad) == (3, 11)
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_array_equal(got.fastest, want.fastest)
    for col in ("mu", "sigma", "acc", "rank"):
        g = getattr(got, col)
        assert g.device == torch.device("cpu") and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want,
                                                                    col)),
                                      err_msg=col)
    np.testing.assert_array_equal(got.mu_host, got.mu.numpy())
    assert got.mu_host.dtype == np.float32
    # padded lanes carry the sentinels
    assert (got.mu_host[1, 3:] == np.float32(policy_select.PAD_MU)).all()
    assert (got.rank[2, 4:] == policy_select.PAD_RANK).all()
    assert (got.sigma[1, 3:] == 0).all() and (got.acc[1, 3:] == 1).all()
    with pytest.raises(ValueError):
        TF.StackedPools([], device="cpu")


@pytest.mark.parametrize("B", [97, 300])
@pytest.mark.parametrize("seed", [5, 11])
def test_select_fleet_matches_reference(reference_draws, B, seed):
    got_s = TF.stack_cell_tables(_tables(T), device="cpu")
    want_s = JF.stack_cell_tables(_tables(J))
    rng = np.random.default_rng(B + seed)
    t_u = rng.uniform(2.0, 250.0, size=(3, B))
    t_l = t_u - 20.0
    t_l[:, :B // 10] += 45.0                    # degenerate rows
    got = TF.select_fleet(got_s, t_u, t_l, gamma=1.0, seed=seed)
    want = JF.select_fleet(want_s, t_u, t_l, gamma=1.0, seed=seed)
    assert got.shape == (3, B) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and (got >= 0).any()
    for c in range(3):
        assert (got[c] < got_s.n[c]).all()
    with pytest.raises(ValueError, match="budget bounds"):
        TF.select_fleet(got_s, t_u[:2], t_l[:2])


def test_select_fleet_stacked_plain_equals_reference_on_synthetic(
        reference_draws):
    """The shard_map test's operands (8 cells of 3–7 models, padded to
    8, B on the bucket): the stacked host entry point equal to the
    reference's vmapped body."""
    C, npad, B = 8, 8, 256
    rng = np.random.default_rng(3)
    mu = np.full((C, npad), jsel.PAD_MU, np.float32)
    sig = np.zeros((C, npad), np.float32)
    acc = np.ones((C, npad), np.float32)
    rank = np.full((C, npad), jsel.PAD_RANK, np.float32)
    for c in range(C):
        n = 3 + c % 5
        mu[c, :n] = rng.uniform(3.0, 120.0, n)
        sig[c, :n] = 0.1 * mu[c, :n]
        acc[c, :n] = rng.uniform(0.5, 0.85, n)
        rank[c, :n] = np.argsort(np.argsort(-acc[c, :n]))
    t_u = rng.uniform(2.0, 250.0, size=(C, B)).astype(np.float32)
    t_l = t_u - 20.0
    want = jsel.select_fleet_stacked(mu, sig, acc, rank, t_u, t_l, seed=11)
    got = policy_select.select_fleet_stacked(
        *(torch.from_numpy(x) for x in (mu, sig, acc, rank)), t_u, t_l,
        seed=11)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the frontend
# ----------------------------------------------------------------------

def _frontends(**kw):
    return (TF.FleetFrontend(T.fleet_scenario(**kw)),
            JF.FleetFrontend(J.fleet_scenario(**kw)))


def test_placement_and_budget_matrix_match_reference():
    got, want = _frontends(n_cells=3, weights=(6.0, 3.0, 1.0), rtt_ms=35.0,
                           name="t_budget")
    rids = np.arange(50_000)
    home = got.home_of_requests(rids)
    np.testing.assert_array_equal(home, want.home_of_requests(rids))
    np.testing.assert_array_equal(got.uid_of(rids), want.uid_of(rids))
    load = np.array([5.0, 11.0, 23.0])
    for g, w in zip(got.budget_matrix(home[:500], load),
                    want.budget_matrix(home[:500], load)):
        np.testing.assert_array_equal(g, w)
    frac = np.bincount(home, minlength=3) / rids.size
    assert np.allclose(frac, (0.6, 0.3, 0.1), atol=0.02)


@pytest.mark.parametrize("case", ["forced", "capacity", "load"])
def test_plan_with_spill_matches_reference(reference_draws, case):
    """Spill planning over the same pending window: a cell that cannot
    serve at zero load (forced), a window over its cells' capacity, and
    a load-triggered shed."""
    kw = dict(n_cells=3, rtt_ms=30.0, name="t_plan",
              spill_threshold_ms=40.0 if case == "load" else 0.0)
    got_f, want_f = _frontends(**kw)
    got_t, want_t = _tables(T), _tables(J)
    if case == "forced":
        for tabs in (got_t, want_t):
            tabs[2].mu[:] = 400.0           # cell 2 serves nothing in time
    got_s = TF.stack_cell_tables(got_t, device="cpu")
    want_s = JF.stack_cell_tables(want_t)
    rids = np.arange(1000, 1900)
    load = {"forced": np.zeros(3), "capacity": np.array([10.0, 5.0, 1.0]),
            "load": np.array([120.0, 60.0, 2.0])}[case]
    cap = {"forced": np.array([900.0, 900.0, 600.0]),
           "capacity": np.array([150.0, 600.0, 600.0]),
           "load": np.array([900.0, 900.0, 900.0])}[case]
    got = got_f.plan(rids, load, got_s, cap_req=cap, seed=4)
    want = want_f.plan(rids, load, want_s, cap_req=cap, seed=4)
    for col in ("home", "assigned", "rtt_extra_ms", "picks"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)
    assert got.n_spilled == want.n_spilled > 0


@pytest.mark.parametrize("backend,n,device", [
    (None, 100, "cpu"), ("auto", 100, "cpu"), ("numpy", 10_000, "cpu"),
    ("cpu", 10, "cpu"), ("cuda", 10, "cuda")])
def test_frontend_device_follows_the_policy_backend(backend, n, device):
    sc = T.get_scenario("fleet_steady")
    sc = dataclasses.replace(sc, policy=dataclasses.replace(
        sc.policy, backend=backend))
    assert TF.FleetFrontend(sc).device(n) == device


def test_fleet_on_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = T.get_scenario("fleet_steady")
    sc = dataclasses.replace(sc, policy=dataclasses.replace(
        sc.policy, backend="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build(sc).run()


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def test_one_cell_zero_rtt_fleet_matches_golden():
    """A 1-cell zero-RTT fleet is the single-cell system, pick for pick
    and shed for shed, through the harness and the fleet engine."""
    sc = T.get_scenario("steady")
    fl = TF.FleetSpec(cells=(TF.CellSpec("solo"),), rtt_ms=0.0)
    base = T.build(sc).run()
    wrapped = T.build(_with_fleet(sc, fl)).run()
    assert base.result.sla_attainment == GOLDEN_ATTAINMENT
    assert wrapped.result == base.result
    fr = TF.FleetEngine(_with_fleet(sc, fl)).run()
    assert fr.sla_attainment == GOLDEN_ATTAINMENT
    assert fr.n_spilled == 0 and fr.locality == 1.0 and fr.n_cells == 1


def _fleet_pair(**kw):
    return T.fleet_scenario(**kw), J.fleet_scenario(**kw)


def _epochs_equal(got, want):
    assert len(got.epochs) == len(want.epochs) > 1
    for g, w in zip(got.epochs, want.epochs):
        assert g.epoch == w.epoch
        assert dataclasses.asdict(g.result) == dataclasses.asdict(w.result)
        assert g.router_stats == w.router_stats
        np.testing.assert_array_equal(g.n_assigned, w.n_assigned)
        np.testing.assert_array_equal(g.load_ms, w.load_ms)
        assert g.n_spilled == w.n_spilled
    for key in ("sla_attainment", "mean_accuracy", "mean_latency",
                "mean_queue_wait", "n_spilled", "spill_rate", "locality",
                "n_arrived", "n_completed"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("kw", [
    dict(n_cells=2, rate_rps=60.0, n_requests=2000, spill=False),
    dict(n_cells=3, rate_rps=300.0, n_requests=3000, rtt_ms=20.0,
         subset=("DenseNet", "InceptionV3", "NasNet-Large"),
         trace_path="examples/azure_functions_day.csv", rotate_phases=True,
         spill_threshold_ms=30.0, epoch_ms=4000.0)],
    ids=["no_spill", "trace_spill"])
def test_fleet_engine_matches_reference(reference_draws, kw):
    got_sc, want_sc = _fleet_pair(name="t_engine", **kw)
    got = TF.FleetEngine(got_sc).run()
    want = JF.FleetEngine(want_sc).run()
    _epochs_equal(got, want)
    if kw.get("spill", True):
        assert got.n_spilled > 0
    else:
        assert got.n_spilled == 0
    sr = got.as_scenario_result()
    assert sr.fleet is got and len(sr.epochs) == len(got.epochs)
