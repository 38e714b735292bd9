"""The port's charged pass and fused selection against the reference.

- ``select_charged`` on the CPU (the wrapper's plain version,
  ``ref.charged_select_ref``) against the reference's ``charged_select``
  (``lax.scan`` over ``_charged_step``), fed the reference's own
  uniforms: all five outputs equal;
- the Router's charged device pass on ``backend="cpu"`` against the
  reference Router on ``backend="jax"``: equal decision columns, stats
  and RNG stream;
- the reference's charged-scan oracles (``tests/test_charging.py``) on
  the port;
- ``ref.fused_select_ref`` against the pipeline it replaced (the same
  stages with ``torch.cumsum``);
- the wrappers' argument checks.

Tolerances: none — picks, verdicts, placements and waits are compared
exactly (the same float operations in the same order on both sides,
but for the reference's summation order over the pool, which moves a
draw only when a uniform lands within an ulp of a boundary).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import ModiPick as JModi
from repro.core.profiles import ModelProfile as JProfile
from repro.core.profiles import ProfileStore as JStore
from repro.kernels import policy_select as jps
from repro.router import ChargedWaits as JCharged
from repro.router import Router as JRouter
from repro.router import SlaAwareAdmission as JSla
from repro_torch.core.policy import ModiPick
from repro_torch.core.profiles import ModelProfile, ProfileStore
from repro_torch.core.zoo import TABLE2, make_store
from repro_torch.kernels import ops, policy_select, ref
from repro_torch.router import ChargedWaits, Router, SlaAwareAdmission

THRESHOLD = 20.0


def _reference_uniforms(seed, n, device):
    """The reference's draws (``jax.random.uniform(PRNGKey(seed),
    (bpad,))``) as a torch tensor."""
    r = jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    return torch.from_numpy(np.array(r)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(policy_select, "uniforms", _reference_uniforms)


def _profiles(rng, n):
    return [(float(rng.uniform(0.3, 0.95)), float(rng.uniform(5.0, 60.0)),
             float(rng.uniform(0.0, 6.0))) for _ in range(n)]


def _stores(specs):
    def build(profile_cls, store_cls):
        ps = []
        for i, (acc, mu, sigma) in enumerate(specs):
            p = profile_cls(name=f"m{i}", accuracy=acc)
            p.mu, p.var, p.n_obs = mu, sigma ** 2, 50
            ps.append(p)
        return store_cls(ps)
    return build(JProfile, JStore), build(ModelProfile, ProfileStore)


def _topology(rng, n, R):
    """Each model served by 1–3 of R replicas."""
    return [sorted(rng.choice(R, size=int(rng.integers(1, min(R, 3) + 1)),
                              replace=False).tolist()) for _ in range(n)]


# case → (n models, R replicas, speeds vary, a replica down, admission)
CASES = {
    "admit_all": (5, 8, False, False, None),
    "sla_slack_mu": (5, 8, False, False, (4.0, True)),
    "sla_plain": (4, 6, False, False, (0.0, False)),
    "speeds": (6, 9, True, False, (2.0, True)),
    "replica_down": (5, 7, False, True, (0.0, True)),
    "n1": (1, 2, False, False, (0.0, True)),
    "n8": (8, 16, True, False, None),
}


def _case(name, seed):
    n, R, speeds, down, adm = CASES[name]
    rng = np.random.default_rng(seed)
    specs = _profiles(rng, n)
    cand = _topology(rng, n, R)
    rep_wait = rng.uniform(0.0, 30.0, R)
    if down:
        # replica 0 is down (its wait is inf); model 0 has no other
        rep_wait[0] = np.inf
        cand[0] = [0]
    speed = rng.uniform(0.5, 2.0, R) if speeds else np.ones(R)
    budgets = rng.uniform(20.0, 160.0, 300)
    return specs, cand, rep_wait, speed, budgets, adm


@pytest.mark.parametrize("name", sorted(CASES))
def test_charged_plain_matches_reference_scan(name, reference_draws):
    specs, cand, rep_wait, speed, budgets, adm = _case(name, len(name))
    jstore, store = _stores(specs)
    jtab, tab = jstore.table(), store.table()
    mu = [m for _, m, _ in specs]
    names = tab.names
    jstate = JCharged(rep_wait, cand, speed, mu, names)
    state = ChargedWaits(rep_wait, cand, speed, mu, names)
    kw = dict(gamma=1.0, seed=1234567 + len(name))
    if adm is not None:
        kw.update(adm_limit=budgets, adm_slack=adm[0],
                  adm_include_mu=adm[1])
    expect = jps.charged_select(jtab.device_pool(), budgets,
                                budgets - THRESHOLD, jstate, **kw)
    got = policy_select.select_charged(tab.device_pool("cpu"), budgets,
                                       budgets - THRESHOLD, state, **kw)
    for what, g, e in zip(("picks", "admitted", "has_base", "replica",
                           "w_chosen"), got, expect):
        np.testing.assert_array_equal(g, e, err_msg=what)
    # the cases exercise what they are named for
    picks, admitted, has_base = got[:3]
    assert admitted.any() and has_base.any()
    if adm is not None:
        assert not admitted.all()
    if len(specs) > 1:
        assert len(np.unique(picks[admitted])) > 1
    np.testing.assert_array_equal(state.rep_wait, np.maximum(rep_wait, 0.0))


@pytest.mark.parametrize("admission", [None, (0.0, False), (5.0, True)])
@pytest.mark.parametrize("topology", ["replicas", "per_model"])
def test_router_charged_device_pass_matches_reference(admission, topology,
                                                      reference_draws):
    """``route_batch_arrays(charge=True)`` on ``backend="cpu"`` (the
    device pass on its plain version) against the reference Router on
    ``backend="jax"``."""
    rng = np.random.default_rng(17)
    specs = _profiles(rng, 6)
    jstore, store = _stores(specs)
    names = store.table().names
    B = 200
    t_sla = rng.uniform(40.0, 180.0, B)
    t_in = rng.uniform(2.0, 30.0, B)

    def router(cls, store_, sla, backend):
        adm = None if admission is None else sla(
            slack_ms=admission[0], include_service_time=admission[1])
        return cls(store_, (JModi if cls is JRouter else ModiPick)(THRESHOLD),
                   admission=adm, queue_aware=True, trace_detail=False,
                   backend=backend)

    jr = router(JRouter, jstore, JSla, "jax")
    r = router(Router, store, SlaAwareAdmission, "cpu")
    assert r._use_charged_scan(B)
    if topology == "replicas":
        cand = _topology(rng, 6, 10)
        waits = rng.uniform(0.0, 40.0, 10)
        speed = rng.uniform(0.5, 2.0, 10)
        mu = [m for _, m, _ in specs]
        kw = dict(charged=JCharged(waits, cand, speed, mu, names))
        pkw = dict(charged=ChargedWaits(waits, cand, speed, mu, names))
    else:
        waits = {n: float(w) for n, w in zip(names,
                                              rng.uniform(0.0, 40.0, 6))}
        kw = pkw = dict(w_queue_map=waits)
    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    jres = jr.route_batch_arrays(t_sla, t_in, jrng, charge=True, **kw)
    res = r.route_batch_arrays(t_sla, t_in, prng, charge=True, **pkw)
    for col in ("model_idx", "admitted", "fallback", "w_queue_ms",
                "replica_idx", "reject_code"):
        np.testing.assert_array_equal(getattr(res, col), getattr(jres, col),
                                      err_msg=col)
    assert [res.reason_of(i) for i in range(B)] == \
        [jres.reason_of(i) for i in range(B)]
    assert r.stats() == jr.stats()
    assert prng.random() == jrng.random()
    assert len(np.unique(res.model_idx[res.admitted])) > 1
    if admission is not None:
        assert not res.admitted.all()


# ----------------------------------------------------------------------
# The reference's charged-scan oracles (tests/test_charging.py), on the
# port's sequential path and its device pass on the CPU.
# ----------------------------------------------------------------------
def _one_model_store(mu=50.0):
    p = ModelProfile(name="m0", accuracy=0.9)
    p.mu, p.var, p.n_obs = mu, 0.0, 100
    return ProfileStore([p])


@pytest.mark.parametrize("backend", ["numpy", "cpu"])
def test_charged_scan_deterministic_single_model(backend):
    """One model, two replicas, fixed budgets: admits exactly while the
    least replica wait is under the budget, alternating replicas — a
    closed-form trajectory with no sampling freedom."""
    store = _one_model_store(50.0)
    router = Router(store, ModiPick(t_threshold=20.0),
                    admission=SlaAwareAdmission(), queue_aware=True,
                    trace_detail=False, backend=backend)
    assert router._use_charged_scan(12) == (backend == "cpu")
    state = ChargedWaits(rep_wait=[0.0, 0.0], cand=[[0, 1]],
                         speed=[1.0, 1.0], mu=[50.0], names=("m0",))
    B = 12
    res = router.route_batch_arrays(
        np.full(B, 200.0), np.zeros(B), np.random.default_rng(0),
        charged=state, charge=True)
    assert res.admitted.tolist() == [True] * 8 + [False] * 4
    assert res.model_idx[:8].tolist() == [0] * 8
    assert res.replica_idx[:8].tolist() == [0, 1] * 4
    assert res.w_queue_ms[:8].tolist() == [0.0, 0.0, 50.0, 50.0,
                                           100.0, 100.0, 150.0, 150.0]
    assert res.w_queue_ms[8:].tolist() == [200.0] * 4
    assert all("budget" in res.reason_of(i) for i in range(8, 12))
    s = router.stats()
    assert s["n_admitted"] == 8 and s["n_shed"] == 4


def test_charged_scan_multimodel_spreads_and_places():
    """The device pass over a real zoo: picks are valid pool indices,
    every admitted request lands on a replica that serves its model, the
    burst spreads over more than one model, and the caller's ledger is
    left as it was (the sequential path charges it in place)."""
    store = make_store(TABLE2)
    router = Router(store, ModiPick(t_threshold=20.0), queue_aware=True,
                    trace_detail=False, backend="cpu")
    tab = store.table()
    n = len(tab.names)

    def state():
        return ChargedWaits(rep_wait=[0.0] * (2 * n),
                            cand=[[2 * m, 2 * m + 1] for m in range(n)],
                            speed=[1.0] * (2 * n), mu=tab.mu, names=tab.names)

    B = 256
    st = state()
    res = router.route_batch_arrays(
        np.full(B, 250.0), np.full(B, 50.0), np.random.default_rng(1),
        charged=st, charge=True)
    assert res.admitted.all()
    picks = res.model_idx
    assert ((0 <= picks) & (picks < n)).all()
    assert len(np.unique(picks)) > 1
    reps = res.replica_idx
    assert ((reps == 2 * picks) | (reps == 2 * picks + 1)).all()
    assert np.sum(st.rep_wait) == 0.0
    router_np = Router(store, ModiPick(t_threshold=20.0), queue_aware=True,
                       trace_detail=False, backend="numpy")
    st2 = state()
    res2 = router_np.route_batch_arrays(
        np.full(B, 250.0), np.full(B, 50.0), np.random.default_rng(1),
        charged=st2, charge=True)
    want = sum(float(tab.mu[m]) for m in res2.model_idx)
    assert float(np.sum(st2.rep_wait)) == pytest.approx(want, rel=1e-12)


# ----------------------------------------------------------------------
# The fused plain version against the pipeline it replaced.
# ----------------------------------------------------------------------
def _cumsum_pipeline(mu, sig, acc, rank, t_u, t_l, r01, gamma):
    """The eager pipeline the fused kernel replaced: the masks, the
    stage-3 probabilities, ``torch.cumsum`` and the argmax draw."""
    base, has_base, eligible = policy_select._stages12(mu, sig, rank, t_u,
                                                       t_l)
    w = ref.policy_probs_ref(mu, sig, acc, t_u, t_l,
                             eligible.to(torch.float32), gamma=gamma)
    cdf = torch.cumsum(w, dim=1)
    total = cdf[:, -1]
    thresh = r01 * total
    choice = torch.argmax((cdf > thresh[:, None]).to(torch.uint8), dim=1)
    choice = torch.where(total > thresh, choice, base)
    return torch.where(has_base, choice, -1)


@pytest.mark.parametrize("n,gamma", [(1, 1.0), (3, 1.0), (8, 2.0),
                                     (128, 1.0)])
def test_fused_plain_gives_the_replaced_pipelines_picks(n, gamma):
    rng = np.random.default_rng(n)
    B = 700
    mu = rng.uniform(5.0, 60.0, n).astype(np.float32)
    sig = rng.uniform(0.0, 6.0, n).astype(np.float32)
    acc = rng.uniform(0.3, 0.95, n).astype(np.float32)
    t_u = rng.uniform(-5.0, 90.0, B).astype(np.float32)
    t_u[:7] = mu.min() - 50.0          # no base
    t_l = (t_u - 25.0).astype(np.float32)
    t_l[7:20] = t_u[7:20] + 40.0       # degenerate (negative) mass
    pool = policy_select.DevicePool(mu, sig, acc,
                                    np.argsort(-acc, kind="stable"),
                                    int(np.argmin(mu)), device="cpu")
    args = (pool.mu, pool.sigma, pool.acc, pool.rank, torch.from_numpy(t_u),
            torch.from_numpy(t_l), torch.from_numpy(rng.random(B, np.float32)))
    got = ref.fused_select_ref(*args, gamma=gamma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _cumsum_pipeline(*args, gamma).numpy())
    assert torch.equal(ops.fused_select(*args, gamma=gamma), got)
    assert (got[:7] == -1).all() and (got >= 0).any()


# ----------------------------------------------------------------------
# The wrappers refuse what the kernels do not take, on every device.
# ----------------------------------------------------------------------
def _charged_args(n=3, R=2, B=4):
    pool = [torch.ones(n) for _ in range(5)]
    return (*pool, torch.ones(n, R, dtype=torch.bool), torch.ones(R),
            torch.zeros(R), *(torch.ones(B) for _ in range(4)))


@pytest.mark.parametrize("case", ["meta", "f64", "shape", "pool", "cand",
                                  "smem"])
def test_selection_wrappers_raise(case):
    args = list(_charged_args())
    fused = [args[i] for i in (0, 1, 2, 3, 8, 9, 10)]
    if case == "meta":
        args = [a.to("meta") for a in args]
        fused = [a.to("meta") for a in fused]
    elif case == "f64":
        args[8] = fused[4] = args[8].double()
    elif case == "shape":
        args[6] = torch.ones(3)
        fused[3] = torch.ones(4)
    elif case == "pool":
        # a pool of no models (any width of one or more is taken)
        fused = [torch.ones(0)] * 4 + fused[4:]
        args[5] = torch.ones(3, 2, dtype=torch.uint8)
    elif case == "cand":
        args[5] = torch.ones(2, 3, dtype=torch.bool)
        fused[6] = torch.ones(5)
    else:
        # 128 models over 2000 replicas: the mask alone is 256,000 bytes
        args = list(_charged_args(n=128, R=2000))
        fused[0] = torch.ones(0)
        assert policy_select.charged_smem_bytes(128, 2000) > \
            policy_select.MAX_SMEM
    with pytest.raises((ValueError, TypeError)):
        ops.charged_select(*args)
    with pytest.raises((ValueError, TypeError)):
        ops.fused_select(*fused)


def test_charged_chunk_mirrors_the_kernel_source():
    """The CPU's shared-memory bound stages as many requests as the
    kernel does."""
    src = (Path(policy_select.__file__).parents[1] / "csrc"
           / "policy_select.cu").read_text()
    chunk = re.search(r"constexpr int kChunk = (\d+);", src)
    assert chunk and int(chunk.group(1)) == policy_select.CHARGED_CHUNK
    assert policy_select.charged_smem(3, 6, "cpu") == (
        policy_select.charged_smem_bytes(3, 6), policy_select.MAX_SMEM)


@pytest.mark.parametrize("n,R,seed", [(1, 2, 0), (5, 8, 1), (11, 44, 2),
                                      (40, 9, 3)])
def test_candidate_lists_equal_the_mask(n, R, seed):
    """The charged kernel's candidate lists (``candidate_lists``, which
    ``select_charged`` builds on the host and ``charged_select`` on the
    pool's device) spell the mask both ways: each model's replicas
    ascending, each replica's models ascending.  Model 0 has no replica
    and the last replica serves no model."""
    rng = np.random.default_rng(seed)
    mask = torch.zeros(n, R, dtype=torch.bool)
    for m in range(1, n):
        mask[m, rng.integers(0, R - 1, rng.integers(1, 4))] = True
    lists = policy_select.candidate_lists(mask)
    assert lists.dtype == torch.int32
    host = lists.numpy()
    nnz = int(mask.sum())
    assert len(host) == n + 1 + nnz + R + 1 + nnz
    off, cols = host[:n + 1], host[n + 1:n + 1 + nnz]
    roff, mods = host[n + 1 + nnz:n + R + 2 + nnz], host[n + R + 2 + nnz:]
    for m in range(n):
        assert list(cols[off[m]:off[m + 1]]) == \
            torch.nonzero(mask[m]).flatten().tolist()
    for r in range(R):
        assert list(mods[roff[r]:roff[r + 1]]) == \
            torch.nonzero(mask[:, r]).flatten().tolist()
    assert off[1] == off[0] == 0 and roff[R] == roff[R - 1] == nnz


def test_empty_batches_launch_nothing():
    args = _charged_args(B=0)
    picks, admitted, has_base, rep, w = ops.charged_select(*args)
    assert picks.shape == admitted.shape == w.shape == (0,)
    assert ops.fused_select(*(args[i] for i in (0, 1, 2, 3, 8, 9, 10))
                            ).shape == (0,)
