"""The port's discrete-event engine against the reference engine.

Each test builds the same engine on both sides from the same constants
and seed and runs the same workload:

- on ``backend="numpy"`` (the default at these batch widths), the
  engine's SoA columns (model, replica, fallback, reject reason, every
  timestamp), the run summary and the Router's counters are equal bit
  for bit: ``singleton``, ``batched`` and ``batched_snapshot`` (the
  reference engine benchmark's three configurations), the two SoA
  goldens of ``tests/test_engine_soa.py`` (also asserted as literals),
  one run with replica faults and one with a mid-run elastic
  controller;
- on ``backend="cpu"`` — the device path, through the plain versions of
  the charged pass (``charged_select``) and the fused selection
  (``fused_select``) — fed the reference's uniforms, against the
  reference engine on ``backend="jax"`` (``lax.scan`` over
  ``_charged_step``, and ``_fused_select``): the same decisions for the
  charged and the uncharged 200-wide bursts, and for charged bursts
  over a pool in which every replica of two models (replica 0 among
  them) is killed mid-run.

Tolerances: none — every column is compared exactly.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import policy_select

BURST, BURST_EVERY_MS = 200, 400.0
COLUMNS = ("arrival", "t_input", "t_sla", "enqueue", "sstart", "service",
           "finish", "depart", "model", "replica", "cls", "icls",
           "fallback", "rejected", "reason", "retries")


def _side(root):
    """The names a run needs from one package: ``repro`` (the reference)
    or ``repro_torch`` (the port)."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")
    sim, router = mod("sim"), mod("router")
    pol, zoo = mod("core.policy"), mod("core.zoo")
    return SimpleNamespace(
        root=root, sim=sim, TABLE2=zoo.TABLE2,
        NetworkModel=mod("core.netmodel").NetworkModel,
        ModiPick=pol.ModiPick, DynamicGreedy=pol.DynamicGreedy,
        RetryPolicy=router.RetryPolicy,
        SlaAwareAdmission=router.SlaAwareAdmission,
        ElasticConfig=sim.ElasticConfig)


REF, PORT = _side("repro"), _side("repro_torch")


def _burst_arrivals(s, n):
    times = np.repeat(np.arange(-(-n // BURST)) * BURST_EVERY_MS, BURST)[:n]
    return s.sim.TraceArrivals(times)


def _batched(s, backend=None, charge=True, faults=(), retry=None):
    return s.sim.ServingSimulator(
        s.TABLE2, s.NetworkModel(50.0, 0.0),
        s.sim.per_model_replicas(s.TABLE2, replicas_per_model=4), seed=3,
        queue_aware=True, backend=backend, charge_batches=charge,
        faults=faults, retry=retry)


def _modipick_run(eng, s, n, arrivals, **kw):
    return eng, eng.run(s.ModiPick(t_threshold=20.0), 250.0, n,
                        arrivals=arrivals, **kw)


# config → s → (engine, summary), on the numpy backend
NUMPY_CONFIGS = {
    "singleton": lambda s: _modipick_run(
        s.sim.ServingSimulator(s.TABLE2, s.NetworkModel(50.0, 25.0),
                               s.sim.per_model_replicas(s.TABLE2),
                               seed=3, queue_aware=True),
        s, 2000, s.sim.PoissonArrivals(40.0)),
    "batched": lambda s: _modipick_run(_batched(s), s, 2000,
                                       _burst_arrivals(s, 2000)),
    "batched_snapshot": lambda s: _modipick_run(
        _batched(s, charge=False), s, 2000, _burst_arrivals(s, 2000)),
    # tests/test_engine_soa.py: lookahead window, SLA mix, class labels
    "golden_classes_window": lambda s: _modipick_run(
        s.sim.ServingSimulator(s.TABLE2, s.NetworkModel(50.0, 25.0),
                               s.sim.per_model_replicas(s.TABLE2), seed=7,
                               queue_aware=True, batch_window_ms=5.0,
                               charge_batches=False),
        s, 500, s.sim.PoissonArrivals(40.0),
        sla_for=lambda i: 150.0 if i % 3 == 0 else 300.0,
        class_for=lambda i: "interactive" if i % 3 == 0 else "batch"),
    # tests/test_engine_soa.py: a hard-capped shared pool that sheds
    "golden_shedding": lambda s: _golden_shedding(s),
    "faults": lambda s: _faults_run(s),
    "elastic": lambda s: _elastic_run(s),
}


def _golden_shedding(s):
    eng = s.sim.ServingSimulator(
        s.TABLE2, s.NetworkModel(50.0, 25.0),
        s.sim.shared_replicas(3, max_queue_depth=4), seed=13)
    return eng, eng.run(s.DynamicGreedy(), 250.0, 400,
                        arrivals=s.sim.PoissonArrivals(50.0))


def _faults_run(s):
    """A shared pool of three under SLA-aware admission: r0 killed (its
    victims re-routed), r1 degraded, both restored, a latency drift on
    the most accurate model and a network drift."""
    F = s.sim
    faults = [F.ReplicaFault(at_ms=10_000.0, kind="kill", replica="r0"),
              F.ReplicaFault(at_ms=30_000.0, kind="degrade", replica="r1",
                             factor=2.5),
              F.LatencyDrift(at_ms=40_000.0, model="NasNet-Large",
                             mu_mult=2.0),
              F.ReplicaFault(at_ms=50_000.0, kind="recover", replica="r0"),
              F.NetworkDrift(at_ms=60_000.0, rtt_mult=1.5),
              F.ReplicaFault(at_ms=70_000.0, kind="recover", replica="r1")]
    eng = F.ServingSimulator(s.TABLE2, s.NetworkModel(40.0, 10.0),
                             F.shared_replicas(3), seed=13, queue_aware=True,
                             admission=s.SlaAwareAdmission(),
                             faults=faults,
                             retry=s.RetryPolicy(max_attempts=3))
    return _modipick_run(eng, s, 2000, F.PoissonArrivals(20.0))


def _elastic_run(s):
    """A flash crowd (1,500 requests over 15 s) and a quiet tail (500
    over 60 s) under a proportional mid-run controller with cold
    starts."""
    cfg = s.ElasticConfig(kind="proportional", control_interval_ms=250.0,
                          cold_start_ms=100.0, target_queue_ms=25.0,
                          max_replicas=8)
    eng = s.sim.ServingSimulator(s.TABLE2, s.NetworkModel(50.0, 25.0),
                                 s.sim.shared_replicas(1), seed=3,
                                 queue_aware=True, elastic=cfg)
    times = np.concatenate([np.linspace(0.0, 15_000.0, 1500),
                            np.linspace(20_000.0, 80_000.0, 500)])
    return _modipick_run(eng, s, len(times), s.sim.TraceArrivals(times))


def _assert_same_run(port, ref):
    """Equal SoA columns, lists, summary and Router counters; on the
    first differing column, name the first request that differs."""
    (pe, pr), (re_, rr) = port, ref
    for col in COLUMNS:
        a, b = getattr(pe._cols, col), getattr(re_._cols, col)
        assert a.dtype == b.dtype and a.shape == b.shape, col
        diff = np.flatnonzero(~((a == b) | (a != a) & (b != b)))
        assert not len(diff), (f"column {col}: request {diff[0]} differs "
                               f"(port {a[diff[0]]}, reference "
                               f"{b[diff[0]]})")
    assert pe._reasons == re_._reasons
    assert pe._completed_rids == re_._completed_rids
    assert pe._rejected_rids == re_._rejected_rids
    assert pe._replica_names == re_._replica_names
    assert dataclasses.asdict(pr) == dataclasses.asdict(rr)
    assert pe.router.stats() == re_.router.stats()


@pytest.mark.parametrize("config", sorted(NUMPY_CONFIGS))
def test_engine_numpy_matches_reference(config):
    make = NUMPY_CONFIGS[config]
    port, ref = make(PORT), make(REF)
    _assert_same_run(port, ref)
    eng, res = port
    assert res.n_arrived == len(eng._cols.model)
    if config == "faults":
        assert res.n_retries > 0 and res.n_rejected > 0
    if config == "elastic":
        assert res.n_provisioned > 0 and res.n_decommissioned > 0
    if config.startswith("batched"):
        # one Router call per 200-wide burst
        assert eng.router.stats()["n_batches"] == 2000 // BURST


def test_engine_soa_goldens_pinned():
    """The two goldens of ``tests/test_engine_soa.py``, as literals, on
    the port."""
    _, r = NUMPY_CONFIGS["golden_classes_window"](PORT)
    assert (r.n_arrived, r.n_completed, r.n_rejected) == (500, 500, 0)
    assert r.sla_attainment == 0.918
    assert r.mean_accuracy == 0.7644200000000001
    assert r.mean_latency == 195.7473904291624
    assert r.p99_latency == 315.2542742867032
    assert r.mean_queue_wait == 36.03014440619576
    assert r.horizon_ms == 12595.728078284552
    assert r.per_class["batch"]["n_arrived"] == 333
    assert r.per_class["batch"]["attainment"] == 0.972972972972973
    assert r.per_class["batch"]["accuracy"] == 0.8045255255255257
    assert r.per_class["batch"]["mean_latency"] == 228.88442811973565
    assert r.per_class["interactive"]["attainment"] == 0.8083832335329342
    assert r.per_class["interactive"]["accuracy"] == 0.6844491017964072
    assert r.per_class["interactive"]["mean_latency"] == 129.67174042340864

    _, r = NUMPY_CONFIGS["golden_shedding"](PORT)
    assert (r.n_arrived, r.n_completed, r.n_rejected) == (400, 257, 143)
    assert r.sla_attainment == 0.0175
    assert r.mean_accuracy == 0.818591439688716
    assert r.mean_latency == 433.22467826000116
    assert r.p99_queue_wait == 336.09236612235816
    assert r.replica_utilization == {'r0': 0.9925038681183374,
                                     'r1': 0.9743912120965644,
                                     'r2': 0.9725285189388206}
    assert r.model_usage == {
        'InceptionV3': 0.023346303501945526,
        'InceptionV4': 0.17120622568093385,
        'MobileNetV1-1.0': 0.011673151750972763,
        'NasNet-Large': 0.7859922178988327,
        'NasNet-Mobile': 0.007782101167315175}


def test_engine_views_and_timeline_match_reference():
    """The lazy request views and the attainment timeline read the same
    columns on both sides."""
    (pe, _), (re_, _) = (NUMPY_CONFIGS["faults"](PORT),
                         NUMPY_CONFIGS["faults"](REF))
    assert pe.attainment_timeline(5_000.0) == re_.attainment_timeline(5_000.0)
    for a, b in ((pe.completed_requests, re_.completed_requests),
                 (pe.rejected_requests, re_.rejected_requests)):
        assert [dataclasses.asdict(x) for x in a] == \
            [dataclasses.asdict(x) for x in b]
    assert pe.committed_replica_count() == re_.committed_replica_count()


def test_simulator_closed_loop_matches_reference():
    """``core.simulate.Simulator`` (the paper's closed loop over the
    engine) and ``sla_sweep``."""
    from repro.core import simulate as jsim
    from repro_torch.core import simulate as tsim

    def run(s, mod):
        sim = mod.Simulator(s.TABLE2, s.NetworkModel(50.0, 25.0), seed=1)
        return mod.sla_sweep(sim, lambda t: s.ModiPick(t_threshold=20.0),
                             (150.0, 250.0), n_requests=600)

    got, want = run(PORT, tsim), run(REF, jsim)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


# ----------------------------------------------------------------------
# the device path on the CPU (the kernels' plain versions), on the
# reference's uniforms, against the reference's jax path
# ----------------------------------------------------------------------

def _reference_uniforms(seed, n, device):
    r = jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    return torch.from_numpy(np.array(r)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(policy_select, "uniforms", _reference_uniforms)


def _killed(s):
    """Every replica of SqueezeNet (pool model 0, whose first replica is
    the pool's replica 0) and of NasNet-Large killed mid-run, two of
    SqueezeNet's revived later (replica 0 among them)."""
    F = s.sim
    kill = [F.ReplicaFault(at_ms=1_260.0, kind="kill", replica=f"{m}/{k}")
            for m in ("SqueezeNet", "NasNet-Large") for k in range(4)]
    revive = [F.ReplicaFault(at_ms=3_000.0, kind="recover",
                             replica=f"SqueezeNet/{k}") for k in (0, 1)]
    return kill + revive


def _misplaced(eng):
    """Requests placed on a replica that does not serve their model."""
    c, names = eng._cols, eng._model_names
    return [i for i in np.flatnonzero(c.replica >= 0)
            if not eng._replica_names[c.replica[i]].startswith(
                names[c.model[i]] + "/")]


# config → (charge_batches, faults)
DEVICE_CONFIGS = {"batched": (True, False),
                  "batched_snapshot": (False, False),
                  "batched_killed": (True, True)}


@pytest.mark.parametrize("config", sorted(DEVICE_CONFIGS))
def test_engine_device_path_matches_reference(config, reference_draws,
                                              monkeypatch):
    charge, kills = DEVICE_CONFIGS[config]
    calls = []
    name = "charged_select" if charge else "fused_select"
    wrapper = getattr(policy_select, name)

    def record(*a, **kw):
        calls.append(a[0].device)
        return wrapper(*a, **kw)

    monkeypatch.setattr(policy_select, name, record)

    def run(s, backend):
        eng = _batched(s, backend=backend, charge=charge,
                       faults=_killed(s) if kills else (),
                       retry=s.RetryPolicy(max_attempts=2) if kills else None)
        return _modipick_run(eng, s, 2000, _burst_arrivals(s, 2000))

    port = run(PORT, "cpu")
    ref = run(REF, "jax")
    _assert_same_run(port, ref)
    # every burst went through the plain version of the kernel in use
    assert len(calls) == 2000 // BURST
    assert all(d == torch.device("cpu") for d in calls)
    eng, res = port
    if kills:
        # A model whose replicas are all down has every candidate at
        # +inf in the ledger: its shift is taken as 0 (the reference
        # clamps a non-finite wait, ROADMAP §C) and the replica argmin
        # lands on replica 0.  While replica 0 is dead the engine falls
        # back to the live-pool pick, finds no live replica of the model
        # and rejects; once replica 0 is back, the pick is placed there,
        # on a replica that does not serve the model (the reference's
        # fault, which the port keeps).
        reasons = {eng._reasons[c] for c in
                   eng._cols.reason[eng._cols.rejected]}
        assert "no live replica for NasNet-Large" in reasons
        assert _misplaced(eng) == _misplaced(ref[0])
        assert len(_misplaced(eng)) > 0
