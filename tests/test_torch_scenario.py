"""The port's Scenario API against the reference's.

- every registered scenario is the same plain data on both sides (its
  ``to_dict``), and round-trips through a dict and JSON on the port;
- each of the sixteen registered scenarios gives, from
  ``build(sc).run()``, the same epochs as the reference: the engine's
  summary, the Router's counters and the replica history, equal bit for
  bit (numpy backend, the default at these batch widths; the premodel
  and fleet scenarios' stacked selections run the kernel's plain
  version on the CPU, on the reference's uniforms);
- the pinned goldens of ``tests/test_scenario.py`` (``steady`` and the
  paper's closed loop) as literals;
- ``examples/drift.toml`` and ``examples/elastic.toml`` load to the
  same scenario;
- ``PolicySpec.backend``: ``jax`` is refused with the valid values
  named, the port's own backends are accepted;
- the ``from_scenario`` adapters of the engine, the closed loop and the
  pool executor.
"""
import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenario as J
import repro_torch.scenario as T
from repro.serving.executor import PoolExecutor as JExecutor
from repro_torch.core.policy import ModiPick
from repro_torch.core.simulate import Simulator
from repro_torch.core.zoo import TABLE2
from repro_torch.kernels import policy_select
from repro_torch.router import SlaAwareAdmission
from repro_torch.scenario.spec import (DeploymentSpec, NetworkSpec,
                                       PolicySpec, Scenario, WorkloadSpec)
from repro_torch.serving.executor import PoolExecutor
from repro_torch.sim import (PoissonArrivals, ServingSimulator,
                             per_model_replicas)
from repro_torch.core.netmodel import NetworkModel

REPO = Path(__file__).resolve().parent.parent
# The registered scenarios the port cannot run yet: none.
UNPORTED = ()
RUNNABLE = [n for n in T.list_scenarios() if n not in UNPORTED]


def _reference_uniforms(seed, n, device):
    r = jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    return torch.from_numpy(np.array(r)).to(device)


def _reference_cell_uniforms(seed, C, n, device):
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(C, dtype=jnp.uint32))
    r = jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=jnp.float32))(
        keys)
    return torch.from_numpy(np.array(r)).to(device)


def test_registry_holds_the_reference_scenarios_as_data():
    assert T.list_scenarios() == J.list_scenarios()
    assert len(T.list_scenarios()) == 16 and len(RUNNABLE) == 16
    for name in T.list_scenarios():
        assert (T.get_scenario(name).to_dict()
                == J.get_scenario(name).to_dict()), name


@pytest.mark.parametrize("name", T.list_scenarios())
def test_scenario_dict_round_trip(name):
    sc = T.get_scenario(name)
    assert Scenario.from_dict(sc.to_dict()) == sc
    assert Scenario.from_dict(json.loads(json.dumps(sc.to_dict()))) == sc


@pytest.mark.parametrize("name", RUNNABLE)
def test_registered_scenario_matches_reference(name, monkeypatch):
    monkeypatch.setattr(policy_select, "uniforms", _reference_uniforms)
    monkeypatch.setattr(policy_select, "cell_uniforms",
                        _reference_cell_uniforms)
    got = T.build(T.get_scenario(name)).run()
    want = J.build(J.get_scenario(name)).run()
    assert len(got.epochs) == len(want.epochs)
    for g, w in zip(got.epochs, want.epochs):
        assert (g.epoch, g.n_replicas) == (w.epoch, w.n_replicas)
        assert dataclasses.asdict(g.result) == dataclasses.asdict(w.result)
        assert g.router_stats == w.router_stats
    assert got.replica_history == want.replica_history
    assert got.attainment_history == want.attainment_history
    for key in ("sla_attainment", "mean_accuracy", "mean_latency",
                "mean_queue_wait"):
        assert getattr(got, key) == getattr(want, key), key


def test_steady_scenario_golden():
    r = T.build(T.get_scenario("steady")).run().result
    assert r.sla_attainment == 0.9983333333333333
    assert r.mean_accuracy == 0.7975266666666666
    assert r.mean_latency == 191.67831081440173
    assert r.mean_queue_wait == 23.493148434870164
    eng = ServingSimulator(TABLE2, NetworkModel(50.0, 25.0),
                           per_model_replicas(TABLE2), seed=3,
                           queue_aware=True)
    assert r == eng.run(ModiPick(t_threshold=20.0), 250.0, 600,
                        arrivals=PoissonArrivals(30.0))


def test_closed_loop_scenario_golden():
    sc = Scenario(
        name="paper_loop",
        workload=WorkloadSpec(arrival="closed_loop", n_requests=800,
                              t_sla_ms=200.0),
        network=NetworkSpec(50.0, 25.0),
        deployment=DeploymentSpec(topology="shared", replicas=1),
        policy=PolicySpec(policy="modipick", kwargs={"t_threshold": 20.0}),
        seed=1)
    r = Simulator.from_scenario(sc).run(ModiPick(t_threshold=20.0), 200.0,
                                        800)
    assert r.sla_attainment == 0.9775
    assert r.mean_accuracy == 0.7813437499999999
    h = T.build(sc).run().result
    assert h.sla_attainment == 0.9775
    assert h.mean_accuracy == 0.7813437499999999


@pytest.mark.parametrize("path", ["examples/drift.toml",
                                  "examples/elastic.toml"])
def test_example_files_load_to_the_reference_scenario(path):
    got = T.Scenario.from_file(REPO / path)
    want = J.Scenario.from_file(REPO / path)
    assert got.to_dict() == want.to_dict()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_backend_jax_refused_and_port_backends_accepted():
    with pytest.raises(ValueError, match="auto, numpy, cuda, cpu"):
        PolicySpec(backend="jax")
    for backend in (None, "auto", "numpy", "cuda", "cpu"):
        assert PolicySpec(backend=backend).backend == backend
    sc = dataclasses.replace(T.get_scenario("steady"),
                             policy=PolicySpec(queue_aware=True,
                                               backend="cpu"))
    assert T.build(sc).engine().backend == "cpu"


def test_engine_and_closed_loop_adapters():
    sc = T.get_scenario("steady")
    eng = ServingSimulator.from_scenario(sc)
    assert isinstance(eng, ServingSimulator)
    assert eng.seed == 3 and eng.queue_aware
    assert len(eng.pool.replicas) == len(TABLE2)
    assert len(ServingSimulator.from_scenario(sc, n_replicas=2)
               .pool.replicas) == 2 * len(TABLE2)
    with pytest.raises(ValueError, match="closed loop"):
        Simulator.from_scenario(sc)


@dataclass
class _FakeVariant:
    name: str
    quality: float
    latency_fn: Callable[[], float]

    def run(self, tokens, n_decode=2) -> float:
        return float(self.latency_fn())


def test_executor_from_scenario_matches_reference():
    """``PoolExecutor.from_scenario`` on both sides over the same fake
    pool and latency stream: the same admission, choices and results."""
    def run(scenario_mod, executor_cls):
        sc = scenario_mod.Scenario(
            name="exec",
            workload=scenario_mod.WorkloadSpec(arrival="poisson",
                                               rate_rps=5.0, n_requests=10,
                                               t_sla_ms=200.0),
            network=scenario_mod.NetworkSpec(15.0, 0.0),
            deployment=scenario_mod.DeploymentSpec(admission="sla_aware"),
            policy=scenario_mod.PolicySpec(policy="modipick",
                                           queue_aware=True),
            seed=1)
        rng = np.random.default_rng(0)
        pool = [_FakeVariant("small", 0.5, lambda: rng.normal(10, 1)),
                _FakeVariant("large", 0.9, lambda: rng.normal(80, 4))]
        ex = executor_cls.from_scenario(sc, pool)
        ex.warm_up(np.zeros((1, 4), np.int32))
        return ex, [dataclasses.asdict(ex.execute(np.zeros((1, 4), np.int32),
                                                  t_sla=200.0))
                    for _ in range(12)]

    ex, got = run(T, PoolExecutor)
    _, want = run(J, JExecutor)
    assert isinstance(ex.router.admission, SlaAwareAdmission)
    assert ex.queue_aware and ex.seed == 1
    assert got == want
    assert {r["variant"] for r in got} <= {"small", "large"}
