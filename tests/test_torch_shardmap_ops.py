"""The port's sharded kernel wrappers (``repro_torch.distributed.
shardmap_ops``) on a (2, 4) data × model mesh of eight CPU devices
against the reference's ``shard_map`` wrappers on 8 fake XLA devices
(a subprocess, so that this process's JAX keeps one device), on the
same seeded inputs, with ``tests/test_shardmap_ops.py``'s shapes and
tolerances (heads that do not divide the model axis included), and
against the port's unsharded call.  Then the fleet's ``mesh=`` on a
four-cell ``cell`` mesh: ``select_fleet``, ``FleetFrontend.plan`` and a
``FleetEngine`` run against the reference's on a four-device cell mesh
and against the port's unsharded calls, bit for bit (the port on the
reference's per-cell draws).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fleet as TF
import repro_torch.scenario as T
from repro_torch.distributed import shardmap_ops as S
from repro_torch.kernels import ops, policy_select
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, tolerance) of each case; the inputs are made below from a seed
TOLS = {"flash": 2e-5, "decode": 2e-5, "ssd": 2e-4, "rglru": 1e-5,
        "fallback": 2e-5}
FLEET = dict(n_cells=4, rate_rps=300.0, n_requests=3000, rtt_ms=20.0,
             subset=("DenseNet", "InceptionV3", "NasNet-Large"),
             trace_path="examples/azure_functions_day.csv",
             rotate_phases=True, spill_threshold_ms=30.0, epoch_ms=4000.0,
             name="t_mesh")
SUBSETS = ((), ("MobileNetV1-0.25", "SqueezeNet", "DenseNet"),
           ("DenseNet", "NasNet-Mobile", "InceptionV3", "InceptionV4"),
           ("SqueezeNet", "InceptionV3"))

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed import shardmap_ops as S
import repro.fleet as JF
import repro.scenario as J

out = sys.argv[1]
x = dict(np.load(out + "/inputs.npz"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
res = {}
res["flash"] = S.sharded_flash_attention(x["q"], x["k"], x["v"], mesh,
                                         causal=True)
res["decode"] = S.sharded_decode_attention(x["qd"], x["k"], x["v"],
                                           x["pos"], mesh)
res["ssd"] = S.sharded_ssd_scan(x["x"], x["dt"], x["A"], x["Bm"], x["Cm"],
                                mesh, chunk=64)
res["rglru"] = S.sharded_rglru_scan(x["a"], x["b"], mesh, block_s=64)
res["fallback"] = S.sharded_flash_attention(x["q3"], x["k3"], x["k3"], mesh,
                                            causal=True)
cells = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("cell",))
kw = json.loads(sys.argv[2])
subsets = json.loads(sys.argv[3])
sc = J.fleet_scenario(**kw)
views = [JF.cell_view(sc, c) for c in sc.deployment.fleet.cells]
views = [dataclasses.replace(v, deployment=dataclasses.replace(
    v.deployment, subset=tuple(s))) for v, s in zip(views, subsets)]
stacked = JF.stack_cell_tables([J.build(v).store().table() for v in views])
for B in (97, 300):
    t = np.load(out + f"/budget{B}.npy")
    res[f"picks{B}"] = JF.select_fleet(stacked, t[0], t[1], seed=5,
                                       mesh=cells)
    res[f"picks{B}_plain"] = JF.select_fleet(stacked, t[0], t[1], seed=5)
plan = JF.FleetFrontend(sc).plan(np.arange(1000, 1900),
                                 np.array([10.0, 5.0, 1.0, 60.0]), stacked,
                                 cap_req=np.array([150.0, 600.0, 600.0,
                                                   90.0]),
                                 seed=4, mesh=cells)
for col in ("home", "assigned", "rtt_extra_ms", "picks"):
    res["plan_" + col] = getattr(plan, col)
run = JF.FleetEngine(sc, mesh=cells).run()
epochs = [dict(epoch=e.epoch, result=dataclasses.asdict(e.result),
               router_stats=e.router_stats, n_assigned=e.n_assigned.tolist(),
               load_ms=e.load_ms.tolist(), n_spilled=e.n_spilled)
          for e in run.epochs]
summary = {k: getattr(run, k) for k in (
    "sla_attainment", "mean_accuracy", "mean_latency", "mean_queue_wait",
    "n_spilled", "spill_rate", "locality", "n_arrived", "n_completed")}
with open(out + "/engine.json", "w") as f:
    json.dump({"epochs": epochs, "summary": summary}, f)
np.savez(out + "/reference.npz", **{k: np.asarray(v) for k, v in res.items()})
print("reference ok")
"""


def _inputs():
    """tests/test_shardmap_ops.py's shapes, from a seeded numpy stream."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    B, H, KV, Sq, hd, G = 2, 4, 4, 256, 64, 2
    N, P_ = 32, 16
    x = {"q": rng.normal(size=(B, H, Sq, hd)).astype(f32),
         "k": rng.normal(size=(B, KV, Sq, hd)).astype(f32),
         "v": rng.normal(size=(B, KV, Sq, hd)).astype(f32),
         "qd": rng.normal(size=(B, KV, G, hd)).astype(f32),
         "pos": np.array([100, 33], np.int32),
         "x": (rng.normal(size=(B, 4, 128, P_)) * 0.5).astype(f32),
         "dt": np.log1p(np.exp(rng.normal(size=(B, 4, 128)))).astype(f32),
         "A": -np.exp(rng.normal(size=4) * 0.3).astype(f32),
         "Bm": (rng.normal(size=(B, 4, 128, N)) * 0.3).astype(f32),
         "Cm": (rng.normal(size=(B, 4, 128, N)) * 0.3).astype(f32),
         "a": (1 / (1 + np.exp(-rng.normal(size=(B, 128, 128))))).astype(f32),
         "b": (rng.normal(size=(B, 128, 128)) * 0.1).astype(f32),
         "q3": rng.normal(size=(B, 3, Sq, hd)).astype(f32),
         "k3": rng.normal(size=(B, 3, Sq, hd)).astype(f32)}
    return x


def _budgets(B):
    rng = np.random.default_rng(B)
    t_u = rng.uniform(2.0, 250.0, size=(4, B))
    t_l = t_u - 20.0
    t_l[:, :B // 10] += 45.0                    # degenerate rows
    return np.stack([t_u, t_l])


def _reference_cell_uniforms(seed, C, n, device):
    """The reference's per-cell draws: ``jax.random.uniform`` on
    ``fold_in(PRNGKey(seed), c)`` for each cell c."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(C, dtype=jnp.uint32))
    r = jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=jnp.float32))(
        keys)
    return torch.from_numpy(np.array(r)).to(device)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("shardmap")
    np.savez(out / "inputs.npz", **_inputs())
    for B in (97, 300):
        np.save(out / f"budget{B}.npy", _budgets(B))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out), json.dumps(FLEET),
         json.dumps(SUBSETS)], env=env, capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(out / "engine.json") as f:
        engine = json.load(f)
    return dict(np.load(out / "reference.npz")), engine


@pytest.fixture
def cpu_mesh():
    return make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)


def _port(name, x, mesh):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    if name == "flash":
        return S.sharded_flash_attention(t["q"], t["k"], t["v"], mesh,
                                         causal=True), \
            ops.flash_attention(t["q"], t["k"], t["v"], causal=True)
    if name == "decode":
        return S.sharded_decode_attention(t["qd"], t["k"], t["v"], t["pos"],
                                          mesh), \
            ops.decode_attention(t["qd"], t["k"], t["v"], t["pos"])
    if name == "ssd":
        args = (t["x"], t["dt"], t["A"], t["Bm"], t["Cm"])
        return S.sharded_ssd_scan(*args, mesh, chunk=64), \
            ops.ssd_scan(*args, chunk=64)
    if name == "rglru":
        return S.sharded_rglru_scan(t["a"], t["b"], mesh, block_s=64), \
            ops.rglru_scan(t["a"], t["b"])
    return S.sharded_flash_attention(t["q3"], t["k3"], t["k3"], mesh,
                                     causal=True), \
        ops.flash_attention(t["q3"], t["k3"], t["k3"], causal=True)


@pytest.mark.parametrize("name", list(TOLS))
def test_sharded_wrapper_matches_reference(reference, cpu_mesh, name):
    want = reference[0][name]
    got, plain = _port(name, _inputs(), cpu_mesh)
    if name == "ssd":  # the port's ssd_scan also returns the final state
        (got, got_state), (plain, plain_state) = got, plain
        torch.testing.assert_close(got_state, plain_state, rtol=TOLS[name],
                                   atol=TOLS[name])
    tol = TOLS[name]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)


def test_specs_and_blocks(cpu_mesh):
    """Heads shard over 'model' only when H and KV divide it; a spec that
    does not divide a dimension is refused; an abstract mesh has no
    devices to run on; the (1, 1) mesh is one direct call."""
    assert S._head_axis(cpu_mesh, 4, 4) == "model"
    assert S._head_axis(cpu_mesh, 12, 2) is None
    assert S._data_axes(cpu_mesh) == ("data",)
    x = torch.arange(24.0).view(4, 6)
    seen = []

    def fn(b):
        seen.append(tuple(b.shape))
        return b * 2

    out = S.shard_blocks(fn, cpu_mesh, (S.P("data", None),),
                         S.P("data", None), x)
    torch.testing.assert_close(out, x * 2, rtol=0, atol=0)
    assert len(seen) == 8 and set(seen) == {(2, 6)}   # every device runs
    seen.clear()
    out = S.shard_blocks(fn, cpu_mesh, (S.P(None, ("data", "model")),),
                         S.P(None, ("data", "model")),
                         torch.arange(32.0).view(4, 8))
    torch.testing.assert_close(out, torch.arange(32.0).view(4, 8) * 2,
                               rtol=0, atol=0)
    assert set(seen) == {(4, 1)}
    with pytest.raises(ValueError, match="does not divide"):
        S.shard_blocks(fn, cpu_mesh, (S.P("data", "model"),),
                       S.P("data", "model"), x)
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="abstract"):
        S.shard_blocks(fn, make_production_mesh(), (S.P(None, None),),
                       S.P(None, None), x)
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    seen.clear()
    torch.testing.assert_close(
        S.shard_blocks(fn, one, (S.P("data", "model"),),
                       S.P("data", "model"), x), x * 2, rtol=0, atol=0)
    assert seen == [(4, 6)]


# ----------------------------------------------------------------------
# the fleet's mesh=
# ----------------------------------------------------------------------
@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(policy_select, "cell_uniforms",
                        _reference_cell_uniforms)


@pytest.fixture
def cell_mesh():
    return make_mesh((4,), ("cell",), ["cpu"] * 4)


def _stacked():
    sc = T.fleet_scenario(**FLEET)
    views = [TF.cell_view(sc, c) for c in sc.deployment.fleet.cells]
    views = [dataclasses.replace(v, deployment=dataclasses.replace(
        v.deployment, subset=s)) for v, s in zip(views, SUBSETS)]
    return TF.stack_cell_tables([T.build(v).store().table() for v in views],
                                device="cpu")


@pytest.mark.parametrize("B", [97, 300])
def test_select_fleet_on_a_cell_mesh(reference, reference_draws, cell_mesh,
                                     B):
    stacked = _stacked()
    t_u, t_l = _budgets(B)
    got = TF.select_fleet(stacked, t_u, t_l, seed=5, mesh=cell_mesh)
    plain = TF.select_fleet(stacked, t_u, t_l, seed=5)
    np.testing.assert_array_equal(got, reference[0][f"picks{B}"])
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(plain, reference[0][f"picks{B}_plain"])
    assert (got == -1).any() and (got >= 0).any()
    # three cells do not divide the axis: the single launch
    three = make_mesh((3,), ("cell",), ["cpu"] * 3)
    before = policy_select.stacked_select.launches
    np.testing.assert_array_equal(
        TF.select_fleet(stacked, t_u, t_l, seed=5, mesh=three), plain)
    assert policy_select.stacked_select.launches == before


def test_plan_on_a_cell_mesh(reference, reference_draws, cell_mesh):
    front = TF.FleetFrontend(T.fleet_scenario(**FLEET))
    args = (np.arange(1000, 1900), np.array([10.0, 5.0, 1.0, 60.0]),
            _stacked())
    kw = dict(cap_req=np.array([150.0, 600.0, 600.0, 90.0]), seed=4)
    got = front.plan(*args, **kw, mesh=cell_mesh)
    plain = front.plan(*args, **kw)
    for col in ("home", "assigned", "rtt_extra_ms", "picks"):
        np.testing.assert_array_equal(getattr(got, col),
                                      reference[0]["plan_" + col],
                                      err_msg=col)
        np.testing.assert_array_equal(getattr(got, col), getattr(plain, col),
                                      err_msg=col)
    assert got.n_spilled > 0


def test_fleet_engine_on_a_cell_mesh(reference, reference_draws, cell_mesh):
    sc = T.fleet_scenario(**FLEET)
    got = TF.FleetEngine(sc, mesh=cell_mesh).run()
    plain = TF.FleetEngine(sc).run()
    want = reference[1]
    assert len(got.epochs) == len(want["epochs"]) == len(plain.epochs) > 1
    for g, p, w in zip(got.epochs, plain.epochs, want["epochs"]):
        for other in (p,):
            assert dataclasses.asdict(g.result) == dataclasses.asdict(
                other.result)
            np.testing.assert_array_equal(g.n_assigned, other.n_assigned)
            assert g.n_spilled == other.n_spilled
        assert g.epoch == w["epoch"]
        assert json.loads(json.dumps(dataclasses.asdict(g.result))) == \
            w["result"]
        assert json.loads(json.dumps(g.router_stats)) == w["router_stats"]
        assert g.n_assigned.tolist() == w["n_assigned"]
        assert g.load_ms.tolist() == w["load_ms"]
        assert g.n_spilled == w["n_spilled"]
    for key, value in want["summary"].items():
        assert getattr(got, key) == value == getattr(plain, key), key
    assert got.n_spilled > 0
