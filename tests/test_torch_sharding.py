"""The port's mesh tooling against the reference's
(``repro.distributed``, ``repro.launch.mesh``, ``repro.models``'s
templates):

- ``logical_to_spec`` on the cases of ``tests/test_sharding.py`` and a
  seeded sweep over rules, dims and mesh sizes, each spec equal to the
  reference's (as a JAX ``PartitionSpec``, which tells a one-axis tuple
  from a string);
- ``make_rules`` for every arch × applicable shape × mesh (the
  single-pod and multi-pod production meshes, 2x4 and 1x1), dict for
  dict;
- every parameter and cache leaf's logical axes, segment by segment for
  the port's fused leaves, against ``axes_tree(param_template(cfg))`` /
  ``cache_template`` (the port's layers are unstacked, so the
  reference's leading ``layers`` axis is dropped), and each segment's
  spec under the rules of a train and a decode cell;
- ``with_padded_heads``; the meshes;
- ``quantize_int8``, ``dequantize_int8`` and ``ef_compress`` bit for
  bit, and ``compressed_psum`` / ``ef_compressed_psum_tree`` over a
  group of one and over two gloo processes on the CPU, against the
  reference's ``shard_map`` over 1 and 2 fake devices (a subprocess);
- ``collective_bytes`` on ``HLO_SAMPLE``, ``wire_bytes``, the
  ``Roofline`` terms with the H100's constants, and ``model_flops_for``
  for every cell.

Tolerances: none — every value is compared exactly.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import compression as jcomp
from repro.distributed import hlo as jhlo
from repro.distributed import policy as jpol
from repro.distributed import sharding as jsh
from repro.models import model as JM
from repro.models.layers import is_spec
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import hlo as thlo
from repro_torch.distributed import policy as tpol
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import templates
from repro_torch.models.convert import named_leaves
from repro_torch.models.model import layer_kinds
from test_sharding import HLO_SAMPLE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "1x1": {"data": 1, "model": 1}}


def _port_mesh(name):
    if name == "single":
        return tmesh.make_production_mesh()
    if name == "multi":
        return tmesh.make_production_mesh(multi_pod=True)
    shape = MESHES[name]
    return tmesh.Mesh(tuple(shape.values()), tuple(shape))


def _same(port_spec, ref_spec):
    assert isinstance(port_spec, tsh.PartitionSpec)
    assert JP(*port_spec) == ref_spec, (port_spec, ref_spec)


# ----------------------------------------------------------------------
# logical_to_spec
# ----------------------------------------------------------------------
CASES = [
    (("embed_fsdp", "ff"), {"embed_fsdp": ("data",), "ff": "model"},
     (2560, 7680), {"data": 16, "model": 16}),
    (("batch", "seq", "heads", None),
     {"batch": ("data",), "heads": "model", "seq": None},
     (32, 128, 10, 256), {"data": 16, "model": 16}),
    (("batch", "cache_seq"), {"batch": ("data",), "cache_seq": "data"},
     (16, 64), {"data": 4, "model": 4}),
]


@pytest.mark.parametrize("axes,rules,shape,mesh", CASES)
def test_logical_to_spec_cases_match_reference(axes, rules, shape, mesh):
    got = tsh.logical_to_spec(axes, rules, shape=shape, mesh=FakeMesh(mesh))
    _same(got, jsh.logical_to_spec(axes, rules, shape=shape,
                                   mesh=FakeMesh(mesh)))
    # without a mesh there is no divisibility drop
    _same(tsh.logical_to_spec(axes, rules),
          jsh.logical_to_spec(axes, rules))


RULE_CHOICES = [None, "x", "y", ("x",), ("y",), ("x", "y"), ("y", "x")]


@given(st.integers(1, 64), st.integers(1, 64), st.integers(1, 6),
       st.integers(1, 6), st.integers(0, 6), st.integers(0, 6),
       st.integers(0, 6))
@settings(max_examples=200, deadline=None)
def test_logical_to_spec_sweep_matches_reference(d0, d1, nx, ny, ra, rb, rc):
    rules = {"a": RULE_CHOICES[ra], "b": RULE_CHOICES[rb],
             "c": RULE_CHOICES[rc]}
    mesh = {"x": nx, "y": ny}
    for axes in (("a", "b"), ("c", "a"), ("b", None), ("a", "a")):
        got = tsh.logical_to_spec(axes, rules, shape=(d0, d1),
                                  mesh=FakeMesh(mesh))
        _same(got, jsh.logical_to_spec(axes, rules, shape=(d0, d1),
                                       mesh=FakeMesh(mesh)))
        for d, entry in zip((d0, d1), got):
            n = 1
            for ax in tsh.spec_axes(entry):
                n *= mesh[ax]
            assert d % n == 0


def test_rules_context_and_shard():
    x = torch.zeros(4, 6)
    assert tsh.shard(x, "batch", None) is x
    mesh = FakeMesh({"data": 2, "model": 4})
    with tsh.axis_rules({"batch": "data", "ff": "model"}, mesh):
        assert tsh.current_mesh() is mesh
        assert tsh.logical_to_spec(("batch", "ff"), shape=(4, 6)) == \
            tsh.P("data", None)
        assert tsh.shard(x, "batch", "ff") is x
        with pytest.raises(ValueError):
            tsh.shard(x, "batch")
    assert tsh.current_rules() is None and tsh.current_mesh() is None


def test_tree_specs_and_shardings():
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = {"batch": ("data",), "ff": "model"}
    axes = {"w": ("batch", "ff"), "layers": [("ff",), (None,)]}
    shapes = {"w": torch.empty(4, 8), "layers": [torch.empty(6),
                                                  torch.empty(3)]}
    specs = tsh.tree_specs(axes, rules, mesh, shapes)
    assert specs == {"w": tsh.P(("data",), "model"),
                     "layers": [tsh.P(None), tsh.P(None)]}
    sh = tsh.tree_shardings(axes, rules, mesh, shapes)
    assert sh["w"] == tsh.NamedSharding(mesh, tsh.P(("data",), "model"))


# ----------------------------------------------------------------------
# make_rules
# ----------------------------------------------------------------------
RULE_CELLS = [(a, s.name, m) for a in jreg.ARCH_IDS
              for s in jreg.applicable_shapes(jreg.get_config(a))
              for m in MESHES]


@pytest.mark.parametrize("arch,shape,mesh", RULE_CELLS)
def test_make_rules_matches_reference(arch, shape, mesh):
    got = tpol.make_rules(treg.get_config(arch), TSHAPES[shape],
                          _port_mesh(mesh))
    want = jpol.make_rules(jreg.get_config(arch), JSHAPES[shape],
                           FakeMesh(MESHES[mesh]))
    assert got == want
    assert tpol.train_grad_accum(arch, TSHAPES[shape].global_batch,
                                 _port_mesh(mesh)) == \
        jpol.train_grad_accum(arch, JSHAPES[shape].global_batch,
                              FakeMesh(MESHES[mesh]))


def test_policy_constants_match_reference():
    assert tpol.SERVE_WEIGHT_SHARD_THRESHOLD == \
        jpol.SERVE_WEIGHT_SHARD_THRESHOLD
    assert tpol.TRAIN_GRAD_ACCUM == jpol.TRAIN_GRAD_ACCUM
    assert tpol.TRAIN_OPT_MOMENTS == jpol.TRAIN_OPT_MOMENTS


# ----------------------------------------------------------------------
# Logical axes of the parameters and caches
# ----------------------------------------------------------------------
def _ref_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if is_spec(v):
            out[path] = v
        else:
            out.update(_ref_leaves(v, path))
    return out


_ATTN_FUSED = {"wqkv": ("wq", "wk", "wv"), "bqkv": ("bq", "bk", "bv"),
               "wkv": ("wk", "wv"), "bkv": ("bk", "bv")}
_FUSED = {"ssd/w_in": ("in_z", "in_x", "in_B", "in_C", "in_dt"),
          "ssd/conv_w": ("conv_x_w", "conv_B_w", "conv_C_w"),
          "ssd/conv_b": ("conv_x_b", "conv_B_b", "conv_C_b"),
          "rglru/w_in": ("in_x", "in_gate"),
          "rglru/w_gates": ("w_inp", "w_rec"),
          "rglru/b_gates": ("b_inp", "b_rec"),
          "ssd_cache/conv": ("x", "B", "C")}


def _ref_names(inner: str):
    """The reference's leaf names inside a block for the port's leaf
    ``inner``: the fused leaves' parts, each norm's ``scale``, the
    self-attention under ``attn``."""
    head, _, last = inner.rpartition("/")
    if inner in _FUSED:
        return [f"{head}/{n}" for n in _FUSED[inner]]
    if last in _ATTN_FUSED and head in ("", "xattn"):
        return [f"{head or 'attn'}/{n}" for n in _ATTN_FUSED[last]]
    if inner in ("norm1", "norm2", "norm_x"):
        return [f"{inner}/scale"]
    if inner == "wo":
        return ["attn/wo"]
    return [inner]


def _pairs(cfg, port_tree, ref_tree, cache=False):
    """(port path, segment, its shape, its axes, reference path, the
    reference leaf, stacked) for every segment of every port leaf."""
    ref = _ref_leaves(ref_tree)
    pat = len(cfg.pattern)
    n_stacked = cfg.n_superblocks * pat
    out = []
    for path, leaf in named_leaves(port_tree):
        parts = path.split("/")
        if cache:
            i, inner = int(parts[0]), "/".join(parts[1:])
            kind = layer_kinds(cfg)[i]
            stacked = i < n_stacked
            block = (f"blocks/p{i % pat}" if stacked
                     else f"tail/t{i - n_stacked}")
            names = (list(_FUSED["ssd_cache/conv"]) if kind == "ssd"
                     and inner == "conv" else [inner])
        elif parts[0] == "layers":
            i, inner = int(parts[1]), "/".join(parts[2:])
            stacked = i < n_stacked
            block = (f"blocks/p{i % pat}" if stacked
                     else f"tail/t{i - n_stacked}")
            names = _ref_names(inner)
        elif parts[:2] == ["encoder", "layers"]:
            stacked, block = True, "encoder/blocks"
            names = _ref_names("/".join(parts[3:]))
        else:
            stacked, block = False, ""
            names = {"embed": ["embed/table"],
                     "final_norm": ["final_norm/scale"],
                     "lm_head": ["lm_head"],
                     "encoder/final_norm": ["encoder/final_norm/scale"]}[path]
        assert len(names) == len(leaf.segments), (path, names)
        for j, ((shape, axes), name) in enumerate(zip(leaf.segment_shapes(),
                                                      names)):
            rpath = f"{block}/{name}".strip("/")
            out.append((path, j, shape, axes, rpath, ref[rpath], stacked))
    return out, set(ref)


def _check_axes(cfg, pairs, ref_paths, rules_cells):
    seen = set()
    for path, j, shape, axes, rpath, rleaf, stacked in pairs:
        rshape, raxes = rleaf.shape, rleaf.axes
        if stacked:
            assert raxes[0] == "layers", rpath
            rshape, raxes = rshape[1:], raxes[1:]
        assert (tuple(shape), tuple(axes)) == (tuple(rshape), tuple(raxes)), \
            (path, j, rpath)
        for rules, mesh in rules_cells:
            got = tsh.logical_to_spec(axes, rules, shape=shape, mesh=mesh)
            want = jsh.logical_to_spec(rleaf.axes, rules, shape=rleaf.shape,
                                       mesh=mesh)
            _same(got, JP(*tuple(want)[1:]) if stacked else want)
        seen.add(rpath)
    # stacked reference leaves are covered by every layer of their slot
    assert seen == ref_paths


def _rules_cells(cfg, modes):
    cells = []
    for shape in jreg.applicable_shapes(jreg.get_config(cfg.name)):
        if shape.mode in modes:
            for m in ("single", "2x4"):
                mesh = FakeMesh(MESHES[m])
                cells.append((jpol.make_rules(jreg.get_config(cfg.name),
                                              shape, mesh), mesh))
    return cells


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_axes_match_reference(arch):
    cfg = treg.get_config(arch)
    pairs, ref_paths = _pairs(cfg, templates.param_template(cfg),
                              JM.param_template(jreg.get_config(arch)))
    _check_axes(cfg, pairs, ref_paths, _rules_cells(cfg, ("train",
                                                          "prefill")))


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cache_axes_match_reference(arch, kv):
    import dataclasses
    cfg = dataclasses.replace(treg.get_config(arch), kv_cache_dtype=kv)
    jcfg = dataclasses.replace(jreg.get_config(arch), kv_cache_dtype=kv)
    B, C = 8, 1024
    pairs, ref_paths = _pairs(cfg, templates.cache_template(cfg, B, C),
                              JM.cache_template(jcfg, B, C), cache=True)
    _check_axes(cfg, pairs, ref_paths, _rules_cells(cfg, ("decode",)))
    # int8 leaves keep the reference's dtypes
    ref = _ref_leaves(JM.cache_template(jcfg, B, C))
    for path, _, _, _, rpath, rleaf, _ in pairs:
        if rleaf.dtype:
            leaf = dict(named_leaves(templates.cache_template(cfg, B, C)))[
                path]
            assert str(leaf.dtype).split(".")[-1] == rleaf.dtype


def test_templates_are_the_init_shapes():
    for arch in treg.ARCH_IDS:
        cfg = treg.get_config(arch).reduced()
        from repro_torch.models import model as M
        p = M.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, device="cpu")
        t = templates.param_template(cfg, torch.float32)
        assert [(k, tuple(x.shape), x.dtype) for k, x in named_leaves(p)] \
            == [(k, s.shape, s.dtype) for k, s in named_leaves(t)]
        meta = templates.empty(t)
        assert [(k, tuple(x.shape), x.device.type)
                for k, x in named_leaves(meta)] == \
            [(k, s.shape, "meta") for k, s in named_leaves(t)]
        c = M.init_cache(cfg, 2, 40, device="cpu")
        ct = templates.cache_template(cfg, 2, 40)
        assert [(k, tuple(x.shape), x.dtype) for k, x in named_leaves(c)] \
            == [(k, s.shape, s.dtype) for k, s in named_leaves(ct)]


# ----------------------------------------------------------------------
# Configs and meshes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("multiple", [8, 16, 32])
def test_with_padded_heads_matches_reference(multiple):
    for arch in jreg.ARCH_IDS:
        got = treg.get_config(arch).with_padded_heads(multiple)
        want = jreg.get_config(arch).with_padded_heads(multiple)
        assert (got.name, got.n_heads, got.n_kv_heads, got.head_dim,
                got.resolved_head_dim, got.param_count()) == \
            (want.name, want.n_heads, want.n_kv_heads, want.head_dim,
             want.resolved_head_dim, want.param_count())


def test_meshes():
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert prod.devices is None and "abstract" in repr(prod)
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert tmesh.data_axes(multi) == ("pod", "data")
    assert tmesh.mesh_axis(prod, "pod") == 1
    m = tmesh.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert m.size == 8 and m.devices == (torch.device("cpu"),) * 8
    assert "8 fake devices on 1" in repr(m)
    assert m.coords()[:5] == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0)]
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 4), ("data", "model"), ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh((1, 1), ("data", "model"))


# ----------------------------------------------------------------------
# Compression
# ----------------------------------------------------------------------
def _inputs(seed, n=257):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[:8] = [0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 3.0, -3.0]  # rounding ties
    return x * np.float32(10 ** rng.uniform(-3, 2))


@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_bits_match_reference(seed):
    x = _inputs(seed)
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = tcomp.dequantize_int8(q, s).numpy()
    assert back.tobytes() == np.asarray(jcomp.dequantize_int8(jq, js)).tobytes()


def test_ef_compress_bits_match_reference():
    rng = np.random.default_rng(1)
    err_t, err_j = torch.zeros(64), jnp.zeros(64)
    for _ in range(50):
        g = (rng.normal(size=64) * 1e-3).astype(np.float32)
        q, s, err_t = tcomp.ef_compress(torch.from_numpy(g), err_t)
        jq, js, err_j = jcomp.ef_compress(jnp.asarray(g), err_j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        assert err_t.numpy().tobytes() == np.asarray(err_j).tobytes()


def test_compressed_psum_group_of_one_matches_reference():
    x = _inputs(3, 64)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    f = jax.shard_map(lambda v: jcomp.compressed_psum(v[0], "d")[None],
                      mesh=mesh, in_specs=JP("d", None),
                      out_specs=JP("d", None))
    want = np.asarray(f(jnp.asarray(x)[None]))[0]
    got = tcomp.compressed_psum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
    grads = {"a": torch.from_numpy(x), "b": [torch.from_numpy(x[:7])]}
    errs = {"a": torch.zeros(64), "b": [torch.zeros(7)]}
    red, new = tcomp.ef_compressed_psum_tree(grads, errs)
    q, s, e = tcomp.ef_compress(grads["b"][0], errs["b"][0])
    assert red["b"][0].numpy().tobytes() == \
        tcomp.dequantize_int8(q, s).numpy().tobytes()
    assert new["b"][0].numpy().tobytes() == e.numpy().tobytes()


_REF_PSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed import compression as comp
x, g, e = (np.load(sys.argv[1] + f"/{n}.npy") for n in ("x", "g", "e"))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
f = shard_map(lambda v: comp.compressed_psum(v[0], "d")[None], mesh=mesh,
              in_specs=P("d", None), out_specs=P("d", None))
np.save(sys.argv[1] + "/psum.npy", np.asarray(f(jnp.asarray(x))))
def tree(gv, ev):
    red, new = comp.ef_compressed_psum_tree({"w": gv[0]}, {"w": ev[0]}, "d")
    return red["w"][None], new["w"][None]
f = shard_map(tree, mesh=mesh, in_specs=(P("d", None), P("d", None)),
              out_specs=(P("d", None), P("d", None)))
red, new = f(jnp.asarray(g), jnp.asarray(e))
np.save(sys.argv[1] + "/red.npy", np.asarray(red))
np.save(sys.argv[1] + "/new.npy", np.asarray(new))
"""

_PORT_RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import compression as comp
out, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
x, g, e = (np.load(out + f"/{n}.npy")[rank] for n in ("x", "g", "e"))
np.save(out + f"/psum{rank}.npy",
        comp.compressed_psum(torch.from_numpy(x), dist.group.WORLD).numpy())
red, new = comp.ef_compressed_psum_tree({"w": torch.from_numpy(g)},
                                        {"w": torch.from_numpy(e)},
                                        dist.group.WORLD)
np.save(out + f"/red{rank}.npy", red["w"].numpy())
np.save(out + f"/new{rank}.npy", new["w"].numpy())
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_over_two_processes_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    np.save(tmp_path / "x.npy", rng.normal(size=(2, 96)).astype(np.float32))
    np.save(tmp_path / "g.npy",
            (rng.normal(size=(2, 96)) * 1e-3).astype(np.float32))
    np.save(tmp_path / "e.npy",
            (rng.normal(size=(2, 96)) * 1e-6).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", _REF_PSUM, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert ref.returncode == 0, ref.stderr[-2000:]
    port = str(_free_port())
    ranks = [subprocess.Popen([sys.executable, "-c", _PORT_RANK,
                               str(tmp_path), str(r), port], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(2)]
    for p in ranks:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    for name in ("psum", "red", "new"):
        want = np.load(tmp_path / f"{name}.npy")
        for r in range(2):
            got = np.load(tmp_path / f"{name}{r}.npy")
            assert got.tobytes() == want[r].tobytes(), (name, r)


# ----------------------------------------------------------------------
# HLO text, the roofline, model FLOPs
# ----------------------------------------------------------------------
def test_collective_bytes_matches_reference():
    got, want = thlo.collective_bytes(HLO_SAMPLE), jhlo.collective_bytes(
        HLO_SAMPLE)
    assert got.by_kind_count == want.by_kind_count
    assert got.by_kind == want.by_kind
    assert got.total_bytes == want.total_bytes


def test_wire_bytes():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert thlo.wire_bytes(kind, 1024.0, 1) == 0.0
    assert thlo.wire_bytes("all-reduce", 1024.0, 4) == 2 * 1024 * 3 / 4
    assert thlo.wire_bytes("reduce-scatter", 8.0, 8) == 56.0
    with pytest.raises(ValueError):
        thlo.wire_bytes("broadcast", 1.0, 2)


def test_roofline_terms_h100():
    assert (thlo.PEAK_FLOPS_BF16, thlo.HBM_BW, thlo.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    args = dict(n_chips=256, hlo_flops=1e18, hlo_bytes=1e15,
                coll_bytes_per_chip=1e9, model_flops=6e17)
    r = thlo.Roofline(**args)
    assert r.compute_s == 1e18 / (256 * 989e12)
    assert r.memory_s == 1e15 / (256 * 3.35e12)
    assert r.collective_s == 1e9 / 450e9
    assert r.dominant == "compute"
    assert r.mfu == 6e17 / (r.step_s * 256 * 989e12)
    assert 0 < r.mfu <= 1.0
    # the reference's formulas, its constants swapped for the H100's
    j = jhlo.Roofline(**args)
    scale = {"compute_s": jhlo.PEAK_FLOPS_BF16 / thlo.PEAK_FLOPS_BF16,
             "memory_s": jhlo.HBM_BW / thlo.HBM_BW,
             "collective_s": jhlo.ICI_BW / thlo.NVLINK_BW}
    for key, f in scale.items():
        assert getattr(r, key) == pytest.approx(getattr(j, key) * f,
                                                rel=1e-15)
    d = r.to_dict()
    assert set(d) == set(j.to_dict())
    none = thlo.Roofline(1, 1e12, 1e15, None, 1e12)
    assert none.collective_s is None and none.dominant == "memory"
    assert none.to_dict()["collective_s"] is None


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_model_flops_match_reference(arch):
    for shape in jreg.applicable_shapes(jreg.get_config(arch)):
        assert thlo.model_flops_for(treg.get_config(arch),
                                    TSHAPES[shape.name]) == \
            jhlo.model_flops_for(jreg.get_config(arch), shape)
