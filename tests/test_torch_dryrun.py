"""The port's dry-run (``repro_torch.launch.dryrun``) on the ``meta``
device, its kernel costs (``repro_torch.kernels.cost``) and the pool
built from its records (``repro_torch.core.gpu_pool``):

- at full size, the two cells that are red in the reference
  (``mamba2-1.3b × long_500k``, ``whisper-tiny × decode_32k``: its
  ``shard()`` meets an ``Explicit`` mesh) and a training cell
  (``qwen2-1.5b × train_4k``): status ok, argument bytes equal to the
  reference's ``abstract(param_template)`` bytes with its cache or
  optimizer state and inputs, ``model_flops`` equal, counted FLOPs at
  least ``model_flops``; a 2x4 cell's bytes a device from the
  reference's own specs;
- the CLI and the reference's JSON schema;
- every kernel wrapper on ``meta``: empty outputs of the kernel's
  shapes, its cost recorded, and a refusal outside ``cost.counting()``;
- the cost formulas: the visible pairs against ``ref.attention_mask``,
  and the bounds of the kernels line at the main path's shapes;
- ``gpu_pool.load_pool`` / ``to_zoo`` against ``tpu_pool``'s on the
  same JSON files.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.core import tpu_pool
from repro.distributed import hlo as jhlo
from repro.distributed import policy as jpol
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.models import model as JM
from repro.models.layers import abstract, is_spec
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro_torch.core import gpu_pool
from repro_torch.device import resolve_device
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = dryrun.make_dryrun_mesh("single")


def _nbytes(tree) -> int:
    return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _reference_argument_bytes(arch, shape_name):
    """The reference's arguments of the cell, as its dry-run builds them
    (``build_cell``): bf16 parameters, then the optimizer state and the
    batch, the batch, or the cache and the tokens."""
    cfg, shape = jreg.get_config(arch), JSHAPES[shape_name]
    p_abs = abstract(JM.param_template(cfg), jnp.bfloat16)
    out = {"params": _nbytes(p_abs)}
    if shape.mode == "train":
        moments = jpol.TRAIN_OPT_MOMENTS.get(arch, "fp32")
        out["opt_state"] = _nbytes(jax.eval_shape(
            lambda p: j_init_opt_state(p, moments), p_abs))
        out["batch"] = _nbytes(japi.batch_specs(cfg, shape))
    elif shape.mode == "prefill":
        out["batch"] = _nbytes(japi.batch_specs(cfg, shape))
    else:
        B = shape.global_batch
        out["cache"] = _nbytes(abstract(
            JM.cache_template(cfg, B, shape.seq_len), jnp.bfloat16))
        out["tokens"] = 2 * 4 * B
    return out


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-1.3b", "long_500k"), ("whisper-tiny", "decode_32k"),
    ("qwen2-1.5b", "train_4k")])
def test_dryrun_full_size_cell(arch, shape):
    res = dryrun.run_cell(arch, shape, SINGLE, "single", verbose=False)
    assert res["status"] == "ok" and res["n_chips"] == 1
    want = _reference_argument_bytes(arch, shape)
    assert res["memory"]["argument_bytes_by_role"] == want
    assert res["memory"]["argument_size_in_bytes"] == sum(want.values())
    roof = res["roofline"]
    assert roof["model_flops"] == jhlo.model_flops_for(
        jreg.get_config(arch), JSHAPES[shape])
    assert roof["hlo_flops"] >= roof["model_flops"] > 0
    assert res["cost"]["flops"] == res["cost"]["aten_flops"] + \
        res["cost"]["kernel_flops"]
    assert res["collectives"]["bytes_per_chip"] == 0.0
    assert roof["collective_s"] == 0.0
    assert roof["dominant"] in ("compute", "memory")
    kernels = {"long_500k": {}, "decode_32k": {"decode_attention": 8},
               "train_4k": {"flash_attention": 4 * 28,
                            "flash_attention_bwd": 2 * 28,
                            "adamw": 1}}[shape]
    assert res["cost"]["kernel_calls"] == kernels


def test_dryrun_bytes_a_device_on_2x4_from_the_reference_specs():
    """qwen2-1.5b × decode_32k on a 2x4 mesh: each leaf's bytes over the
    pieces the reference's spec of it (``logical_to_spec`` under its
    ``make_rules``) cuts it into."""
    arch, shape_name = "qwen2-1.5b", "decode_32k"
    mesh = dryrun.make_dryrun_mesh("2x4")
    res = dryrun.run_cell(arch, shape_name, mesh, "2x4", verbose=False)
    assert res["n_chips"] == 8 and res["collectives"]["bytes_per_chip"] \
        is None and res["roofline"]["collective_s"] is None
    assert res["memory"]["output_size_in_bytes"] is None

    class FakeMesh:
        shape = {"data": 2, "model": 4}

    cfg, shape = jreg.get_config(arch), JSHAPES[shape_name]
    rules = jpol.make_rules(cfg, shape, FakeMesh())

    def per_device(tmpl):
        total = 0
        for spec in jax.tree.leaves(tmpl, is_leaf=is_spec):
            p = jsh.logical_to_spec(spec.axes, rules, shape=spec.shape,
                                    mesh=FakeMesh())
            n = 1
            for entry in p:
                for a in (() if entry is None else (entry,) if isinstance(
                        entry, str) else entry):
                    n *= FakeMesh.shape[a]
            size = jnp.dtype(spec.dtype or jnp.bfloat16).itemsize
            total += math.prod(spec.shape) * size // n
        return total

    B = shape.global_batch
    by_role = res["memory"]["argument_bytes_by_role"]
    assert by_role["params"] == per_device(JM.param_template(cfg))
    assert by_role["cache"] == per_device(
        JM.cache_template(cfg, B, shape.seq_len))
    assert by_role["tokens"] == 2 * 4 * B // 2      # batch over 'data'


def test_dryrun_cli_writes_the_reference_schema(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "dry-run complete: 1/1 cells ok" in proc.stdout
    with open(tmp_path / "whisper-tiny__decode_32k__single.json") as fh:
        out = json.load(fh)
    assert {"arch", "shape", "mesh", "n_chips", "status", "memory", "cost",
            "collectives", "roofline", "timing"} <= set(out)
    assert set(out["roofline"]) == set(jhlo.Roofline(
        1, 1.0, 1.0, 0.0, 1.0).to_dict())
    assert out["roofline"]["hlo_flops"] > 0
    assert out["cost"]["bytes_accessed"] > 0


def test_resolve_device_takes_meta_only_when_asked():
    with pytest.raises(ValueError, match="dry-run"):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"


# ----------------------------------------------------------------------
# The kernel wrappers on meta
# ----------------------------------------------------------------------
def _m(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _meta_calls():
    bf = torch.bfloat16
    q, k = _m(2, 4, 64, 32, dtype=bf), _m(2, 2, 64, 32, dtype=bf)
    qd, pos = _m(2, 2, 2, 32, dtype=bf), _m(2, dtype=torch.int32)
    k8 = _m(2, 2, 80, 32, dtype=torch.int8)
    x, dt, A = _m(2, 4, 40, 16), _m(2, 4, 40), _m(4)
    Bm = _m(2, 2, 40, 16)
    a = _m(2, 40, 24)
    mu, B_ = _m(5), 7
    f = lambda *s: _m(*s)  # noqa: E731
    sc = torch.empty((), device="meta")
    return [
        ("flash_attention", lambda: ops.flash_attention(q, k, k, window=16),
         cost.flash_attention(q, k, True, 16), [(2, 4, 64, 32)]),
        ("flash_attention_bwd", lambda: ops.flash_attention_bwd(
            q, k, k, q, _m(2, 4, 64), q, causal=False),
         cost.flash_attention_bwd(q, k, False, 0),
         [(2, 4, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32)]),
        ("decode_attention", lambda: ops.decode_attention(
            qd, _m(2, 2, 80, 32, dtype=bf), _m(2, 2, 80, 32, dtype=bf), pos),
         cost.decode_attention(qd, 2 * 2 * 80), [(2, 2, 2, 32)]),
        ("decode_attention_int8", lambda: ops.decode_attention_int8(
            qd, k8, k8, _m(2, 2, 80), _m(2, 2, 80), pos,
            k_new=_m(2, 2, 32, dtype=bf), v_new=_m(2, 2, 32, dtype=bf),
            slot=pos), cost.decode_attention_int8(qd, 320, write=True),
         [(2, 2, 2, 32)]),
        ("ssd_scan", lambda: ops.ssd_scan(x, dt, A, Bm, Bm, chunk=32),
         cost.ssd_scan(2, 4, 2, 40, 16, 16, 32, torch.float32),
         [(2, 4, 40, 16), (2, 4, 16, 16)]),
        ("ssd_scan_bwd", lambda: ops.ssd_scan_bwd(
            x, dt, A, Bm, Bm, x, None, chunk=32, states=_m(2, 4, 2, 16, 16)),
         cost.ssd_scan_bwd(2, 4, 2, 40, 16, 16, 32, torch.float32),
         [(2, 4, 40, 16), (2, 4, 40), (4,), (2, 2, 40, 16), (2, 2, 40, 16)]),
        ("rglru_scan", lambda: ops.rglru_scan(a, a), cost.rglru_scan(a),
         [(2, 40, 24)]),
        ("rglru_scan_bwd", lambda: ops.rglru_scan_bwd(a, a, a),
         cost.rglru_scan_bwd(a), [(2, 40, 24), (2, 40, 24)]),
        ("modipick_probs", lambda: ops.modipick_probs(
            mu, mu, mu, f(B_), f(B_), f(B_, 5)), cost.modipick_probs(7, 5),
         [(7, 5)]),
        ("fused_select", lambda: ops.fused_select(
            mu, mu, mu, mu, f(B_), f(B_), f(B_)), cost.fused_select(7, 5),
         [(7,)]),
        ("charged_select", lambda: ops.charged_select(
            mu, mu, mu, mu, mu, _m(5, 3, dtype=torch.bool), f(3), f(3),
            f(B_), f(B_), f(B_), f(B_)),
         cost.charged_select(5, 3, 7, 5 + 3 + 2 + 2 * 15),
         [(7,), (7,), (7,), (7,), (7,)]),
        ("stacked_select", lambda: ops.stacked_select(
            f(2, 5), f(2, 5), mu, mu, _m(7, dtype=torch.int32), f(B_),
            f(B_), f(B_)),
         cost.stacked_select(f(2, 5), mu, _m(7, dtype=torch.int32)),
         [(7,), (7,)]),
        ("adamw", lambda: ops.adamw(
            [_m(3, 5, dtype=bf), mu], [f(3, 5), mu], [f(3, 5), mu],
            [f(3, 5), mu], [True, False], sc, sc, sc, b1=0.9, b2=0.95,
            eps=1e-8, weight_decay=0.1, grad_clip=1.0),
         cost.adamw([_m(3, 5, dtype=bf), mu], [f(3, 5), mu], [True, False]),
         [()]),
    ]


@pytest.mark.parametrize("case", range(13))
def test_wrapper_on_meta_records_its_cost(case):
    name, call, want, shapes = _meta_calls()[case]
    wrapper = getattr(ops, name)
    before = ops.launch_counts()
    with cost.counting() as tally:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.is_meta for o in outs)
    assert tally.calls == {name: 1}
    assert (tally.flops, tally.nbytes) == (want.flops, want.nbytes)
    assert ops.launch_counts() == before       # nothing was launched
    with pytest.raises(ValueError, match="counting"):
        call()
    assert wrapper in ops.WRAPPERS


def test_autograd_functions_on_meta():
    """Under grad mode the differentiable wrappers run their autograd
    Functions on meta, forward and backward, each recording its cost."""
    q = _m(1, 2, 32, 16).requires_grad_()
    k = _m(1, 2, 32, 16).requires_grad_()
    x, dt = _m(1, 2, 32, 16).requires_grad_(), _m(1, 2, 32).requires_grad_()
    A, Bm = _m(2).requires_grad_(), _m(1, 1, 32, 16).requires_grad_()
    a = _m(1, 32, 8).requires_grad_()
    with cost.counting() as tally:
        o = ops.flash_attention(q, k, k)
        y, _ = ops.ssd_scan(x, dt, A, Bm, Bm, chunk=16)
        h = ops.rglru_scan(a, a)
        torch.autograd.grad((o.sum() + y.sum() + h.sum()),
                            (q, k, x, dt, A, Bm, a))
    assert tally.calls == {n: 1 for n in (
        "flash_attention", "ssd_scan", "rglru_scan", "flash_attention_bwd",
        "ssd_scan_bwd", "rglru_scan_bwd")}


# ----------------------------------------------------------------------
# The cost formulas
# ----------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (128, 128, True, 0), (200, 200, True, 64), (64, 100, False, 0),
    (100, 64, True, 0), (1000, 1000, True, 2048), (33, 77, True, 5),
    (77, 33, False, 9)])
def test_visible_pairs_match_the_mask(Sq, Sk, causal, window):
    mask = ref.attention_mask(Sq, Sk, causal, window, "cpu")
    assert cost.visible_pairs(Sq, Sk, causal, window) == int(mask.sum())


def test_bounds_of_the_kernels_line():
    """The bounds ``chip_smoke.py``'s kernels line gives at the main
    path's shapes, from these formulas: the same numbers, to the bit."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        (cost.flash_attention(_m(4, 12, 128, 128, dtype=bf),
                              _m(4, 2, 128, 128, dtype=bf)),
         (0.0010955271641791046, "bytes")),
        (cost.ssd_scan(4, 64, 1, 128, 64, 128, 256, bf),
         (0.005125578507462686, "bytes")),
        (cost.rglru_scan(_m(4, 128, 2560)), (0.004695116417910448, "bytes")),
        (cost.flash_attention_bwd(_m(4, 12, 1024, 128), _m(4, 2, 1024, 128)),
         (0.19541643636363637, "operations")),
        (cost.rglru_scan_bwd(_m(2, 1024, 2560)),
         (0.03130077611940299, "bytes")),
        (cost.ssd_scan_bwd(2, 64, 1, 1024, 64, 128, 256, f32, True),
         (0.12435634734545453, "operations")),
        (cost.modipick_probs(8192, 2), (5.869611940298507e-05, "bytes")),
        (cost.fused_select(200, 11), (1.0077611940298509e-06, "bytes")),
        (cost.stacked_select(_m(2, 11), _m(11), _m(200, dtype=torch.int32),
                             _m(11)), (1.3456716417910447e-06, "bytes"))]
    for c, want in cases:
        assert cost.bound(c) == want


# ----------------------------------------------------------------------
# The pool built from the dry-run's records
# ----------------------------------------------------------------------
def test_gpu_pool_matches_tpu_pool_on_the_same_records(tmp_path):
    for arch in ("qwen2-1.5b", "mamba2-1.3b"):
        for shape in ("prefill_32k", "decode_32k"):
            res = dryrun.run_cell(arch, shape, SINGLE, "single",
                                  verbose=False)
            with open(tmp_path / f"{arch}__{shape}__single.json", "w") as fh:
                json.dump(res, fh)
    with open(tmp_path / "whisper-tiny__decode_32k__single.json", "w") as fh:
        json.dump({"arch": "whisper-tiny", "shape": "decode_32k",
                   "status": "fail"}, fh)
    got = gpu_pool.load_pool(str(tmp_path))
    want = tpu_pool.load_pool(str(tmp_path))
    assert [m.arch for m in got] == [m.arch for m in want] == [
        "mamba2-1.3b", "qwen2-1.5b"]
    for g, w in zip(got, want):
        assert (g.arch, g.mesh, g.prefill_bound_s, g.decode_bound_s,
                g.quality) == (w.arch, w.mesh, w.prefill_bound_s,
                               w.decode_bound_s, w.quality)
    for kw in ({}, dict(prefill_tokens=512, decode_tokens=64,
                        jitter_cv=0.1, dispatch_ms=1.0)):
        zg, zw = gpu_pool.to_zoo(got, **kw), tpu_pool.to_zoo(want, **kw)
        assert [(e.name, e.top1, e.mu_ms, e.sigma_ms) for e in zg] == \
            [(e.name, e.top1, e.mu_ms, e.sigma_ms) for e in zw]
    assert gpu_pool.load_pool(str(tmp_path), mesh="2x4") == []
