"""Dry-run on the ``meta`` device: every (arch × shape) cell's step built
and run on tensors without storage, its work counted, and held to the
H100's roofline.

The reference lowers and compiles each cell for a TPU mesh and reads
XLA's memory, cost and collective analyses (``repro/launch/dryrun.py``).
The port runs its own step eagerly, so here the same step (the training
step, prefill or one decode step) runs on ``meta`` tensors:

- the parameters, optimizer state, batch or cache are built empty from
  their templates (``models/templates.py``), with the reference's
  logical-axis rules (``distributed/policy.py``) giving each leaf's spec
  and so the argument bytes each device holds;
- a ``TorchDispatchMode`` counts every aten op's FLOPs
  (``torch.utils.flop_counter``'s formulas: the matrix products) and the
  bytes of its tensor inputs and outputs (views and empty allocations
  move none);
- each kernel wrapper called on ``meta`` records its analytic cost
  (``kernels/cost.py``, the formulas of ``chip_smoke.py``'s bounds) in
  place of launching.

The port runs its layers in a Python loop, so every layer is counted:
the reference's scan calibration (compiling 1- and 2-repetition
variants, ``models/runtime_flags.py``) has no counterpart.  ``single``
is one H100.  On a larger mesh the FLOPs and bytes are the whole step's
and the collective terms are not counted (``null``): the port has no
partitioner whose collectives could be read.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs.registry import applicable_shapes, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import hlo as hlo_mod
from repro_torch.distributed.policy import (TRAIN_OPT_MOMENTS, make_rules,
                                            train_grad_accum)
from repro_torch.distributed.sharding import (axis_rules, logical_to_spec,
                                              shards)
from repro_torch.kernels import cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, templates
from repro_torch.models.convert import leaf_layout, named_leaves
from repro_torch.models.templates import LeafSpec

DEFAULT_OUT = os.path.join("build", "dryrun")

_aten = torch.ops.aten
# ops that move no data: allocations without a fill, and reshapes that
# aten does not mark as views
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view}


class OpCount(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run under it (see the module's
    note), and the number of ops counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        self.ops += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.nbytes += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                           if isinstance(t, torch.Tensor))
        return out


def make_dryrun_mesh(name: str) -> Mesh:
    """``single`` (one H100: data 1 × model 1) or ``RxC`` / ``PxRxC``
    (data × model, pod × data × model); abstract, since the dry-run
    places nothing."""
    if name == "single":
        return Mesh((1, 1), ("data", "model"))
    dims = tuple(int(x) for x in name.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return Mesh(dims, axes)


def _batch_leaf(shape, dtype) -> LeafSpec:
    axes = ("batch",) + (None,) * (len(shape) - 1)
    return LeafSpec(tuple(shape), dtype, (axes,), (shape[-1],))


def device_bytes(spec: LeafSpec, rules, mesh) -> int:
    """Bytes of a leaf one device holds under ``rules``: each segment's
    bytes over the pieces its spec cuts it into (a 0-D leaf whole)."""
    if not spec.shape:
        return spec.nbytes
    esize = spec.nbytes // math.prod(spec.shape)
    total = 0
    for shape, axes in spec.segment_shapes():
        p = logical_to_spec(axes, rules, shape=shape, mesh=mesh)
        total += math.prod(shape) * esize // shards(p, mesh)
    return total


def _moment_specs(param: LeafSpec, moment) -> list:
    """LeafSpecs of one leaf's moment: fp32 in the parameter's layout, or
    int8 ``q`` in it with per-(row, segment) fp32 ``scale`` (and
    ``lo``), which shard like the parameter's rows."""
    if isinstance(moment, torch.Tensor):
        return [dataclasses.replace(param, dtype=moment.dtype)]
    out = [dataclasses.replace(param, dtype=moment["q"].dtype)]
    rows = param.axes[0][:-1] + (None,)
    for key in ("scale", "lo"):
        if key in moment:
            shp = tuple(moment[key].shape)
            out.append(LeafSpec(shp, moment[key].dtype, (rows,), (shp[-1],)))
    return out


class Cell(NamedTuple):
    """A cell ready to run: ``fn(*args)`` on ``meta``, and the argument
    leaves by role (params, opt_state, batch or cache and tokens)."""
    fn: Any
    args: tuple
    rules: dict
    cfg: Any
    shape: ShapeConfig
    leaves: Dict[str, list]


def build_cell(arch: str, shape_name: str, mesh: Mesh, overrides=None,
               grad_accum=None, shape: Optional[ShapeConfig] = None,
               param_dtype=torch.bfloat16, pad_heads: int = 0,
               kv_int8: bool = False) -> Cell:
    """The cell's step and its arguments on ``meta``.  ``shape``
    replaces ``SHAPES[shape_name]``; parameters are ``param_dtype``
    (bf16, as the reference's dry-run, unless given)."""
    cfg = get_config(arch)
    if pad_heads:
        cfg = cfg.with_padded_heads(pad_heads)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    shape = shape or SHAPES[shape_name]
    rules = make_rules(cfg, shape, mesh, overrides)
    dev = resolve_device("meta", meta=True)
    p_tmpl = templates.param_template(cfg, param_dtype)
    params = templates.empty(p_tmpl, dev)
    leaves = {"params": [s for _, s in named_leaves(p_tmpl)]}

    if shape.mode == "train":
        from repro_torch.training.optimizer import init_opt_state
        from repro_torch.training.train_step import make_train_step
        if grad_accum is None:
            grad_accum = train_grad_accum(arch, shape.global_batch, mesh)
        moments = TRAIN_OPT_MOMENTS.get(arch, "fp32")
        tcfg = TrainConfig(remat="full", grad_accum=grad_accum,
                           opt_moments=moments)
        opt = init_opt_state(params, moments, leaf_layout(cfg, params))
        specs = dict(named_leaves(p_tmpl))
        leaves["opt_state"] = [LeafSpec((), torch.int32, ((),), (1,))] + [
            s for m in (opt.mu, opt.nu) for path, t in m.items()
            for s in _moment_specs(specs[path], t)]
        b_specs = api.batch_specs(cfg, shape)
        leaves["batch"] = [_batch_leaf(*v) for v in b_specs.values()]
        batch = {k: torch.empty(shp, dtype=dt, device=dev)
                 for k, (shp, dt) in b_specs.items()}
        return Cell(make_train_step(cfg, tcfg), (params, opt, batch), rules,
                    cfg, shape, leaves)
    if shape.mode == "prefill":
        b_specs = api.batch_specs(cfg, shape)
        leaves["batch"] = [_batch_leaf(*v) for v in b_specs.values()]
        batch = {k: torch.empty(shp, dtype=dt, device=dev)
                 for k, (shp, dt) in b_specs.items()}
        return Cell(api.make_prefill_step(cfg, cache_len=shape.seq_len),
                    (params, batch), rules, cfg, shape, leaves)
    B = shape.global_batch
    c_tmpl = templates.cache_template(cfg, B, shape.seq_len,
                                      api.act_dtype(cfg))
    leaves["cache"] = [s for _, s in named_leaves(c_tmpl)]
    leaves["tokens"] = [_batch_leaf((B,), torch.int32)] * 2
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    pos = torch.empty((B,), dtype=torch.int32, device=dev)
    return Cell(api.make_serve_step(cfg), (params, templates.empty(c_tmpl, dev),
                                           tok, pos), rules, cfg, shape, leaves)


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, mesh: Mesh, mesh_name: str,
             overrides=None, verbose: bool = True, **build_kw) -> dict:
    """Build the cell, run its step on ``meta`` under the counts, and
    return the reference's record (``memory``, ``cost``, ``collectives``,
    ``roofline``, ``timing``)."""
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, overrides, **build_kw)
    t1 = time.time()
    result = {"arch": arch, "shape": cell.shape.name, "mesh": mesh_name,
              "n_chips": mesh.size, "status": "ok"}
    args_ids = {id(t) for t in tree_leaves(cell.args)
                if isinstance(t, torch.Tensor)}
    with axis_rules(cell.rules, mesh), cost.counting() as tally:
        with OpCount() as ops:
            grad = torch.enable_grad() if cell.shape.mode == "train" \
                else torch.no_grad()
            with grad:
                out = cell.fn(*cell.args)
    t2 = time.time()
    per_role = {role: sum(device_bytes(s, cell.rules, mesh) for s in specs)
                for role, specs in cell.leaves.items()}
    new_out = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
               and id(t) not in args_ids]
    result["memory"] = {
        "argument_size_in_bytes": sum(per_role.values()),
        "argument_bytes_by_role": per_role,
        "output_size_in_bytes": (_nbytes(new_out) if mesh.size == 1
                                 else None),
        "temp_size_in_bytes": None}
    flops = float(ops.flops + tally.flops)
    nbytes = float(ops.nbytes + tally.nbytes)
    result["cost"] = {"flops": flops, "bytes_accessed": nbytes,
                      "aten_flops": float(ops.flops),
                      "aten_bytes": float(ops.nbytes), "aten_ops": ops.ops,
                      "kernel_flops": float(tally.flops),
                      "kernel_bytes": float(tally.nbytes),
                      "kernel_calls": dict(tally.calls)}
    coll = 0.0 if mesh.size == 1 else None
    result["collectives"] = {"bytes_per_chip": coll,
                             "by_kind": {} if coll == 0.0 else None}
    roof = hlo_mod.Roofline(
        n_chips=mesh.size, hlo_flops=flops, hlo_bytes=nbytes,
        coll_bytes_per_chip=coll,
        model_flops=hlo_mod.model_flops_for(cell.cfg, cell.shape))
    result["roofline"] = roof.to_dict()
    result["timing"] = {"build_s": t1 - t0, "run_s": t2 - t1}
    if verbose:
        coll_ms = ("not counted" if roof.collective_s is None
                   else f"{roof.collective_s * 1e3:.2f}ms")
        print(f"[{arch} × {cell.shape.name} × {mesh_name}] "
              f"compute={roof.compute_s * 1e3:.2f}ms "
              f"memory={roof.memory_s * 1e3:.2f}ms collective={coll_ms} "
              f"dominant={roof.dominant} "
              f"useful={roof.useful_flops_ratio:.2f} "
              f"mfu_bound={roof.mfu:.3f} (build {t1 - t0:.1f}s + run "
              f"{t2 - t1:.1f}s)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single (one H100) | RxC (data x model, abstract)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of logical-axis rule overrides")
    ap.add_argument("--tag", default="")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad query heads to a multiple "
                         "(ModelConfig.with_padded_heads)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache")
    args = ap.parse_args(argv)

    mesh = make_dryrun_mesh(args.mesh)
    overrides = json.loads(args.overrides) if args.overrides else None
    os.makedirs(args.out, exist_ok=True)

    cells = []
    if args.all:
        from repro_torch.configs.registry import ARCH_IDS
        for a in ARCH_IDS:
            for s in applicable_shapes(get_config(a)):
                cells.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    n_ok = 0
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{args.mesh}{args.tag}"
        out_path = os.path.join(args.out, tag + ".json")
        try:
            res = run_cell(arch, shape_name, mesh, args.mesh, overrides,
                           pad_heads=args.pad_heads, kv_int8=args.kv_int8)
            n_ok += 1
        except Exception:  # one cell's failure is recorded, the rest run
            res = {"arch": arch, "shape": shape_name, "mesh": args.mesh,
                   "status": "fail", "error": traceback.format_exc()}
            print(f"[{arch} × {shape_name}] FAILED")
            print(res["error"])
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    print(f"dry-run complete: {n_ok}/{len(cells)} cells ok")
    if n_ok < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
