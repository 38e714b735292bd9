"""Logical-axis-rule sharding (MaxText-style), the reference's rules
(``repro/distributed/sharding.py``).

Parameters, caches and activations carry *logical* axis names
(``models/templates.py``); a rules table, installed per run with
:func:`axis_rules`, maps each name to mesh axes, and
:func:`logical_to_spec` turns a leaf's names into a
:class:`PartitionSpec` with the reference's divisibility-aware drop.
The dry-run reads those specs for the bytes a device holds; the
sharded kernel wrappers (``distributed/shardmap_ops.py``) split their
operands by them.  Nothing here moves data: :func:`shard` only
validates, since the port has no GSPMD to hint.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis name, or a
    tuple of them.  A tuple rule stays a tuple even when it holds one
    axis, as the reference spells it: ``P("x")`` and ``P(("x",))``
    shard alike and compare unequal."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh: what ``tree_shardings`` gives a leaf."""
    mesh: object
    spec: PartitionSpec


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_STATE, "rules", None)


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, MeshAxes], mesh=None):
    prev_rules = getattr(_STATE, "rules", None)
    prev_mesh = getattr(_STATE, "mesh", None)
    _STATE.rules = dict(rules)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.rules = prev_rules
        _STATE.mesh = prev_mesh


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Dict[str, MeshAxes]] = None,
    *,
    shape: Optional[Sequence[int]] = None,
    mesh=None,
) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec.

    If ``shape``+``mesh`` are given, any mapping whose axis size does not
    divide the dim is dropped (divisibility-aware fallback) and duplicate
    mesh axes are dropped left-to-right.
    """
    rules = rules if rules is not None else (current_rules() or {})
    mesh = mesh if mesh is not None else current_mesh()
    used = set()
    out = []
    for i, name in enumerate(logical_axes):
        assignment = rules.get(name) if name else None
        if assignment is None:
            out.append(None)
            continue
        as_tuple = not isinstance(assignment, str)
        axes = (assignment,) if isinstance(assignment, str) else tuple(assignment)
        axes = tuple(a for a in axes if a not in used)
        if mesh is not None and shape is not None:
            total = 1
            kept = []
            for a in axes:
                n = mesh.shape[a]
                if shape[i] % (total * n) == 0:
                    kept.append(a)
                    total *= n
            axes = tuple(kept)
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if as_tuple else axes[0])
    return PartitionSpec(*out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shards(spec: PartitionSpec, mesh) -> int:
    """The pieces a leaf of ``spec`` is cut into on ``mesh``."""
    n = 1
    for entry in spec:
        for a in spec_axes(entry):
            n *= mesh.shape[a]
    return n


def shard(x, *logical_axes: Optional[str]):
    """Annotate an activation with logical axes: ``x`` itself.  Under
    rules the spec is computed and checked against x's rank; the port
    runs eagerly, with no partitioner to hint."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes for a "
                         f"{x.dim()}-D tensor")
    logical_to_spec(logical_axes, rules, shape=x.shape, mesh=current_mesh())
    return x


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and not isinstance(v, PartitionSpec) and all(
        isinstance(e, (str, type(None))) for e in v)


def _tree_map(fn, tree, *rest, is_leaf):
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest),
                                    is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_specs(axes_tree, rules, mesh, shapes_tree):
    """Map a tree (dicts and lists) of logical-axes tuples and a tree of
    the same structure whose leaves have ``.shape`` to PartitionSpecs."""
    return _tree_map(
        lambda ax, shp: logical_to_spec(ax, rules, shape=shp.shape, mesh=mesh),
        axes_tree, shapes_tree, is_leaf=_is_axes)


def tree_shardings(axes_tree, rules, mesh, shapes_tree):
    """:func:`tree_specs` as :class:`NamedSharding` records."""
    specs = tree_specs(axes_tree, rules, mesh, shapes_tree)
    return _tree_map(lambda s: NamedSharding(mesh, s), specs,
                     is_leaf=lambda v: isinstance(v, PartitionSpec))
