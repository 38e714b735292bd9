"""Weights made by the benchmark from ``--seed``, handed to the program
and to the plain reference alike.

One variant's parameters are drawn on the device in one call of
``torch.randn`` (and, for Mamba2's A and dt, one of ``torch.rand``) into
a flat buffer of the served type, then scaled leaf by leaf in place.
:func:`make` returns the program's parameter tree, whose leaves are views
of that buffer laid out as ``repro_torch.models.model`` holds them
(``wqkv`` = q | k | v side by side, Mamba2's ``w_in`` = z | x | B | C |
dt, norm gains stored as ``gain − 1``), and the logical leaves by their
published names, views of the same tensors, which the reference reads.
The same seed gives the same bits on the same device.  The layout is the
family's: ``leaves`` and ``spec`` of ``bench/reference/<family>.py``; the
draw and the scaling rules are the same for every family.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import reference
from .reference.common import Spec


def variant_seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B1 + 7919 * (index + 1)) % (1 << 63)


def leaves(family: str, v: dict, init: dict) -> list:
    """(path, shape, std or a rule name) of every program leaf, in the
    order they are drawn, as the family's reference module lays them
    out."""
    return reference.load(family).leaves(v, init)


def _set(tree, path: str, t) -> None:
    keys = path.split("/")
    node = tree
    for k, nxt in zip(keys[:-1], keys[1:]):
        if k == "layers":
            node = node.setdefault("layers", [])
            continue
        if k.isdigit():
            i = int(k)
            while len(node) <= i:
                node.append({})
            node = node[i]
            continue
        node = node.setdefault(k, {})
    node[keys[-1]] = t


def get(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[int(k)] if k.isdigit() else node[k]
    return node


def make(family: str, v: dict, init: dict, seed: int, index: int,
         dtype: torch.dtype, device) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(program tree, logical leaves) of variant ``v`` (a ``variants``
    entry of a configuration file), drawn from ``seed`` and the variant's
    ``index`` in its pool."""
    drawn = leaves(family, v, init)
    gen = torch.Generator(device=device)
    gen.manual_seed(variant_seed(seed, index))
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    special = [(path, shape, rule) for path, shape, rule in drawn
               if rule in ("A_log", "dt_bias")]
    u = None
    if special:
        u = torch.rand(sum(math.prod(s) for _, s, _ in special),
                       generator=gen, dtype=torch.float32, device=device)
    tree: dict = {}
    off = uoff = 0
    for path, shape, rule in drawn:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if rule == "one":
            t.fill_(1.0)
        elif rule in ("A_log", "dt_bias"):
            x = u[uoff:uoff + n].view(shape)
            uoff += n
            if rule == "A_log":
                a = init["A_min"] + x * (init["A_max"] - init["A_min"])
                t.copy_(torch.log(a))
            else:
                lo, hi = math.log(init["dt_min"]), math.log(init["dt_max"])
                dt = torch.clamp_min(torch.exp(lo + x * (hi - lo)),
                                     init["dt_floor"])
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            t.mul_(rule)
        _set(tree, path, t)
    return tree, logical(family, v, tree)


def spec(family: str, v: dict) -> Spec:
    """Each logical leaf: its name, the program leaf it lies in and where
    in that leaf."""
    return reference.load(family).spec(v)


def logical(family: str, v: dict, tree) -> Dict[str, torch.Tensor]:
    """The logical leaves of a program tree (views)."""
    return {name: get(tree, path)[idx] for name, path, idx
            in spec(family, v)}


def logical_of_paths(family: str, v: dict,
                     by_path: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The logical leaves of tensors keyed by program path (an optimizer
    state's moments, say)."""
    return {name: by_path[path][idx] for name, path, idx
            in spec(family, v)}
