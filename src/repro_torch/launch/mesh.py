"""Device meshes: named axes over a grid of devices.

The reference builds ``jax.make_mesh`` meshes over TPU chips (or XLA's
fake host devices).  The port's :class:`Mesh` holds the axis names, their
sizes and the devices, row-major over the axes: a tuple of
``torch.device``, or None for an abstract mesh that only the dry-run's
arithmetic reads (the production meshes).  A debug mesh may name one
device several times, as XLA's fake host devices stand eight devices on
one CPU: ``make_mesh((2, 4), ("data", "model"), ["cuda:0"] * 8)`` runs
every block of a sharded call on one card (``distributed/
shardmap_ops.py``).

Nothing here touches a device when the module is imported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """Axis names, sizes and devices (row-major over the axes, or None
    for an abstract mesh)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices: Optional[Sequence] = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                             "one distinct name with each size")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh sizes must be >= 1, got {shape}")
        self.axis_names: Tuple[str, ...] = axes
        self._sizes = shape
        self.devices: Optional[Tuple[torch.device, ...]] = None
        if devices is not None:
            devs = tuple(torch.device(d) for d in devices)
            if len(devs) != math.prod(shape):
                raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                                 f"devices, got {len(devs)}")
            self.devices = devs

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return math.prod(self._sizes)

    def coords(self):
        """Each device's coordinates over the axes, row-major: the order
        of ``devices``."""
        out = [()]
        for s in self._sizes:
            out = [c + (i,) for c in out for i in range(s)]
        return out

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        if self.devices is None:
            return f"Mesh({axes}; abstract)"
        distinct = list(dict.fromkeys(self.devices))
        if len(distinct) < len(self.devices):
            named = ", ".join(f"{d} x{self.devices.count(d)}"
                              for d in distinct)
            return (f"Mesh({axes}; {named}: {len(self.devices)} fake "
                    f"devices on {len(distinct)})")
        return f"Mesh({axes}; {', '.join(map(str, self.devices))})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, abstract: single pod (data=16,
    model=16), multi-pod (pod=2, data=16, model=16).  The port has no
    such machine; the dry-run reads their arithmetic."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  Without ``devices``, the first
    ``prod(shape)`` cards (raises when there are fewer); with them, those
    devices in order: a debug mesh may name one card (or ``"cpu"``)
    more than once."""
    n = math.prod(int(s) for s in shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"a {tuple(shape)} mesh needs {n} cards; "
                               f"{have} found (pass devices= for a debug "
                               "mesh)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(shape, axes, devices)


def mesh_axis(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def data_axes(mesh):
    """The data-parallel axes present in this mesh ('pod' + 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
