"""Device-side fleet selection: stacked per-cell pool operands and the
one-launch (cell × batch × pool) dispatch.

Each cell serves its own zoo subset, so its pool has its own width.  To
judge every cell's pending batch in ONE launch, the per-cell pools are
padded to the fleet-wide maximum width with sentinels on the padded
lanes (``PAD_MU`` — never eligible; ``PAD_RANK`` — never wins the
stage-1 argmin; σ 0, accuracy 1), stacked on a leading cell axis and
uploaded once.  The stacked snapshot is frozen against one set of
``ProfileTable`` snapshots — rebuild (cheap) when any cell's profiles
move, exactly like ``ProfileTable.device_pool()``.  The cell mesh of the
reference (``select_fleet(mesh=...)`` under ``shard_map``) is not
ported: every cell is judged on one device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.policy_select import (PAD_MU, PAD_RANK,
                                               select_fleet_stacked)


class StackedPools:
    """(C, npad) pool operands for ``select_fleet`` on ``device`` — the
    fleet analogue of :class:`~repro_torch.kernels.policy_select.
    DevicePool` — and ``mu_host``, the same padded μ as a float32 numpy
    array, for host code that reads the profiles (the frontend's
    structural check, the engine's capacity prior) without a read-back
    from the card."""

    __slots__ = ("C", "npad", "n", "device", "mu", "sigma", "acc", "rank",
                 "fastest", "mu_host")

    def __init__(self, tables: Sequence, device="cuda"):
        self.C = len(tables)
        if self.C == 0:
            raise ValueError("StackedPools needs at least one cell table")
        self.device = resolve_device(device)
        self.n = np.array([len(t) for t in tables], dtype=np.int64)
        self.npad = int(self.n.max())
        self.fastest = np.array([t.fastest for t in tables], dtype=np.int64)
        ops = np.empty((4, self.C, self.npad), np.float32)
        ops[:] = np.array([PAD_MU, 0.0, 1.0, PAD_RANK],
                          np.float32)[:, None, None]
        for c, t in enumerate(tables):
            n = len(t)
            ops[0, c, :n] = t.mu
            ops[1, c, :n] = t.sigma
            ops[2, c, :n] = t.accuracy
            ops[3, c, np.asarray(t.acc_order)] = np.arange(n)
        self.mu_host = ops[0]
        self.mu, self.sigma, self.acc, self.rank = \
            torch.from_numpy(ops).to(self.device)


def stack_cell_tables(tables: Sequence, device="cuda") -> StackedPools:
    """Stack every cell's ``ProfileTable`` snapshot into one
    :class:`StackedPools` on ``device`` (padded to the common width)."""
    return StackedPools(tables, device)


def select_fleet(stacked: StackedPools, t_u, t_l, *, gamma: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """Every cell's judgment of every pending request in one launch.

    ``t_u``/``t_l``: (C, B) budget bounds — row ``c`` is what request
    ``b``'s budget *would be* if served by cell ``c`` (home rows carry
    no RTT; remote rows already subtract it).  Returns (C, B) int32
    picks, −1 where cell ``c`` has no eligible variant for request
    ``b`` — the frontend's viability matrix."""
    t_u = np.asarray(t_u, dtype=np.float32)
    t_l = np.asarray(t_l, dtype=np.float32)
    if t_u.shape != t_l.shape or t_u.ndim != 2 or t_u.shape[0] != stacked.C:
        raise ValueError(f"budget bounds must be (C={stacked.C}, B); got "
                         f"t_u {t_u.shape}, t_l {t_l.shape}")
    return select_fleet_stacked(stacked.mu, stacked.sigma, stacked.acc,
                                stacked.rank, t_u, t_l, gamma=gamma,
                                seed=seed)
