"""The fleet frontend: sticky user→cell placement and honest spill.

Every request belongs to a *user*; users stick to a home cell chosen by
hashing their id against the cells' weight distribution (splitmix64 —
stateless, deterministic, no directory service to simulate).  Per
rebalancing epoch the frontend judges each pending request against
EVERY cell at once (one ``fleet.device.select_fleet`` call over the
(cell × batch × pool) operands, on the device the scenario's policy
backend names — see :meth:`FleetFrontend.device`): row ``c`` of the
budget matrix is what
the request's budget would be if cell ``c`` served it,

    T_u[c, r] = T_sla − 2·T_input − L_c − RTT_xcell · [c ≠ home(r)]

so a spilled request's budget already pays the inter-cell round trip
and the target cell's load signal before anyone commits to it — the
same honesty rule :class:`~repro_torch.router.api.BudgetBreakdown` encodes
per decision.

Spill volumes are *capacity-aware*, not signal-chasing.  The naive rule
— move every endangered request to the currently cheapest cell — is
unstable: the whole hot window herds onto one target, drowns it, the
drowned cell serves nothing, reads idle next epoch, and the herd comes
back (a textbook bang-bang oscillation; the first cut of this planner
did exactly that).  Instead the planner sheds only each hot cell's
*excess over its estimated capacity* (plus an optional load-triggered
fraction), spreads it across targets in proportion to their remaining
headroom, and never plans more into a target than that headroom — so a
valley cell absorbs spill up to its capacity and not beyond.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import policy_vec
from repro_torch.fleet.device import StackedPools, select_fleet
from repro_torch.scenario.spec import Scenario

_UID_SALT = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: uint64 → well-mixed uint64, vectorized."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@dataclass
class SpillPlan:
    """One epoch's placement: where every pending request runs."""
    home: np.ndarray          # (B,) home cell of each request
    assigned: np.ndarray      # (B,) serving cell after spill
    rtt_extra_ms: np.ndarray  # (B,) RTT the assignment pays (0 at home)
    picks: np.ndarray         # (C, B) per-cell variant picks (−1 = none)

    @property
    def spilled(self) -> np.ndarray:
        return self.assigned != self.home

    @property
    def n_spilled(self) -> int:
        return int(self.spilled.sum())


class FleetFrontend:
    """Sticky placement + capacity-aware spill planning."""

    # A load-triggered shed (beyond the capacity excess) never moves
    # more than this share of a hot cell's window.
    MAX_SPILL_FRAC = 0.5
    # Plan to this utilization of estimated capacity: at ρ = 1 the
    # in-window queue still grows without bound, so both the outbound
    # excess and the inbound headroom leave a margin.
    TARGET_UTIL = 0.9

    def __init__(self, scenario: Scenario):
        fleet = scenario.deployment.fleet
        if fleet is None:
            raise ValueError(f"scenario {scenario.name!r} has no fleet")
        self.fleet = fleet
        self.n_cells = fleet.n_cells
        w = np.array([c.weight for c in fleet.cells], dtype=np.float64)
        self._cum = np.cumsum(w) / w.sum()
        self._cum[-1] = 1.0 + 1e-12   # guard the u == 1.0 edge
        self.n_users = fleet.n_users
        self.rtt_ms = fleet.rtt_ms
        self.spill = fleet.spill
        self.spill_threshold_ms = fleet.spill_threshold_ms
        self.t_sla_ms = scenario.workload.t_sla_ms
        self.t_threshold = float(
            scenario.policy.kwargs.get("t_threshold", 20.0))
        self.backend = scenario.policy.backend
        # 2·T_input estimate per cell: the frontend plans on the uplink
        # *mean* (it has not seen the draw yet); the engine then samples
        # the real uplink per request.
        self.net2_ms = np.array(
            [2.0 * (c.network.mean_ms if c.network is not None
                    else scenario.network.mean_ms) for c in fleet.cells],
            dtype=np.float64)

    # -- sticky placement ----------------------------------------------
    def uid_of(self, rids) -> np.ndarray:
        """Global request id → user id (many requests per user)."""
        r = np.asarray(rids, dtype=np.uint64)
        return (_mix(r ^ _UID_SALT) % np.uint64(self.n_users)).astype(
            np.int64)

    def home_cell(self, uids) -> np.ndarray:
        """User id → home cell, proportional to cell weights."""
        u = _mix(np.asarray(uids, dtype=np.uint64))
        u01 = u.astype(np.float64) / float(2**64)
        return np.searchsorted(self._cum, u01, side="right").astype(
            np.int64)

    def home_of_requests(self, rids) -> np.ndarray:
        return self.home_cell(self.uid_of(rids))

    def device(self, n_pending: int) -> str:
        """Where an epoch's stacked selection over ``n_pending``
        requests runs: ``policy_vec.selection_device`` of the scenario's
        policy backend (``cuda`` the kernel; ``cpu``, ``numpy`` and
        ``auto`` below ``DEVICE_MIN_BATCH`` its plain version on the
        CPU)."""
        return policy_vec.selection_device(self.backend, n_pending)

    # -- spill planning --------------------------------------------------
    def budget_matrix(self, home: np.ndarray, load_ms: np.ndarray):
        """(C, B) upper budget bounds: the spilled-budget formula
        ``T_sla − 2·T_input − L_c − RTT·[c ≠ home]`` per cell × request;
        the lower bound subtracts the policy's t_threshold window."""
        rtt = self.rtt_ms * (np.arange(self.n_cells)[:, None]
                             != home[None, :])
        t_u = (self.t_sla_ms - self.net2_ms[home][None, :]
               - np.asarray(load_ms, dtype=np.float64)[:, None] - rtt)
        return t_u, t_u - self.t_threshold

    def plan(self, rids, load_ms, stacked: StackedPools, *,
             cap_req: Optional[np.ndarray] = None, gamma: float = 1.0,
             seed: int = 0) -> SpillPlan:
        """Place one epoch's pending requests.

        ``rids``: (B,) global request ids; ``load_ms``: (C,) per-cell
        load signal (previous window's mean queue wait); ``cap_req``:
        (C,) estimated per-window serving capacity in requests
        (``np.inf``/None = unknown — the engine learns it from observed
        throughput); ``stacked``: the cells' pooled profile snapshots.
        """
        rids = np.asarray(rids)
        home = self.home_of_requests(rids)
        load_ms = np.asarray(load_ms, dtype=np.float64)
        t_u, t_l = self.budget_matrix(home, load_ms)
        picks = select_fleet(stacked, t_u, t_l, gamma=gamma, seed=seed)
        assigned = home.copy()
        if self.spill and self.n_cells > 1:
            # Structural viability: can the cell serve at ZERO load?
            # (fastest variant fits the un-loaded budget).  A cell that
            # fails this must spill regardless; a cell that merely has
            # a high load signal sheds only its capacity excess — its
            # queue drained at the epoch boundary, so congestion
            # non-viability must not force out the whole window.
            mu = stacked.mu_host.astype(np.float64)
            mu_min = np.where(mu < 1e29, mu, np.inf).min(axis=1)
            struct_ok = (self.t_sla_ms - self.net2_ms
                         - self.t_threshold) > mu_min
            self._plan_spill(assigned, home, picks >= 0, struct_ok,
                             load_ms, cap_req)
        rtt_extra = np.where(assigned != home, self.rtt_ms, 0.0)
        return SpillPlan(home=home, assigned=assigned,
                         rtt_extra_ms=rtt_extra, picks=picks)

    def _plan_spill(self, assigned: np.ndarray, home: np.ndarray,
                    viable: np.ndarray, struct_ok: np.ndarray,
                    load_ms: np.ndarray,
                    cap_req: Optional[np.ndarray]) -> None:
        """Capacity-aware spill, in place on ``assigned``.

        Per hot cell (worst first) the outbound budget is the window's
        excess over the cell's estimated capacity plus an optional
        load-triggered share — or the whole window when the cell is
        *structurally* unable to serve (fastest variant misses the
        zero-load budget).  Congestion-non-viable requests (endangered
        by the load signal) are moved first, the rest evenly strided
        through the window.  Targets receive shares proportional to
        their remaining headroom (largest-remainder split), each
        request landing on its share's cell only if that cell has a
        viable variant for it — otherwise its cheapest viable target."""
        C = self.n_cells
        n_home = np.bincount(home, minlength=C).astype(np.float64)
        if cap_req is None:
            cap = np.full(C, np.inf)
        else:
            cap = np.asarray(cap_req, dtype=np.float64)
        # Unknown capacity: a neutral guess — one average window.
        guess = max(n_home.mean(), 1.0)
        cap = np.where(np.isfinite(cap), cap, guess) * self.TARGET_UTIL
        head = np.maximum(cap - n_home, 0.0)

        thr = self.spill_threshold_ms
        for c in np.argsort(-load_ms):
            mine = np.where(home == c)[0]
            if mine.size == 0:
                continue
            forced = not struct_ok[c]
            excess = max(0.0, n_home[c] - cap[c])
            extra = 0.0
            if thr > 0.0 and load_ms[c] > thr:
                extra = min((load_ms[c] - thr) / load_ms[c],
                            self.MAX_SPILL_FRAC) * mine.size
            budget = mine.size if forced else \
                int(min(max(excess, extra), mine.size))
            if budget == 0:
                continue
            # Count-based excess is proactive — this window WILL
            # overrun home capacity, so any cell with headroom is a
            # valid target (per-request viability, which already pays
            # the RTT, gates below).  A purely load-triggered shed is
            # reactive and keeps the conservative gate: the target must
            # win even after the RTT.
            if forced or excess > 0.0:
                ok_target = np.ones(C, dtype=bool)
            else:
                ok_target = load_ms + self.rtt_ms < max(load_ms[c], thr)
            targets = np.where((np.arange(C) != c)
                               & (head > 0.0) & ok_target)[0]
            if targets.size == 0:
                continue
            # Endangered requests (non-viable under the load signal)
            # move first, then an even stride over the rest.
            risk = ~viable[c, mine]
            sel = mine[risk][:budget]
            rest = budget - sel.size
            if rest > 0:
                others = mine[~risk]
                take = min(rest, others.size)
                sel = np.concatenate([
                    sel, others[np.linspace(0, others.size - 1, num=take,
                                            dtype=np.int64)]])
            # Headroom caps bound the total; largest-remainder split
            # spreads it proportionally.
            k = min(sel.size, int(head[targets].sum()))
            if k == 0:
                continue
            sel = sel[:k]
            share = head[targets] / head[targets].sum()
            alloc = np.minimum(np.floor(share * k + 0.5),
                               head[targets]).astype(np.int64)
            while alloc.sum() > k:
                alloc[np.argmax(alloc)] -= 1
            t_of = np.repeat(targets, alloc)
            if t_of.size < sel.size:
                sel = sel[:t_of.size]
            if sel.size == 0:
                continue
            # A request whose allotted target has no viable variant for
            # it falls back to its least-loaded viable target (or stays
            # home when none is viable).
            ok = viable[t_of, sel]
            if not ok.all():
                bad = ~ok
                tl = np.where(viable[np.ix_(targets, sel[bad])],
                              load_ms[targets][:, None], np.inf)
                alt = np.argmin(tl, axis=0)
                feasible = np.isfinite(tl[alt, np.arange(alt.size)])
                t_of[bad] = np.where(feasible, targets[alt], c)
            assigned[sel] = t_of
            moved = np.bincount(t_of[t_of != c], minlength=C)
            head -= moved
            head[c] += moved.sum()        # the shed frees home headroom
            np.maximum(head, 0.0, out=head)