"""Vectorized policy engine: batched selection over a ProfileTable.

All of ModiPick's request-time math (§3.3 stages 1–3) and the paper's
baselines are batched over requests *and* over the model pool:

- **stage 1** is a masked argmax over the (batch × pool) Eq. 2
  eligibility matrix in accuracy order (first True per row = greedy base);
- **stage 2** is a broadcast window-membership matrix around each row's
  base model;
- **stage 3** evaluates the Eq. 3–4 utilities for every (request, model)
  pair at once and samples with the Gumbel-top-1 trick — argmax over
  ``log p + Gumbel`` draws exactly from the normalized utility
  distribution, so the batched path is distributionally identical to the
  scalar ``rng.choice`` loop (and the probability *vectors* are equal to
  the scalar ``ModiPick._probs`` output to float precision).

Deterministic policies (static/dynamic greedy, related-accurate) are
bit-identical to their scalar loops, including tie-breaking order.

Backends
--------
``select_batch(..., backend=...)`` accepts:

- ``"numpy"`` — the reference implementation, always available;
- a torch device name, ``"cuda"`` or ``"cpu"`` — ModiPick's stages 1–3
  and the draw run device-resident on that device
  (``repro_torch.kernels.policy_select``): one hand-written kernel
  launch on ``cuda`` (``fused_select``; the stage-3 kernel
  ``modipick_probs`` for detailed traces), their plain PyTorch versions
  on ``cpu``;
- ``"auto"``/``None`` — numpy below ``DEVICE_MIN_BATCH`` requests,
  ``cuda`` at or above it when a card is present (only for ModiPick —
  everything else is pure masked argmax/argmin, which numpy already does
  at memory bandwidth).

``REPRO_TORCH_POLICY_BACKEND`` (env) overrides the default for a whole
run — set ``numpy`` to force the reference path, ``cuda`` to force the
kernel.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.policy import (EPS, DynamicGreedy, ModiPick, Policy,
                                     PureRandom, RelatedAccurate,
                                     RelatedRandom, SelectionTrace,
                                     StaticGreedy)
from repro_torch.core.profiles import ProfileStore, ProfileTable

# Batch size at which ModiPick's selection (and the Router's charged
# pass) moves to the device.  The value is the reference's CPU-XLA
# crossover; the card's crossover is measured by ``chip_smoke.py``'s
# ``[crossover]`` phase (PERF.md §7) but the value is kept, so that
# ``auto`` takes the same structure as the reference's.
DEVICE_MIN_BATCH = 4096

DEVICE_BACKENDS = ("cuda", "cpu")
VALID_BACKENDS = ("auto", "numpy") + DEVICE_BACKENDS


def _as_table(store: Union[ProfileStore, ProfileTable]) -> ProfileTable:
    return store if isinstance(store, ProfileTable) else store.table()


def _resolve_backend(backend: Optional[str], n_batch: int) -> str:
    if backend is None:
        env = os.environ.get("REPRO_TORCH_POLICY_BACKEND")
        if env and env not in VALID_BACKENDS:
            raise ValueError(
                f"REPRO_TORCH_POLICY_BACKEND={env!r} is not a recognised "
                f"policy backend; valid values: {', '.join(VALID_BACKENDS)}")
        backend = env or "auto"
    elif backend not in VALID_BACKENDS:
        raise ValueError(f"unknown policy backend {backend!r}; "
                         f"valid values: {', '.join(VALID_BACKENDS)}")
    if backend == "auto":
        if n_batch >= DEVICE_MIN_BATCH and torch.cuda.is_available():
            return "cuda"
        return "numpy"
    return backend


def resolve_backend(backend: Optional[str], n_batch: int) -> str:
    """Public backend resolution (``auto``/env/threshold → ``numpy`` or a
    device) — the Router uses it to decide whether a charged batch would
    ride the device-resident charged pass under the same policy as the
    uncharged fused pipeline."""
    return _resolve_backend(backend, n_batch)


def selection_device(backend: Optional[str], n_batch: int) -> str:
    """The device a selection with no numpy path runs on under
    ``backend``: ``cuda`` or ``cpu`` where the backend resolves to
    one, ``cpu`` (the kernel's plain version) where it resolves to
    ``numpy``, ``auto`` below ``DEVICE_MIN_BATCH`` included.  Premodel's
    classed selection and the fleet's stacked selection follow it: the
    reference runs their device function at every batch size."""
    resolved = _resolve_backend(backend, n_batch)
    return resolved if resolved in DEVICE_BACKENDS else "cpu"


# ----------------------------------------------------------------------
# stages 1–2: masked argmax + broadcast window membership (numpy)
# ----------------------------------------------------------------------

def modipick_masks(tab: ProfileTable, t_u: np.ndarray, t_l: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched stages 1–2.

    Returns ``(base, has_base, eligible, natural)`` where ``base[b]`` is
    the stage-1 pick's pool index (undefined where ``~has_base``),
    ``eligible`` is the (B, n) stage-2 membership matrix with the base
    forced in, and ``natural`` is the same matrix *before* forcing (the
    scalar path appends an out-of-window base at the end of its eligible
    list, which matters for deterministic tie-breaking)."""
    mu, sigma = tab.mu, tab.sigma
    order = tab.acc_order
    B = len(t_u)
    # Eq. 2 eligibility over the pool in accuracy order; argmax finds the
    # first True per row = most accurate feasible base.
    mu_o, sig_o = mu[order], sigma[order]
    elig1 = ((mu_o + sig_o)[None, :] < t_u[:, None]) \
        & ((mu_o - sig_o)[None, :] < t_l[:, None])
    has_base = elig1.any(axis=1)
    base = order[elig1.argmax(axis=1)]
    base[~has_base] = tab.fastest  # placeholder; masked by has_base

    # stage 2: window [T_L - half, T_L + half] around each row's base.
    half = np.abs(t_l - mu[base]) + sigma[base]
    lo, hi = t_l - half, t_l + half
    natural = (lo[:, None] <= mu[None, :]) & (mu[None, :] <= hi[:, None]) \
        & ((mu + sigma)[None, :] < t_u[:, None])
    eligible = natural.copy()
    eligible[np.arange(B), base] = True  # base always eligible
    eligible &= has_base[:, None]
    return base, has_base, eligible, natural


# ----------------------------------------------------------------------
# stage 3: batched Eq. 3–4 utilities → per-request probability vectors
# ----------------------------------------------------------------------

def modipick_probs(tab: ProfileTable, t_u: np.ndarray, t_l: np.ndarray,
                   eligible: np.ndarray, gamma: float) -> np.ndarray:
    """(B, n) probability matrix over the pool; zero where ineligible.
    Rows with no eligible models (fallback rows) come back all-zero."""
    num = t_u[:, None] - (tab.mu + tab.sigma)[None, :]
    den = np.maximum(np.abs(t_l[:, None] - tab.mu[None, :]), EPS)
    u = np.maximum(tab.accuracy, EPS)[None, :] ** gamma * num / den
    u = np.where(eligible, u, 0.0)
    total = u.sum(axis=1)
    counts = eligible.sum(axis=1)
    # Scalar-path degenerate case: non-finite or non-positive mass →
    # uniform over the eligible set.
    bad = (~np.isfinite(total)) | (total <= 0)
    safe = np.where(bad | (counts == 0), 1.0, total)
    probs = np.where(bad[:, None],
                     eligible / np.maximum(counts, 1)[:, None],
                     u / safe[:, None])
    return probs


def gumbel_top1(probs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Sample one index per row from each row's probability vector via
    argmax(log p + Gumbel) — exact categorical sampling, one vectorized
    draw for the whole batch."""
    g = rng.gumbel(size=probs.shape)
    with np.errstate(divide="ignore"):
        logits = np.where(probs > 0, np.log(probs), -np.inf)
    return np.argmax(logits + g, axis=1)


# ----------------------------------------------------------------------
# per-policy batched selection
# ----------------------------------------------------------------------

def _modipick_batch(policy: ModiPick, tab: ProfileTable,
                    t_budgets: np.ndarray, rng: np.random.Generator,
                    backend: str, need_stages: bool = True):
    """Returns ``(idx, has_base, base, eligible, probs)``.

    On a device backend with ``need_stages=False`` the whole pipeline —
    stages 1–2 masks, stage-3 utilities and the categorical draw — runs
    device-resident (``kernels.policy_select.select_fused``) and
    ``base``/``eligible``/``probs`` come back None: nothing but the
    budget rows crosses to the device and nothing but the sampled
    indices crosses back.  ``need_stages=True`` (detailed traces) keeps
    the host mask path; ``probs`` is None whenever the device samples
    without materialising the probability matrix host-side."""
    t_u = t_budgets
    t_l = t_u - policy.t_threshold
    if backend in DEVICE_BACKENDS and not need_stages:
        from repro_torch.kernels import policy_select
        idx, has_base = policy_select.select_fused(
            tab.device_pool(backend), t_u, t_l, gamma=policy.gamma,
            seed=int(rng.integers(np.iinfo(np.int64).max)))
        return idx, has_base, None, None, None
    base, has_base, eligible, _ = modipick_masks(tab, t_u, t_l)
    probs = None
    if backend in DEVICE_BACKENDS:
        from repro_torch.kernels import policy_select
        choice = policy_select.sample_batch(
            tab.mu, tab.sigma, tab.accuracy, t_u, t_l, eligible,
            gamma=policy.gamma,
            seed=int(rng.integers(np.iinfo(np.int64).max)),
            device=backend)
    else:
        probs = modipick_probs(tab, t_u, t_l, eligible, policy.gamma)
        choice = gumbel_top1(probs, rng)
    return np.where(has_base, choice, tab.fastest), has_base, base, \
        eligible, probs


def _related_random_batch(policy: RelatedRandom, tab: ProfileTable,
                          t_budgets: np.ndarray,
                          rng: np.random.Generator):
    t_u = t_budgets
    t_l = t_u - policy.t_threshold
    base, has_base, eligible, _ = modipick_masks(tab, t_u, t_l)
    g = rng.gumbel(size=eligible.shape)
    choice = np.argmax(np.where(eligible, g, -np.inf), axis=1)
    return np.where(has_base, choice, tab.fastest), has_base, base, eligible


def _related_accurate_batch(policy: RelatedAccurate, tab: ProfileTable,
                            t_budgets: np.ndarray):
    t_u = t_budgets
    t_l = t_u - policy.t_threshold
    base, has_base, eligible, natural = modipick_masks(tab, t_u, t_l)
    n = len(tab)
    B = len(t_u)
    # Scalar tie-break: max() keeps the *first* max of the eligible list,
    # which is pool order — except an out-of-window base is appended last.
    rank = np.broadcast_to(np.arange(n), (B, n)).copy()
    forced = ~natural[np.arange(B), base]
    rank[np.arange(B), base] = np.where(forced, n, base)
    acc = np.where(eligible, tab.accuracy[None, :], -np.inf)
    best = acc.max(axis=1)
    cand = eligible & (acc == best[:, None])
    choice = np.argmin(np.where(cand, rank, n + 1), axis=1)
    return np.where(has_base, choice, tab.fastest), has_base, base, eligible


def _dynamic_greedy_batch(tab: ProfileTable, t_budgets: np.ndarray):
    order = tab.acc_order
    elig = tab.mu[None, order] <= t_budgets[:, None]
    has = elig.any(axis=1)
    return np.where(has, order[elig.argmax(axis=1)], tab.fastest), has


def select_batch(policy: Policy, store: Union[ProfileStore, ProfileTable],
                 t_budgets: Sequence[float], rng: np.random.Generator, *,
                 backend: Optional[str] = None) -> List[str]:
    """Batched ``policy.select`` over ``t_budgets`` → list of model names.

    Deterministic policies return exactly what B scalar ``select`` calls
    would; ModiPick/RelatedRandom sample from the identical per-request
    distributions in one vectorized draw (so individual picks differ from
    the sequential RNG stream, but their law does not).
    """
    tab = _as_table(store)
    t = np.asarray(t_budgets, dtype=np.float64)
    if t.ndim != 1:
        raise ValueError("t_budgets must be one-dimensional")
    backend = _resolve_backend(backend, len(t))
    if len(t) == 1 and isinstance(store, ProfileStore):
        # A batch of one IS a scalar selection, whatever the (already
        # validated) backend says — backends shape batches of two or
        # more; the Router routes singletons the same way.  ModiPick
        # rides the lean scalar core (identical picks and RNG stream to
        # ``select_traced``, minus the trace materialisation); stochastic
        # policies therefore consume the scalar RNG pattern here, not
        # the batched one — same law, different stream, exactly like the
        # Router's singleton path.
        if type(policy) is ModiPick:
            return [policy.select_lean(store, float(t[0]), rng).chosen]
        return [policy.select(store, float(t[0]), rng)]

    # Exact-type dispatch: a subclass may override any stage, so only
    # the classes implemented here take the batched path — everything
    # else falls back to the (always-correct) scalar loop.
    kind = type(policy)
    if kind is RelatedRandom:
        idx = _related_random_batch(policy, tab, t, rng)[0]
    elif kind is RelatedAccurate:
        idx = _related_accurate_batch(policy, tab, t)[0]
    elif kind is ModiPick:
        idx = _modipick_batch(policy, tab, t, rng, backend,
                              need_stages=False)[0]
    elif kind is DynamicGreedy:
        idx = _dynamic_greedy_batch(tab, t)[0]
    elif kind is StaticGreedy:
        idx = np.full(len(t), tab.index[_static_greedy_pick(
            policy, store, tab, t, rng)])
    elif kind is PureRandom:
        idx = rng.integers(len(tab), size=len(t))
    else:
        if isinstance(store, ProfileTable):
            raise TypeError(f"no batched implementation for {policy!r} "
                            "and a bare ProfileTable cannot drive the "
                            "scalar path")
        return [policy.select(store, float(b), rng) for b in t]
    return [tab.names[int(i)] for i in idx]


def _static_greedy_pick(policy: StaticGreedy,
                        store: Union[ProfileStore, ProfileTable],
                        tab: ProfileTable, t: np.ndarray,
                        rng: np.random.Generator) -> str:
    if isinstance(store, ProfileTable):
        # No live store to freeze against: honour an existing frozen
        # pick, else derive the dev-time choice from the snapshot
        # (without thawing the policy's own state).
        name = policy._frozen
        if name is None or name not in tab.index:
            name = policy.freeze_pick(tab)
        return name
    return policy.select_traced(store, t[0] if len(t) else 0.0, rng).chosen


def _exploration_traces(tab: ProfileTable, idx, has_base, base, eligible,
                        probs, detail: bool) -> List[SelectionTrace]:
    """Assemble per-request traces from the batched stage outputs.
    Eligible sets (and their probability vectors) are reported in pool
    order — the scalar path appends an out-of-window base at the *end*
    of its list instead, but the set and per-model probabilities are
    identical.  ``detail=False`` skips the per-request eligible/probs
    tuple materialization (chosen + fallback only) — the hot-path mode
    for callers that don't consume the stage decomposition."""
    fastest = tab.names[tab.fastest]
    if not detail:
        return [SelectionTrace(chosen=tab.names[int(i)], fallback=not h)
                for i, h in zip(idx, has_base)]
    traces = []
    for b in range(len(idx)):
        if not has_base[b]:
            traces.append(SelectionTrace(chosen=fastest, fallback=True))
            continue
        members = np.flatnonzero(eligible[b])
        traces.append(SelectionTrace(
            chosen=tab.names[int(idx[b])],
            base=tab.names[int(base[b])],
            eligible=tuple(tab.names[int(i)] for i in members),
            probs=(tuple(float(p) for p in probs[b, members])
                   if probs is not None else ())))
    return traces


def select_batch_traced(policy: Policy,
                        store: Union[ProfileStore, ProfileTable],
                        t_budgets: Sequence[float],
                        rng: np.random.Generator, *,
                        backend: Optional[str] = None,
                        detail: bool = True) -> List[SelectionTrace]:
    """Batched ``policy.select_traced``: one :class:`SelectionTrace` per
    budget, produced by the same batched stages as :func:`select_batch`
    (identical picks for identical ``rng`` state).  ModiPick-family
    traces carry base/eligible/probs (probs only on the numpy backend);
    greedy traces carry the fallback flag.  ``detail=False`` returns
    chosen + fallback only — same picks, no per-request stage-tuple
    materialization (the event-loop hot path).
    """
    tab = _as_table(store)
    t = np.asarray(t_budgets, dtype=np.float64)
    if t.ndim != 1:
        raise ValueError("t_budgets must be one-dimensional")
    if not len(t):
        return []
    backend = _resolve_backend(backend, len(t))

    kind = type(policy)
    if kind is ModiPick:
        idx, has_base, base, eligible, probs = _modipick_batch(
            policy, tab, t, rng, backend, need_stages=detail)
        return _exploration_traces(tab, idx, has_base, base, eligible,
                                   probs, detail)
    if kind is RelatedRandom:
        idx, has_base, base, eligible = _related_random_batch(
            policy, tab, t, rng)
        return _exploration_traces(tab, idx, has_base, base, eligible,
                                   None, detail)
    if kind is RelatedAccurate:
        idx, has_base, base, eligible = _related_accurate_batch(
            policy, tab, t)
        return _exploration_traces(tab, idx, has_base, base, eligible,
                                   None, detail)
    if kind is DynamicGreedy:
        idx, has = _dynamic_greedy_batch(tab, t)
        return [SelectionTrace(chosen=tab.names[int(i)], fallback=not h)
                for i, h in zip(idx, has)]
    if kind is StaticGreedy:
        name = _static_greedy_pick(policy, store, tab, t, rng)
        return [SelectionTrace(chosen=name) for _ in t]
    if kind is PureRandom:
        picks = rng.integers(len(tab), size=len(t))
        return [SelectionTrace(chosen=tab.names[int(i)]) for i in picks]
    if isinstance(store, ProfileTable):
        raise TypeError(f"no batched implementation for {policy!r} and a "
                        "bare ProfileTable cannot drive the scalar path")
    return [policy.select_traced(store, float(b), rng) for b in t]
