"""Arrival processes for the serving simulator.

Three regimes:

- ``ClosedLoopArrivals``: one outstanding request; the next request is
  issued when the previous response departs (plus optional think time).
  This is the paper's §4 evaluation loop — ``core/simulate.py`` is the
  single-replica instance of the engine driven by this process.
- ``PoissonArrivals``: open-loop memoryless traffic at a target rate —
  the production regime where queueing delay appears (MDInference's
  dominant latency source).
- ``TraceArrivals``: replay an explicit list of arrival timestamps
  (e.g. from a production trace or a synthetic burst pattern).

Open-loop processes chain: handling arrival *i* schedules arrival
*i+1*.  Closed-loop chains off request departure instead, so it never
draws from the RNG and preserves the exact draw order of the original
closed loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


class ArrivalProcess:
    closed_loop: bool = False

    def first(self, rng: np.random.Generator) -> float:
        """Time of the first arrival (ms)."""
        return 0.0

    def next_after(self, rng: np.random.Generator, t: float,
                   n_issued: int) -> Optional[float]:
        """Time of the next arrival given the previous chain point ``t``
        (the previous *arrival* for open-loop, the previous *departure*
        for closed-loop).  ``None`` means the process is exhausted."""
        raise NotImplementedError


@dataclass
class ClosedLoopArrivals(ArrivalProcess):
    """Sequential issue: next request when the previous one departs."""
    think_ms: float = 0.0

    def __post_init__(self):
        self.closed_loop = True

    def next_after(self, rng, t, n_issued):
        return t + self.think_ms


@dataclass
class PoissonArrivals(ArrivalProcess):
    """Open-loop Poisson traffic at ``rate_rps`` requests per second."""
    rate_rps: float

    def __post_init__(self):
        assert self.rate_rps > 0.0
        self._gap_ms = 1000.0 / self.rate_rps

    def first(self, rng):
        return float(rng.exponential(self._gap_ms))

    def next_after(self, rng, t, n_issued):
        return t + float(rng.exponential(self._gap_ms))


@dataclass
class TraceArrivals(ArrivalProcess):
    """Replay explicit arrival timestamps (ms, non-decreasing).

    Timestamps are validated at construction — finite, non-negative and
    sorted — so a malformed trace fails loudly here instead of silently
    producing negative inter-arrivals (events scheduled in the past)
    deep inside the event loop.  Duplicate timestamps are legal: they
    model simultaneous arrivals.  Note the engine batches *ENQUEUE*
    events (arrival + sampled uplink), so duplicates reach one
    ``route_batch`` call only over a zero-jitter network — under jitter,
    set ``batch_window_ms`` to at least the uplink spread to group them.
    """
    times_ms: Sequence[float]

    def __post_init__(self):
        times = np.asarray(self.times_ms, dtype=np.float64)
        if times.size == 0:
            raise ValueError("TraceArrivals needs at least one timestamp")
        if not np.isfinite(times).all():
            raise ValueError("TraceArrivals timestamps must be finite "
                             "(got NaN or inf)")
        if times[0] < 0.0:
            raise ValueError("TraceArrivals timestamps must be "
                             f"non-negative (first is {times[0]!r})")
        gaps = np.diff(times)
        if gaps.size and gaps.min() < 0.0:
            i = int(np.argmin(gaps)) + 1
            raise ValueError(
                "TraceArrivals timestamps must be sorted ascending: "
                f"times_ms[{i}]={times[i]!r} < times_ms[{i-1}]={times[i-1]!r}")

    def first(self, rng):
        return float(self.times_ms[0])

    def next_after(self, rng, t, n_issued):
        if n_issued >= len(self.times_ms):
            return None
        return float(self.times_ms[n_issued])

    def __len__(self) -> int:
        return len(self.times_ms)


# ----------------------------------------------------------------------
# Trace synthesizers: non-homogeneous Poisson processes rendered to
# explicit timestamps (so they replay through ``TraceArrivals`` and its
# construction-time validation).  Both use Lewis–Shedler thinning:
# candidate arrivals are drawn at the peak rate and kept with
# probability rate(t)/rate_peak, which is exact for any bounded rate
# function.  Deterministic given ``seed``.
# ----------------------------------------------------------------------

def _thin(n: int, rate_peak_rps: float, rate_at, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    gap_ms = 1000.0 / rate_peak_rps
    out = np.empty(n, dtype=np.float64)
    t, k = 0.0, 0
    while k < n:
        t += float(rng.exponential(gap_ms))
        if rng.random() * rate_peak_rps <= rate_at(t):
            out[k] = t
            k += 1
    return out


def diurnal_trace(n: int, base_rate_rps: float, *,
                  period_ms: float = 60_000.0, amplitude: float = 0.8,
                  phase: float = 0.0, seed: int = 0) -> TraceArrivals:
    """Sinusoidal day/night load: ``rate(t) = base · (1 + amplitude ·
    sin(2πt/period + phase))``.  ``amplitude ∈ [0, 1)`` keeps the rate
    positive; one ``period_ms`` is one synthetic "day"."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    if base_rate_rps <= 0.0 or period_ms <= 0.0:
        raise ValueError("base_rate_rps and period_ms must be positive")
    rate = lambda t: base_rate_rps * (
        1.0 + amplitude * np.sin(2.0 * np.pi * t / period_ms + phase))
    return TraceArrivals(_thin(n, base_rate_rps * (1.0 + amplitude),
                               rate, seed))


def rate_trace_arrivals(counts, *, n: int, rate_rps: float,
                        period_ms: float = 86_400_000.0,
                        phase: float = 0.0, seed: int = 0) -> TraceArrivals:
    """Replay a *rate* trace (per-interval request counts — the shape
    Azure Functions publishes) as explicit arrival timestamps.

    ``counts`` (K,) is normalized to a piecewise-constant rate profile
    over one cyclic ``period_ms`` "day" scaled so the *mean* rate is
    ``rate_rps``, then thinned (Lewis–Shedler, like the synthesizers)
    into ``n`` timestamps.  ``phase`` ∈ [0, 1) rotates the profile by a
    fraction of the day — the fleet's time-zone offset: the same real
    trace shape peaks at a different simulated hour in every cell.
    Deterministic given ``seed``."""
    c = np.asarray(counts, dtype=np.float64)
    if c.ndim != 1 or c.size < 2:
        raise ValueError("rate trace needs a 1-D array of >= 2 counts")
    if not np.isfinite(c).all() or (c < 0).any():
        raise ValueError("rate-trace counts must be finite and >= 0")
    if c.sum() <= 0.0:
        raise ValueError("rate trace is all-zero")
    if not 0.0 <= phase < 1.0:
        raise ValueError(f"phase must be in [0, 1), got {phase}")
    if rate_rps <= 0.0 or period_ms <= 0.0 or n <= 0:
        raise ValueError("need rate_rps > 0, period_ms > 0, n > 0")
    shape = c / c.mean()                  # mean-1 profile
    K = shape.size
    off = phase * K

    def rate(t):
        k = int((t / period_ms * K + off) % K)
        return rate_rps * shape[k]

    return TraceArrivals(_thin(n, rate_rps * float(shape.max()),
                               rate, seed))


def load_rate_counts(path) -> np.ndarray:
    """Parse a rate trace file into per-interval counts.

    Accepted shapes (all real-world-trace friendly):

    - **Azure-Functions CSV**: header rows with hash/trigger columns
      followed by per-minute count columns ``1..1440`` — counts are
      summed across functions per minute;
    - **two-column CSV** ``interval,count`` (header optional);
    - **one-column CSV**: one count per line;
    - **JSON**: ``{"counts": [...]}`` or a bare list.
    """
    import json as _json
    p = str(path)
    if p.endswith(".json"):
        with open(p, "r", encoding="utf-8") as f:
            d = _json.load(f)
        return np.asarray(d["counts"] if isinstance(d, dict) else d,
                          dtype=np.float64)
    import csv
    with open(p, "r", encoding="utf-8", newline="") as f:
        rows = [r for r in csv.reader(f) if r and any(x.strip() for x in r)]
    if not rows:
        raise ValueError(f"empty rate trace file: {p}")

    def _num(x):
        try:
            return float(x)
        except ValueError:
            return None

    header = [_num(x) for x in rows[0]]
    if any(v is None for v in header):
        # Header row: Azure format when >= 2 numeric-named columns
        # (the per-minute "1".."1440" axis); else "interval,count".
        minute_cols = [i for i, v in enumerate(header) if v is not None]
        if len(minute_cols) >= 2:
            body = rows[1:]
            out = np.zeros(len(minute_cols), dtype=np.float64)
            for r in body:
                for j, i in enumerate(minute_cols):
                    v = _num(r[i]) if i < len(r) else None
                    out[j] += v if v is not None else 0.0
            return out
        rows = rows[1:]
        if not rows:
            raise ValueError(f"rate trace {p} has a header but no data")
    if len(rows[0]) >= 2:
        return np.asarray([float(r[1]) for r in rows], dtype=np.float64)
    return np.asarray([float(r[0]) for r in rows], dtype=np.float64)


def load_trace(path, *, n: int, rate_rps: float,
               period_ms: float = 86_400_000.0, phase: float = 0.0,
               seed: int = 0) -> TraceArrivals:
    """Real-trace replay: parse an Azure-Functions-style CSV/JSON rate
    trace (``load_rate_counts``) and render it to ``n`` arrival
    timestamps at mean ``rate_rps`` over a ``period_ms`` day
    (``rate_trace_arrivals``).  The ``fleet_diurnal`` scenario feeds
    every cell the same file with a per-cell ``phase``, so diurnal load
    rolling across time zones comes from a recorded shape instead of
    the sinusoid synthesizer."""
    return rate_trace_arrivals(load_rate_counts(path), n=n,
                               rate_rps=rate_rps, period_ms=period_ms,
                               phase=phase, seed=seed)


def burst_trace(n: int, base_rate_rps: float, *, burst_rate_rps: float,
                burst_every_ms: float = 10_000.0,
                burst_len_ms: float = 1_000.0,
                seed: int = 0) -> TraceArrivals:
    """Square-wave load: quiet traffic at ``base_rate_rps`` punctuated by
    a ``burst_len_ms`` burst at ``burst_rate_rps`` every
    ``burst_every_ms`` (the flash-crowd / retry-storm shape admission
    control is for)."""
    if base_rate_rps <= 0.0 or burst_rate_rps < base_rate_rps:
        raise ValueError("need 0 < base_rate_rps <= burst_rate_rps")
    if not 0.0 < burst_len_ms <= burst_every_ms:
        raise ValueError("need 0 < burst_len_ms <= burst_every_ms")
    rate = lambda t: (burst_rate_rps
                      if (t % burst_every_ms) < burst_len_ms
                      else base_rate_rps)
    return TraceArrivals(_thin(n, burst_rate_rps, rate, seed))
