"""The traced part of a run: ``torch.profiler`` over the card and the
host, reduced to device time by kernel name, the device's busy time in
the traced window, and the idle gaps by what the host was doing.

The traced window is the span ``bench.window`` that the harness opens
and closes inside the profiler.
"""
from __future__ import annotations

import contextlib
import heapq
import re
from collections import defaultdict
from typing import Dict, List

from . import yardstick

WINDOW = "bench.window"


class Trace:
    """Device events (name, start s, end s) inside the traced window,
    host events likewise, and the window's bounds."""

    def __init__(self, device, host, w0: float, w1: float):
        self.device = device
        self.host = host
        self.w0, self.w1 = w0, w1
        self.window_s = w1 - w0
        self.busy_s = yardstick.merged_busy(
            [(max(s, w0), min(e, w1)) for _, s, e in device
             if e > w0 and s < w1])

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the events whose name matches ``pattern``
        (``re.search``)."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n))

    def device_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            tot[n[:64]] += e - s
        return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device in the window, summed by the innermost
        host event running at each gap's middle ("host.none" where
        nothing was)."""
        iv = sorted((max(s, self.w0), min(e, self.w1))
                    for _, s, e in self.device if e > self.w0 and s < self.w1)
        gaps, t = [], self.w0
        for s, e in iv:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            gaps.append((t, self.w1))
        host = sorted(self.host, key=lambda x: x[1])
        tot: Dict[str, float] = defaultdict(float)
        active: list = []   # max-heap on start: (-start, end, name)
        j = 0
        for g0, g1 in sorted(gaps):
            mid = 0.5 * (g0 + g1)
            while j < len(host) and host[j][1] <= mid:
                n, s, e = host[j]
                heapq.heappush(active, (-s, e, n))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2] if active else "host.none"
            tot[name[:64]] += g1 - g0
        return [[n, t] for n, t in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]


class Tracer:
    """Profiles the card and the host between :meth:`start` and
    :meth:`stop`, inside a ``bench.window`` span; then ``trace`` is its
    :class:`Trace`.  Disabled, both calls do nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._trace = None
        self.running = False

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self.running = True

    def stop(self) -> None:
        """Stops the profiler; the trace is read later, by
        :attr:`trace`, outside any measured window."""
        if not self.running:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.running = False

    @property
    def trace(self):
        if self._trace is None and getattr(self, "_prof", None) is not None \
                and not self.running:
            self._trace = reduce(self._prof)
            del self._prof
        return self._trace


def span(name: str, enabled: bool):
    """A host span ``name`` in the trace (a no-op context when off)."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def reduce(prof) -> Trace:
    from torch.autograd import DeviceType
    device, host = [], []
    w0 = w1 = None
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        s = (e.start_ns() - base) * 1e-9
        end = s + e.duration_ns() * 1e-9
        name = e.name()
        ua = getattr(e, "is_user_annotation", None)
        if e.device_type() != DeviceType.CPU and (
                (ua is not None and ua()) or name == WINDOW
                or name.startswith(("serve.", "train."))):
            continue    # a host span drawn on the device's timeline
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                w0, w1 = s, end
            else:
                host.append((name, s, end))
        else:
            device.append((name, s, end))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    device = [x for x in device if x[2] > w0 and x[1] < w1]
    host = [x for x in host if x[2] > w0 and x[1] < w1]
    return Trace(device, host, w0, w1)
