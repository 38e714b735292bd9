"""Spans at the port's layer boundaries, on the profiler's clock.

A span names one layer's share of a request or a training step:

    with obs.span("variant.run"):
        ...

Spans are off until :func:`enable`.  Off, :func:`span` returns one
shared no-op context: it allocates nothing, reads no clock and enters no
``record_function``, so a span site costs one flag test.  On, a span

- records ``(name, start, end, parent, root)`` in memory
  (:class:`Record`, read with :func:`records`); the root is the
  enclosing ``executor.request`` or ``train.step``, and its identifier
  (the request id or the step index) is the record's ``root``;
- enters ``torch.profiler.record_function(name)``, so a running
  profiler holds the span beside the card's kernels;
- where the call site passes a CUDA ``device``, records a CUDA event at
  its start and its end on that device's current stream
  (:meth:`Record.device_ms`): the phase's time on the card, without a
  profiler.

Timestamps are epoch nanoseconds (``time.time_ns``), the clock the
profiler reports its events on (``start_ns()`` of a ``record_function``
event), so the in-memory spans and a device trace share one timeline.
A span's record starts just before the profiler's event and ends just
after it.  Spans are recorded from one thread.

There is nothing else to set: the profiler's trace, or the in-memory
list, is what an operator reads.  ``SPANS`` names every span the port
opens, and where.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import List, Optional

SPANS = (
    "executor.request",   # serving/executor.py PoolExecutor.execute (root)
    "router.route",       # the Router.route call in execute
    "policy.select",      # router.py _route_scalar: the policy's select
    "policy.base",        # core/policy.py ModiPick, stage 1 (Eq. 2)
    "policy.window",      # stage 2: the exploration window
    "policy.draw",        # stage 3: Eq. 3-4 utilities and the draw
    "variant.run",        # serving/pool.py Variant.run
    "variant.upload",     # the tokens to the device
    "model.prefill",      # models/model.py prefill (device events)
    "model.decode",       # one decode_step and its argmax (device events)
    "variant.sync",       # the host's wait for the card
    "profiles.observe",   # the EWMA profile update in execute
    "train.step",         # training/loop.py TrainLoop.run, one step (root)
    "train.batch",        # the batch to the device
    "train.sync",         # the host's waits for the card and the metrics
    "train.grads",        # training/train_step.py loss_and_grads
    "train.optimizer",    # adamw_update
    "kernels.build",      # kernels/build.py: nvcc compiling a library
)
ROOTS = ("executor.request", "train.step")

_on = False
_records: List["Record"] = []
_stack: List["Record"] = []
_OFF = nullcontext()


class Record:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (epoch ns),
    ``parent`` (the index in :func:`records` of the enclosing span, or
    None), ``root`` (the identifier of the enclosing root span, or
    None)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "events",
                 "index")

    def __init__(self, name: str, parent: Optional[int], root):
        self.name, self.parent, self.root = name, parent, root
        self.start_ns = self.end_ns = self.index = 0
        self.events = None

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> Optional[float]:
        """Device ms from the span's start event to its end event (waits
        for the end event); None for a span without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Span:
    __slots__ = ("name", "ident", "stream", "rec", "rf")

    def __init__(self, name: str, ident, device):
        if name not in SPANS:
            raise ValueError(f"no span {name!r} in obs.SPANS")
        self.name, self.ident, self.stream = name, ident, None
        if device is not None and device.type == "cuda":
            import torch
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self) -> Record:
        from torch.profiler import record_function
        parent = _stack[-1] if _stack else None
        root = (self.ident if self.name in ROOTS
                else parent.root if parent is not None else None)
        rec = self.rec = Record(
            self.name, None if parent is None else parent.index, root)
        rec.index = len(_records)
        _records.append(rec)
        _stack.append(rec)
        rec.start_ns = time.time_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if self.stream is not None:
            import torch
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _stack.pop()
        return False


def span(name: str, ident=None, device=None):
    """A context for span ``name`` (one of ``SPANS``).  ``ident`` is a
    root span's identifier; ``device`` (a ``torch.device``) asks for
    CUDA events when it is a card.  Off, the shared no-op context."""
    if not _on:
        return _OFF
    return _Span(name, ident, device)


def enable() -> None:
    """Spans on, into a new in-memory list."""
    global _on, _records
    _records = []
    _stack.clear()
    _on = True


def disable() -> None:
    """Spans off; the list stays readable until the next :func:`enable`."""
    global _on
    _on = False


def records() -> List[Record]:
    """The spans recorded since the last :func:`enable`, in the order
    they were entered."""
    return list(_records)
