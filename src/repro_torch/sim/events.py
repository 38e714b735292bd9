"""Discrete-event core: a time-ordered event queue with stable FIFO
tie-breaking.

Every simulation entity (arrival generator, replica, network) interacts
through this queue only; handlers never advance time themselves.  Ties
are broken by insertion order (monotonic sequence number) so runs are
bit-deterministic under a fixed seed regardless of heap internals.
"""
from __future__ import annotations

import heapq
from typing import Any, List, NamedTuple

# Event kinds (request lifecycle: uplink -> queue -> inference -> downlink).
ARRIVAL = "arrival"    # request leaves the device; uplink transfer starts
ENQUEUE = "enqueue"    # input arrived at the server; select model + queue
FINISH = "finish"      # inference finished on a replica
DEPART = "depart"      # downlink done; response reached the device
# Environment events (not tied to one request): replica lifecycle faults
# and ground-truth drift, scheduled on the same queue (``sim/faults.py``).
FAULT = "fault"
# Elastic replica lifecycle (``sim/elastic.py``): PROVISION carries both
# halves of a scale-up — ``("create", count)`` materializes replicas in
# the WARMING state, ``("ready", replica, gen)`` flips one to UP after
# its cold start (the ``gen`` token orphans readies for replicas that
# were cancelled while warming).  CONTROL is the mid-run controller
# tick, rescheduling itself every ``control_interval_ms`` while
# requests remain outstanding.
PROVISION = "provision"
CONTROL = "control"


class Event(NamedTuple):
    """Heap record.  A NamedTuple compares field-by-field in C — the
    unique ``seq`` always breaks ``time`` ties before ``kind``/``data``
    are ever reached, preserving the FIFO tie-break while keeping the
    heap's comparison off the Python bytecode path."""
    time: float
    seq: int
    kind: str
    data: Any = None


class EventQueue:
    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, data: Any = None) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind, data=data)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Event:
        """Next event without removing it (the batching lookahead)."""
        return self._heap[0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
