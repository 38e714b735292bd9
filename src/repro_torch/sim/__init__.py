"""Discrete-event serving simulation for ModiPick at production scale.

The paper (ModiPick: SLA-aware Accuracy Optimization For Mobile Deep
Inference) evaluates model selection with a single-request closed loop
(§4).  This package generalises that loop into an event-driven serving
simulator — concurrent traffic, FIFO queues, heterogeneous replicas —
so selection can be studied in the regime where queueing delay, not
network jitter, dominates latency variability.

Paper-section → code map:

- §3.1 mobile inference lifecycle (uplink → inference → downlink):
  ``engine.ServingSimulator`` request lifecycle events
  (``events.ARRIVAL/ENQUEUE/FINISH/DEPART``), plus the FIFO-wait stage
  the paper's single-request loop cannot express.
- §3.2 Eq. 1 budget ``T_sla - 2*T_input``: ``core.policy.budget``;
  the queue-aware generalisation ``T_sla - 2*T_input - W_queue(m)`` is
  ``repro_torch.router.queueaware``.
- §3.3 three-stage selection + EWMA profiles + cold-model refresh:
  unchanged in ``core.policy`` / ``core.profiles``; the engine feeds
  observed inference latency and queue waits back into the store.
- Request routing — admission, budget math, selection — is the unified
  ``repro_torch.router.Router``; the engine groups same-timestamp ENQUEUEs
  (plus an optional lookahead window) into one ``route_batch_arrays``
  call with intra-batch load charging (``router.charging``).
- §4 closed-loop evaluation: ``arrivals.ClosedLoopArrivals`` over a
  single shared replica — ``core.simulate.Simulator`` is now a thin
  wrapper that replays the paper's loop draw-for-draw.
- Beyond-paper: ``arrivals.PoissonArrivals`` / ``TraceArrivals`` open
  loops, ``replica.per_model_replicas`` (endpoint-per-model topology),
  admission control via ``Replica.max_queue_depth``, and
  ``engine.rate_sweep`` for SLA-attainment-vs-load curves
  (``benchmarks/load_sweep.py``).
"""
from repro_torch.router.queueaware import (QueueAwareSelector, queue_aware_budget,
                                     shifted_store)
from repro_torch.sim.arrivals import (ArrivalProcess, ClosedLoopArrivals,
                                PoissonArrivals, TraceArrivals, burst_trace,
                                diurnal_trace)
from repro_torch.sim.elastic import (CONTROLLER_KINDS, ControlReading,
                               ElasticConfig, make_controller)
from repro_torch.sim.engine import (LoadSimResult, ServingSimulator, SimRequest,
                              rate_sweep)
from repro_torch.sim.events import (ARRIVAL, CONTROL, DEPART, ENQUEUE, FAULT,
                              FINISH, PROVISION, EventQueue)
from repro_torch.sim.faults import (FaultEvent, LatencyDrift, NetworkDrift,
                              ReplicaFault, schedule_faults)
from repro_torch.sim.replica import (DEGRADED, DOWN, DRAINING, HEALTH_STATES, UP,
                               WARMING, GaussianServiceModel, Replica,
                               ReplicaPool, per_model_replicas,
                               shared_replicas)

__all__ = [
    "ArrivalProcess", "ClosedLoopArrivals", "PoissonArrivals",
    "TraceArrivals", "burst_trace", "diurnal_trace", "LoadSimResult",
    "ServingSimulator", "SimRequest",
    "rate_sweep", "ARRIVAL", "CONTROL", "DEPART", "ENQUEUE", "FAULT",
    "FINISH", "PROVISION", "EventQueue",
    "FaultEvent", "LatencyDrift", "NetworkDrift", "ReplicaFault",
    "schedule_faults",
    "QueueAwareSelector", "queue_aware_budget", "shifted_store",
    "GaussianServiceModel", "Replica", "ReplicaPool", "per_model_replicas",
    "shared_replicas",
    "UP", "DEGRADED", "WARMING", "DRAINING", "DOWN", "HEALTH_STATES",
    "CONTROLLER_KINDS", "ControlReading", "ElasticConfig",
    "make_controller",
]
