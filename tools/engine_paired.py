#!/usr/bin/env python3
"""Time the discrete-event engine's charged ``batched`` run on the card.

    PYTHONPATH=<tree>/src python3 tools/engine_paired.py [--n 100000] [--label NAME]

The run is the reference engine benchmark's ``batched`` configuration
(``benchmarks/engine_throughput.py``): Table 2's 11 models over 4
replicas each, queue-aware, a zero-jitter 50 ms uplink, SLA 250 ms, the
requests in 200-wide simultaneous bursts every 400 ms, each burst one
charged selection launch on ``backend="cuda"``.  A short run first
builds and warms the kernels, then the timed run.  ``repro_torch`` is
imported from the path the caller gives, so that two trees of the port
can be timed in turns on one card, in one command.

Prints one JSON line: the label, requests/s, events/s, wall seconds,
SLA attainment, mean accuracy, the charged kernel's launches, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def run(n: int):
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.core.zoo import TABLE2
    from repro_torch.kernels import ops
    from repro_torch.sim import (ServingSimulator, TraceArrivals,
                                 per_model_replicas)
    eng = ServingSimulator(
        TABLE2, NetworkModel(50.0, 0.0),
        per_model_replicas(TABLE2, replicas_per_model=4), seed=3,
        queue_aware=True, backend="cuda", charge_batches=True)
    times = np.repeat(np.arange(-(-n // 200)) * 400.0, 200)[:n]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(ModiPick(t_threshold=20.0), 250.0, n,
                  arrivals=TraceArrivals(times))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, ops.launch_counts()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_paired: no CUDA device", file=sys.stderr)
        return 1
    run(2_000)
    res, wall, counts = run(a.n)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    events = 4 * res.n_completed + 2 * res.n_rejected
    print(json.dumps({
        "label": a.label, "requests_per_s": res.n_arrived / wall,
        "events_per_s": events / wall, "wall_s": wall,
        "sla_attainment": res.sla_attainment,
        "mean_accuracy": res.mean_accuracy,
        "charged_launches": counts["charged_select"], "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
