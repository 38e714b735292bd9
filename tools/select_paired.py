#!/usr/bin/env python3
"""Time the fused (B2) and stacked (B4) selection kernels on the card at
the main path's shapes.

    PYTHONPATH=<tree>/src python3 tools/select_paired.py [--label NAME]

Shapes: B2 on the operands of the first burst of the reference engine
benchmark's ``batched_snapshot`` run (Table 2's 11 models, 200-wide
bursts; recorded from a short run of that configuration on the card),
on a 2-model pool at B = 8192 (``select_batch``'s shape) and on a
3-model pool at B = 100,000; B4 on a premodel burst (B = 200 over K = 2
class rows of 11 models, with queue shifts) and on the fleet epochs of
6 cells of 5 models (B = 2550 a cell) and 4 cells of 11 (B = 1200 a
cell), padded lanes and all.  Beside them the card's launch floor: one empty kernel
(``torch.cuda._sleep(0)``).  Each time is the device's ms a call with
the launch queue filled ahead (a sleep kernel holds the device while the
host queues the calls), with the host's µs a call beside it.
``repro_torch`` is imported from the path the caller gives, and only
that tree's ``policy_select`` library is built, so that two trees can be
timed in turns on one card, in one command.

Prints one JSON line: the label, each shape's device ms and host µs a
call, the launch floor, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def time_call(fn, iters=200, warmup=10) -> tuple:
    """(device ms, host µs) a call: ``iters`` calls queued behind a
    sleep kernel long enough that the host never lets the device wait."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = 2 * host_s + 1e-3
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * 2e9))  # ~2 GHz SM clock
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters, host_s / iters * 1e6
        sleep_s *= 2
    raise RuntimeError("the host did not queue the calls ahead of the card")


def engine_burst():
    """The fused selection's operands on the first burst of the engine's
    ``batched_snapshot`` configuration (5 bursts run on the card)."""
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.core.zoo import TABLE2
    from repro_torch.kernels import policy_select
    from repro_torch.sim import (ServingSimulator, TraceArrivals,
                                 per_model_replicas)
    eng = ServingSimulator(
        TABLE2, NetworkModel(50.0, 0.0),
        per_model_replicas(TABLE2, replicas_per_model=4), seed=3,
        queue_aware=True, backend="cuda", charge_batches=False)
    wrapper, calls = policy_select.fused_select, []

    def record(*a, **kw):
        if not calls:
            calls.append((tuple(x.clone() for x in a), dict(kw)))
        return wrapper(*a, **kw)

    # the wrapper counts its launch on the module's name, this function
    record.launches = wrapper.launches
    policy_select.fused_select = record
    try:
        eng.run(ModiPick(t_threshold=20.0), 250.0, 1000,
                arrivals=TraceArrivals(np.repeat(np.arange(5) * 400.0, 200)))
    finally:
        policy_select.fused_select = wrapper
    return calls[0]


def fused_synthetic(n, B, seed):
    """A synthetic n-model pool and B budget rows, from a seed."""
    g = np.random.default_rng(seed)
    mu, sig, acc = g.uniform(5, 60, n), g.uniform(0, 5, n), g.uniform(
        0.3, 0.9, n)
    rank = np.argsort(np.argsort(-acc, kind="stable"))
    t_u = g.uniform(-5, 90, B)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device="cuda")
    return (f32(mu), f32(sig), f32(acc), f32(rank), f32(t_u),
            f32(t_u - 25.0), f32(g.random(B))), {}


def stacked_synthetic(form, P, n, B, seed):
    """The stacked kernel's operands: ``classed``, P class rows over one
    acc/rank with queue shifts and the fallback; ``fleet``, P cells of B
    requests each, every cell but the first narrower than n, its padded
    lanes at PAD_MU/0/1/PAD_RANK."""
    from repro_torch.kernels import policy_select
    g = np.random.default_rng(seed)
    mu, sig = g.uniform(5.0, 60.0, (P, n)), g.uniform(0.0, 5.0, (P, n))
    if form == "classed":
        acc = g.uniform(0.3, 0.9, n)
        rank = np.argsort(np.argsort(-acc, kind="stable"))
        row = g.integers(0, P, B)
    else:
        acc = g.uniform(0.3, 0.9, (P, n))
        rank = np.argsort(np.argsort(-acc, kind="stable", axis=1), axis=1)
        for c, w in enumerate(g.integers(1, n + 1, P)):
            w = n if c == 0 else w
            mu[c, w:], sig[c, w:] = policy_select.PAD_MU, 0.0
            acc[c, w:], rank[c, w:] = 1.0, policy_select.PAD_RANK
        row = np.repeat(np.arange(P), B)
        B = P * B
    t_u = g.uniform(-5.0, 120.0, B)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device="cuda")
    args = (f32(mu), f32(sig), f32(acc), f32(rank),
            torch.tensor(row, dtype=torch.int32, device="cuda"), f32(t_u),
            f32(t_u - 25.0), f32(g.random(B)))
    classed = form == "classed"
    return args, dict(shifts=f32(g.uniform(0.0, 20.0, n)) if classed
                      else None, fallback=classed)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("select_paired: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, policy_select
    build.build(("policy_select",))
    cases = {
        "fused engine burst": ("fused_select", engine_burst()),
        "fused B=8192 n=2": ("fused_select", fused_synthetic(2, 8192, 1)),
        "fused B=100000 n=3": ("fused_select",
                               fused_synthetic(3, 100_000, 2)),
        "stacked classed K=2 B=200": (
            "stacked_select", stacked_synthetic("classed", 2, 11, 200, 3)),
        "stacked fleet C=6 npad=5 B=2550 a cell": (
            "stacked_select", stacked_synthetic("fleet", 6, 5, 2550, 4)),
        "stacked fleet C=4 npad=11 B=1200 a cell": (
            "stacked_select", stacked_synthetic("fleet", 4, 11, 1200, 5))}
    out = {"label": a.label}
    floor = time_call(lambda: torch.cuda._sleep(0))
    for name, (kernel, (args, kw)) in cases.items():
        fn = getattr(policy_select, kernel)
        ms, host_us = time_call(lambda: fn(*args, **kw))
        out[name] = {"ms": ms, "host_us": host_us,
                     "B": int(args[4].shape[0]), "n": int(args[0].shape[-1])}
    out["launch floor"] = {"ms": floor[0], "host_us": floor[1]}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
