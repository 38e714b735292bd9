#!/usr/bin/env python3
"""Read a benchmark cell through the program's spans (``repro_torch.obs``)
on the card: where a request's or a training step's time goes, by layer.

    python3 tools/span_probe.py --workload qwen2-pool.serve --seed <n> \\
        [--seconds 51] [--out build/probe.json]
    python3 tools/span_probe.py --workload mamba2-pool.train --seed <n>

A serve cell runs as ``bench/serve.py`` runs it with ``--trace 1``: set-up,
the untraced window, then ``TRACE_REQUESTS`` requests under
``torch.profiler`` (the profiled segment), here with the spans on.  Then
``LARGEST_CALLS`` runs of the largest variant with the spans off
(``largest_ms.serve``), the same requests again with the spans on and no
profiler (the span segment), and the largest variant's runs in turns
with the spans off and on.  A training cell runs ``TrainLoop`` on the
benchmark's batches: warm steps, a window of ``--seconds`` with the spans
off, ``TRACE_STEPS`` steps under the profiler with the spans on, as many
again with the spans on alone, then blocks of steps with the spans off
and on in turns.  The cell's reference is not read: ``correct`` is the
benchmark's.

The device events of the profiled segment are put under the innermost
program span that holds their launch: the host time of the runtime call
(``cudaLaunchKernel``, ``cudaGraphLaunch``, ...) with the same
correlation id.  Prints one JSON object (and writes it to ``--out``):

- serve: ``prefill_ms`` / ``decode_ms``, the median device ms of
  ``model.prefill`` / each ``model.decode`` (CUDA events) of the span
  segment's requests to the largest variant; ``run_idle_share``, 1 − the
  median device-busy ms of the kernels launched inside that variant's
  ``variant.run`` spans (profiled) over the median wall ms of those
  spans (span segment); ``run_kernels_per_req``, device kernels launched
  inside ``variant.run`` per request (profiled);
- training: ``optimizer_ms``, device ms a step of the kernels launched
  inside ``train.optimizer`` (profiled); ``step_idle_share``, 1 − the
  device busy a step inside ``train.step`` (profiled) over the mean
  wall of ``train.step`` (span segment);
- both: each span's median wall ms (span segment), the device time by
  innermost span, the card's idle time in the profiled window by the
  innermost program or harness span at each gap's middle (``idle_by_span``)
  beside the harness's own breakdown (``idle_gaps``), and what the spans
  cost when on.
"""
from __future__ import annotations

import argparse
import bisect
import heapq
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import run as runmod  # noqa: E402
from bench import serve as bserve  # noqa: E402
from bench import train as btrain  # noqa: E402
from bench import system, trace as btrace, yardstick  # noqa: E402
from repro_torch import obs  # noqa: E402

LAUNCH = re.compile(r"^cu(da)?[A-Z]")     # a CUDA API call: cudaX or cuX
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")
HARNESS = ("serve.idle", "serve.execute")
COST_BLOCKS = 3     # blocks of steps (or runs) each with the spans off and on


def median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def memory_peak() -> int:
    return torch.cuda.max_memory_allocated() \
        if torch.cuda.is_available() else 0


# ----------------------------------------------------------------------
# The profiled segment's events
# ----------------------------------------------------------------------
class Events:
    """A profile's events in seconds from its first: device events
    (name, start, end, launch or None), host events (name, start, end),
    the window (``bench.window``) and the program's spans."""

    def __init__(self, raw, spans):
        self.spans = set(spans)
        base = min(r[1] for r in raw)
        launch = {}
        for name, s, d, dev, corr, ua in raw:
            if not dev and LAUNCH.match(name):
                t = (s - base) * 1e-9
                launch[corr] = min(t, launch.get(corr, t))
        self.device, self.host, self.dropped = [], [], 0
        self.w0 = self.w1 = None
        for name, s, d, dev, corr, ua in raw:
            t0, t1 = (s - base) * 1e-9, (s + d - base) * 1e-9
            if dev:
                if ua or name in self.spans or name == btrace.WINDOW \
                        or name.startswith(("serve.", "train.")):
                    self.dropped += 1       # a host span drawn on the card
                    continue
                self.device.append((name, t0, t1, launch.get(corr)))
            elif name == btrace.WINDOW:
                self.w0, self.w1 = t0, t1
            else:
                self.host.append((name, t0, t1))
        self.by_launch = sorted((x for x in self.device if x[3] is not None),
                                key=lambda x: x[3])
        self._keys = [x[3] for x in self.by_launch]
        self.unlaunched = len(self.device) - len(self.by_launch)

    def named(self, name):
        """(start, end) of the host events named ``name``, in order."""
        return sorted((s, e) for n, s, e in self.host if n == name)

    def launched(self, s, e, kernels_only=False):
        lo = bisect.bisect_left(self._keys, s)
        hi = bisect.bisect_right(self._keys, e)
        out = self.by_launch[lo:hi]
        if kernels_only:
            out = [x for x in out if not NOT_KERNEL.match(x[0])]
        return out

    def busy(self, evs):
        return yardstick.merged_busy([(x[1], x[2]) for x in evs])

    def innermost(self, times, names):
        """For each of the ascending ``times``, the innermost host event
        named in ``names`` that holds it (the latest-started of those
        holding it: the spans nest), or None."""
        evs = sorted((s, e, n) for n, s, e in self.host if n in names)
        out, active, j = [], [], 0     # max-heap on start: (-start, end, n)
        for t in times:
            while j < len(evs) and evs[j][0] <= t:
                heapq.heappush(active, (-evs[j][0], evs[j][1], evs[j][2]))
                j += 1
            while active and active[0][1] < t:
                heapq.heappop(active)
            out.append(active[0][2] if active else None)
        return out

    def device_by_span(self):
        out = defaultdict(float)
        under = self.innermost(self._keys, self.spans)
        for (name, s, e, _), span in zip(self.by_launch, under):
            out[span or "none"] += e - s
        return dict(sorted(out.items(), key=lambda x: -x[1]))

    def idle_by_span(self):
        iv = sorted((max(s, self.w0), min(e, self.w1))
                    for _, s, e, _ in self.device
                    if e > self.w0 and s < self.w1)
        gaps, t = [], self.w0
        for s, e in iv:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            gaps.append((t, self.w1))
        under = self.innermost([0.5 * (g0 + g1) for g0, g1 in gaps],
                               self.spans | set(HARNESS))
        out = defaultdict(float)
        for (g0, g1), span in zip(gaps, under):
            out[span or "host.none"] += g1 - g0
        return dict(sorted(out.items(), key=lambda x: -x[1]))


def probe_tracer(holder: dict):
    """``bench/trace.py``'s Tracer, with the program's spans on while it
    profiles; keeps the raw events."""

    class ProbeTracer(btrace.Tracer):
        def start(self):
            super().start()
            if self.enabled:
                obs.enable()

        def stop(self):
            if not self.running:
                return
            obs.disable()
            super().stop()
            from torch.autograd import DeviceType
            holder["raw"] = [
                (e.name(), e.start_ns(), e.duration_ns(),
                 e.device_type() != DeviceType.CPU, e.correlation_id(),
                 bool(getattr(e, "is_user_annotation", lambda: False)()))
                for e in self._prof.profiler.kineto_results.events()]
    return ProbeTracer


def span_table(recs):
    """Median wall ms, and device ms where there are events, by name."""
    wall, dev = defaultdict(list), defaultdict(list)
    for r in recs:
        wall[r.name].append(r.wall_ms)
        if r.events is not None:
            dev[r.name].append(r.device_ms())
    return {n: {"n": len(x), "wall_ms": median(x),
                **({"device_ms": median(dev[n])} if dev[n] else {})}
            for n, x in wall.items()}


def self_ms(recs, name):
    """Median of the ``name`` spans' wall minus their children's."""
    kids = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            kids[r.parent] += r.wall_ms
    return median([r.wall_ms - kids[r.index] for r in recs
                   if r.name == name])


# ----------------------------------------------------------------------
# Serve
# ----------------------------------------------------------------------
def serve(cfg, traffic, seed, seconds, device="cuda") -> dict:
    held: dict = {}
    bserve.Tracer = probe_tracer(held)
    c = bserve.Cell(cfg, traffic, seed, device, trace=True)
    ctx = c.window(seconds, t_start=T_START)
    largest = cfg["variants"][-1]["name"]
    largest_ms = c.service_ms(largest, bserve.LARGEST_CALLS)
    ev = Events(held["raw"], obs.SPANS)
    traced = ctx["traced"]
    # the span segment: the profiled segment's requests again, no profiler
    arrivals, uplinks = bserve.schedule(ctx["traffic"], seed, seconds)
    k = len(traced)
    first = len(c.ex.results)
    obs.enable()
    seg, _, _ = c._offer(arrivals[:k], uplinks[:k], ctx["prompts"][:k],
                         ctx["traffic"], SimpleNamespace(on=False, out=[]),
                         set())
    obs.disable()
    recs = obs.records()
    variant_of = {first + i: r.variant
                  for i, r in enumerate(c.ex.results[first:])}
    of_largest = [r for r in recs if variant_of.get(r.root) == largest]
    # the spans' cost: the largest variant's runs, off and on in turns
    cost = {"off": [], "on": []}
    for _ in range(COST_BLOCKS):
        for mode in ("off", "on"):
            if mode == "on":
                obs.enable()
            cost[mode] += c.service_ms(largest, bserve.LARGEST_CALLS)
            obs.disable()
    mem = memory_peak()
    c.free()

    # profiled: each request's variant from the harness's records, in order
    reqs = ev.named("executor.request")
    runs = ev.named("variant.run")
    run_var = []
    for (s, e), r in zip(reqs, traced):
        run_var += [(rs, re_, r["variant"]) for rs, re_ in runs
                    if s <= rs and re_ <= e]
    busy_largest = [1e3 * ev.busy(ev.launched(s, e))
                    for s, e, v in run_var if v == largest]
    wall_largest = [r.wall_ms for r in of_largest if r.name == "variant.run"]
    served = [r for r in traced if not r["failed"]]
    kernels = sum(len(ev.launched(s, e, kernels_only=True)) for s, e in runs)
    out = {
        "prefill_ms": median([r.device_ms() for r in of_largest
                              if r.name == "model.prefill"]),
        "decode_ms": median([r.device_ms() for r in of_largest
                             if r.name == "model.decode"]),
        "run_idle_share": (1.0 - median(busy_largest) / median(wall_largest)
                           if busy_largest and wall_largest else None),
        "run_kernels_per_req": kernels / len(served) if served else None,
        "largest_busy_ms_profiled": median(busy_largest),
        "largest_run_wall_ms_span_segment": median(wall_largest),
        "largest_ms_spans_off": median(largest_ms),
        "largest_span_table": span_table(of_largest),
        "largest_run_self_ms": self_ms(of_largest, "variant.run"),
        "span_table": span_table(recs),
        "request_self_ms": self_ms(recs, "executor.request"),
        "route_self_ms": self_ms(recs, "router.route"),
        "cost_largest_ms": {m: median(x) for m, x in cost.items()},
        "cost_largest_all": cost,
        "requests": {"window": len(ctx["requests"]), "profiled": k,
                     "profiled_to_largest": len(busy_largest),
                     "span_segment_to_largest": len(wall_largest)},
        "span_segment_e2e_p95_ms": yardstick.p95([r["e2e"] for r in seg]),
        "window_e2e_p95_ms": yardstick.p95(
            [r["e2e"] for r in ctx["requests"]]),
        "window_attainment": yardstick.attainment(
            ctx["requests"], traffic["t_sla_ms"]),
        "memory_peak_bytes": mem,
    }
    out.update(common(ev, ctx["trace"]))
    return out


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------
class Done(Exception):
    pass


def train(cfg, traffic, seed, seconds, device="cuda") -> dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.training.loop import TrainLoop
    v = next(x for x in cfg["variants"] if x["name"] == cfg["train_variant"])
    B, S = traffic["batch"], traffic["seq_len"]
    tl = TrainLoop(system.model_config(cfg["family"], v),
                   TrainConfig(seed=seed % (1 << 31), **traffic["optimizer"]),
                   dtype=getattr(torch, traffic["param_dtype"]),
                   device=device, log_every=1 << 30)
    feed = btrain.Feed(v["vocab_size"], B, S, seed)
    held: dict = {}
    tracer = probe_tracer(held)(True)
    tracer.start()      # the profiler's own first start
    tracer.stop()
    n = btrain.TRACE_STEPS
    # phases after the warm steps: the window (until --seconds), the
    # profiled steps, the span segment, then off/on blocks of n steps
    plan = ["profiled"] * n + ["spans"] * n
    for _ in range(COST_BLOCKS):
        plan += ["off"] * n + ["on"] * n
    st = dict(i=0, t=None, t0=None, window=[], gaps=defaultdict(list),
              phase="warm")

    def on_step(step, metrics):
        now = time.perf_counter()
        ph = st["phase"]
        if ph != "warm" and st["t"] is not None:
            st["gaps"][ph].append(now - st["t"])
        if ph == "window":
            st["window"].append(metrics["step_time_s"])
        st["t"] = now
        if ph == "warm":
            if step < btrain.WARM_STEPS - 1:
                return
            sync()
            st["t0"] = now
            nxt = "window"
        elif ph == "window" and now - st["t0"] < seconds:
            return
        else:
            if ph == "profiled" and plan[st["i"]] != "profiled":
                tracer.stop()
            if ph in ("spans", "on") and (st["i"] >= len(plan)
                                          or plan[st["i"]] != ph):
                obs.disable()
                held.setdefault("span_records", obs.records())
            if st["i"] >= len(plan):
                raise Done
            nxt = plan[st["i"]]
            st["i"] += 1
        if nxt != ph:
            if nxt == "profiled":
                sync()
                tracer.start()
            elif nxt in ("spans", "on"):
                obs.enable()
        st["phase"] = nxt
        st["t"] = time.perf_counter()

    try:
        tl.run(feed, n_steps=1 << 30, on_step=on_step)
    except Done:
        pass
    finally:
        obs.disable()
        tracer.stop()
    mem = memory_peak()
    ev = Events(held["raw"], obs.SPANS)
    recs = held["span_records"]
    steps = ev.named("train.step")
    busy_step = sum(ev.busy(ev.launched(s, e)) for s, e in steps) / len(steps)
    opt = sum(ev.busy(ev.launched(s, e)) for s, e in
              ev.named("train.optimizer")) / len(steps)
    grads = sum(ev.busy(ev.launched(s, e)) for s, e in
                ev.named("train.grads")) / len(steps)
    wall = statistics.fmean(r.wall_ms for r in recs if r.name == "train.step")
    gaps = {k: statistics.fmean(x) for k, x in st["gaps"].items()}
    out = {
        "optimizer_ms": 1e3 * opt,
        "step_idle_share": 1.0 - 1e3 * busy_step / wall,
        "grads_device_ms": 1e3 * grads,
        "step_busy_ms_profiled": 1e3 * busy_step,
        "step_wall_ms_span_segment": wall,
        "window_step_s": statistics.fmean(st["window"]),
        "window_steps": len(st["window"]),
        "window_tokens_per_s": B * S / statistics.fmean(st["gaps"]["window"]),
        "step_interval_s": gaps,
        "span_table": span_table(recs),
        "step_self_ms": self_ms(recs, "train.step"),
        "memory_peak_bytes": mem,
    }
    out.update(common(ev, tracer.trace))
    return out


def common(ev: Events, trace) -> dict:
    return {
        "traced_idle_share": 1.0 - trace.busy_s / trace.window_s,
        "traced_busy_s": trace.busy_s, "traced_window_s": trace.window_s,
        "idle_gaps": trace.idle_gaps(),
        "idle_by_span": ev.idle_by_span(),
        "device_by_span": ev.device_by_span(),
        "device_ops": trace.device_ops(),
        "device_events": len(ev.device), "unlaunched": ev.unlaunched,
        "annotations_dropped": ev.dropped,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runmod.prepare_env()
    _, _, cfg, traffic, _ = runmod.load_cell(args.workload)
    fn = serve if traffic["kind"] == "serve" else train
    out = fn(cfg, traffic, args.seed, args.seconds)
    out = {"workload": args.workload, "seed": args.seed,
           "card": runmod.power_limit(), **out}
    line = json.dumps(out, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
