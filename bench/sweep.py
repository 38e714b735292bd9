"""Find a serve cell's knee once, on the card, and the SLA it is run at.

    python3 bench/sweep.py --workload qwen2-pool.serve --seed 11 \\
        --seconds 51 --rates 1,1.25,1.5,2,3,4 [--write]

One process builds and warms the cell's pool once.  It first times each
variant's warm service at the cell's shape (``--service-calls`` calls of
``Variant.run``) and sets t_sla to the 95th percentile of the round
trip, 2·(μ + 1.645·σ) of the traffic's uplink, plus the smallest
variant's median service, rounded up to 5 ms.  Then it offers the rates
in rising order, each for ``--seconds`` or for as long as
``--min-requests`` requests take, whichever is longer, and records
attainment, accuracy, e2e p95, the mean wait and the backlog (requests
due but not started) at the middle and at the end of the window.  A rate
passes when its attainment is within 0.05 of the lowest rate's and its
backlog at the end is no larger than at the middle; the sweep stops at
the first rate that fails.  The knee (``knee_of``) is the highest rate
up to which every rate passes; the cell runs at four fifths of it
(``rate_at``).  The record, with the card's name and power limit, is
printed as one JSON line; ``--write`` puts it beside the traffic file
(``bench/traffic/<mix>.sweep.json``) and writes the rate and t_sla into
the traffic file.
"""
import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import run as runmod  # noqa: E402
from bench import serve, yardstick  # noqa: E402

MIN_REQUESTS = 50   # the least the lowest rate's attainment may rest on
TOLERANCE = 0.05    # attainment a passing rate may lose to the lowest rate's


def rate_at(knee: float) -> float:
    """Four fifths of the knee, rounded down to a whole rate, or to a
    tenth below 5 requests/s, where a whole rate would be far from four
    fifths."""
    r = 0.8 * knee
    return float(math.floor(r)) if r >= 5 else math.floor(10 * r) / 10


def passes(row: dict, base: float) -> bool:
    return (row["attainment"] >= base - TOLERANCE
            and row["backlog_end"] <= row["backlog_mid"])


def knee_of(rows) -> float | None:
    """The highest rate up to which every rate of the sweep passes, or
    None where the lowest rate holds fewer than MIN_REQUESTS requests or
    no rate fails (the sweep stopped short of the knee)."""
    rows = sorted(rows, key=lambda r: r["rate"])
    if not rows or rows[0]["n"] < MIN_REQUESTS:
        return None
    base, knee = rows[0]["attainment"], None
    for r in rows:
        if not passes(r, base):
            return knee
        knee = r["rate"]
    return None


def backlog(reqs, t: float) -> int:
    return sum(1 for r in reqs if r["due"] <= t < r["start"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--min-requests", type=int, default=MIN_REQUESTS)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--service-calls", type=int, default=10)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    runmod.prepare_env()
    _, cell, cfg, traffic, _ = runmod.load_cell(args.workload)
    c = serve.Cell(cfg, traffic, args.seed, "cuda")
    service = {v["name"]: c.service_ms(v["name"], args.service_calls)
               for v in cfg["variants"]}
    net = traffic["network"]
    rt95 = 2.0 * (net["mean_ms"] + 1.645 * net["std_ms"])
    smallest = statistics.median(service[cfg["variants"][0]["name"]])
    t_sla = 5.0 * math.ceil((rt95 + smallest) / 5.0)
    c.traffic = dict(traffic, t_sla_ms=t_sla)
    serve.note(f"t_sla {t_sla} ms (round trip p95 {rt95:.2f} + smallest "
               f"{smallest:.3f})")
    rows = []
    for rate in sorted(float(x) for x in args.rates.split(",")):
        t = time.perf_counter()
        seconds = max(args.seconds, args.min_requests / rate)
        ctx = c.window(seconds, rate=rate)
        reqs = ctx["requests"]
        use = {}
        for r in reqs:
            use[r["variant"]] = use.get(r["variant"], 0) + 1
        row = dict(
            rate=rate, seconds=seconds, n=len(reqs),
            attainment=yardstick.attainment(reqs, t_sla),
            accuracy=sum(r["quality"] for r in reqs) / len(reqs),
            e2e_p95_ms=yardstick.p95([r["e2e"] for r in reqs]),
            wait_ms=1e3 * statistics.mean(r["start"] - r["due"]
                                          for r in reqs),
            backlog_mid=backlog(reqs, seconds / 2),
            backlog_end=backlog(reqs, seconds),
            drain_s=ctx["window_end_s"] - seconds,
            usage={k: n / len(reqs) for k, n in sorted(use.items())},
            failed=sum(r["failed"] for r in reqs))
        rows.append(row)
        serve.note(f"rate {rate}: {json.dumps(row)} "
                   f"({time.perf_counter() - t:.1f} s)")
        if not passes(row, rows[0]["attainment"]):
            break
    knee = knee_of(rows)
    rec = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
               min_requests=args.min_requests, card=runmod.power_limit(),
               service_ms={k: dict(median=statistics.median(x), samples=x)
                           for k, x in service.items()},
               round_trip_p95_ms=rt95, t_sla_ms=t_sla, rows=rows, knee=knee,
               rate_per_s=None if knee is None else rate_at(knee))
    print(json.dumps(rec), flush=True)
    if args.write and knee is not None:
        path = ROOT / "bench" / "traffic" / f"{cell['traffic']}.json"
        path.with_suffix(".sweep.json").write_text(
            json.dumps(rec, indent=1) + "\n")
        traffic.update(rate_per_s=rec["rate_per_s"], t_sla_ms=t_sla)
        path.write_text(json.dumps(traffic, indent=2) + "\n")
    c.free()
    return 0 if knee is not None else 1


if __name__ == "__main__":
    sys.exit(main())
