"""Nearest-rank 95th percentile of e2e over every request due in the
window (a failed request counts as infinitely late)."""
from bench import yardstick


def read(ctx):
    reqs = ctx.get("requests")
    if not reqs:
        return None
    return yardstick.p95([r["e2e"] for r in reqs])
