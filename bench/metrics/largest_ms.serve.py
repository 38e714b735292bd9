"""Median wall ms of ``Variant.run`` of the pool's largest variant at
the cell's shape, over a fixed count of calls after the window."""
import statistics


def read(ctx):
    xs = ctx.get("largest_ms")
    if not xs:
        return None
    return statistics.median(xs)
