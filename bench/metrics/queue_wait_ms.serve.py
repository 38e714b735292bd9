"""Mean ms from each request's due time to the start of its
``PoolExecutor.execute`` call, on the harness's clock."""


def read(ctx):
    reqs = ctx.get("requests")
    if not reqs:
        return None
    return 1e3 * sum(r["start"] - r["due"] for r in reqs) / len(reqs)
