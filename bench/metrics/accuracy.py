"""Mean quality of the variant that served each request due in the
window; a failed request scores 0."""


def read(ctx):
    reqs = ctx.get("requests")
    if not reqs:
        return None
    return sum(0.0 if r["failed"] else r["quality"] for r in reqs) / len(reqs)
