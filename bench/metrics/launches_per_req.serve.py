"""The port's kernel launches over the window (``ops.launch_counts``)
per request served."""


def read(ctx):
    reqs = [r for r in ctx.get("requests") or () if not r["failed"]]
    if not reqs or ctx.get("launches") is None:
        return None
    return sum(ctx["launches"].values()) / len(reqs)
