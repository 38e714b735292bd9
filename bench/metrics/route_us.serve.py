"""Mean host µs of a ``Router.route`` call in the window, from the
harness's span around the call."""


def read(ctx):
    spans = ctx.get("route_s")
    if not spans:
        return None
    return 1e6 * sum(spans) / len(spans)
