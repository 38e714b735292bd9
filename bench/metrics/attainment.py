"""Share of the requests due in the window whose e2e (2·T_input + the
wait from the due time + the service) was within the traffic's t_sla; a
failed request is a miss."""
from bench import yardstick


def read(ctx):
    reqs = ctx.get("requests")
    if not reqs:
        return None
    return yardstick.attainment(reqs, ctx["traffic"]["t_sla_ms"])
