"""Share (0 to 1) of the traced window in which no operation ran on the
card, from torch.profiler."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or "requests" not in ctx:
        return None
    return 1.0 - tr.busy_s / tr.window_s
