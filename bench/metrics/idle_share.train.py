"""Share (0 to 1) of the traced training steps' window in which no
operation ran on the card, from torch.profiler, read for each family's
``idle_share.train.<family>``."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or "steps" not in ctx:
        return None
    return 1.0 - tr.busy_s / tr.window_s
