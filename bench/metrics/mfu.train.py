"""Model FLOPs of the window's training steps (the frozen formula of
``bench/yardstick.py``) over the window's time × the H100's published
bf16 dense peak, in %, read for each family's
``mfu.train.<family>``."""
from bench import yardstick


def read(ctx):
    if ctx.get("variant") is None or not ctx.get("steps") \
            or not ctx.get("window_s"):
        return None
    return yardstick.mfu_pct(ctx)
