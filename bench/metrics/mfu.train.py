"""Model FLOPs of the window's training steps (``train_step_flops`` of
the family's module, ``bench/families/<family>.py``) over the window's
time × the H100's published bf16 dense peak, in %, read for each
family's ``mfu.train.<family>``."""
from bench import families, yardstick


def read(ctx):
    if ctx.get("variant") is None or not ctx.get("steps") \
            or not ctx.get("window_s"):
        return None
    t = ctx["traffic"]
    count = families.load(ctx["config"]["family"]).train_step_flops
    return yardstick.mfu_pct(
        ctx["steps"] * count(ctx["variant"], t["batch"], t["seq_len"]),
        ctx["window_s"])
