"""Tokens of every training step of the window over the window's time,
read for each family's ``train_tokens_per_s.<family>``."""


def read(ctx):
    if not ctx.get("steps") or not ctx.get("window_s"):
        return None
    return ctx["tokens"] / ctx["window_s"]
