"""Seconds from the process's start to the window's start: imports,
weights, warm-up, kernel builds and compiles."""


def read(ctx):
    return ctx.get("setup_s")
