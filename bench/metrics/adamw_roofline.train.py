"""AdamW's share of its roofline in the traced training steps: the least
time of one update a step over every parameter (p, m and v read and
written once, g read twice: for the global norm and for the update;
4·esize + 16 bytes a parameter at the HBM rate) over the device time of
the ``adamw_*_kernel`` kernels in the trace, in %.  Read for each
family's ``adamw_roofline.train.<family>``; nothing where the program
has no such kernel."""
from bench import yardstick

KERNEL = r"\badamw_\w+_kernel\b"


def read(ctx):
    tr, v = ctx.get("trace"), ctx.get("variant")
    if tr is None or v is None:
        return None
    dev = tr.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    esize = 4 if ctx["traffic"]["param_dtype"] == "float32" else 2
    least = ctx["traced_steps"] * yardstick.least_seconds(
        0, (4 * esize + 16) * yardstick.param_count(v), "fp32")
    return 100.0 * least / dev
