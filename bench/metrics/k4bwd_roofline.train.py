"""K4-bwd's share of its roofline in the traced training steps: the
least time of their SSD-scan backward calls (one an SSD layer a step,
fp32 as 3xTF32) over the device time of the ``ssd_bwd_*`` kernels in the
trace, in %; nothing for a model without SSD layers."""
from bench import reference, yardstick

KERNEL = r"\bssd_bwd_[a-z]+_kernel\b"


def read(ctx):
    tr, v = ctx.get("trace"), ctx.get("variant")
    if tr is None or v is None:
        return None
    n = reference.load(ctx["config"]["family"]).layer_kinds(v).count("ssd")
    dev = tr.kernel_seconds(KERNEL)
    if n == 0 or dev <= 0:
        return None
    t, s = ctx["traffic"], v["ssm"]
    esize = 4 if t["param_dtype"] == "float32" else 2
    di = s["expand"] * v["hidden_size"]
    c = yardstick.k4_bwd_cost(t["batch"], di // s["head_dim"], s["n_groups"],
                              t["seq_len"], s["head_dim"], s["d_state"],
                              s["chunk_size"], esize)
    least = ctx["traced_steps"] * n * yardstick.least_seconds(*c)
    return 100.0 * least / dev
