"""K4-bwd's share of its roofline in the traced training steps: the
least time of their SSD-scan backward calls (one a layer a step, fp32 as
3xTF32) over the device time of the ``ssd_bwd_*`` kernels in the trace,
in %."""
from bench import yardstick

KERNEL = r"\bssd_bwd_[a-z]+_kernel\b"


def read(ctx):
    tr, v = ctx.get("trace"), ctx.get("variant")
    if tr is None or v is None or ctx["config"]["family"] != "mamba2":
        return None
    dev = tr.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    t, s = ctx["traffic"], v["ssm"]
    esize = 4 if t["param_dtype"] == "float32" else 2
    di = s["expand"] * v["hidden_size"]
    c = yardstick.k4_bwd_cost(t["batch"], di // s["head_dim"], s["n_groups"],
                              t["seq_len"], s["head_dim"], s["d_state"],
                              s["chunk_size"], esize)
    least = ctx["traced_steps"] * v["num_hidden_layers"] \
        * yardstick.least_seconds(*c)
    return 100.0 * least / dev
