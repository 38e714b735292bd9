"""K2-bwd's share of its roofline in the traced training steps: the
least time of their flash-attention backward calls (one an attention
layer a step, fp32 as 3xTF32) over the device time of the
``bwd_{dot,dq,dkdv,reduce}`` kernels in the trace, in %; nothing for a
model without attention layers."""
from bench import reference, yardstick

KERNEL = r"\bbwd_(dot|dq|dkdv|reduce)_kernel\b"


def read(ctx):
    tr, v = ctx.get("trace"), ctx.get("variant")
    if tr is None or v is None:
        return None
    n = reference.load(ctx["config"]["family"]).layer_kinds(v).count("attn")
    dev = tr.kernel_seconds(KERNEL)
    if n == 0 or dev <= 0:
        return None
    t = ctx["traffic"]
    esize = 4 if t["param_dtype"] == "float32" else 2
    c = yardstick.k2_bwd_cost(t["batch"], v["num_attention_heads"],
                              v["num_key_value_heads"], t["seq_len"],
                              v["head_dim"], esize)
    least = ctx["traced_steps"] * n * yardstick.least_seconds(*c)
    return 100.0 * least / dev
