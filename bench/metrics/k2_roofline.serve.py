"""K2's share of its roofline in the traced requests: the least time of
their flash-attention calls (one a layer a prefill, the frozen counts
of ``bench/yardstick.py`` and the H100's peaks) over the device time of
the ``flash_bf16_kernel`` launches in the trace, in %."""
from bench import yardstick

KERNEL = r"\bflash_bf16_kernel\b"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["config"]["family"] != "qwen2":
        return None
    dev = tr.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    S = ctx["traffic"]["prompt_tokens"]
    least = 0.0
    for r in ctx["traced"]:
        if r["failed"]:
            continue
        v = ctx["variants"][r["variant"]]
        c = yardstick.k2_cost(1, v["num_attention_heads"],
                              v["num_key_value_heads"], S, v["head_dim"], 2)
        least += v["num_hidden_layers"] * yardstick.least_seconds(*c)
    return 100.0 * least / dev
