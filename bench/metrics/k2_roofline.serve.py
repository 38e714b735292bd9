"""K2's share of its roofline in the traced requests: the least time of
their flash-attention calls (one an attention layer a prefill, the
frozen counts of ``bench/yardstick.py`` and the H100's peaks) over the
device time of the ``flash_bf16_kernel`` launches in the trace, in %;
nothing where no traced request ran an attention layer."""
from bench import reference, yardstick

KERNEL = r"\bflash_bf16_kernel\b"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    dev = tr.kernel_seconds(KERNEL)
    if dev <= 0:
        return None
    kinds = reference.load(ctx["config"]["family"]).layer_kinds
    S = ctx["traffic"]["prompt_tokens"]
    least = 0.0
    for r in ctx["traced"]:
        if r["failed"]:
            continue
        v = ctx["variants"][r["variant"]]
        n = kinds(v).count("attn")
        if n:
            c = yardstick.k2_cost(1, v["num_attention_heads"],
                                  v["num_key_value_heads"], S, v["head_dim"],
                                  2)
            least += n * yardstick.least_seconds(*c)
    return 100.0 * least / dev if least > 0 else None
