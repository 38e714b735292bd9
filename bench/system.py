"""The system under test: the configuration files' variants as the
port's ``ModelConfig``, and its launch counters.  Every import of
``repro_torch`` by the benchmark goes through here (or the two runners,
``serve.py`` and ``train.py``), inside a function."""
from __future__ import annotations

from typing import Dict


def model_config(family: str, v: dict):
    """The port's ``ModelConfig`` of a variant as the configuration file
    states it."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    common = dict(name=v["name"], n_layers=v["num_hidden_layers"],
                  d_model=v["hidden_size"], vocab_size=v["vocab_size"],
                  norm="rms", norm_eps=v["rms_norm_eps"],
                  tie_embeddings=v["tie_word_embeddings"],
                  quality=v["quality"], dtype="bfloat16")
    if family == "qwen2":
        return ModelConfig(family="dense", n_heads=v["num_attention_heads"],
                           n_kv_heads=v["num_key_value_heads"],
                           d_ff=v["intermediate_size"],
                           head_dim=v["head_dim"], pattern=("attn",),
                           rope_theta=v["rope_theta"], qkv_bias=True,
                           mlp="swiglu", **common)
    if family == "mamba2":
        return ModelConfig(family="ssm", n_heads=1, n_kv_heads=1, d_ff=0,
                           pattern=("ssd",), ssm=SSMConfig(**v["ssm"]),
                           **common)
    raise ValueError(f"no family {family!r}")


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import ops
    return dict(ops.launch_counts())


def reset_launch_counts() -> None:
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
