"""Qwen2 on the program's side: the dense family, GQA with q/k/v biases,
RoPE and a SwiGLU MLP; its model FLOPs are ``bench/yardstick.py``'s."""
from ..yardstick import train_step_flops  # noqa: F401
from . import common


def model_config(v: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(family="dense", n_heads=v["num_attention_heads"],
                       n_kv_heads=v["num_key_value_heads"],
                       d_ff=v["intermediate_size"], head_dim=v["head_dim"],
                       pattern=("attn",), rope_theta=v["rope_theta"],
                       qkv_bias=True, mlp="swiglu", **common(v))


def tiny(v: dict, i: int) -> None:
    v.update(num_attention_heads=4, num_key_value_heads=2,
             head_dim=(16, 32, 32)[i], intermediate_size=96 * (i + 1))
