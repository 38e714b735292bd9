"""Mamba-2 on the program's side: the SSD family, one mixer a layer; its
model FLOPs are ``bench/yardstick.py``'s."""
from ..yardstick import train_step_flops  # noqa: F401
from . import common


def model_config(v: dict):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(family="ssm", n_heads=1, n_kv_heads=1, d_ff=0,
                       pattern=("ssd",), ssm=SSMConfig(**v["ssm"]),
                       **common(v))


def tiny(v: dict, i: int) -> None:
    v["ssm"] = dict(v["ssm"], d_state=16, head_dim=16, chunk_size=16)
