"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the architectures this package implements."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs import qwen2_1_5b
from repro_torch.configs.base import ModelConfig

_FACTORIES: Dict[str, Callable[[], ModelConfig]] = {
    "qwen2-1.5b": qwen2_1_5b.config,
}

ARCH_IDS: List[str] = list(_FACTORIES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _FACTORIES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _FACTORIES[arch_id]()
