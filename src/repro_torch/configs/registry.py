"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the architectures this package implements."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs import mamba2_1_3b, qwen2_1_5b, recurrentgemma_2b
from repro_torch.configs.base import ModelConfig

_FACTORIES: Dict[str, Callable[[], ModelConfig]] = {
    "qwen2-1.5b": qwen2_1_5b.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "recurrentgemma-2b": recurrentgemma_2b.config,
}

ARCH_IDS: List[str] = list(_FACTORIES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _FACTORIES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _FACTORIES[arch_id]()
