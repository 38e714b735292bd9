"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the decoder-only architectures this package
implements, in the reference's order."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs import (command_r_35b, dbrx_132b, gemma3_4b,
                                 mamba2_1_3b, moonshot_v1_16b_a3b,
                                 phi4_mini_3_8b, qwen2_1_5b,
                                 recurrentgemma_2b)
from repro_torch.configs.base import ModelConfig

_FACTORIES: Dict[str, Callable[[], ModelConfig]] = {
    "recurrentgemma-2b": recurrentgemma_2b.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "qwen2-1.5b": qwen2_1_5b.config,
    "phi4-mini-3.8b": phi4_mini_3_8b.config,
    "command-r-35b": command_r_35b.config,
    "gemma3-4b": gemma3_4b.config,
    "dbrx-132b": dbrx_132b.config,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.config,
}

ARCH_IDS: List[str] = list(_FACTORIES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _FACTORIES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _FACTORIES[arch_id]()
