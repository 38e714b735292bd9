"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists the reference's ten architectures, in its order."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs import (command_r_35b, dbrx_132b, gemma3_4b,
                                 internvl2_2b, mamba2_1_3b,
                                 moonshot_v1_16b_a3b, phi4_mini_3_8b,
                                 qwen2_1_5b, recurrentgemma_2b, whisper_tiny)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_FACTORIES: Dict[str, Callable[[], ModelConfig]] = {
    "recurrentgemma-2b": recurrentgemma_2b.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "qwen2-1.5b": qwen2_1_5b.config,
    "phi4-mini-3.8b": phi4_mini_3_8b.config,
    "command-r-35b": command_r_35b.config,
    "gemma3-4b": gemma3_4b.config,
    "whisper-tiny": whisper_tiny.config,
    "dbrx-132b": dbrx_132b.config,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.config,
    "internvl2-2b": internvl2_2b.config,
}

ARCH_IDS: List[str] = list(_FACTORIES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _FACTORIES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _FACTORIES[arch_id]()


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """The reference's shape grid for one arch: every shape of
    :data:`SHAPES`, but long_500k only for a sub-quadratic one."""
    return [shape for shape in SHAPES.values()
            if shape.name != "long_500k" or cfg.sub_quadratic]
