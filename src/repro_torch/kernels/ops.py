"""Public wrappers of the port's kernels and their launch counters.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its hand-written kernel for a tensor on the card (or raises);
it adds one to its ``launches`` count each time it launches the kernel,
and nowhere else.

| wrapper            | kernel                          | replaces (reference)                         |
| ------------------ | ------------------------------- | -------------------------------------------- |
| ``flash_attention``  | ``csrc/flash_attention.cu`` (CUDA)  | ``kernels/flash_attention.py`` ``_flash_kernel``  |
| ``decode_attention`` | ``csrc/decode_attention.cu`` (CUDA) | ``kernels/decode_attention.py`` ``_decode_kernel`` |
| ``modipick_probs``   | ``kernels/policy_select.py`` (Triton) | ``kernels/policy_select.py`` ``_probs_kernel``   |
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.policy_select import modipick_probs

WRAPPERS = (flash_attention, decode_attention, modipick_probs)


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
