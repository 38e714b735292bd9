"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``.
Without a card they raise rather than carry on elsewhere: the CPU runs
only when a caller asks for it by name, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names the
    card and there is none, or names a device type the port has no code
    for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; the port runs on "
                         "'cuda' or, when asked, 'cpu'")
    return dev
