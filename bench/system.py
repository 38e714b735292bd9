"""The system under test: the configuration files' variants as the
port's ``ModelConfig``, and its launch counters.  Every import of
``repro_torch`` by the benchmark goes through here, the family modules
(``bench/families/``) or the two runners, ``serve.py`` and ``train.py``,
inside a function."""
from __future__ import annotations

from typing import Dict

from . import families


def model_config(family: str, v: dict):
    """The port's ``ModelConfig`` of a variant as the configuration file
    states it, from ``bench/families/<family>.py``."""
    return families.load(family).model_config(v)


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import ops
    return dict(ops.launch_counts())


def reset_launch_counts() -> None:
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
