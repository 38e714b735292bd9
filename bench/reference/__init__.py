"""Plain fp32 PyTorch references of the benchmark's models, independent
of the program: they read the logical leaves of ``bench/weights.py`` and
import nothing of ``repro_torch``, ``repro`` or ``jax``.

A family is one module here, ``<family>.py``, found by a configuration's
``"family"``.  It gives its weights' layout, ``leaves(v, init)`` (the
program leaves in draw order) and ``spec(v)`` (where each logical leaf
lies in them); ``layer_kinds(v)``, one kind a layer (``"attn"``,
``"ssd"``), which the kernel readers count; and its fp32 forward,
``embed(W, tokens)``, ``layer(v, W, i, x, positions, mm=mm)``,
``head(v, W, x, mm=mm)`` and ``logits(v, W, tokens, last, mm=mm)``.
A model that mixes layer kinds takes each layer's leaves, spec and
forward from the module of its kind."""
import importlib


def load(family: str):
    """The reference module of ``family``."""
    try:
        return importlib.import_module(f".{family}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{family}":
            raise
        raise ValueError(f"no family {family!r}: there is no "
                         f"bench/reference/{family}.py") from None
