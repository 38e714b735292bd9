"""Plain fp32 PyTorch references of the benchmark's models, independent
of the program: they read the logical leaves of ``bench/weights.py`` and
import nothing of ``repro_torch``, ``repro`` or ``jax``."""
