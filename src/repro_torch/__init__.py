"""ModiPick in PyTorch on an NVIDIA H100: the port of the JAX package
``repro``, with every TPU kernel on its path written by hand for Hopper.
It imports neither JAX nor ``repro``."""
