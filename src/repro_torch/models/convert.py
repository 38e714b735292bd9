"""Carry the reference's parameters into the port's layout.

The reference keeps a pattern's layers stacked along axis 0
(``blocks/p0/...``), the embedding under ``embed/table`` and each norm's
scale under ``.../scale``.  :func:`from_jax_params` takes that tree as
numpy arrays (or anything ``np.array`` accepts) and returns the port's
per-layer dictionaries, with ``wq | wk | wv`` (and their biases) side
by side as the fused ``wqkv`` (``bqkv``).  Every leaf is copied with
``np.array`` before it becomes a tensor, so no tensor shares memory with
a read-only buffer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Params, check_supported


def _tensor(x, dtype, device) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def from_jax_params(cfg: ModelConfig, params_np, *, dtype=torch.float32,
                    device="cuda") -> Params:
    """Map the reference's parameter tree for a dense decoder onto the
    port's parameters, on ``device`` (the card unless the caller asks
    for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    if params_np.get("tail"):
        raise ValueError("a dense decoder has no tail layers")
    blocks = params_np["blocks"]["p0"]

    def layer(i, tree):
        return {k: (layer(i, v) if isinstance(v, dict)
                    else _tensor(v[i], dtype, device))
                for k, v in tree.items()}

    layers = []
    for i in range(cfg.n_layers):
        b = layer(i, blocks)
        a = b["attn"]
        p = {"norm1": b["norm1"]["scale"], "norm2": b["norm2"]["scale"],
             "mlp": b["mlp"], "wo": a["wo"],
             "wqkv": torch.cat([a["wq"], a["wk"], a["wv"]], dim=1)}
        if cfg.qkv_bias:
            p["bqkv"] = torch.cat([a["bq"], a["bk"], a["bv"]])
        layers.append(p)
    params = {"embed": _tensor(params_np["embed"]["table"], dtype, device),
              "layers": layers,
              "final_norm": _tensor(params_np["final_norm"]["scale"], dtype,
                                    device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(params_np["lm_head"], dtype, device)
    return params
