"""Carry the reference's parameters into the port's layout.

The reference keeps layer i of superblock s of the pattern stacked under
``blocks/p{i}`` at index s and the tail layers under ``tail/t{j}``, the
embedding under ``embed/table`` and each norm's scale under
``.../scale``.  :func:`from_jax_params` takes that tree as numpy arrays
(or anything ``np.array`` accepts) and returns the port's per-layer
dictionaries in the order of ``cfg.block_kinds``, with the projections
the port runs as one matmul side by side: ``wq | wk | wv`` (and their
biases) as ``wqkv`` (``bqkv``); an SSD layer's ``in_z | in_x | in_B |
in_C | in_dt`` as ``w_in`` and its x, B and C convs as one; an RG-LRU
layer's ``in_x | in_gate`` as ``w_in`` and ``w_inp | w_rec`` (and their
biases) as ``w_gates`` (``b_gates``).  An MLP's leaves, or a MoE layer's
``router``, ``wi``, ``wg`` and ``wo``, and an untied ``lm_head`` are
carried as they are.  Every leaf is copied with
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


def _ssd(t) -> dict:
    cat = torch.cat
    return {"w_in": cat([t["in_z"], t["in_x"], t["in_B"], t["in_C"],
                         t["in_dt"]], dim=1),
            "conv_w": cat([t["conv_x_w"], t["conv_B_w"], t["conv_C_w"]],
                          dim=1),
            "conv_b": cat([t["conv_x_b"], t["conv_B_b"], t["conv_C_b"]]),
            "A_log": t["A_log"], "D": t["D"], "dt_bias": t["dt_bias"],
            "norm_z": t["norm_z"], "out_proj": t["out_proj"]}


def _rglru(t) -> dict:
    cat = torch.cat
    return {"w_in": cat([t["in_x"], t["in_gate"]], dim=1),
            "conv_w": t["conv_w"], "conv_b": t["conv_b"],
            "w_gates": cat([t["w_inp"], t["w_rec"]], dim=1),
            "b_gates": cat([t["b_inp"], t["b_rec"]]),
            "lam": t["lam"], "out": t["out"]}


def from_jax_params(cfg: ModelConfig, params_np, *, dtype=torch.float32,
                    device="cuda") -> Params:
    """Map the reference's parameter tree for a decoder onto the port's
    parameters, on ``device`` (the card unless the caller asks for the
    CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    pat = len(cfg.pattern)

    def tensors(tree, index=None):
        return {k: (tensors(v, index) if isinstance(v, dict)
                    else _tensor(v if index is None else v[index], dtype,
                                 device))
                for k, v in tree.items()}

    layers = []
    for i, kind in enumerate(cfg.block_kinds):
        if i < cfg.n_superblocks * pat:
            b = tensors(params_np["blocks"][f"p{i % pat}"], i // pat)
        else:
            b = tensors(params_np["tail"][f"t{i - cfg.n_superblocks * pat}"])
        p = {"norm1": b["norm1"]["scale"]}
        if kind == "ssd":
            p["ssd"] = _ssd(b["ssd"])
            layers.append(p)
            continue
        if kind == "rglru":
            p["rglru"] = _rglru(b["rglru"])
        else:
            a = b["attn"]
            p["wo"] = a["wo"]
            p["wqkv"] = torch.cat([a["wq"], a["wk"], a["wv"]], dim=1)
            if cfg.qkv_bias:
                p["bqkv"] = torch.cat([a["bq"], a["bk"], a["bv"]])
        p["norm2"], p["mlp"] = b["norm2"]["scale"], b["mlp"]
        layers.append(p)
    params = {"embed": _tensor(params_np["embed"]["table"], dtype, device),
              "layers": layers,
              "final_norm": _tensor(params_np["final_norm"]["scale"], dtype,
                                    device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(params_np["lm_head"], dtype, device)
    return params
