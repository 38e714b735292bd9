"""RecurrentGemma / Griffin RG-LRU recurrent block.

Recurrence (per channel): a_t = exp(−c · softplus(Λ) · r_t),
h_t = a_t · h_{t−1} + sqrt(1 − a_t²) · (i_t ⊙ x_t), with input gate i_t
and recurrence gate r_t, in fp32.  Prefill runs the hand-written scan
(``ops.rglru_scan``) in place of the reference's XLA
``rglru_scan_xla``; decode advances one plain-PyTorch step from the
cached state.

Parameters, with the reference's ``in_x | in_gate`` and
``w_inp | w_rec`` (and their biases) side by side as one matmul each:

    {"w_in": (D, 2W), "conv_w": (cw, W), "conv_b": (W,),
     "w_gates": (W, 2W), "b_gates": (2W,), "lam": (W,), "out": (W, D)}

A decode cache is ``{"conv": (B, cw−1, W), "h": (B, W)}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models.layers import (causal_conv, conv_step, init_normal,
                                       init_rglru_lambda)


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype) -> dict:
    """Random parameters by the reference's rules (``rglru_template``)."""
    d, w = cfg.d_model, cfg.rglru.width(cfg.d_model)
    dev = generator.device

    def normal(*shape, out_proj=False):
        return init_normal(shape, generator, dtype, out_proj=out_proj)

    return {"w_in": torch.cat([normal(d, w), normal(d, w)], dim=1),
            "conv_w": normal(cfg.rglru.conv_width, w),
            "conv_b": torch.zeros(w, dtype=dtype, device=dev),
            "w_gates": torch.cat([normal(w, w), normal(w, w)], dim=1),
            "b_gates": torch.zeros(2 * w, dtype=dtype, device=dev),
            "lam": init_rglru_lambda((w,), generator, dtype),
            "out": normal(w, d, out_proj=True)}


def _gates(p, xb, cfg: ModelConfig):
    """The recurrence's a_t and b_t (fp32) from the conv output xb."""
    w = xb.shape[-1]
    g = (xb @ p["w_gates"]).float() + p["b_gates"].float()
    i, r = torch.sigmoid(g[..., :w]), torch.sigmoid(g[..., w:])
    log_a = -cfg.rglru.c_exponent * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) \
        * (i * xb.float())
    return a, b


def rglru_prefill(p, x, cfg: ModelConfig, impl: ModelKernels = KERNELS):
    """Full-sequence recurrent block.  x: (B,S,D) → (out (B,S,D), cache);
    the cache's state is the scan's last row."""
    w = cfg.rglru.width(cfg.d_model)
    proj = x @ p["w_in"]
    xb, gate = proj[..., :w], F.gelu(proj[..., w:], approximate="tanh")
    hist = xb[:, -(cfg.rglru.conv_width - 1):].contiguous()
    a, b = _gates(p, causal_conv(xb, p["conv_w"], p["conv_b"]), cfg)
    h = impl.rglru_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p["out"]
    return out, {"conv": hist, "h": h[:, -1].to(x.dtype)}


def rglru_decode_step(p, cache, x, cfg: ModelConfig):
    """x: (B,1,D).  Returns (out (B,1,D), new cache)."""
    w = cfg.rglru.width(cfg.d_model)
    proj = x[:, 0] @ p["w_in"]
    xb, gate = proj[:, :w], F.gelu(proj[:, w:], approximate="tanh")
    conv, hist = conv_step(cache["conv"], xb, p["conv_w"], p["conv_b"])
    a, b = _gates(p, conv, cfg)
    h = a * cache["h"].float() + b
    out = (h.to(x.dtype) * gate) @ p["out"]
    return out[:, None], {"conv": hist, "h": h.to(cache["h"].dtype)}
