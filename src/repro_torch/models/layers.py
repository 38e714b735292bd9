"""Shared layer primitives: norms, RoPE, sinusoidal positions, MLPs,
parameter init."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
# Parameter init: the reference's rules (``repro/models/layers.py``
# ``materialize``), drawn from an explicit torch.Generator on the target
# device.
# ----------------------------------------------------------------------
def init_normal(shape, generator: torch.Generator, dtype, *,
                out_proj: bool = False) -> torch.Tensor:
    """N(0, std²) with the reference's std: 1/√(last dim), or 0.02/√2
    for a residual-out projection."""
    std = (0.02 / math.sqrt(2.0) if out_proj
           else 1.0 / math.sqrt(max(1, shape[-1])))
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def init_rglru_lambda(shape, generator: torch.Generator,
                      dtype) -> torch.Tensor:
    """The RG-LRU's Λ: drawn so that a = sigmoid(Λ)^c spreads over
    (0.9, 0.999), as the reference's ``rglru_lambda`` rule draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    return (torch.log(u ** -2.0 - 1.0) * 0.5).to(dtype)


def causal_conv(x, w, b):
    """Depthwise causal convolution.  x: (B,S,C); w: (W,C); b: (C,).
    Summed tap by tap in x.dtype, as the reference sums it."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def conv_step(hist, new, w, b):
    """One causal-conv decode step.  hist: (B, W−1, C) previous inputs;
    new: (B, C).  Returns (out (B, C), new history (B, W−1, C))."""
    h = torch.cat([hist, new[:, None]], dim=1)
    return torch.einsum("bwc,wc->bc", h, w) + b, h[:, 1:]


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rmsnorm(x, scale, eps):
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, eps):
    """LayerNorm without a bias, with fp32 statistics and the same
    ``(1 + scale)`` gain as ``rmsnorm``."""
    h = x.to(torch.float32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def apply_norm(kind, x, scale, eps):
    return rmsnorm(x, scale, eps) if kind == "rms" else layernorm(x, scale, eps)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_tables(positions, theta, head_dim):
    """cos/sin tables of half-split RoPE at ``positions`` ((S,) or
    (B, S)), in fp32 and shaped to broadcast over (..., S, H, hd/2).
    A forward pass builds them once and every layer reuses them."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.dim() == 1:
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]


def rope(x, tables):
    """x: (..., S, H, hd) rotated by ``rope_tables``' (cos, sin); the
    rotation is computed in fp32."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d, max_scale=10_000.0):
    """Absolute sinusoidal position embeddings (..., d) at ``positions``,
    in fp32: sines then cosines, as the reference lays them out."""
    half = d // 2
    freqs = max_scale ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def mlp_apply(params, x, kind: str):
    h = x @ params["wi"]
    if kind in ("swiglu", "geglu"):
        g = x @ params["wg"]
        act = F.silu(h) if kind == "swiglu" else F.gelu(h, approximate="tanh")
        h = act * g
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["wo"]
