"""Shared layer primitives: norms, RoPE, MLPs, parameter init."""
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


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rmsnorm(x, scale, eps):
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


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
