"""Mamba-2 SSD (state-space duality) mixer.

Prefill runs the hand-written SSD scan (``ops.ssd_scan``: the chunked
intra- plus inter-chunk computation, with the final state as a second
output) in place of the reference's XLA ``ssd_chunked``; under autograd
on the card its backward is the hand-written K4-bwd
(``ops.ssd_scan_bwd``).  The D-skip and the gated RMSNorm stay in the
block, as in the reference.  Decode keeps O(1) state: the conv history
and the (H, hd, N) SSM state, advanced by one plain-PyTorch recurrence
step.

Parameters, with the reference's five input projections side by side
as one matmul and its three depthwise convs (x, B, C) as one:

    {"w_in": (D, 2·d_in + 2·G·N + H)   z | x | B | C | dt,
     "conv_w": (W, d_in + 2·G·N), "conv_b": (d_in + 2·G·N,),
     "A_log": (H,), "D": (H,), "dt_bias": (H,), "norm_z": (d_in,),
     "out_proj": (d_in, D)}

A decode cache is ``{"conv": (B, W−1, d_in + 2·G·N), "state": (B, H,
hd, N)}``; the conv history holds the pre-conv x | B | C projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models.layers import causal_conv, conv_step, init_normal


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), \
        s.n_groups * s.d_state


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype) -> dict:
    """Random parameters by the reference's rules (``ssd_template``)."""
    s, d_in, H, n = _dims(cfg)
    d, dev = cfg.d_model, generator.device

    def normal(*shape, out_proj=False):
        return init_normal(shape, generator, dtype, out_proj=out_proj)

    # each projection and conv is drawn with the std of its own fan-in
    w_in = torch.cat([normal(d, d_in), normal(d, d_in), normal(d, n),
                      normal(d, n), normal(d, H)], dim=1)
    conv_w = torch.cat([normal(s.conv_width, d_in), normal(s.conv_width, n),
                        normal(s.conv_width, n)], dim=1)
    return {"w_in": w_in, "conv_w": conv_w,
            "conv_b": torch.zeros(d_in + 2 * n, dtype=dtype, device=dev),
            "A_log": torch.ones(H, dtype=dtype, device=dev),
            "D": torch.ones(H, dtype=dtype, device=dev),
            "dt_bias": torch.zeros(H, dtype=dtype, device=dev),
            "norm_z": torch.zeros(d_in, dtype=dtype, device=dev),
            "out_proj": normal(d_in, d, out_proj=True)}


def _gated_norm(p, y, z, dtype):
    """Mamba-2's gated RMSNorm: norm(y · silu(z)), in fp32."""
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + p["norm_z"].float())
    return yf.to(dtype)


def ssd_prefill(p, x, cfg: ModelConfig, impl: ModelKernels = KERNELS):
    """Full-sequence SSD mixer.  x: (B,S,D) → (out (B,S,D), cache)."""
    s, d_in, H, n = _dims(cfg)
    Bb, S, _ = x.shape
    proj = x @ p["w_in"]
    z, xbc, dt = proj[..., :d_in], proj[..., d_in:-H], proj[..., -H:]
    hist = xbc[:, -(s.conv_width - 1):]
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xh = xbc[..., :d_in].view(Bb, S, H, s.head_dim)
    B_ = xbc[..., d_in:d_in + n].view(Bb, S, s.n_groups, s.d_state)
    C_ = xbc[..., d_in + n:].view(Bb, S, s.n_groups, s.d_state)
    A = -torch.exp(p["A_log"].float())
    dt_sp = F.softplus(dt.float() + p["dt_bias"].float())  # (B,S,H)
    y, state = impl.ssd_scan(xh.transpose(1, 2), dt_sp.transpose(1, 2), A,
                             B_.transpose(1, 2), C_.transpose(1, 2),
                             chunk=s.chunk_size)
    y = y.transpose(1, 2) + xh * p["D"].to(xh.dtype)[:, None]
    y = _gated_norm(p, y.reshape(Bb, S, d_in), z, x.dtype)
    cache = {"conv": hist.contiguous(), "state": state.to(x.dtype)}
    return y @ p["out_proj"], cache


def ssd_decode_step(p, cache, x, cfg: ModelConfig):
    """x: (B,1,D).  Returns (out (B,1,D), new cache)."""
    s, d_in, H, n = _dims(cfg)
    proj = x[:, 0] @ p["w_in"]
    z, xbc, dt = proj[:, :d_in], proj[:, d_in:-H], proj[:, -H:]
    xbc, hist = conv_step(cache["conv"], xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xh = xbc[:, :d_in].reshape(-1, H, s.head_dim).float()
    hg = H // s.n_groups
    Bh = xbc[:, d_in:d_in + n].reshape(-1, s.n_groups, s.d_state)
    Ch = xbc[:, d_in + n:].reshape(-1, s.n_groups, s.d_state)
    Bh = Bh.repeat_interleave(hg, dim=1).float()  # (B,H,N)
    Ch = Ch.repeat_interleave(hg, dim=1).float()

    A = -torch.exp(p["A_log"].float())
    dt_sp = F.softplus(dt.float() + p["dt_bias"].float())  # (B,H)
    decay = torch.exp(dt_sp * A)
    upd = dt_sp[..., None, None] * xh[..., None] * Bh[:, :, None, :]
    state = cache["state"].float() * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(p, y.reshape(-1, d_in), z, x.dtype)
    out = y @ p["out_proj"]
    return out[:, None], {"conv": hist,
                          "state": state.to(cache["state"].dtype)}
