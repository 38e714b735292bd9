"""Mamba-2 (arXiv:2405.21060) forward in plain fp32 PyTorch: token
embedding, per layer RMSNorm → the SSD mixer → residual, final RMSNorm,
the tied head.  The mixer: one input projection to z, x, B, C and dt; a
depthwise causal conv over x | B | C, then SiLU; dt = softplus(dt +
dt_bias), A = −exp(A_log); the SSD recurrence h_t = exp(dt·A)·h +
dt·B⊗x, y = C·h, computed exactly by the chunked state-space-duality
form of the paper's listing; y + D·x; the gated RMSNorm of y·silu(z);
the output projection.  No cache, no kernels."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import exact_fp32, mm, rms


def segsum(a):
    """(..., T) → (..., T, T): Σ a[j+1..i] below the diagonal, −inf
    above."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, dt, A, B, C, chunk):
    """x: (b, T, h, p); dt: (b, T, h); A: (h,); B, C: (b, T, g, n).
    Returns y (b, T, h, p), fp32."""
    b, T, h, p = x.shape
    g = B.shape[2]
    pad = (-T) % chunk
    X = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    Ad = F.pad(dt * A, (0, 0, 0, pad))
    Bp = F.pad(B, (0, 0, 0, 0, 0, pad))
    Cp = F.pad(C, (0, 0, 0, 0, 0, pad))
    c = (T + pad) // chunk
    X = X.view(b, c, chunk, h, p)
    Bh = Bp.view(b, c, chunk, g, -1).repeat_interleave(h // g, dim=3)
    Ch = Cp.view(b, c, chunk, g, -1).repeat_interleave(h // g, dim=3)
    Ad = Ad.view(b, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    cum = torch.cumsum(Ad, dim=-1)
    L = torch.exp(segsum(Ad))                          # (b,h,c,l,s)
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y = torch.einsum("bhcls,bcshp->bclhp", scores * L, X)
    decay = torch.exp(cum[..., -1:] - cum)             # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chain = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", chain, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states,
                         torch.exp(cum))
    return y.reshape(b, c * chunk, h, p)[:, :T]


def layer(v, W, i, x, mm=mm):
    p = f"layers.{i}."
    s, eps = v["ssm"], v["rms_norm_eps"]
    b, T, d = x.shape
    di = s["expand"] * d
    H, P, G = di // s["head_dim"], s["head_dim"], s["n_groups"]
    h = rms(x, W[p + "norm1"], eps)
    z = mm(h, W[p + "in_z"])
    xbc = torch.cat([mm(h, W[p + "in_" + k]) for k in ("x", "B", "C")],
                    dim=-1)
    w = torch.cat([W[p + "conv_" + k].float() for k in ("x", "B", "C")],
                  dim=1)                                 # (W, ch)
    bias = torch.cat([W[p + "convb_" + k].float() for k in ("x", "B", "C")])
    K = w.shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + T] * w[j] for j in range(K)) + bias
    xbc = F.silu(conv)
    n = G * s["d_state"]
    xs = xbc[..., :di].reshape(b, T, H, P)
    Bm = xbc[..., di:di + n].reshape(b, T, G, -1)
    Cm = xbc[..., di + n:].reshape(b, T, G, -1)
    dt = F.softplus(mm(h, W[p + "in_dt"]) + W[p + "dt_bias"].float())
    A = -torch.exp(W[p + "A_log"].float())
    y = ssd(xs, dt, A, Bm, Cm, s["chunk_size"])
    y = (y + xs * W[p + "D"].float()[:, None]).reshape(b, T, di)
    y = rms(y * F.silu(z), W[p + "norm_z"], v.get("gated_norm_eps", eps))
    return x + mm(y, W[p + "out_proj"])


def head(v, W, x, mm=mm):
    h = rms(x, W["final_norm"], v["rms_norm_eps"])
    return mm(h, W["embed"].T)


def embed(W, tokens):
    return W["embed"][tokens].float()


@torch.no_grad()
def logits(v, W, tokens, last: int, mm=mm):
    """Logits (B, last, vocab) of the last ``last`` positions of
    ``tokens`` (B, T)."""
    with exact_fp32():
        x = embed(W, tokens)
        for i in range(v["num_hidden_layers"]):
            x = layer(v, W, i, x, mm)
        return head(v, W, x[:, -last:], mm)
