"""Mamba-2 (arXiv:2405.21060) forward in plain fp32 PyTorch: token
embedding, per layer RMSNorm → the SSD mixer → residual, final RMSNorm,
the tied head.  The mixer: one input projection to z, x, B, C and dt; a
depthwise causal conv over x | B | C, then SiLU; dt = softplus(dt +
dt_bias), A = −exp(A_log); the SSD recurrence h_t = exp(dt·A)·h +
dt·B⊗x, y = C·h, computed exactly by the chunked state-space-duality
form of the paper's listing; y + D·x; the gated RMSNorm of y·silu(z);
the output projection.  No cache, no kernels.  Also the family's
weights' layout: the program leaves in draw order and where each logical
leaf lies in them."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Spec, exact_fp32, mm, model_leaves, model_spec, rms


def layer_kinds(v) -> list:
    return ["ssd"] * v["num_hidden_layers"]


def _widths(v):
    """(d_inner, SSD heads, n_groups × d_state) of a layer."""
    c = v["ssm"]
    di = c["expand"] * v["hidden_size"]
    return di, di // c["head_dim"], c["n_groups"] * c["d_state"]


def layer_leaves(v, init, i) -> list:
    """(path, shape, std or a rule name) of an SSD layer's program leaves
    in draw order: ``w_in`` = z | x | B | C | dt side by side."""
    p, d, g = f"layers/{i}/", v["hidden_size"], init["norm_scale_std"]
    di, H, n = _widths(v)
    W = v["ssm"]["conv_width"]
    conv_std = 1.0 / math.sqrt(3.0 * W)  # U(±1/√W): fan_in W
    return [(p + "norm1", (d,), g),
            (p + "ssd/w_in", (d, 2 * di + 2 * n + H),
             1.0 / math.sqrt(3.0 * d)),
            (p + "ssd/conv_w", (W, di + 2 * n), conv_std),
            (p + "ssd/conv_b", (di + 2 * n,), conv_std),
            (p + "ssd/A_log", (H,), "A_log"),
            (p + "ssd/D", (H,), "one"),
            (p + "ssd/dt_bias", (H,), "dt_bias"),
            (p + "ssd/norm_z", (di,), g),
            (p + "ssd/out_proj", (di, d),
             1.0 / math.sqrt(3.0 * di) / math.sqrt(v["num_hidden_layers"]))]


def layer_spec(v, i) -> Spec:
    p, q, all_ = f"layers.{i}.", f"layers/{i}/", slice(None)
    di, H, n = _widths(v)
    cuts = {"z": (0, di), "x": (di, 2 * di), "B": (2 * di, 2 * di + n),
            "C": (2 * di + n, 2 * di + 2 * n),
            "dt": (2 * di + 2 * n, 2 * di + 2 * n + H)}
    out: Spec = [(p + "norm1", q + "norm1", ())]
    for k, (lo, hi) in cuts.items():
        out.append((p + "in_" + k, q + "ssd/w_in", (all_, slice(lo, hi))))
    for k, (lo, hi) in (("x", (0, di)), ("B", (di, di + n)),
                        ("C", (di + n, di + 2 * n))):
        out.append((p + "conv_" + k, q + "ssd/conv_w", (all_, slice(lo, hi))))
        out.append((p + "convb_" + k, q + "ssd/conv_b", (slice(lo, hi),)))
    return out + [(p + k, q + "ssd/" + k, ())
                  for k in ("A_log", "D", "dt_bias", "norm_z", "out_proj")]


def leaves(v, init) -> list:
    return model_leaves(v, init, layer_leaves)


def spec(v) -> Spec:
    return model_spec(v, layer_spec)


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


def layer(v, W, i, x, positions, mm=mm):
    """x + the SSD mixer of layer ``i``; x: (B, T, d) fp32.  ``positions``
    is every family's argument; the recurrence has no use for it."""
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
            x = layer(v, W, i, x, None, mm)
        return head(v, W, x[:, -last:], mm)
