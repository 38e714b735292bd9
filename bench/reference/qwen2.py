"""Qwen2 (arXiv:2407.10671) forward in plain fp32 PyTorch: token
embedding, per layer RMSNorm → GQA causal attention with q/k/v biases
and half-split RoPE (θ from the config) → residual, RMSNorm → SwiGLU MLP
→ residual, final RMSNorm, the tied or untied head.  No cache, no
kernels: the whole sequence at once, attention in blocks of query rows
so that its scores fit.  Also the family's weights' layout: the program
leaves in draw order and where each logical leaf lies in them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Spec, exact_fp32, mm, model_leaves, model_spec, rms

Q_BLOCK = 512


def layer_kinds(v) -> list:
    return ["attn"] * v["num_hidden_layers"]


def layer_leaves(v, init, i) -> list:
    """(path, shape, std) of an attention layer's program leaves in draw
    order: ``wqkv`` = q | k | v side by side."""
    p, d, g, s = f"layers/{i}/", v["hidden_size"], init["norm_scale_std"], \
        init["linear_std"]
    H, KV, hd, f = (v["num_attention_heads"], v["num_key_value_heads"],
                    v["head_dim"], v["intermediate_size"])
    return [(p + "norm1", (d,), g),
            (p + "wqkv", (d, (H + 2 * KV) * hd), s),
            (p + "bqkv", ((H + 2 * KV) * hd,), init["bias_std"]),
            (p + "wo", (H * hd, d), s),
            (p + "norm2", (d,), g),
            (p + "mlp/wi", (d, f), s),
            (p + "mlp/wg", (d, f), s),
            (p + "mlp/wo", (f, d), s)]


def layer_spec(v, i) -> Spec:
    p, q, all_ = f"layers.{i}.", f"layers/{i}/", slice(None)
    H, KV, hd = v["num_attention_heads"], v["num_key_value_heads"], \
        v["head_dim"]
    a, b = H * hd, (H + KV) * hd
    c = b + KV * hd
    return [(p + "norm1", q + "norm1", ()),
            (p + "wq", q + "wqkv", (all_, slice(0, a))),
            (p + "wk", q + "wqkv", (all_, slice(a, b))),
            (p + "wv", q + "wqkv", (all_, slice(b, c))),
            (p + "bq", q + "bqkv", (slice(0, a),)),
            (p + "bk", q + "bqkv", (slice(a, b),)),
            (p + "bv", q + "bqkv", (slice(b, c),)),
            (p + "wo", q + "wo", ()),
            (p + "norm2", q + "norm2", ()),
            (p + "gate", q + "mlp/wi", ()),
            (p + "up", q + "mlp/wg", ()),
            (p + "down", q + "mlp/wo", ())]


def leaves(v, init) -> list:
    return model_leaves(v, init, layer_leaves)


def spec(v) -> Spec:
    return model_spec(v, layer_spec)


def rope(x, positions, theta):
    """x: (B, T, heads, hd) rotated in fp32, halves split."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA attention in fp32.  q: (B,T,H,hd); k, v: (B,T,KV,hd)."""
    B, T, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (B,H,T,hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for lo in range(0, T, Q_BLOCK):
        hi = min(T, lo + Q_BLOCK)
        s = (q[:, :, lo:hi] @ k[:, :, :hi].transpose(-1, -2)) * hd ** -0.5
        mask = keys[None, :hi] <= torch.arange(lo, hi,
                                               device=q.device)[:, None]
        s = torch.where(mask, s, float("-inf"))
        out[:, :, lo:hi] = torch.softmax(s, dim=-1) @ v[:, :, :hi]
    return out.transpose(1, 2)


def layer(v, W, i, x, positions, mm=mm):
    """x + attention + MLP of layer ``i``; x: (B, T, d) fp32."""
    p = f"layers.{i}."
    B, T, _ = x.shape
    H, KV, hd = (v["num_attention_heads"], v["num_key_value_heads"],
                 v["head_dim"])
    eps, theta = v["rms_norm_eps"], v["rope_theta"]
    h = rms(x, W[p + "norm1"], eps)
    q = (mm(h, W[p + "wq"]) + W[p + "bq"].float()).view(B, T, H, hd)
    k = (mm(h, W[p + "wk"]) + W[p + "bk"].float()).view(B, T, KV, hd)
    val = (mm(h, W[p + "wv"]) + W[p + "bv"].float()).view(B, T, KV, hd)
    a = attention(rope(q, positions, theta), rope(k, positions, theta), val)
    x = x + mm(a.reshape(B, T, H * hd), W[p + "wo"])
    h = rms(x, W[p + "norm2"], eps)
    return x + mm(F.silu(mm(h, W[p + "gate"])) * mm(h, W[p + "up"]),
                  W[p + "down"])


def head(v, W, x, mm=mm):
    """Logits (fp32) of hidden states x after the final norm."""
    h = rms(x, W["final_norm"], v["rms_norm_eps"])
    w = W["embed"].T if v["tie_word_embeddings"] else W["lm_head"]
    return mm(h, w)


def embed(W, tokens):
    return W["embed"][tokens].float()


@torch.no_grad()
def logits(v, W, tokens, last: int, mm=mm):
    """Logits (B, last, vocab) of the last ``last`` positions of
    ``tokens`` (B, T)."""
    with exact_fp32():
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed(W, tokens)
        for i in range(v["num_hidden_layers"]):
            x = layer(v, W, i, x, positions, mm)
        return head(v, W, x[:, -last:], mm)
