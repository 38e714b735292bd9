"""Model assembly: dense decoder LMs (pre-norm attention + MLP blocks).

The reference scans over stacked layer parameters; here the layers are a
Python list and the forward pass a loop over it.  Parameters are plain
dictionaries of tensors:

    {"embed": (Vpad, D), "final_norm": (D,), "lm_head": (D, Vpad) when
     untied, "layers": [{"norm1", "wqkv", ["bqkv"], "wo", "norm2",
     "mlp": {"wi", ["wg"], "wo"}}, ...]}

where ``wqkv`` is the reference's ``wq | wk | wv`` side by side and
``bqkv`` their biases.  A cache is a list of per-layer ``{"k", "v"}``
(B, C, KV, hd) tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import KERNELS, AttentionImpl
from repro_torch.models.layers import (init_normal, mlp_apply, rmsnorm,
                                       rope_tables)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the dense-attention subset this
    package implements."""
    unsupported = []
    if cfg.family != "dense" or any(k != "attn" for k in cfg.pattern):
        unsupported.append(f"family {cfg.family!r} / pattern {cfg.pattern}")
    if not cfg.use_rope:
        unsupported.append("absolute positions (use_rope=False)")
    if cfg.norm != "rms":
        unsupported.append(f"norm {cfg.norm!r}")
    if cfg.kv_cache_dtype != "bf16":
        unsupported.append(f"kv_cache_dtype {cfg.kv_cache_dtype!r}")
    if cfg.mlp not in ("swiglu", "geglu", "gelu"):
        unsupported.append(f"mlp {cfg.mlp!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not implemented in the port yet: "
            + "; ".join(unsupported))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random parameters from ``generator`` on ``device`` (the card
    unless the caller asks for the CPU); raises when ``generator`` lives
    on another device."""
    check_supported(cfg)
    dev = resolve_device(device)
    gdev = generator.device
    if gdev.type != dev.type or dev.index not in (None, gdev.index):
        raise ValueError(f"the generator lives on {gdev}, but the "
                         f"parameters were asked for on {dev}")
    dev = gdev
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv, v = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab

    def normal(*shape, out_proj=False):
        return init_normal(shape, generator, dtype, out_proj=out_proj)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        # the reference draws wq, wk and wv each with std 1/sqrt(out dim)
        wqkv = torch.cat([normal(d, h * hd), normal(d, kv * hd),
                          normal(d, kv * hd)], dim=1)
        p = {"norm1": zeros(d), "wqkv": wqkv,
             "wo": normal(h * hd, d, out_proj=True), "norm2": zeros(d)}
        if cfg.qkv_bias:
            p["bqkv"] = zeros((h + 2 * kv) * hd)
        mlp = {"wi": normal(d, f), "wo": normal(f, d, out_proj=True)}
        if cfg.mlp in ("swiglu", "geglu"):
            mlp["wg"] = normal(d, f)
        p["mlp"] = mlp
        layers.append(p)
    params = {"embed": normal(v, d), "layers": layers,
              "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, v)
    return params


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[dict]:
    dev = resolve_device(device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def embed_tokens(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model) ** 0.5, dtype=x.dtype,
                         device=x.device)
    return x


def unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _mlp_block(cfg, p, x):
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp)


def prefill(cfg: ModelConfig, params, tokens, cache_len: int,
            impl: AttentionImpl = KERNELS):
    """tokens: (B, S) integer ids.  Returns (cache, last-token logits
    (B, Vpad))."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    tables = rope_tables(positions, cfg.rope_theta, cfg.resolved_head_dim)
    x = embed_tokens(cfg, params, tokens)
    cache = []
    for p in params["layers"]:
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        out, c = attn.prefill_attention(p, h, tables, cfg,
                                        cache_len=cache_len, impl=impl)
        x = _mlp_block(cfg, p, x + out)
        cache.append(c)
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return cache, unembed(cfg, params, x)[:, 0]


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                impl: AttentionImpl = KERNELS):
    """tokens: (B,) integer ids; pos: (B,) int32 absolute positions.
    Returns (logits (B, Vpad), cache) — the cache is updated in place."""
    tables = rope_tables(pos[:, None], cfg.rope_theta,
                         cfg.resolved_head_dim)
    x = embed_tokens(cfg, params, tokens[:, None])
    for p, c in zip(params["layers"], cache):
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        out, _ = attn.decode_attention(p, c, h, pos, tables, cfg, impl=impl)
        x = _mlp_block(cfg, p, x + out)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0], cache
