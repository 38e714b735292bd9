"""Model assembly: decoder LMs of attention, local-attention, Mamba-2
SSD and RG-LRU blocks, with dense or mixture-of-experts feed-forwards.

The reference scans over stacked superblocks (one repetition of the
config's block pattern) plus an unrolled tail; here the layers are a
Python list in the order of ``cfg.block_kinds`` and the forward pass a
loop over it.  Parameters are plain dictionaries of tensors:

    {"embed": (Vpad, D), "final_norm": (D,), "lm_head": (D, Vpad) when
     untied, "layers": [one dict per layer]}

where an ``attn`` or ``local`` layer is ``{"norm1", "wqkv", ["bqkv"],
"wo", "norm2", "mlp": {"wi", ["wg"], "wo"}}`` (``wqkv`` is the
reference's ``wq | wk | wv`` side by side, ``bqkv`` their biases; a MoE
config's ``mlp`` is ``{"router", "wi", "wg", "wo"}``, see
``models/moe.py``), an
``rglru`` layer ``{"norm1", "rglru", "norm2", "mlp"}`` and an ``ssd``
layer ``{"norm1", "ssd"}`` (no MLP; see ``models/ssm.py`` and
``models/rglru.py``).  A cache is a list with one entry per layer: a
``{"k", "v"}`` (B, C, KV, hd) pair for attention, the conv history and
recurrent state for ``ssd`` and ``rglru``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, init_normal, mlp_apply,
                                       rope_tables)

Params = Dict[str, Any]
ATTENTION_KINDS = ("attn", "local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the decoder subset this package
    implements: dense, MoE, SSM and hybrid families of attention, local
    attention, SSD and RG-LRU blocks."""
    unsupported = []
    if cfg.family not in ("dense", "moe", "ssm", "hybrid") or not set(
            cfg.pattern) <= {"attn", "local", "ssd", "rglru"}:
        unsupported.append(f"family {cfg.family!r} / pattern {cfg.pattern}")
    if cfg.family == "moe" and cfg.moe is None:
        unsupported.append("family 'moe' without a MoEConfig")
    if "ssd" in cfg.pattern and cfg.ssm is None:
        unsupported.append("ssd blocks without an SSMConfig")
    if "rglru" in cfg.pattern and cfg.rglru is None:
        unsupported.append("rglru blocks without an RGLRUConfig")
    if not cfg.use_rope:
        unsupported.append("absolute positions (use_rope=False)")
    if cfg.norm not in ("rms", "layer"):
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

    def attention_layer():
        # the reference draws wq, wk and wv each with std 1/sqrt(out dim)
        wqkv = torch.cat([normal(d, h * hd), normal(d, kv * hd),
                          normal(d, kv * hd)], dim=1)
        p = {"wqkv": wqkv, "wo": normal(h * hd, d, out_proj=True)}
        if cfg.qkv_bias:
            p["bqkv"] = zeros((h + 2 * kv) * hd)
        return p

    layers = []
    for kind in cfg.block_kinds:
        p = {"norm1": zeros(d)}
        if kind == "ssd":
            p["ssd"] = ssm_mod.init_params(cfg, generator, dtype)
            layers.append(p)
            continue
        if kind == "rglru":
            p["rglru"] = rglru_mod.init_params(cfg, generator, dtype)
        else:
            p.update(attention_layer())
        if cfg.moe is not None:
            mlp = moe_mod.init_params(cfg, generator, dtype)
        else:
            mlp = {"wi": normal(d, f), "wo": normal(f, d, out_proj=True)}
            if cfg.mlp in ("swiglu", "geglu"):
                mlp["wg"] = normal(d, f)
        p["norm2"], p["mlp"] = zeros(d), mlp
        layers.append(p)
    params = {"embed": normal(v, d), "layers": layers,
              "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, v)
    return params


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[dict]:
    """An empty cache: zeros of the shapes a prefill of ``cache_len``
    slots produces."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = []
    for kind in cfg.block_kinds:
        if kind in ATTENTION_KINDS:
            C = min(cache_len, cfg.window) if kind == "local" else cache_len
            shape = (batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
            cache.append({"k": zeros(*shape), "v": zeros(*shape)})
        elif kind == "ssd":
            s = cfg.ssm
            d_in, n = s.d_inner(cfg.d_model), s.n_groups * s.d_state
            cache.append({"conv": zeros(batch, s.conv_width - 1,
                                        d_in + 2 * n),
                          "state": zeros(batch, s.n_heads(cfg.d_model),
                                         s.head_dim, s.d_state)})
        else:
            w = cfg.rglru.width(cfg.d_model)
            cache.append({"conv": zeros(batch, cfg.rglru.conv_width - 1, w),
                          "h": zeros(batch, w)})
    return cache


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


def ffn_block(cfg: ModelConfig, p, x, routing=None):
    """x + the layer's feed-forward of its second norm: the MLP, or the
    MoE (routed by ``routing`` when given, else by its own input)."""
    h2 = apply_norm(cfg.norm, x, p["norm2"], cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_mod.moe_ffn(p["mlp"], h2, cfg, routing)[0]
    return x + mlp_apply(p["mlp"], h2, cfg.mlp)


def rope_for(cfg: ModelConfig, positions):
    """RoPE tables at ``positions`` for the attention layers, or None
    when there are none."""
    if not set(cfg.block_kinds) & set(ATTENTION_KINDS):
        return None
    return rope_tables(positions, cfg.rope_theta, cfg.resolved_head_dim)


def mix_prefill(cfg: ModelConfig, kind: str, p, x, tables, cache_len: int,
                impl: ModelKernels = KERNELS):
    """A layer's first half over the full sequence: x + its mixer
    (attention, SSD or RG-LRU) of its first norm.  x: (B,S,D).  Returns
    (x, the layer's cache)."""
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps)
    if kind == "ssd":
        out, cache = ssm_mod.ssd_prefill(p["ssd"], h, cfg, impl)
    elif kind == "rglru":
        out, cache = rglru_mod.rglru_prefill(p["rglru"], h, cfg, impl)
    else:
        out, cache = attn.prefill_attention(p, h, tables, cfg, kind,
                                            cache_len=cache_len, impl=impl)
    return x + out, cache


def mix_decode(cfg: ModelConfig, kind: str, p, x, cache, pos, tables,
               impl: ModelKernels = KERNELS):
    """A layer's first half for one decode step.  x: (B,1,D).  Returns
    (x, the layer's cache): an attention cache is written in place and
    returned, a recurrent one replaced."""
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps)
    if kind == "ssd":
        out, cache = ssm_mod.ssd_decode_step(p["ssd"], cache, h, cfg)
    elif kind == "rglru":
        out, cache = rglru_mod.rglru_decode_step(p["rglru"], cache, h, cfg)
    else:
        out, cache = attn.decode_attention(p, cache, h, pos, tables, cfg,
                                           kind, impl=impl)
    return x + out, cache


def block_prefill(cfg: ModelConfig, kind: str, p, x, tables,
                  cache_len: int, impl: ModelKernels = KERNELS):
    """One layer over the full sequence.  x: (B,S,D).  Returns (x, the
    layer's cache)."""
    x, cache = mix_prefill(cfg, kind, p, x, tables, cache_len, impl)
    return (x if kind == "ssd" else ffn_block(cfg, p, x)), cache


def block_decode(cfg: ModelConfig, kind: str, p, x, cache, pos, tables,
                 impl: ModelKernels = KERNELS):
    """One layer, one decode step.  x: (B,1,D).  Returns (x, the layer's
    cache)."""
    x, cache = mix_decode(cfg, kind, p, x, cache, pos, tables, impl)
    return (x if kind == "ssd" else ffn_block(cfg, p, x)), cache


def final_logits(cfg: ModelConfig, params, x):
    """Logits (B, Vpad) of the last position of x (B,S,D)."""
    x = apply_norm(cfg.norm, x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0]


def prefill(cfg: ModelConfig, params, tokens, cache_len: int,
            impl: ModelKernels = KERNELS):
    """tokens: (B, S) integer ids.  Returns (cache, last-token logits
    (B, Vpad))."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    tables = rope_for(cfg, positions)
    x = embed_tokens(cfg, params, tokens)
    cache = []
    for kind, p in zip(cfg.block_kinds, params["layers"]):
        x, c = block_prefill(cfg, kind, p, x, tables, cache_len, impl)
        cache.append(c)
    return cache, final_logits(cfg, params, x)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                impl: ModelKernels = KERNELS):
    """tokens: (B,) integer ids; pos: (B,) int32 absolute positions.
    Returns (logits (B, Vpad), cache) — the list is updated in place."""
    tables = rope_for(cfg, pos[:, None])
    x = embed_tokens(cfg, params, tokens[:, None])
    for i, (kind, p) in enumerate(zip(cfg.block_kinds, params["layers"])):
        x, cache[i] = block_decode(cfg, kind, p, x, cache[i], pos, tables,
                                   impl)
    return final_logits(cfg, params, x), cache
