"""Attention blocks: GQA causal attention, prefill KV caches, decode.

Prefill attention goes through the hand-written prefill kernel and each
decode step through the decode kernel (``repro_torch.kernels.ops``); on
CPU tensors those wrappers run their plain versions.  The activations
stay in the reference's (B, S, H, hd) layout and the cache in its
(B, C, KV, hd) layout; the kernels read both through strides, so no
layout copy is made on the way in or out.

q, k and v come from one fused projection (``wqkv``: the reference's
``wq | wk | wv`` side by side), and RoPE rotates the q and k heads of
that output together: eager PyTorch pays per launched operation, and
this keeps a layer's attention to a handful of them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rope


class AttentionImpl(NamedTuple):
    """The two attention functions a forward pass calls, with the
    signatures of ``ops.flash_attention`` and ``ops.decode_attention``."""
    prefill: Callable
    decode: Callable


# The kernel wrappers: what the model runs.
KERNELS = AttentionImpl(ops.flash_attention, ops.decode_attention)
# The plain versions on any device: what a check holds the model against.
PLAIN = AttentionImpl(ref.flash_attention_ref, ref.decode_attention_ref)


def _project_qkv(params, x, tables, cfg: ModelConfig):
    """q (B,S,H,hd) and k, v (B,S,KV,hd), RoPE applied to q and k; all
    three are views of two buffers, with hd contiguous."""
    B, S, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = x @ params["wqkv"]
    if cfg.qkv_bias:
        qkv = qkv + params["bqkv"]
    qk = rope(qkv[..., :(H + KV) * hd].view(B, S, H + KV, hd), tables)
    v = qkv[..., (H + KV) * hd:].view(B, S, KV, hd)
    return qk[:, :, :H], qk[:, :, H:], v


def prefill_cache(k, v, cache_len: int):
    """The cache after a full prefill of S tokens (RoPE already applied to
    k), zero-padded along the sequence to ``cache_len`` slots."""
    pad = (0, 0, 0, 0, 0, max(0, cache_len - k.shape[1]))
    return {"k": F.pad(k, pad), "v": F.pad(v, pad)}


def prefill_attention(params, x, tables, cfg: ModelConfig,
                      cache_len: Optional[int] = None,
                      impl: AttentionImpl = KERNELS):
    """Full-sequence causal attention.  x: (B, S, D); tables: the
    forward pass's ``rope_tables`` at positions (B, S).

    Returns (out (B,S,D), cache_or_None)."""
    q, k, v = _project_qkv(params, x, tables, cfg)
    out = impl.prefill(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=True)
    B, S = x.shape[:2]
    out = out.transpose(1, 2).reshape(B, S, -1) @ params["wo"]
    cache = prefill_cache(k, v, cache_len) if cache_len is not None else None
    return out, cache


def decode_attention(params, cache, x, pos, tables, cfg: ModelConfig,
                     impl: AttentionImpl = KERNELS):
    """One decode step. x: (B, 1, D); pos: (B,) int32 absolute position
    of the new token; tables: ``rope_tables`` at ``pos[:, None]``.
    Returns (attn_out (B,1,D), cache).

    The new token's k/v are written into ``cache`` in place (the
    reference returns a new cache array instead); the returned cache is
    the same object."""
    B = x.shape[0]
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    q, k_new, v_new = _project_qkv(params, x, tables, cfg)
    rows = torch.arange(B, device=x.device)
    slot = pos.to(torch.int64)
    cache["k"][rows, slot] = k_new[:, 0]
    cache["v"][rows, slot] = v_new[:, 0]
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd)
    out = impl.decode(qg, cache["k"].permute(0, 2, 1, 3),
                      cache["v"].permute(0, 2, 1, 3), pos)
    out = out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
    return out, cache
