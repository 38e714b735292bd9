"""Attention blocks: GQA causal and sliding-window attention, prefill KV
caches, decode.

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

A ``local`` layer attends over the last ``cfg.window`` positions and
keeps ``C = min(cache_len, window)`` cache slots: position p lives in
slot p % C, a ring once p ≥ C.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models.layers import rope


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


def prefill_cache(cfg: ModelConfig, kind: str, k, v, cache_len: int):
    """The cache after a full prefill of S tokens (RoPE already applied to
    k), zero-padded along the sequence to ``cache_len`` slots.  A local
    layer whose window is shorter keeps ``window`` slots instead, slot j
    holding the latest position p < S with p % window == j.

    Before the ring wraps (S < window) that p is negative for the slots
    j ≥ S, which no decode step reads before it writes them.  The
    reference takes p as a wrapped index there: a value of the prompt
    while p ≥ −S, and NaN below (out of range), which its decode step
    then spreads through 0 · NaN.  Here those slots hold the
    reference's value while p ≥ −S and zero below."""
    S = k.shape[1]
    if kind == "local" and cfg.window < cache_len:
        slots = torch.arange(cfg.window, device=k.device)
        pos = (S - 1) - torch.remainder(S - 1 - slots, cfg.window)
        held = pos >= -S
        pos = torch.where(held, pos, 0)
        held = held[None, :, None, None]
        return {"k": torch.where(held, k[:, pos], 0.0),
                "v": torch.where(held, v[:, pos], 0.0)}
    if kind == "local":  # C = cache_len ≤ window: the first C positions
        k, v = k[:, :cache_len], v[:, :cache_len]
    pad = (0, 0, 0, 0, 0, max(0, cache_len - S))
    return {"k": F.pad(k, pad), "v": F.pad(v, pad)}


def prefill_attention(params, x, tables, cfg: ModelConfig, kind: str = "attn",
                      cache_len: Optional[int] = None,
                      impl: ModelKernels = KERNELS):
    """Full-sequence causal attention, windowed for a ``local`` layer.
    x: (B, S, D); tables: the forward pass's ``rope_tables`` at
    positions (B, S).

    Returns (out (B,S,D), cache_or_None)."""
    q, k, v = _project_qkv(params, x, tables, cfg)
    window = cfg.window if kind == "local" else 0
    out = impl.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, window=window)
    B, S = x.shape[:2]
    out = out.transpose(1, 2).reshape(B, S, -1) @ params["wo"]
    cache = (prefill_cache(cfg, kind, k, v, cache_len)
             if cache_len is not None else None)
    return out, cache


def decode_attention(params, cache, x, pos, tables, cfg: ModelConfig,
                     kind: str = "attn", impl: ModelKernels = KERNELS):
    """One decode step. x: (B, 1, D); pos: (B,) int32 absolute position
    of the new token; tables: ``rope_tables`` at ``pos[:, None]``.
    Returns (attn_out (B,1,D), cache).

    The new token's k/v are written into ``cache`` in place (the
    reference returns a new cache array instead); the returned cache is
    the same object.

    The decode kernel reads slots 0..pos and takes slot index for
    position.  A local layer's ring breaks that once it wraps, so it is
    called with pos_eff = min(pos, C − 1) and no window: before the wrap
    slot j holds position j, and after it every slot holds one of the
    last C ≤ window positions, all of them visible — the reference's
    ``valid`` mask in both cases."""
    B = x.shape[0]
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    q, k_new, v_new = _project_qkv(params, x, tables, cfg)
    C = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = pos.to(torch.int64)
    if kind == "local":
        slot = torch.remainder(slot, C)
        pos = torch.clamp(pos, max=C - 1)
    cache["k"][rows, slot] = k_new[:, 0]
    cache["v"][rows, slot] = v_new[:, 0]
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd)
    out = impl.decode_attention(qg, cache["k"].permute(0, 2, 1, 3),
                                cache["v"].permute(0, 2, 1, 3), pos)
    out = out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
    return out, cache
