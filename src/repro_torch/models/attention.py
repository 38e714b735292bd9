"""Attention blocks: GQA causal and sliding-window attention, prefill KV
caches, decode; a whisper encoder's full attention and its decoder's
cross-attention over the encoder output.

Prefill attention goes through the hand-written prefill kernel and each
decode step through a decode kernel (``repro_torch.kernels.ops``); on
CPU tensors those wrappers run their plain versions.  The activations
stay in the reference's (B, S, H, hd) layout and the cache in its
(B, C, KV, hd) layout; the kernels read both through strides, so no
layout copy is made on the way in or out.

q, k and v come from one fused projection (``wqkv``: the reference's
``wq | wk | wv`` side by side), and RoPE rotates the q and k heads of
that output together: eager PyTorch pays per launched operation, and
this keeps a layer's attention to a handful of them.  A config without
RoPE (``use_rope=False``: whisper's absolute positions, added at the
embedding) passes no tables and nothing is rotated.  Cross-attention
projects q from the decoder and k, v from the encoder output (``wkv``:
``wk | wv``).

A ``local`` layer attends over the last ``cfg.window`` positions and
keeps ``C = min(cache_len, window)`` cache slots: position p lives in
slot p % C, a ring once p ≥ C.

``kv_cache_dtype="int8"`` stores k and v as int8 with an fp32 scale per
(batch, slot, KV head), ``{"k", "v", "k_scale", "v_scale"}``, as the
reference does.  Prefill attention still runs on the unquantized k/v;
each decode step makes one call of the int8 decode kernel, which
quantizes the new token's k/v, writes them into the cache and attends,
dequantizing as it reads, so no bf16 copy of the cache is made.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.kernels.ref import dequantize_kv, quantize_kv  # noqa: F401
from repro_torch.models.layers import rope


def _project_qkv(params, x, tables, cfg: ModelConfig):
    """q (B,S,H,hd) and k, v (B,S,KV,hd), RoPE applied to q and k unless
    ``tables`` is None; all three are views of one or two buffers, with
    hd contiguous."""
    B, S, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = x @ params["wqkv"]
    if cfg.qkv_bias:
        qkv = qkv + params["bqkv"]
    qk = qkv[..., :(H + KV) * hd].view(B, S, H + KV, hd)
    if tables is not None:
        qk = rope(qk, tables)
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
    reference's value while p ≥ −S and zero below.

    An int8 cache quantizes the padded (or gathered) slots, as the
    reference does: a zero slot holds 0 at scale 1e-12."""
    S = k.shape[1]
    if kind == "local" and cfg.window < cache_len:
        slots = torch.arange(cfg.window, device=k.device)
        pos = (S - 1) - torch.remainder(S - 1 - slots, cfg.window)
        held = pos >= -S
        pos = torch.where(held, pos, 0)
        held = held[None, :, None, None]
        k, v = torch.where(held, k[:, pos], 0.0), torch.where(held, v[:, pos],
                                                                0.0)
    else:
        if kind == "local":  # C = cache_len ≤ window: the first C positions
            k, v = k[:, :cache_len], v[:, :cache_len]
        pad = (0, 0, 0, 0, 0, max(0, cache_len - S))
        k, v = F.pad(k, pad), F.pad(v, pad)
    if cfg.kv_cache_dtype != "int8":
        return {"k": k, "v": v}
    (qk, sk), (qv, sv) = quantize_kv(k), quantize_kv(v)
    return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


def prefill_attention(params, x, tables, cfg: ModelConfig, kind: str = "attn",
                      cache_len: Optional[int] = None,
                      impl: ModelKernels = KERNELS, causal: bool = True):
    """Full-sequence causal attention, windowed for a ``local`` layer
    (``causal=False``: an encoder's full attention).  x: (B, S, D);
    tables: the forward pass's ``rope_tables`` at positions (B, S), or
    None.

    Returns (out (B,S,D), cache_or_None)."""
    q, k, v = _project_qkv(params, x, tables, cfg)
    window = cfg.window if kind == "local" else 0
    out = impl.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
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
    slot = pos
    if kind == "local":
        slot = torch.remainder(slot, C)
        pos = torch.clamp(pos, max=C - 1)
    qg = q.reshape(B, KV, cfg.n_heads // KV, hd)
    k, v = cache["k"].permute(0, 2, 1, 3), cache["v"].permute(0, 2, 1, 3)
    if cfg.kv_cache_dtype == "int8":
        out = impl.decode_attention_int8(
            qg, k, v, cache["k_scale"].transpose(1, 2),
            cache["v_scale"].transpose(1, 2), pos, k_new=k_new[:, 0],
            v_new=v_new[:, 0], slot=slot)
    else:
        rows = torch.arange(B, device=x.device)
        slot = slot.to(torch.int64)
        cache["k"][rows, slot] = k_new[:, 0]
        cache["v"][rows, slot] = v_new[:, 0]
        out = impl.decode_attention(qg, k, v, pos)
    out = out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"]
    return out, cache


def _project_cross(params, x, enc_out, cfg: ModelConfig):
    """Cross-attention's q (B,S,H,hd) from the decoder's x and k, v
    (B,F,KV,hd) from the encoder output: views of two buffers, hd
    contiguous.  The reference projects q through ``wq`` for the encoder
    output too and drops it; only k and v are projected here."""
    B, S, _ = x.shape
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ params["wq"]
    kv = enc_out @ params["wkv"]
    if cfg.qkv_bias:
        q, kv = q + params["bq"], kv + params["bkv"]
    Fr = enc_out.shape[1]
    return (q.view(B, S, H, hd), kv[..., :KV * hd].view(B, Fr, KV, hd),
            kv[..., KV * hd:].view(B, Fr, KV, hd))


def cross_attention(params, x, enc_out, cfg: ModelConfig,
                    impl: ModelKernels = KERNELS):
    """The decoder's queries over the encoder output, unmasked (K2 with
    ``causal=False``).  x: (B,S,D); enc_out: (B,F,D).  Returns (out
    (B,S,D), xk, xv (B,F,KV,hd)): the cross cache of a decode step."""
    q, xk, xv = _project_cross(params, x, enc_out, cfg)
    out = impl.flash_attention(q.transpose(1, 2), xk.transpose(1, 2),
                               xv.transpose(1, 2), causal=False)
    B, S = x.shape[:2]
    return out.transpose(1, 2).reshape(B, S, -1) @ params["wo"], xk, xv


def cross_decode_attention(params, xk, xv, x, cfg: ModelConfig,
                           impl: ModelKernels = KERNELS):
    """One decode step's cross-attention over all F frames of the cross
    cache xk, xv (B,F,KV,hd): the decode kernel at pos = F − 1 with no
    window reads every slot, the reference's unmasked softmax.  x:
    (B,1,D).  Returns (B,1,D)."""
    B = x.shape[0]
    hd, KV, H = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    pos = torch.full((B,), xk.shape[1] - 1, dtype=torch.int32,
                     device=x.device)
    out = impl.decode_attention(q.view(B, KV, H // KV, hd),
                                xk.permute(0, 2, 1, 3),
                                xv.permute(0, 2, 1, 3), pos)
    return out.reshape(B, 1, H * hd) @ params["wo"]
