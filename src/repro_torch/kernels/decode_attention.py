"""Decode attention: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` (the port of the Pallas ``_decode_kernel``).

One new token per sequence attends over its KV cache, the GQA group's
query rows together.  The public layout is the reference's: q
(B,KV,G,hd), k/v (B,KV,S,hd), pos (B,) int32.  q, k and v are read
through their strides (hd contiguous), so the model passes a view of its
projection output and ``cache.permute(0, 2, 1, 3)`` views of its
(B,S,KV,hd) cache, and the cache is never copied.
Slots past ``pos`` (and outside the window) are not read; any S and
any group size G are taken.

The kernel splits the cache across blocks: :func:`split_plan` cuts the
cache length into ``n_split`` chunks, the blocks of one (batch, KV head)
write partial softmax states to scratch, and the last of them merges
those into the output, all in one launch.  The scratch and the
per-(batch, KV head) arrival counters are kept per device and stream,
so a call allocates nothing but its output (the counters start at zero
and every launch leaves them at zero).  The
kernel reads rows with 16-byte copies, so on the card every row of q, k
and v must start on 16 bytes.

:func:`decode_attention_int8` attends over an int8 cache (the
reference's ``kv_cache_dtype="int8"``) with a kernel of its own: k and v
as (B,KV,S,hd) int8 views and their scales as (B,KV,S) fp32 views of
the model's (B,C,KV,hd) and (B,C,KV) cache.  Given the new token's
``k_new``, ``v_new`` and ``slot``, the same launch first quantizes them
as the reference does and writes the int8 rows and scales into the
cache, so a decode step makes one call for the cache and the attention.
The kernel walks 32-slot tiles with several in flight, dequantizes them
in registers as the reference does (float(x) · scale rounded to q's
dtype), and has its own split plan (:func:`split_plan_int8`).

On a CPU tensor each wrapper runs its plain version
(``ref.decode_attention_ref``, ``ref.decode_attention_int8_ref``); on a
CUDA tensor it launches the kernel or raises; on ``meta`` tensors (the
dry-run) it records the kernel's cost and returns the output empty,
inside ``cost.counting()`` only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS,
                                                 check_aligned)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_I, _I] + [_P] * 8 + [_I] * 6
             + [_L] * 9 + [_I, ctypes.c_float, _P])
_ARGTYPES_INT8 = ([_I, _I] + [_P] * 13 + [_I] * 6
                  + [_L] * 19 + [_I, ctypes.c_float, _P])

TILE = 16        # positions a block loads at a time (kT in the kernel)
MAX_SPLIT = 64   # bounds the scratch and the merge's reads
H100_SMS = 132
TILE_INT8 = 32        # slots the int8 kernel loads at a time (kT8)
MAX_SPLIT_INT8 = 128  # kMaxSplit8
WAVE_TILES = 32       # tiles past which an int8 block's chunk is cut


def split_plan(B: int, KV: int, C: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(chunk, n_split) for a cache of C slots: the fewest chunks, each a
    multiple of TILE positions, that make B·KV·n_split blocks cover
    ``sms`` SMs, with no more chunks than tiles and at most MAX_SPLIT.
    The grid is (n_split, KV, B)."""
    tiles = -(-C // TILE)
    want = -(-sms // (B * KV))
    per = max(1, tiles // want, -(-tiles // MAX_SPLIT))  # tiles a chunk
    return per * TILE, -(-tiles // per)


def split_plan_int8(B: int, KV: int, C: int,
                    sms: int = H100_SMS) -> Tuple[int, int]:
    """(chunk, n_split) of the int8 kernel for a cache of C slots: chunks
    of whole TILE_INT8 tiles, the fewest that make B·KV·n_split blocks
    cover ``sms`` SMs, but none longer than WAVE_TILES tiles (a long
    cache then takes more than one wave of blocks, so that each block
    keeps several tiles in flight without a long serial walk), and at
    most MAX_SPLIT_INT8 chunks."""
    tiles = -(-C // TILE_INT8)
    want = -(-sms // (B * KV))
    per = max(1, min(tiles // want, WAVE_TILES),
              -(-tiles // MAX_SPLIT_INT8))
    return per * TILE_INT8, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device, stream: int, pairs: int, floats: int):
    """(counters, partials) for launches on ``stream``: at least ``pairs``
    int32 arrival counters, zero between launches, and ``floats`` float32
    of partial-state scratch.  Launches on one stream run in order, so
    they can share both."""
    key = (device.index, stream)
    bufs = _SCRATCH.get(key)
    if bufs is None or bufs[0].numel() < pairs or bufs[1].numel() < floats:
        bufs = (torch.zeros(max(pairs, 256), dtype=torch.int32,
                            device=device),
                torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                            device=device))
        _SCRATCH[key] = bufs
    return bufs


def _check(q, k, v, pos, window: int, cache_dtype=None) -> None:
    """Raise on what the kernel does not take; k and v hold q's dtype
    unless ``cache_dtype`` names theirs."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or pos.dim() != 1:
        raise ValueError("decode_attention wants q (B,KV,G,hd), k, v "
                         f"(B,KV,S,hd) and pos (B,); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(pos.shape)}")
    B, KV, G, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, KV) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if pos.shape[0] != B or pos.dtype != torch.int32:
        raise TypeError(f"pos must be ({B},) int32; got "
                        f"{tuple(pos.shape)} {pos.dtype}")
    if G < 1:
        raise ValueError(f"group size must be >= 1, got {G}")
    if B == 0 or k.shape[2] == 0:
        raise ValueError("decode_attention needs non-empty B and S")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; one of {HEAD_DIMS}")
    want = q.dtype if cache_dtype is None else cache_dtype
    if q.dtype not in DTYPES or k.dtype != want or v.dtype != want:
        raise TypeError("decode_attention takes float32 or bfloat16 q and "
                        f"k, v of {'its' if cache_dtype is None else want} "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, k, v and pos must lie on one device")
    if not pos.is_contiguous():
        raise ValueError("decode_attention needs pos contiguous")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention needs the head dimension "
                         "contiguous (stride 1) in q, k and v")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(symbol, argtypes, q, k, v, pos, window, plan=split_plan,
            before_pos=(), after_pos=(), more_strides=()):
    """Launch ``symbol`` on the card: the split plan, the output, the
    scratch, then the pointers q, k, v, ``before_pos``, pos,
    ``after_pos``, and the strides of q, k, v and ``more_strides``."""
    check_aligned("decode_attention", q, k, v)
    fn = build.function("decode_attention", symbol, argtypes)
    B, KV, G, hd = q.shape
    S = k.shape[2]
    chunk, n_split = plan(B, KV, S, _sm_count(q.device.index))
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_o = part_ml = counters = None
    if n_split > 1:
        n_part = B * KV * n_split * G
        cnt, part = _scratch(q.device, stream, B * KV, n_part * (hd + 2))
        counters, part_o = cnt.data_ptr(), part.data_ptr()
        part_ml = part_o + 4 * n_part * hd  # bytes past the partial acc
    err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             *before_pos, pos.data_ptr(), *after_pos, out.data_ptr(),
             part_o, part_ml, counters, B, KV, G, S, chunk, n_split,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *more_strides, window, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed (error {err})")
    return out


def _meta(name, c, q):
    """On ``meta`` tensors: record the kernel's cost ``c``, with every
    slot of the cache read (pos has no values there), and return the
    output empty."""
    cost.record(name, c)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def decode_attention(q, k, v, pos, *, window: int = 0):
    """q: (B,KV,G,hd) new-token queries grouped per KV head; k, v:
    (B,KV,S,hd) cache with the new token's k/v already written; pos:
    (B,) int32 absolute position of the new token.

    Returns (B,KV,G,hd) in q.dtype."""
    _check(q, k, v, pos, window)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window)
    if q.device.type == "meta":
        return _meta("decode_attention", cost.decode_attention(
            q, q.shape[0] * k.shape[1] * k.shape[2]), q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention has no path for {q.device}")
    build.refuse_grad("decode_attention", q, k, v)
    out = _launch("decode_attention_fwd", _ARGTYPES, q, k, v, pos, window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_int8(q, k, v, k_scale, v_scale, pos, *,
                          window: int = 0, k_new=None, v_new=None,
                          slot=None):
    """:func:`decode_attention` over an int8 cache.  q: (B,KV,G,hd)
    float32 or bfloat16; k, v: (B,KV,S,hd) int8; k_scale, v_scale:
    (B,KV,S) float32; pos: (B,) int32.

    With the new token's ``k_new``, ``v_new`` (B,KV,hd) in q's dtype and
    its ``slot`` (B,) int32 in [0, S) (``pos``, or ``pos % S`` on a local
    ring), they are first quantized as the reference's ``_quantize_kv``
    does and written into k, v, k_scale and v_scale at ``slot`` (in
    place), and the attention reads them there.

    Returns (B,KV,G,hd) in q.dtype."""
    _check(q, k, v, pos, window, cache_dtype=torch.int8)
    for t in (k_scale, v_scale):
        if t.shape != k.shape[:3] or t.dtype != torch.float32:
            raise TypeError(f"decode_attention_int8 wants float32 scales of "
                            f"{tuple(k.shape[:3])}; got {tuple(t.shape)} "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError("the scales must lie on q's device")
    new = (k_new, v_new, slot)
    if any(t is not None for t in new):
        if any(t is None for t in new):
            raise ValueError("decode_attention_int8 takes k_new, v_new and "
                             "slot together")
        want = (q.shape[0], q.shape[1], q.shape[3])
        for t in (k_new, v_new):
            if tuple(t.shape) != want or t.dtype != q.dtype \
                    or t.stride(2) != 1:
                raise TypeError(f"k_new and v_new must be {want} {q.dtype} "
                                f"with hd contiguous; got {tuple(t.shape)} "
                                f"{t.dtype}")
        if tuple(slot.shape) != (q.shape[0],) or slot.dtype != torch.int32 \
                or not slot.is_contiguous():
            raise TypeError(f"slot must be ({q.shape[0]},) int32; got "
                            f"{tuple(slot.shape)} {slot.dtype}")
        if not (k_new.device == v_new.device == slot.device == q.device):
            raise ValueError("k_new, v_new and slot must lie on q's device")
    if q.device.type == "cpu":
        return ref.decode_attention_int8_ref(q, k, v, k_scale, v_scale, pos,
                                             window=window, k_new=k_new,
                                             v_new=v_new, slot=slot)
    if q.device.type == "meta":
        return _meta("decode_attention_int8", cost.decode_attention_int8(
            q, q.shape[0] * k.shape[1] * k.shape[2],
            write=k_new is not None), q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 has no path for {q.device}")
    build.refuse_grad("decode_attention_int8", q, k_new, v_new)
    writes = k_new is not None
    out = _launch(
        "decode_attention_int8_fwd", _ARGTYPES_INT8, q, k, v, pos, window,
        plan=split_plan_int8,
        before_pos=(k_scale.data_ptr(), v_scale.data_ptr()),
        after_pos=tuple(t.data_ptr() if writes else None for t in new),
        more_strides=(*k_scale.stride(), *v_scale.stride(),
                      *(k_new.stride()[:2] if writes else (0, 0)),
                      *(v_new.stride()[:2] if writes else (0, 0))))
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
