"""Decode attention: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` (the port of the Pallas ``_decode_kernel``).

One new token per sequence attends over its KV cache, the GQA group's
query rows together.  The public layout is the reference's: q
(B,KV,G,hd), k/v (B,KV,S,hd), pos (B,) int32.  q, k and v are read
through their strides (hd contiguous), so the model passes a view of its
projection output and ``cache.permute(0, 2, 1, 3)`` views of its
(B,S,KV,hd) cache, and the cache is never copied.
Slots past ``pos`` (and outside the window) are not read; any S is
taken.

On a CPU tensor the wrapper runs the plain version
(``ref.decode_attention_ref``); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

MAX_GROUP = 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I]
             + [_L] * 9 + [_I, ctypes.c_float, _P])


def _check(q, k, v, pos, window: int) -> None:
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
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"group size {G} not supported (1..{MAX_GROUP})")
    if B == 0 or k.shape[2] == 0:
        raise ValueError("decode_attention needs non-empty B and S")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; one of {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError("q, k, v and pos must lie on one device")
    if not pos.is_contiguous():
        raise ValueError("decode_attention needs pos contiguous")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention needs the head dimension "
                         "contiguous (stride 1) in q, k and v")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention(q, k, v, pos, *, window: int = 0):
    """q: (B,KV,G,hd) new-token queries grouped per KV head; k, v:
    (B,KV,S,hd) cache with the new token's k/v already written; pos:
    (B,) int32 absolute position of the new token.

    Returns (B,KV,G,hd) in q.dtype."""
    _check(q, k, v, pos, window)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention has no path for {q.device}")
    fn = build.function("decode_attention", "decode_attention_fwd",
                        _ARGTYPES)
    B, KV, G, hd = q.shape
    S = k.shape[2]
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             pos.data_ptr(), out.data_ptr(), B, KV, G, S, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], window, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (error {err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
