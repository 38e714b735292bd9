"""Prefill attention: the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` (the port of the Pallas ``_flash_kernel``).

GQA causal / sliding-window attention with an fp32 online softmax.  The
public layout is the reference's: q (B,H,Sq,hd), k/v (B,KV,Sk,hd).  The
kernel reads all three through their strides (hd must be contiguous), so
a caller holding (B,S,H,hd) activations passes ``x.transpose(1, 2)``
views and nothing is copied; the output is laid out as (B,Sq,H,hd) in
memory and returned as its (B,H,Sq,hd) view, so the inverse transpose is
free too.  Any Sq and Sk are taken — the kernel masks the ragged edge.
The bfloat16 kernel copies rows with 16-byte loads, so on the card every
row of its q, k and v must start on 16 bytes (:func:`check_aligned`).

On a CPU tensor the wrapper runs the plain version
(``ref.flash_attention_ref``); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I]
             + [_L] * 12 + [_I, _I, ctypes.c_float, _P])


def _check(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,H,Sq,hd) and k, v "
                         f"(B,KV,Sk,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    KV, Sk = k.shape[1], k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError("flash_attention needs non-empty B, Sq and Sk")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; one of {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs the head dimension "
                         "contiguous (stride 1) in q, k and v")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def check_aligned(name: str, q, k, v, keys=("q", "k", "v")) -> None:
    """Raise ValueError unless every row (the last dimension) of the 4-D
    tensors q, k and v starts on 16 bytes: each address, and each of the
    three leading strides of a dimension longer than 1, is a multiple of
    16 bytes.  ``keys`` names the three in the message."""
    for key, t in zip(keys, (q, k, v)):
        st, n = t.stride(), t.shape
        # 16 bytes hold a power of two of elements, so one OR tests all
        lead = ((st[0] if n[0] > 1 else 0) | (st[1] if n[1] > 1 else 0)
                | (st[2] if n[2] > 1 else 0))
        if t.data_ptr() % 16 or lead % (16 // t.element_size()):
            raise ValueError(
                f"{name} needs every row of {key} on 16 bytes; got address "
                f"{t.data_ptr()} and strides {st} of {t.element_size()}-byte "
                "elements")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,hd); k, v: (B,KV,Sk,hd). window=0 ⇒ unbounded.

    Returns (B,H,Sq,hd) in q.dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no path for {q.device}")
    build.refuse_grad("flash_attention", q, k, v)
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q, k, v)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, KV, Sq, Sk,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], int(causal), window, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (error {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
