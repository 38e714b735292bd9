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
or raises.  On ``meta`` tensors (the dry-run) it records the kernel's
cost (``kernels/cost.py``) and returns empty outputs, inside
``cost.counting()`` only.

Training: on a CUDA tensor under grad mode with an input that requires
grad, :func:`flash_attention` runs through :class:`FlashAttention`, an
autograd Function whose forward launches the same kernel with its
log-sum-exp (``lse`` (B,H,Sq) fp32, ``m + log l``) and saves q, k, v, o
and lse, and whose backward launches the FlashAttention-2 backward
kernels through :func:`flash_attention_bwd`: D = rowsum(dO ∘ O), dQ a
q tile a block, dK and dV a (query head, key tile) a block, and, when a
KV head serves G > 1 query heads, a pass that sums each group's G
partial dK, dV in head order.  :func:`bwd_plan` gives their tiles, grids
and scratch; the launch takes its grids and scratch from it.  dq, dk and dv come back with the memory order of q, k and
v.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, cost, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
             + [_L] * 12 + [_I, _I, ctypes.c_float, _P])
_BWD_ARGTYPES = ([_I, _I] + [_P] * 8 + [_L] + [_P] * 3 + [_I] * 5
                 + [_P, _P, _I, _I, ctypes.c_float, _P])

# The backward kernels' launch plan: blocks of BWD_WARPS warps, 16 rows
# a warp.  Its tiles are constants of the CUDA source, which reports them
# (``flash_attention_bwd_plan``); its grids and scratch are passed to the
# launch, which refuses ones that do not cover the shapes.
BWD_WARPS = 4
BWD_ROWS = 16 * BWD_WARPS
SMEM_LIMIT = 232448      # dynamic shared memory a block may use (227 KB)


class BwdPlan(NamedTuple):
    """The backward's launch plan.  ``rows``: keys of a dK/dV block and q
    rows of a dQ block (16 a warp); ``walk``: rows of the tiles each
    walks (q rows, keys); ``splits``: warps that share 16 rows, each on
    ``cols`` of the hd columns (and the same share of the score's k);
    ``smem``: dynamic shared memory bytes of a block of either kernel;
    ``dq_grid``, ``dkdv_grid``: (x, y) blocks; ``scratch``: fp32 bytes of
    the partial dK, dV (0 when KV == H)."""
    rows: int
    walk: int
    splits: int
    cols: int
    smem: int
    threads: int
    dq_grid: tuple
    dkdv_grid: tuple
    scratch: int


def bwd_plan(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
             dtype) -> BwdPlan:
    """The tiles, grids and scratch of :func:`flash_attention_bwd`'s
    kernels for q (B,H,Sq,hd), k/v (B,KV,Sk,hd) of ``dtype``.  fp32
    rows are padded by 4 floats, bf16 rows by 8 elements; a walked tile
    has 16 rows in fp32 or at hd 256 (so shared memory holds two blocks
    an SM up to hd 128), else 32.  At hd 256 two warps share 16 rows,
    each on half of hd, and exchange their score partials through
    shared memory."""
    f32 = dtype == torch.float32
    walk = 16 if f32 or hd == 256 else 32
    splits = 2 if hd == 256 else 1
    esize, pad = (4, 4) if f32 else (2, 8)
    xchg = 0 if splits == 1 else splits * BWD_WARPS * 2 * walk // 8 * 4 * 32
    smem = esize * (hd + pad) * (2 * BWD_ROWS + 4 * walk) + 4 * xchg
    cols = hd // splits
    return BwdPlan(
        rows=BWD_ROWS, walk=walk, splits=splits, cols=cols, smem=smem,
        threads=32 * BWD_WARPS * splits,
        dq_grid=(B * H, -(-Sq // BWD_ROWS)),
        dkdv_grid=(B * H, -(-Sk // BWD_ROWS)),
        scratch=0 if H == KV else 2 * B * H * Sk * hd * 4)


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


def _misaligned(t) -> bool:
    """Whether some row (the last dimension) of the 4-D tensor t starts
    off 16 bytes: its address, or one of the three leading strides of a
    dimension longer than 1, is not a multiple of 16 bytes."""
    st, n = t.stride(), t.shape
    # 16 bytes hold a power of two of elements, so one OR tests all
    lead = ((st[0] if n[0] > 1 else 0) | (st[1] if n[1] > 1 else 0)
            | (st[2] if n[2] > 1 else 0))
    return bool(t.data_ptr() % 16 or lead % (16 // t.element_size()))


def check_aligned(name: str, q, k, v, keys=("q", "k", "v")) -> None:
    """Raise ValueError unless every row (the last dimension) of the 4-D
    tensors q, k and v starts on 16 bytes (:func:`_misaligned`).
    ``keys`` names the three in the message."""
    for key, t in zip(keys, (q, k, v)):
        if _misaligned(t):
            raise ValueError(
                f"{name} needs every row of {key} on 16 bytes; got address "
                f"{t.data_ptr()} and strides {t.stride()} of "
                f"{t.element_size()}-byte elements")


def _forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """Launch the forward kernel: (out, lse or None).  On ``meta``
    tensors, record its cost and return the outputs empty."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.is_meta:
        cost.record("flash_attention",
                    cost.flash_attention(q, k, causal, window, with_lse))
        return out, lse
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q, k, v)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(),
             B, H, KV, Sq, Sk,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], int(causal), window, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (error {err})")
    flash_attention.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """K2 with its backward kernel: what :func:`flash_attention` runs on
    the card when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,hd); k, v: (B,KV,Sk,hd). window=0 ⇒ unbounded.

    Returns (B,H,Sq,hd) in q.dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention has no path for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0


def _rows_aligned(t):
    """t itself if every row of it starts on 16 bytes (what the backward
    kernels' 16-byte copies need), else a contiguous copy of it."""
    if _misaligned(t):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _empty_like_layout(t):
    """An uninitialised tensor of t's shape and dtype whose dimensions lie
    in memory in the order of t's strides (dense, without t's gaps)."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    out = torch.empty([t.shape[i] for i in order], dtype=t.dtype,
                      device=t.device)
    return out.permute([order.index(i) for i in range(t.dim())])


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` = o for
    the output gradient ``dout`` (o's shape, hd contiguous), from the
    forward's log-sum-exp ``lse`` (B,H,Sq) fp32.  On a CPU tensor the
    plain version (``ref.flash_attention_bwd_ref``); on a CUDA tensor
    the kernels, or raises.  The kernels copy q, k, v and dout rows 16
    bytes at a time: one whose rows do not start on 16 bytes is copied
    to a contiguous tensor first."""
    _check(q, k, v, window)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    B, H, Sq, hd = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                           causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd has no path for {q.device}")
    if not (o.device == dout.device == lse.device == q.device):
        raise ValueError("q, k, v, o, lse and dout must lie on one device")
    if q.is_meta:
        cost.record("flash_attention_bwd",
                    cost.flash_attention_bwd(q, k, causal, window))
        return tuple(_empty_like_layout(t) for t in (q, k, v))
    build.refuse_grad("flash_attention_bwd", q, k, v, o, dout)
    dout = dout.to(q.dtype)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    if o.stride(3) != 1 or o.dtype != q.dtype:
        raise ValueError("o must be in q's dtype with hd contiguous")
    lse = lse.contiguous()
    dq, dk, dv = (_empty_like_layout(t) for t in (q, k, v))
    q, k, v, dout = (_rows_aligned(t) for t in (q, k, v, dout))
    KV, Sk = k.shape[1], k.shape[2]
    plan = bwd_plan(B, H, KV, Sq, Sk, hd, q.dtype)
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty(plan.scratch // 4, dtype=torch.float32,
                        device=q.device) if plan.scratch else None)
    grids = (ctypes.c_int * 4)(*plan.dq_grid, *plan.dkdv_grid)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, dout, dq, dk, dv) for s in t.stride()[:3]))
    fn = build.function("flash_attention", "flash_attention_bwd",
                        _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
             None if part is None else part.data_ptr(), plan.scratch // 4,
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KV, Sq, Sk,
             ctypes.cast(grids, ctypes.c_void_p),
             ctypes.cast(strides, ctypes.c_void_p), int(causal), window,
             hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed "
                           f"(error {err})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
