"""RG-LRU linear recurrence: the wrapper of the hand-written CUDA kernel
``csrc/rglru_scan.cu`` (the port of the Pallas ``_rglru_kernel``).

h_t = a_t · h_{t−1} + b_t over axis 1 of (B,S,W), from h_0 = 0, with an
fp32 carry.  a and b are read through their (batch, seq) strides with W
contiguous; h is returned contiguous in a.dtype.  Any S is taken.

The kernel cuts S into segments inside one launch (a block owns 32
channels × n_seg segments; :func:`segment_plan` picks n_seg so that the
grid holds about ``WARPS_PER_SM`` warps an SM): each thread composes
its segment's affine map, the block combines the maps into each
segment's carry-in, and each thread re-walks its segment from it.

On a CPU tensor the wrapper runs the plain version
(``ref.rglru_scan_ref``); on a CUDA tensor it launches the kernel or
raises; on ``meta`` tensors (the dry-run) it records the kernel's cost
and returns h empty, inside ``cost.counting()`` only.

Training: on a CUDA tensor under grad mode with an input that requires
grad, :func:`rglru_scan` runs through :class:`RGLRUScan`, whose forward
launches the same kernel and saves a and h, and whose backward launches
the backward kernel (:func:`rglru_scan_bwd`): g_t = dh_t + a_{t+1}
g_{t+1}, da_t = g_t h_{t−1}, db_t = g_t, walked from the end.  Its
plan is its own (:func:`bwd_plan`): S cut into chunks that a block
holds in registers, the chunks of a channel group chained right to left
through carries the blocks publish in zeroed scratch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.decode_attention import H100_SMS, _sm_count
from repro_torch.kernels.flash_attention import DTYPES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _P, _P, _P, _I, _I, _I, _I] + [_L] * 6 + [_P]
_BWD_ARGTYPES = ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
                 + [_L] * 10 + [_P])

CHANNELS = 32      # channels a block (kCh in the kernel)
MAX_SEGMENTS = 32  # segments a block (kMaxSeg)
REG_STEPS = 16     # steps a thread holds in registers (kR)
WARPS_PER_SM = 16  # the occupancy segment_plan aims for
BWD_SEGMENTS = 16  # segments a backward block (kBwdSeg)
BWD_STEPS = 12     # steps a backward thread holds in registers (kBwdR)


def segment_plan(B: int, S: int, W: int, sms: int = H100_SMS):
    """(seg, n_seg): S cut into n_seg segments of seg steps (the last
    may be shorter, none is empty), at most ``MAX_SEGMENTS``.  The
    segments are as long as they can be while the grid still holds
    ``WARPS_PER_SM`` warps on each of ``sms`` SMs and a segment stays
    within ``REG_STEPS`` steps; no shorter than ``MAX_SEGMENTS`` allow."""
    warps = B * -(-W // CHANNELS)  # warps of one segment row
    want = max(-(-WARPS_PER_SM * sms // warps), -(-S // REG_STEPS))
    want = max(1, min(want, MAX_SEGMENTS, S))
    seg = max(S // want, -(-S // MAX_SEGMENTS))
    return seg, -(-S // seg)


def bwd_plan(S: int):
    """(seg, n_seg, n_chunk) of the backward kernel: S cut into n_chunk
    chunks of n_seg segments of seg steps (the last chunk may be
    shorter, none is empty); a segment is held in registers (seg <=
    ``BWD_STEPS``) and a chunk is one block (n_seg <= ``BWD_SEGMENTS``).
    Chunks are as long as a block can hold, so the chain that carries
    between them is as short as it can be."""
    n_chunk = -(-S // (BWD_SEGMENTS * BWD_STEPS))
    seg = -(-S // (n_chunk * BWD_SEGMENTS))
    n_seg = -(-(-(-S // n_chunk)) // seg)
    return seg, n_seg, -(-S // (seg * n_seg))


def bwd_scratch_words(B: int, S: int, W: int) -> int:
    """32-bit words of the backward's zeroed scratch: a ticket counter,
    then a flag and CHANNELS carries a (channel group, chunk)."""
    n_grp = B * -(-W // CHANNELS)
    return 1 + n_grp * bwd_plan(S)[2] * (1 + CHANNELS)


def _check(a, b) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError("rglru_scan wants a and b of one shape (B,S,W); "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.numel() == 0:
        raise ValueError("rglru_scan needs non-empty B, S and W")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError("rglru_scan takes float32 or bfloat16 a, b of one "
                        f"dtype; got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rglru_scan needs the channel dimension "
                         "contiguous (stride 1) in a and b")


def _forward(a, b):
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if a.is_meta:
        cost.record("rglru_scan", cost.rglru_scan(a))
        return h
    fn = build.function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    seg, _ = segment_plan(B, S, W, _sm_count(a.device.index))
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h.data_ptr(),
             B, S, W, seg, *a.stride()[:2], *b.stride()[:2],
             *h.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed (error {err})")
    rglru_scan.launches += 1
    return h


class RGLRUScan(torch.autograd.Function):
    """K5 with its backward kernel: what :func:`rglru_scan` runs on the
    card when a gradient is wanted."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)


def rglru_scan(a, b):
    """a, b: (B,S,W).  Returns h: (B,S,W) in a.dtype with
    h_t = a_t h_{t−1} + b_t."""
    _check(a, b)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan has no path for {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return _forward(a, b)


rglru_scan.launches = 0


def rglru_scan_bwd(a, h, dh):
    """(da, db) of ``h = rglru_scan(a, b)`` for the output gradient dh,
    from a and the forward's h (all (B,S,W), W contiguous; dh is cast to
    a's dtype).  On a CPU tensor the plain version
    (``ref.rglru_scan_bwd_ref``); on a CUDA tensor the kernel, or
    raises."""
    _check(a, h)
    if dh.shape != a.shape:
        raise ValueError(f"dh {tuple(dh.shape)} must have a's shape "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h, dh)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_bwd has no path for {a.device}")
    if dh.device != a.device:
        raise ValueError("a, h and dh must lie on one device")
    if a.is_meta:
        cost.record("rglru_scan_bwd", cost.rglru_scan_bwd(a))
        return (torch.empty(a.shape, dtype=a.dtype, device=a.device),
                torch.empty(a.shape, dtype=a.dtype, device=a.device))
    build.refuse_grad("rglru_scan_bwd", a, h, dh)
    dh = dh.to(a.dtype)
    if dh.stride(2) != 1:
        dh = dh.contiguous()
    fn = build.function("rglru_scan", "rglru_scan_bwd", _BWD_ARGTYPES)
    B, S, W = a.shape
    seg, n_seg, n_chunk = bwd_plan(S)
    da = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    db = torch.empty_like(da)
    scratch = torch.zeros(bwd_scratch_words(B, S, W), dtype=torch.int32,
                          device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(DTYPES[a.dtype], a.data_ptr(), h.data_ptr(), dh.data_ptr(),
             da.data_ptr(), db.data_ptr(), B, S, W, seg, n_seg, n_chunk,
             scratch.data_ptr(),
             *(s for t in (a, h, dh, da, db) for s in t.stride()[:2]),
             stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed (error {err})")
    rglru_scan_bwd.launches += 1
    return da, db


rglru_scan_bwd.launches = 0
