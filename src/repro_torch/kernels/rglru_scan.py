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
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import H100_SMS, _sm_count
from repro_torch.kernels.flash_attention import DTYPES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _P, _P, _P, _I, _I, _I, _I] + [_L] * 6 + [_P]

CHANNELS = 32      # channels a block (kCh in the kernel)
MAX_SEGMENTS = 32  # segments a block (kMaxSeg)
REG_STEPS = 16     # steps a thread holds in registers (kR)
WARPS_PER_SM = 16  # the occupancy segment_plan aims for


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


def rglru_scan(a, b):
    """a, b: (B,S,W).  Returns h: (B,S,W) in a.dtype with
    h_t = a_t h_{t−1} + b_t."""
    _check(a, b)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan has no path for {a.device}")
    build.refuse_grad("rglru_scan", a, b)
    fn = build.function("rglru_scan", "rglru_scan_fwd", _ARGTYPES)
    B, S, W = a.shape
    seg, _ = segment_plan(B, S, W, _sm_count(a.device.index))
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), h.data_ptr(),
             B, S, W, seg, *a.stride()[:2], *b.stride()[:2],
             *h.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed (error {err})")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
