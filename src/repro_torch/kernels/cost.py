"""The work of each kernel wrapper at its arguments' shapes: operations,
bytes and the rate they run at on the H100, and the least time the card
could take for them.

One count serves two readers: ``chip_smoke.py``'s ``bound_ms`` of each
kernel, and the dry-run (``launch/dryrun.py``), where a wrapper called
on ``meta`` tensors records its :class:`Cost` in place of launching
(:func:`record`).  Bytes count each input read once and each output
written once; operations count what the algorithm does (2 a
multiply-add).  ``rate`` names the peak the operations are held to:
``"bf16"`` (the tensor cores), ``"fp32"`` (the CUDA cores) or
``"tf32x3"`` (an fp32 body that issues three TF32 products a product:
3 × the operations at the TF32 rate).

Where the work depends on the data, the caller passes what its data
needs (``live`` slots of a decode step, the charged pass's ``rescan``);
on ``meta`` there is no data, and the dry-run counts every slot of the
cache and no rescan.
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.hlo import (HBM_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_FP32, PEAK_FLOPS_TF32)

# rate → (products issued a product, operations a second)
RATES = {"bf16": (1, PEAK_FLOPS_BF16), "fp32": (1, PEAK_FLOPS_FP32),
         "tf32x3": (3, PEAK_FLOPS_TF32)}


class Cost(NamedTuple):
    flops: float
    nbytes: float
    rate: str


def bound(c: Cost, rate: Optional[str] = None) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak of ``rate`` (``c.rate``
    unless given)."""
    issue, peak = RATES[rate or c.rate]
    t_bytes = c.nbytes / HBM_BW * 1e3
    t_ops = issue * c.flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rate(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs ``ref.attention_mask`` lets through: key j
    is seen by query i when j <= i (causal) and j > i - window
    (window > 0)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# ----------------------------------------------------------------------
# The model's kernels
# ----------------------------------------------------------------------
def flash_attention(q, k, causal: bool = True, window: int = 0,
                    with_lse: bool = False) -> Cost:
    """K2: q, k, v read once, the output (and the fp32 log-sum-exp)
    written once; QKᵀ and PV, 2·hd operations each, over the visible
    pairs."""
    B, H, Sq, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[2], causal, window)
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    if with_lse:
        nbytes += 4 * B * H * Sq
    return Cost(4 * hd * pairs * B * H, nbytes, _rate(q.dtype))


def flash_attention_bwd(q, k, causal: bool = True, window: int = 0) -> Cost:
    """K2's backward: q, k, v, o, dO and the lse read once, dq, dk, dv
    written once; the FA2 backward's five products (S, dP, dV, dK, dQ:
    2·hd operations each) over the visible pairs.  The bf16 body does
    them on the tensor cores; the fp32 body as 3xTF32."""
    B, H, Sq, hd = q.shape
    pairs = visible_pairs(Sq, k.shape[2], causal, window)
    nbytes = (q.element_size() * 4 * (q.numel() + k.numel())
              + 4 * B * H * Sq)
    return Cost(10 * hd * pairs * B * H, nbytes,
                "tf32x3" if q.dtype == torch.float32 else "bf16")


def decode_attention(q, live: int) -> Cost:
    """K3: the ``live`` (batch, KV head, slot) rows of k and v up to each
    sequence's position read once, q read and the output written once,
    pos read; q·k and p·v, 2·hd operations each a (query row, slot)."""
    B, KV, G, hd = q.shape
    esize = q.element_size()
    return Cost(4 * G * hd * live,
                esize * (2 * q.numel() + 2 * live * hd) + 4 * B,
                _rate(q.dtype))


def decode_attention_int8(q, live: int, write: bool = False) -> Cost:
    """K3-int8: the live slots' int8 k and v rows and their two fp32
    scales read once, q read and the output written once, pos read; with
    the write, also the new token's k and v read, their int8 rows and
    scales written and the slots read, and the quantizer's ~4 operations
    an element."""
    B, KV, G, hd = q.shape
    nbytes = live * (2 * hd + 2 * 4) + 2 * q.element_size() * q.numel() \
        + 4 * B
    ops = 4 * G * hd * live
    if write:
        nbytes += B * KV * (2 * hd * q.element_size() + 2 * hd + 2 * 4) + 4 * B
        ops += 8 * B * KV * hd
    return Cost(ops, nbytes, _rate(q.dtype))


def ssd_scan(B: int, H: int, G: int, S: int, hd: int, N: int, chunk: int,
             dtype) -> Cost:
    """K4: x, B_, C_, dt, A read once, y and the final state written
    once; the scores once per (batch, group) and chunk, M·X and the state
    update per head and chunk, and the inter-chunk term on every chunk
    but the first (where the state is zero).  bf16 on the tensor cores;
    fp32 as 3xTF32."""
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (esize * (2 * B * H * S * hd + 2 * B * G * S * N)
              + 4 * (B * H * S + H + B * H * hd * N))
    ops = 0
    for s0 in range(0, S, chunk):
        ln = min(chunk, S - s0)
        pairs = ln * (ln + 1) // 2
        ops += 2 * B * G * pairs * N + 2 * B * H * (
            pairs * hd + ln * hd * N * (2 if s0 else 1))
    return Cost(ops, nbytes, "tf32x3" if dtype == torch.float32 else "bf16")


def ssd_scan_bwd(B: int, H: int, G: int, S: int, hd: int, N: int,
                 chunk: int, dtype, dstate: bool = False) -> Cost:
    """K4's backward: x, dy, dt, A, B_, C_, the forward's chunk states
    (and dstate) read once, dx, ddt, dA, dB_ and dC_ written once; per
    chunk the scores C·Bᵀ once per (batch, group) over the causal pairs,
    and per head dy·xᵀ, Mᵀ·dy, dscores·B and dscoresᵀ·C over the pairs,
    the state update's G·B and Gᵀ·x over the rows, and on every chunk
    but the first the inter-chunk dy·S_in and the chain's dyᵀ·C.  fp32
    as 3xTF32."""
    esize = 2 if dtype == torch.bfloat16 else 4
    cs = min(chunk, S)
    nc = -(-S // cs)
    nbytes = (esize * (3 * B * H * S * hd + 4 * B * G * S * N)
              + 4 * (2 * B * H * S + 2 * H + B * H * nc * hd * N
                     + (B * H * hd * N if dstate else 0)))
    ops = 0
    for s0 in range(0, S, cs):
        ln = min(cs, S - s0)
        pairs = ln * (ln + 1) // 2
        ops += 2 * B * G * pairs * N + 2 * B * H * (
            2 * pairs * hd + 2 * pairs * N + ln * hd * N * (4 if s0 else 2))
    return Cost(ops, nbytes, "tf32x3" if dtype == torch.float32 else "bf16")


def rglru_scan(a) -> Cost:
    """K5: a and b read once, h written once; a multiply-add an element
    with an fp32 carry."""
    return Cost(2 * a.numel(), a.element_size() * 3 * a.numel(), "fp32")


def rglru_scan_bwd(a) -> Cost:
    """K5's backward: a, h and dh read once, da and db written once; two
    multiply-adds an element."""
    return Cost(4 * a.numel(), a.element_size() * 5 * a.numel(), "fp32")


# ----------------------------------------------------------------------
# The selection kernels (fp32 on the CUDA cores)
# ----------------------------------------------------------------------
def modipick_probs(B: int, n: int) -> Cost:
    """K1: the pool, the row bounds and the eligibility read once, the
    probabilities written; ~12 fp32 operations a (request, model)."""
    return Cost(12 * B * n, 4 * (3 * n + 2 * B + 2 * B * n), "fp32")


def fused_select(B: int, n: int) -> Cost:
    """The fused selection: pool and rows read once, picks written; ~20
    fp32 operations a (request, model): Eq. 2, the window, Eq. 3-4, the
    mass, the normalisation and the running sum."""
    return Cost(20 * B * n, 4 * (4 * n + 3 * B) + 4 * B, "fp32")


def charged_select(n: int, R: int, B: int, lists: int,
                   rescan: int = 0) -> Cost:
    """The charged pass: pool, candidate lists (``lists`` int32 words),
    ledger and rows read once, five outputs written; ~20 fp32 operations
    a (request, model) for stages 1-3, and ``rescan``: for each admitted
    request, the rows of the models its replica serves (one compare a
    candidate)."""
    return Cost(20 * B * n + rescan,
                4 * (5 * n + 2 * R + 4 * B + lists) + 14 * B, "fp32")


def stacked_select(mu, acc, row, shifts=None) -> Cost:
    """The stacked selection: the pool rows (mu, sigma, acc, rank, the
    shifts) and per request its row, bounds and uniform read once, its
    pick and flag written; ~20 fp32 operations a (request, model)."""
    B, n = row.shape[0], mu.shape[1]
    nshift = 0 if shifts is None else n
    nbytes = 4 * (2 * mu.numel() + 2 * acc.numel() + nshift) + 21 * B
    return Cost(20 * B * n, nbytes, "fp32")


# ----------------------------------------------------------------------
# The dry-run's count
# ----------------------------------------------------------------------
class Tally:
    """Kernel costs recorded by wrappers called on ``meta`` tensors:
    ``flops`` and ``nbytes`` summed, ``calls`` by wrapper."""

    def __init__(self):
        self.flops = 0.0
        self.nbytes = 0.0
        self.calls: Dict[str, int] = {}

    def add(self, name: str, c: Cost) -> None:
        self.flops += c.flops
        self.nbytes += c.nbytes
        self.calls[name] = self.calls.get(name, 0) + 1


_STATE = threading.local()


class counting:
    """``with counting() as tally``: within the block a kernel wrapper
    called on ``meta`` tensors records its cost in ``tally`` (a
    :class:`Tally`) and returns empty outputs; outside it, such a call
    raises."""

    def __enter__(self) -> Tally:
        self._prev = getattr(_STATE, "tally", None)
        _STATE.tally = Tally()
        return _STATE.tally

    def __exit__(self, *exc) -> None:
        _STATE.tally = self._prev


def record(name: str, c: Cost) -> None:
    """Record wrapper ``name``'s cost on ``meta`` tensors; outside
    :func:`counting` a wrapper has no path for ``meta`` and raises a
    ValueError, as for any other device it has no code for."""
    tally = getattr(_STATE, "tally", None)
    if tally is None:
        raise ValueError(f"{name} has no path for meta tensors outside "
                         "cost.counting(), the dry-run's count")
    tally.add(name, c)
