"""Mamba-2 SSD chunked scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` (the port of the Pallas ``_ssd_kernel``).

The public layout is the reference's: x (B,H,S,hd), dt (B,H,S)
post-softplus, A (H,) negative, B_ and C_ (B,G,S,N) shared by the
H // G heads of each group.  The kernel reads x, B_ and C_ through their
strides (last dimension contiguous) and dt through any strides, so the
model passes transposed views of its (B,S,H,hd) and (B,S,G,N)
activations and nothing is copied; y is laid out as (B,S,H,hd) in memory
and returned as its (B,H,S,hd) view.  Any S is taken: the last chunk may
be short.

The bfloat16 kernel runs its four products on the tensor cores from
bf16 tiles copied by 16-byte ``cp.async``, so on the card every row of
its x, B_ and C_ must start on 16 bytes and N must be a multiple of 8
and at most 128 (the model's views pass: its ``xbc`` rows are 4352 bf16
wide, and mamba2's N is 128).  The float32 kernel keeps fp32 CUDA-core
math.  :func:`smem_bytes` mirrors each kernel's shared memory;
:func:`occupancy` asks the card how many blocks of it share an SM.

Returns ``(y (B,H,S,hd) in x.dtype, final state (B,H,hd,N) float32)``.
On a CPU tensor the wrapper runs the plain version
(``ref.ssd_scan_ref``); on a CUDA tensor it launches the kernel or
raises.

Training: on a CUDA tensor under grad mode with an input that requires
grad, :func:`ssd_scan` runs through :class:`SSDScan`, whose forward
launches the same kernel with each chunk's entry state (B,H,n_chunks,
hd,N) fp32 and saves the inputs and those states, and whose backward
launches the backward kernels (:func:`ssd_scan_bwd`): a chain that
carries the state's gradient right to left and writes each chunk's, a
pass a (batch, head, chunk) that computes dx, ddt, the per-head dB_ and
dC_ and a dA partial, and a pass that sums those over each group's
heads (and dA over batch and chunk) in a fixed order.  :func:`bwd_plan`
gives their grids, shared memory and scratch; the launch takes its
grids from it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (DTYPES, _empty_like_layout,
                                                 check_aligned)

HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
_TILE = 64            # rows per tile in csrc/ssd_scan.cu (kT, kTj)
MAX_N_BF16 = 128      # the bfloat16 kernel holds C's rows over N in registers

_P, _I = ctypes.c_void_p, ctypes.c_int
_LP = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 6 + [_LP, _P]
_OCC_ARGTYPES = [_I] * 4 + [_LP, ctypes.POINTER(ctypes.c_int)]
_BWD_ARGTYPES = [_I, _I] + [_P] * 17 + [_I] * 7 + [_P, _LP, _P]
BWD_THREADS = 256  # threads of every backward block (kThreads)


class BwdPlan(NamedTuple):
    """The backward's launch plan.  ``cs``: the chunk length (chunk cut
    to S); ``chain_grid``: a block a (head, batch); ``chunk_grid``: a
    block a (chunk, head, batch); ``reduce_grid``: a thread an element
    of (S, N) a (group, batch); ``chain_smem``, ``chunk_smem``: dynamic
    shared memory bytes of a block; ``scratch``: bytes of fp32 scratch
    (each chunk's dS_out, the per-head dB_ and dC_ partials, the dA
    partials)."""
    cs: int
    n_chunks: int
    chain_grid: tuple
    chunk_grid: tuple
    reduce_grid: tuple
    threads: int
    chain_smem: int
    chunk_smem: int
    scratch: int


def bwd_plan(B: int, H: int, G: int, S: int, hd: int, N: int,
             chunk: int) -> BwdPlan:
    """The grids, shared memory and scratch of :func:`ssd_scan_bwd`'s
    kernels (``chain_smem_floats`` and ``chunk_smem_floats`` in
    ``csrc/ssd_scan.cu``).  The chain block holds the (hd, N) carry, a
    C and a dy tile and dt and cum over the chunk; the chunk block the B
    and x tiles of a j tile and its dB accumulator, a region that holds
    either the (hd, N) S_in / dS_out or an i tile's C and dy with the
    M, dscores and column-partial tiles, and five vectors over the
    chunk; fp32 rows padded by one float."""
    cs = min(chunk, S)
    nc = -(-S // cs)
    NP, PX, T = N + 1, hd + 1, _TILE
    union = max(hd * NP, T * NP + T * PX + 2 * T * (T + 1) + 16 * T)
    return BwdPlan(
        cs=cs, n_chunks=nc, chain_grid=(H, B, 1), chunk_grid=(nc, H, B),
        reduce_grid=(-(-S * N // BWD_THREADS), G, B), threads=BWD_THREADS,
        chain_smem=4 * (hd * NP + T * NP + T * PX + 2 * cs),
        chunk_smem=4 * (2 * T * NP + T * PX + union + 5 * cs + 16),
        scratch=4 * (B * H * nc * hd * N + 2 * B * H * S * N + B * H * nc))


def smem_bytes(hd: int, N: int, cs: int, dtype=torch.bfloat16) -> int:
    """Shared memory of one block of the kernel for ``dtype`` at chunk
    length ``cs`` (``tc_smem_bytes`` and ``smem_floats`` in
    ``csrc/ssd_scan.cu``).

    bfloat16: the fp32 (hd, N) state, rows padded by 8 floats; dt, the
    running decay and the update weight over cs rounded up to a pass
    (128 rows at hd <= 64, else 64: ``tc_rows`` in the kernel); a ring
    of two bf16 (B, x) tiles, rows padded by 8 elements, N padded to 16
    (each pass also stages its C rows and its y rows there).

    float32: the state, C and B tiles, an x tile, a score tile and dt
    and the decay, in fp32, rows padded by one float."""
    if dtype == torch.bfloat16:
        npad = -(-N // 16) * 16
        rows = 128 if hd <= 64 else 64
        csp = -(-cs // rows) * rows
        return (4 * (hd * (npad + 8) + 3 * csp)
                + 2 * 2 * _TILE * (npad + 8 + hd + 8))
    NP = N + 1
    return 4 * (hd * NP + 2 * _TILE * NP + _TILE * (hd + 1)
                + _TILE * (_TILE + 1) + 2 * cs)


def _check(x, dt, A, B_, C_, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 4 \
            or C_.dim() != 4:
        raise ValueError("ssd_scan wants x (B,H,S,hd), dt (B,H,S), A (H,) "
                         f"and B_, C_ (B,G,S,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
    if dt.shape != (Bb, H, S) or A.shape != (H,) or C_.shape != B_.shape \
            or B_.shape[0] != Bb or B_.shape[2] != S:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B_ "
                         f"{tuple(B_.shape)} or C_ {tuple(C_.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    if Bb == 0 or S == 0 or N == 0:
        raise ValueError("ssd_scan needs non-empty B, S and N")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported; one of {HEAD_DIMS}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError("ssd_scan takes float32 or bfloat16 x, B_, C_ of "
                        f"one dtype; got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if smem_bytes(hd, N, min(chunk, S), x.dtype) > SMEM_LIMIT:
        raise ValueError(f"hd {hd}, N {N} and chunk {chunk} need more "
                         "shared memory than a block has")
    if dt.dtype not in (torch.float32, x.dtype) or A.dtype != torch.float32:
        raise TypeError(f"dt must be float32 or {x.dtype} and A float32; "
                        f"got {dt.dtype} and {A.dtype}")
    if not (x.device == dt.device == A.device == B_.device == C_.device):
        raise ValueError("x, dt, A, B_ and C_ must lie on one device")
    if x.stride(3) != 1 or B_.stride(3) != 1 or C_.stride(3) != 1:
        raise ValueError("ssd_scan needs the last dimension of x, B_ and "
                         "C_ contiguous (stride 1)")


def occupancy(dtype, hd: int, N: int, cs: int):
    """(shared bytes, blocks an SM) of the kernel for ``dtype`` at
    (hd, N, chunk length cs), as the card reports them."""
    fn = build.function("ssd_scan", "ssd_scan_occupancy", _OCC_ARGTYPES)
    smem, blocks = ctypes.c_longlong(), ctypes.c_int()
    err = fn(DTYPES[dtype], hd, N, cs, ctypes.byref(smem),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ssd_scan occupancy query failed (error {err})")
    return smem.value, blocks.value


def _forward(x, dt, A, B_, C_, chunk: int, with_states: bool):
    """Launch the forward kernel: (y, final state, chunk-entry states or
    None)."""
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
    if x.dtype == torch.bfloat16:
        if N % 8 or N > MAX_N_BF16:
            raise ValueError("the bfloat16 ssd_scan kernel needs N a "
                             f"multiple of 8 (16 bytes) and at most "
                             f"{MAX_N_BF16}; got {N}")
        check_aligned("ssd_scan", x, B_, C_, keys=("x", "B_", "C_"))
    fn = build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    dt = dt.float()  # the model's dt is float32 already: no copy
    cs = min(chunk, S)
    y = torch.empty((Bb, S, H, hd), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((Bb, H, hd, N), dtype=torch.float32,
                        device=x.device)
    states = (torch.empty((Bb, H, -(-S // cs), hd, N), dtype=torch.float32,
                          device=x.device) if with_states else None)
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *B_.stride()[:3], *C_.stride()[:3],
        *y.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPES[x.dtype], hd, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
             B_.data_ptr(), C_.data_ptr(), y.data_ptr(), state.data_ptr(),
             None if states is None else states.data_ptr(),
             Bb, H, G, S, N, cs, strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (error {err})")
    ssd_scan.launches += 1
    return y, state, states


class SSDScan(torch.autograd.Function):
    """K4 with its backward kernels: what :func:`ssd_scan` runs on the
    card when a gradient is wanted.  The final state's gradient arrives
    as None when the caller does not use it (training)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk: int):
        y, state, states = _forward(x, dt, A, B_, C_, chunk, with_states=True)
        ctx.save_for_backward(x, dt, A, B_, C_, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_, C_, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, A, B_, C_, dy, dstate, chunk=ctx.chunk,
                             states=states)
        return (*grads, None)


def ssd_scan(x, dt, A, B_, C_, *, chunk: int = 256):
    """x: (B,H,S,hd); dt: (B,H,S) post-softplus; A: (H,) negative;
    B_, C_: (B,G,S,N) with H % G == 0.  ``chunk`` is the length of the
    chunks the kernel walks.

    Returns (y (B,H,S,hd) in x.dtype, final state (B,H,hd,N) float32);
    the D-skip and the gating are the caller's."""
    _check(x, dt, A, B_, C_, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B_, C_, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no path for {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B_, C_)):
        return SSDScan.apply(x, dt, A, B_, C_, chunk)
    return _forward(x, dt, A, B_, C_, chunk, with_states=False)[:2]


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, A, B_, C_, dy, dstate=None, *, chunk: int = 256,
                 states=None):
    """The gradients (dx, ddt, dA, dB_, dC_) of ``ssd_scan(x, dt, A, B_,
    C_)`` for the output gradient ``dy`` (x's shape, hd contiguous) and
    the final state's gradient ``dstate`` (B,H,hd,N), or None for zero;
    each in its input's dtype.  On a CPU tensor the plain version
    (``ref.ssd_scan_bwd_ref``, which recomputes what it needs and
    ignores ``states``); on a CUDA tensor the kernels, from the
    forward's chunk-entry ``states`` (B,H,n_chunks,hd,N) fp32, or
    raises."""
    _check(x, dt, A, B_, C_, chunk)
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if dstate is not None and dstate.shape != (Bb, H, hd, N):
        raise ValueError(f"dstate must be ({Bb}, {H}, {hd}, {N}); got "
                         f"{tuple(dstate.shape)}")
    plan = bwd_plan(Bb, H, G, S, hd, N, chunk)
    if states is not None and states.shape != (Bb, H, plan.n_chunks, hd, N):
        raise ValueError(f"states must be ({Bb}, {H}, {plan.n_chunks}, "
                         f"{hd}, {N}); got {tuple(states.shape)}")
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(x, dt, A, B_, C_, dy, dstate,
                                    chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd has no path for {x.device}")
    if states is None or states.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd needs the forward's float32 chunk "
                         "states on the card")
    if max(plan.chain_smem, plan.chunk_smem) > SMEM_LIMIT:
        raise ValueError(f"hd {hd}, N {N} and chunk {chunk} need more "
                         "shared memory than a backward block has")
    if not all(t.device == x.device for t in (dy, states) + (
            () if dstate is None else (dstate,))):
        raise ValueError("the inputs, dy, dstate and states must lie on "
                         "one device")
    build.refuse_grad("ssd_scan_bwd", x, dt, A, B_, C_, dy, dstate, states)
    dy = dy.to(x.dtype)
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    states = states.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    dtf = dt.float()
    dx, dB, dC = (_empty_like_layout(t) for t in (x, B_, C_))
    ddt = torch.empty((Bb, H, S), dtype=torch.float32, device=x.device)
    dA = torch.empty(H, dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.scratch // 4, dtype=torch.float32,
                          device=x.device)
    n_so, n_p = Bb * H * plan.n_chunks * hd * N, Bb * H * S * N
    d_so, d_bp, d_cp, d_ap = (scratch[o:o + n].data_ptr() for o, n in (
        (0, n_so), (n_so, n_p), (n_so + n_p, n_p),
        (n_so + 2 * n_p, Bb * H * plan.n_chunks)))
    grid = (ctypes.c_int * 9)(*plan.chain_grid, *plan.chunk_grid,
                              *plan.reduce_grid)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (x, dtf, B_, C_, dy, dx, dB, dC) for s in t.stride()[:3]))
    fn = build.function("ssd_scan", "ssd_scan_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(DTYPES[x.dtype], hd, x.data_ptr(), dtf.data_ptr(), A.data_ptr(),
             B_.data_ptr(), C_.data_ptr(), dy.data_ptr(), states.data_ptr(),
             None if dstate is None else dstate.data_ptr(), d_so, d_bp, d_cp,
             d_ap, dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), dA.data_ptr(), Bb, H, G, S, N, plan.cs,
             plan.n_chunks, ctypes.cast(grid, ctypes.c_void_p), strides,
             stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed (error {err})")
    ssd_scan_bwd.launches += 1
    return dx, ddt.to(dt.dtype), dA, dB, dC


ssd_scan_bwd.launches = 0
