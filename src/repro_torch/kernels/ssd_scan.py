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

The bfloat16 kernel (the serve path) runs its four products on the
tensor cores from bf16 tiles copied by 16-byte ``cp.async``, so on the
card every row of its x, B_ and C_ must start on 16 bytes and N must be
a multiple of 8 and at most 128 (the model's views pass: its ``xbc``
rows are 4352 bf16 wide, and mamba2's N is 128).  :func:`smem_bytes`
mirrors its shared memory; :func:`occupancy` asks the card how many
blocks of it share an SM.

The float32 kernel (training) is the training path's four passes, all
products by 3xTF32 on the tensor cores: the scores C·Bᵀ once per
(batch, group, chunk, 64 × 64 tile pair) for all the group's heads;
each chunk's local state over (chunk, head, batch); the chain of
chunk-entry states, elementwise; the outputs over (64-row tile, chunk,
head, batch).  :func:`fwd_plan` gives their grids, shared memory and
scratch; the launch takes its grids from it.

Returns ``(y (B,H,S,hd) in x.dtype, final state (B,H,hd,N) float32)``.
On a CPU tensor the wrapper runs the plain version
(``ref.ssd_scan_ref``); on a CUDA tensor it launches the kernel or
raises; on ``meta`` tensors (the dry-run) it records the kernel's cost
and returns its outputs empty, inside ``cost.counting()`` only.

Training: on a CUDA tensor under grad mode with an input that requires
grad, :func:`ssd_scan` runs through :class:`SSDScan`, whose forward
launches the same kernel with each chunk's entry state (B,H,n_chunks,
hd,N) fp32 and saves the inputs and those states, and whose backward
launches the backward's passes (:func:`ssd_scan_bwd`), on the same
machinery: the scores; per (chunk, head, batch) the chain's local term
and the inter-chunk term's d(cum); the dscores summed over the heads of
each group (in ``nsplit`` splits, so that the grid fills the card), with
each head's d(cum) terms; the chain of the state's gradient,
elementwise; dx per (64-row tile, chunk, head, batch); dB_ and dC_ per
(64-row tile, 64 columns of N, chunk, batch, group), the heads'
inter-chunk terms one product over (head, hd); ddt per (chunk, head,
batch) and dA over the heads.  :func:`bwd_plan` gives their grids,
shared memory and scratch; the launch takes its grids from it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.flash_attention import (DTYPES, _empty_like_layout,
                                                 check_aligned)

HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (H100)
_TILE = 64            # rows per tile in csrc/ssd_scan.cu (kTj; the training path's tiles)
MAX_N_BF16 = 128      # the bfloat16 kernel holds C's rows over N in registers
SMS = 132             # the H100's SMs: the backward's dscores pass splits a
                      # group's heads until its grid fills two blocks an SM

_P, _I = ctypes.c_void_p, ctypes.c_int
_LP = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 6 + [_LP, _P, _P, _P]
_OCC_ARGTYPES = [_I] * 5 + [_LP, ctypes.POINTER(ctypes.c_int)]
_BWD_ARGTYPES = [_I, _I] + [_P] * 14 + [_I] * 8 + [_P, _LP, _P]
FWD_PASSES = ("scores", "state", "chain", "out")
BWD_PASSES = ("scores", "local", "ds", "chain", "dx", "dbdc", "dt", "da")
_FWD_THREADS = (128, 256, 256, 128)
_BWD_THREADS = (128, 256, 128, 256, 128, 128, 256, 256)


class TrainSmem(NamedTuple):
    """Dynamic shared memory bytes of a block of each pass of the
    training path (``train_smem`` in ``csrc/ssd_train.cuh``); the chains
    and the dA pass take none."""
    scores: int
    fwd_state: int
    fwd_out: int
    local: int
    dx: int
    ds: int
    dbdc: int
    dt: int


def _pad32(v: int) -> int:
    return -(-v // 32) * 32


def _tiles(cs: int):
    """(tiles, rows padded to tiles, tile pairs jt <= it) of a chunk."""
    nt = -(-cs // _TILE)
    return nt, _TILE * nt, nt * (nt + 1) // 2


def train_smem(hd: int, N: int, cs: int) -> TrainSmem:
    """The training path's shared memory at (hd, N, chunk length cs):
    fp32 tiles of 64 rows, N and hd padded to 32 (hd at least 32); rows
    over N padded by 4 floats (8 where a product reads them down a
    column), over hd by 8 (4); 64 x 64 score tiles by 4 (8)."""
    PP, Np = max(hd, 32), _pad32(N)
    cs64 = _tiles(cs)[1]
    ln, lx = Np + 4, PP + 8
    words = TrainSmem(
        scores=2 * 64 * ln,
        fwd_state=PP * ln + 64 * lx + 64 * (Np + 8) + 3 * cs64,
        fwd_out=2 * cs64 + 64 + max(64 * ln + PP * ln,
                                    2 * 64 * 68 + 2 * 64 * lx),
        local=2 * PP * ln + 64 * ln + 64 * lx + PP // 32 * 64 + 2 * cs64,
        dx=2 * cs64 + PP // 32 * 64 + 4 + max(64 * ln + PP * ln + 64 * lx,
                                              2 * 64 * 72 + 2 * 64 * lx),
        ds=64 * 68 + 2 * 64 * (PP + 4) + 3 * 64 + 4 * 64 + 4,
        dbdc=128 + max(2 * 64 * (PP + 4) + 2 * PP * 72, 2 * 64 * 72),
        dt=2 * cs64 + 16)
    return TrainSmem(*(4 * w for w in words))


class FwdPlan(NamedTuple):
    """The float32 forward's launch plan.  ``cs``: the chunk length
    (chunk cut to S); ``grids``: the passes' grids in ``FWD_PASSES``
    order (scores: a tile pair a (chunk, batch·group); state: a (chunk,
    head, batch); chain: 256 elements of (hd, N) a (head, batch); out: a
    64-row tile of a (chunk, head, batch)); ``threads`` and ``smem``
    (dynamic bytes) a block of each; ``scratch``: bytes of fp32 scratch
    (the scores, the chunks' totals and, without ``with_states``, the
    chunk-entry states)."""
    cs: int
    n_chunks: int
    tiles: int
    pairs: int
    grids: tuple
    threads: tuple
    smem: tuple
    scratch: int


def fwd_plan(B: int, H: int, G: int, S: int, hd: int, N: int, chunk: int,
             with_states: bool = True) -> FwdPlan:
    """The grids, shared memory and scratch of the float32 forward's
    passes (``fwd_grids`` in ``csrc/ssd_scan.cu``, ``train_smem`` in
    ``csrc/ssd_train.cuh``)."""
    cs = min(chunk, S)
    nc = -(-S // cs)
    nt, cs64, npairs = _tiles(cs)
    sm = train_smem(hd, N, cs)
    return FwdPlan(
        cs=cs, n_chunks=nc, tiles=nt, pairs=npairs,
        grids=((npairs, nc, B * G), (nc, H, B), (-(-hd * N // 256), H, B),
               (nt * nc, H, B)),
        threads=_FWD_THREADS, smem=(sm.scores, sm.fwd_state, 0, sm.fwd_out),
        scratch=4 * (B * G * nc * cs64 * cs64 + B * H * nc
                     + (0 if with_states else B * H * nc * hd * N)))


class BwdPlan(NamedTuple):
    """The backward's launch plan.  ``cs``: the chunk length (chunk cut
    to S); ``nsplit``: the splits of each group's heads in the dscores
    pass; ``grids``: the passes' grids in ``BWD_PASSES`` order (scores:
    a tile pair a (chunk, batch·group); local: a (chunk, head, batch);
    ds: a (tile pair, split) a (chunk, batch·group); chain: 256 elements
    of (hd, N) a (head, batch); dx: a 64-row tile a (chunk, head,
    batch); dbdc: a (64-row tile, 64 columns of N, dB or dC) a (chunk,
    batch·group); dt: a (chunk, head, batch); da: one block);
    ``threads`` and ``smem`` (dynamic bytes) a block of each;
    ``scratch``: bytes of fp32 scratch (the scores, ``nsplit`` sums of
    dscores, dS_out, cum, q and dw per row, the totals and ⟨G, S_in⟩
    per chunk, the d(cum) row and column sums and paired dA terms per
    tile pair, the dA partials)."""
    cs: int
    n_chunks: int
    tiles: int
    pairs: int
    nsplit: int
    grids: tuple
    threads: tuple
    smem: tuple
    scratch: int


def bwd_plan(B: int, H: int, G: int, S: int, hd: int, N: int,
             chunk: int) -> BwdPlan:
    """The grids, shared memory and scratch of :func:`ssd_scan_bwd`'s
    passes (``bwd_grids`` in ``csrc/ssd_scan_bwd.cu``, ``train_smem`` in
    ``csrc/ssd_train.cuh``).
    The dscores pass splits each group's heads into the fewest splits
    that give it two blocks on each of the card's SMS SMs (at most one
    head a split)."""
    cs = min(chunk, S)
    nc = -(-S // cs)
    nt, cs64, npairs = _tiles(cs)
    units = npairs * nc * B * G
    nsplit = max(1, min(H // G, -(-2 * SMS // units)))
    sm = train_smem(hd, N, cs)
    sq, bhc = B * G * nc * cs64 * cs64, B * H * nc
    return BwdPlan(
        cs=cs, n_chunks=nc, tiles=nt, pairs=npairs, nsplit=nsplit,
        grids=((npairs, nc, B * G), (nc, H, B), (npairs * nsplit, nc, B * G),
               (-(-hd * N // 256), H, B), (nt * nc, H, B),
               (nt * 2 * -(-N // 64), nc, B * G), (nc, H, B), (1, 1, 1)),
        threads=_BWD_THREADS,
        smem=(sm.scores, sm.local, sm.ds, 0, sm.dx, sm.dbdc, sm.dt, 0),
        scratch=4 * ((1 + nsplit) * sq + bhc * hd * N + 3 * B * H * S
                     + bhc * (3 + 129 * npairs)))


def split_heads(H: int, G: int, nsplit: int):
    """The heads each split of the backward's dscores pass sums, for
    each group: ``[[(first, end), ...] for each group]``, as
    ``ssd_bwd_ds_kernel`` cuts them (a split past the group's last head
    is empty)."""
    hg = H // G
    hps = -(-hg // nsplit)
    return [[(g * hg + min(sp * hps, hg), g * hg + min((sp + 1) * hps, hg))
             for sp in range(nsplit)] for g in range(G)]


def smem_bytes(hd: int, N: int, cs: int, dtype=torch.bfloat16) -> int:
    """Shared memory of one block of the kernel for ``dtype`` at chunk
    length ``cs`` (``tc_smem_bytes`` and ``train_smem`` in
    ``csrc/ssd_scan.cu``).

    bfloat16: the fp32 (hd, N) state, rows padded by 8 floats; dt, the
    running decay and the update weight over cs rounded up to a pass
    (128 rows at hd <= 64, else 64: ``tc_rows`` in the kernel); a ring
    of two bf16 (B, x) tiles, rows padded by 8 elements, N padded to 16
    (each pass also stages its C rows and its y rows there).

    float32: the largest block of the forward's passes
    (:func:`train_smem`)."""
    if dtype == torch.bfloat16:
        npad = -(-N // 16) * 16
        rows = 128 if hd <= 64 else 64
        csp = -(-cs // rows) * rows
        return (4 * (hd * (npad + 8) + 3 * csp)
                + 2 * 2 * _TILE * (npad + 8 + hd + 8))
    sm = train_smem(hd, N, cs)
    return max(sm.scores, sm.fwd_state, sm.fwd_out)


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


def occupancy(dtype, hd: int, N: int, cs: int, pass_: int = 0):
    """(shared bytes, blocks an SM) of the kernel for ``dtype`` at
    (hd, N, chunk length cs), as the card reports them: bfloat16's one
    kernel (``pass_`` 0), or the float32 forward's pass ``pass_``
    (``FWD_PASSES``)."""
    fn = build.function("ssd_scan", "ssd_scan_occupancy", _OCC_ARGTYPES)
    smem, blocks = ctypes.c_longlong(), ctypes.c_int()
    err = fn(DTYPES[dtype], hd, N, cs, pass_, ctypes.byref(smem),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ssd_scan occupancy query failed (error {err})")
    return smem.value, blocks.value


def _grid_array(grids):
    return (ctypes.c_int * (3 * len(grids)))(*(g for grid in grids
                                              for g in grid))


def _forward(x, dt, A, B_, C_, chunk: int, with_states: bool):
    """Launch the forward kernel: (y, final state, chunk-entry states or
    None).  On ``meta`` tensors, record its cost and return them
    empty."""
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
    if x.dtype == torch.bfloat16 and (N % 8 or N > MAX_N_BF16):
        raise ValueError("the bfloat16 ssd_scan kernel needs N a "
                         f"multiple of 8 (16 bytes) and at most "
                         f"{MAX_N_BF16}; got {N}")
    cs = min(chunk, S)
    y = torch.empty((Bb, S, H, hd), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((Bb, H, hd, N), dtype=torch.float32,
                        device=x.device)
    states = (torch.empty((Bb, H, -(-S // cs), hd, N), dtype=torch.float32,
                          device=x.device) if with_states else None)
    if x.is_meta:
        cost.record("ssd_scan", cost.ssd_scan(Bb, H, G, S, hd, N, chunk,
                                              x.dtype))
        return y, state, states
    scratch = grid = None
    if x.dtype == torch.bfloat16:
        check_aligned("ssd_scan", x, B_, C_, keys=("x", "B_", "C_"))
    else:
        plan = fwd_plan(Bb, H, G, S, hd, N, chunk, with_states)
        scratch = torch.empty(plan.scratch // 4, dtype=torch.float32,
                              device=x.device)
        grid = _grid_array(plan.grids)
    fn = build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    dt = dt.float()  # the model's dt is float32 already: no copy
    strides = (ctypes.c_longlong * 15)(
        *x.stride()[:3], *dt.stride(), *B_.stride()[:3], *C_.stride()[:3],
        *y.stride()[:3])
    err = fn(DTYPES[x.dtype], hd, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
             B_.data_ptr(), C_.data_ptr(), y.data_ptr(), state.data_ptr(),
             None if states is None else states.data_ptr(),
             Bb, H, G, S, N, cs, strides,
             None if scratch is None else scratch.data_ptr(),
             None if grid is None else ctypes.cast(grid, ctypes.c_void_p),
             _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (error {err})")
    ssd_scan.launches += 1
    return y, state, states


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


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
    if x.device.type not in ("cuda", "meta"):
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
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan_bwd has no path for {x.device}")
    if states is None or states.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd needs the forward's float32 chunk "
                         "states on the card")
    if max(plan.smem) > SMEM_LIMIT:
        raise ValueError(f"hd {hd}, N {N} and chunk {chunk} need more "
                         "shared memory than a backward block has")
    if not all(t.device == x.device for t in (dy, states) + (
            () if dstate is None else (dstate,))):
        raise ValueError("the inputs, dy, dstate and states must lie on "
                         "one device")
    if x.is_meta:
        cost.record("ssd_scan_bwd", cost.ssd_scan_bwd(
            Bb, H, G, S, hd, N, chunk, x.dtype, dstate is not None))
        return (_empty_like_layout(x),
                torch.empty((Bb, H, S), dtype=dt.dtype, device=x.device),
                torch.empty(H, dtype=torch.float32, device=x.device),
                _empty_like_layout(B_), _empty_like_layout(C_))
    build.refuse_grad("ssd_scan_bwd", x, dt, A, B_, C_, dy, dstate, states)
    out = _backward(x, dt, A, B_, C_, dy, dstate, states, plan)
    ssd_scan_bwd.launches += 1
    return out


def _backward(x, dt, A, B_, C_, dy, dstate, states, plan: BwdPlan):
    """Launch the backward's passes on ``plan``: (dx, ddt, dA, dB_,
    dC_)."""
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
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
    grid = _grid_array(plan.grids)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (x, dtf, B_, C_, dy, dx, dB, dC) for s in t.stride()[:3]))
    fn = build.function("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    err = fn(DTYPES[x.dtype], hd, x.data_ptr(), dtf.data_ptr(), A.data_ptr(),
             B_.data_ptr(), C_.data_ptr(), dy.data_ptr(), states.data_ptr(),
             None if dstate is None else dstate.data_ptr(),
             scratch.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), dA.data_ptr(), Bb, H, G, S, N, plan.cs,
             plan.n_chunks, plan.nsplit, ctypes.cast(grid, ctypes.c_void_p),
             strides, _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed (error {err})")
    return dx, ddt.to(dt.dtype), dA, dB, dC


ssd_scan_bwd.launches = 0
