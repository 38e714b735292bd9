"""AdamW over every leaf at once: the wrapper of the hand-written CUDA
kernels ``csrc/adamw.cu``.

One call steps AdamW over lists of leaves (p, g, m, v and a decay flag a
leaf, m and v fp32) in place and returns the gradients' global norm, a
0-dim fp32 tensor on the leaves' device.  The arithmetic is the plain
step's (``ref.adamw_ref``), op for op.

On the card it launches, for each group of at most ``MAX_LEAVES``
leaves, ``adamw_norm_kernel`` (Σ g² a chunk), then one
``adamw_finish_kernel`` (the norm and the clip scale, on the card), then
``adamw_step_kernel`` for each group: one pass over p, g, m and v.  The
leaves are cut into chunks of at most ``CHUNK`` elements that never
cross a leaf; the chunk and leaf tables (:func:`plan`) are built once a
parameter set and cached on the card (the leaves are updated in place,
so their pointers stay), and the gradients' pointers go in each launch's
parameter space.  Nothing syncs with the host.

On CPU tensors the wrapper runs the plain version; on ``meta`` tensors,
inside ``cost.counting()`` only, it records the kernels' cost and returns
the norm empty.  On the card and on ``meta`` it raises a TypeError for
leaves the kernels do not take as they are (:func:`_check`).

``UPDATES`` counts the elements AdamW updated, by path:
``training/optimizer.py`` adds to ``"fused"`` when it calls this
wrapper on the card or on ``meta``, and to ``"eager"`` when it runs the
plain step (``optimizer.update_counts()``; ``ops.reset_launch_counts()``
zeroes it).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, cost, ref

CHUNK = 1 << 16      # elements of a chunk: one block's work
MAX_LEAVES = 448     # leaves a launch takes (kMaxLeaves in the kernel)
TINY = 1e-9          # the clip scale's guard: clip / (‖g‖ + TINY)
DECAY, P_BF16, G_BF16 = 1, 2, 4   # a leaf's flags

LEAF = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("flags", "<i4"),
                 ("pad", "<i4")])
CHUNK_RECORD = np.dtype([("off", "<i8"), ("leaf", "<i4"), ("len", "<i4")])

UPDATES: Dict[str, int] = {"fused": 0, "eager": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PTRS = ctypes.POINTER(ctypes.c_longlong)
_NORM_ARGS = [_P, _P, _I, _I, _I, _PTRS, _I, _P, _P]
_FINISH_ARGS = [_P, _I, _F, _F, _P, _P]
_STEP_ARGS = [_P, _P, _I, _I, _I, _PTRS, _I, _P, _P, _P, _P] + [_F] * 6 + [_P]

_FLOATS = (torch.float32, torch.bfloat16)


def chunk_table(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """(offset, leaf, length) records: each leaf cut into chunks of at
    most ``chunk`` elements, in leaf order, none across two leaves."""
    n = np.asarray(numels, dtype=np.int64)
    counts = -(-n // chunk)
    leaf = np.repeat(np.arange(len(n), dtype=np.int64), counts)
    first = np.cumsum(counts) - counts
    off = (np.arange(len(leaf), dtype=np.int64)
           - np.repeat(first, counts)) * chunk
    out = np.empty(len(leaf), dtype=CHUNK_RECORD)
    out["off"], out["leaf"] = off, leaf
    out["len"] = np.minimum(chunk, n[leaf] - off)
    return out


def launch_groups(numels: Sequence[int], chunk: int = CHUNK,
                  max_leaves: int = MAX_LEAVES
                  ) -> Tuple[Tuple[int, int, int, int], ...]:
    """(leaf0, leaf1, chunk0, chunk1) a launch: runs of at most
    ``max_leaves`` leaves and the chunks that cover them; runs with no
    chunk (empty leaves only) are left out."""
    counts = -(-np.asarray(numels, dtype=np.int64) // chunk)
    ends = np.concatenate([[0], np.cumsum(counts)])
    groups = []
    for l0 in range(0, len(counts), max_leaves):
        l1 = min(l0 + max_leaves, len(counts))
        if ends[l1] > ends[l0]:
            groups.append((l0, l1, int(ends[l0]), int(ends[l1])))
    return tuple(groups)


def leaf_flags(params, grads, decay) -> np.ndarray:
    """Each leaf's flags: DECAY, P_BF16 and G_BF16."""
    return np.array([(DECAY if d else 0)
                     | (P_BF16 if p.dtype == torch.bfloat16 else 0)
                     | (G_BF16 if g.dtype == torch.bfloat16 else 0)
                     for p, g, d in zip(params, grads, decay)],
                    dtype=np.int32)


def plan(params, grads, mu, nu, decay) -> Tuple[np.ndarray, np.ndarray]:
    """The host's tables: a LEAF record a leaf (p, m, v pointers and
    flags) and the chunk table."""
    leaves = np.zeros(len(params), dtype=LEAF)
    leaves["p"] = [p.data_ptr() for p in params]
    leaves["m"] = [m.data_ptr() for m in mu]
    leaves["v"] = [v.data_ptr() for v in nu]
    leaves["flags"] = leaf_flags(params, grads, decay)
    return leaves, chunk_table([p.numel() for p in params])


def launches(numels: Sequence[int]) -> int:
    """Kernel launches of one call over leaves of these sizes."""
    return 2 * len(launch_groups(numels)) + 1


class _Table(NamedTuple):
    key: tuple
    leaves: torch.Tensor     # LEAF records, bytes on the card
    chunks: torch.Tensor     # CHUNK_RECORD records, bytes on the card
    groups: tuple            # launch_groups
    partials: torch.Tensor   # fp32, one a chunk


_TABLE: Dict[str, _Table] = {}


def _upload(records: np.ndarray, device) -> torch.Tensor:
    host = torch.from_numpy(records.view(np.uint8)).pin_memory()
    return host.to(device, non_blocking=True)


def _table(params, grads, mu, nu, decay) -> _Table:
    """The cached tables of this parameter set, built anew when any
    leaf's pointers, size, dtypes or decay flag differ."""
    key = (params[0].device.index,) + tuple(
        (p.data_ptr(), p.numel(), p.dtype, m.data_ptr(), v.data_ptr(),
         bool(d), g.dtype)
        for p, g, m, v, d in zip(params, grads, mu, nu, decay))
    t = _TABLE.get("last")
    if t is not None and t.key == key:
        return t
    leaves, chunks = plan(params, grads, mu, nu, decay)
    dev = params[0].device
    t = _Table(key, _upload(leaves, dev),
               _upload(chunks if len(chunks) else np.zeros(1, CHUNK_RECORD),
                       dev),
               launch_groups([p.numel() for p in params]),
               torch.empty(max(1, len(chunks)), dtype=torch.float32,
                           device=dev))
    _TABLE["last"] = t
    return t


def _check(params, grads, mu, nu, decay) -> None:
    """Raise unless there is one g, m, v and decay flag a leaf and, on
    the card or ``meta``, the kernels take the leaves as they are: every
    leaf on one device, p fp32 or bf16, g fp32 or bf16 of p's shape, m
    and v fp32 tensors of p's shape, and p, m and v contiguous."""
    if not (len(params) == len(grads) == len(mu) == len(nu) == len(decay)):
        raise ValueError("adamw wants one g, m, v and decay flag a leaf")
    if not params:
        raise ValueError("adamw needs at least one leaf")
    dev = params[0].device
    if dev.type == "cpu":
        return
    for p, g, m, v in zip(params, grads, mu, nu):
        if not (isinstance(m, torch.Tensor) and isinstance(v, torch.Tensor)
                and p.dtype in _FLOATS and g.dtype in _FLOATS
                and m.dtype == v.dtype == torch.float32
                and p.shape == g.shape == m.shape == v.shape
                and p.device == g.device == m.device == v.device == dev
                and p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise TypeError("adamw takes fp32 or bf16 p and g, fp32 m and "
                            "v of p's shape, p, m and v contiguous, on one "
                            "device")


def adamw(params, grads, mu, nu, decay, bc1, bc2, lr, *, b1: float,
          b2: float, eps: float, weight_decay: float,
          grad_clip: float) -> torch.Tensor:
    """One AdamW step over the leaves, p, m and v in place: ``decay`` a
    flag a leaf, ``bc1``, ``bc2`` and ``lr`` 0-dim fp32 tensors (the bias
    corrections and the learning rate), the rest the configuration's
    constants.  Returns the gradients' global norm (0-dim fp32); on the
    card it is element 0 of a two-element buffer whose element 1 is the
    clip scale the step used (:func:`clip_scale_of`)."""
    _check(params, grads, mu, nu, decay)
    dev = params[0].device
    if dev.type == "cpu":
        return ref.adamw_ref(params, grads, mu, nu, decay, bc1, bc2, lr,
                             b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay, grad_clip=grad_clip)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"adamw has no path for {dev}")
    if dev.type == "meta":
        cost.record("adamw", cost.adamw(params, grads, decay))
        return torch.empty((), dtype=torch.float32, device=dev)
    for x in (bc1, bc2, lr):
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
                and x.numel() == 1 and x.device == dev):
            raise TypeError("adamw wants bc1, bc2 and lr as one-element "
                            "fp32 tensors on the leaves' device")
    build.refuse_grad("adamw", *params, *grads)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    t = _table(params, grads, mu, nu, decay)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(2, dtype=torch.float32, device=dev)
    gptrs = [g.data_ptr() for g in grads]
    arrays = [(ctypes.c_longlong * (l1 - l0))(*gptrs[l0:l1])
              for l0, l1, _, _ in t.groups]
    leaves, chunks = t.leaves.data_ptr(), t.chunks.data_ptr()

    def launched(err, what):
        if err != 0:
            raise RuntimeError(f"adamw {what} kernel launch failed "
                               f"(error {err})")
        adamw.launches += 1

    norm = build.function("adamw", "adamw_norm", _NORM_ARGS)
    for (l0, l1, c0, c1), arr in zip(t.groups, arrays):
        launched(norm(leaves, chunks, c0, c1 - c0, l0, arr, l1 - l0,
                      t.partials.data_ptr(), stream), "norm")
    finish = build.function("adamw", "adamw_finish", _FINISH_ARGS)
    n_chunks = t.groups[-1][3] if t.groups else 0
    launched(finish(t.partials.data_ptr(), n_chunks, grad_clip, TINY,
                    out.data_ptr(), stream), "finish")
    step = build.function("adamw", "adamw_step", _STEP_ARGS)
    for (l0, l1, c0, c1), arr in zip(t.groups, arrays):
        launched(step(leaves, chunks, c0, c1 - c0, l0, arr, l1 - l0,
                      out.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
                      lr.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
                      weight_decay, stream), "step")
    return out[0]


adamw.launches = 0


def clip_scale_of(norm: torch.Tensor) -> torch.Tensor:
    """The clip scale (0-dim) that the card's :func:`adamw` call which
    returned ``norm`` stepped with: the finish kernel writes it beside
    the norm."""
    if norm.device.type != "cuda" or norm.storage_offset() != 0 or \
            norm.untyped_storage().nbytes() != 8:
        raise ValueError("clip_scale_of takes the norm a card's adamw call "
                         "returned")
    return norm.as_strided((2,), (1,))[1]
