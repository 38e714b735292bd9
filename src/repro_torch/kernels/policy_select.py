"""Device-resident ModiPick selection: stages 1–3 and the draw on one
device, as hand-written CUDA kernels on the card
(``csrc/policy_select.cu``).

Four kernel wrappers, one set of per-row device code under them:

- ``modipick_probs`` (K1, the port of the Pallas ``_probs_kernel``):
  stage 3 alone — the Eq. 3–4 utilities of a given (B, n) eligibility
  matrix, normalised per row.  The detailed-trace path
  (``policy_vec.select_batch_traced(detail=True)``) draws from it.
- ``fused_select`` (the port of the jitted ``_fused_select``): stages
  1–2 (Eq. 2 eligibility, the accuracy-order base, the window), K1's
  probabilities and the inverse-CDF draw in ONE launch:
  ``(mu, sigma, acc, rank, t_u, t_l, r01)`` in, (B,) picks out, −1
  where no base exists.  ``select_fused`` is its host entry point.
- ``charged_select`` (the port of ``charged_select``/``_charged_step``,
  a ``lax.scan`` over the batch): the charged sequential-greedy pass.
  One warp walks the batch in order with the per-replica wait ledger in
  shared memory; each request is admitted and selected against waits
  that include the charges of the requests before it.
  ``select_charged`` is its host entry point, which the Router's device
  pass calls.
- ``stacked_select`` (B4, the port of the jitted ``_classed_select`` and
  ``fleet_select_body``): stages 1–3 and the draw with a pool row per
  request — its input class's row (premodel, with the queue shifts) or
  its cell's row (the fleet).  ``select_classed`` and
  ``select_fleet_stacked`` are its host entry points.

Each wrapper runs its plain PyTorch version (``kernels/ref.py``) for
tensors on the CPU and launches its kernel for tensors on the card (or
raises), and counts its launches.

The uniforms are an input: ``uniforms`` draws them from a generator kept
per device and reseeded from the caller's numpy stream, as the
reference seeds ``jax.random.PRNGKey`` there.  The two generators give
different numbers, so parity tests hand the reference's uniforms to the
wrappers (or patch ``uniforms``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build, ref

EPS = 1e-9
# Padded-lane sentinels of the fleet's stacked pools: a model this slow
# is never eligible, and a rank this large never wins stage 1.
PAD_MU = 1e30
PAD_RANK = 1e9
MAX_POOL = 128           # models the K1, fused and stacked kernels take
# Bytes of shared memory an H100 block can have: the limit a CPU call is
# held to, so that it refuses what the card would.  On the card the
# wrapper asks the kernel's library for the block's size and the card
# for its limit (``charged_smem``).
MAX_SMEM = 232_448
CHARGED_CHUNK = 256      # requests the charged block stages at once
BLOCK_B = 256            # the batch bucket's step (``_bucket``)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROBS_ARGS = [_P] * 7 + [_I, _I, _F, _P]
_FUSED_ARGS = [_P] * 8 + [_I, _I, _F, _P]
_CHARGED_ARGS = [_P] * 14 + [_I, _I, _I, _F, _F, _I, _I, _P]
_STACKED_ARGS = [_P] * 11 + [_I, _I, _I, _F, _I, _P]


def _check_f32(name, xs, device) -> None:
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError(f"{name} takes float32 tensors; got "
                        + ", ".join(str(x.dtype) for x in xs))
    if any(x.device != device for x in xs):
        raise ValueError(f"{name} operands must lie on one device")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError(f"{name} operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no path for {device}")


def _check_shapes(name, pairs) -> None:
    for arg, x, shape in pairs:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}; got "
                             f"{tuple(x.shape)}")


def _check_pool(name, n) -> None:
    if not 1 <= n <= MAX_POOL:
        raise ValueError(f"{name}: pool of {n} models not supported "
                         f"(1..{MAX_POOL})")


def _launch(lib_symbol, argtypes, device, *args) -> None:
    fn = build.function("policy_select", lib_symbol, argtypes)
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{lib_symbol} launch failed (error {err})")


def modipick_probs(mu, sigma, acc, t_u, t_l, elig, *, gamma: float = 1.0):
    """Fused stage-3 probability matrix.

    mu/sigma/acc: (n,) pool arrays; t_u/t_l: (B,) per-request bounds;
    elig: (B, n) float32 0/1 stage-2 eligibility → (B, n) float32
    probabilities (rows with no eligible model come back all-zero)."""
    if elig.dim() != 2:
        raise ValueError(f"elig must be (B, n); got {tuple(elig.shape)}")
    B, n = elig.shape
    _check_shapes("modipick_probs", (
        ("mu", mu, (n,)), ("sigma", sigma, (n,)), ("acc", acc, (n,)),
        ("t_u", t_u, (B,)), ("t_l", t_l, (B,))))
    _check_f32("modipick_probs", (mu, sigma, acc, t_u, t_l, elig),
               elig.device)
    _check_pool("modipick_probs", n)
    if elig.device.type == "cpu":
        return ref.policy_probs_ref(mu, sigma, acc, t_u, t_l, elig,
                                    gamma=gamma, eps=EPS)
    out = torch.empty((B, n), dtype=torch.float32, device=elig.device)
    if B:
        _launch("modipick_probs_fwd", _PROBS_ARGS, elig.device,
                mu.data_ptr(), sigma.data_ptr(), acc.data_ptr(),
                t_u.data_ptr(), t_l.data_ptr(), elig.data_ptr(),
                out.data_ptr(), B, n, float(gamma))
        modipick_probs.launches += 1
    return out


modipick_probs.launches = 0


def fused_select(mu, sigma, acc, rank, t_u, t_l, r01, *,
                 gamma: float = 1.0):
    """Stages 1–3 and the inverse-CDF draw against the uniforms ``r01``.

    mu/sigma/acc/rank: (n,) pool arrays (``rank``: each model's place in
    the accuracy-descending order); t_u/t_l/r01: (B,) → (B,) int32: the
    drawn pool index, or −1 where no base model exists (the caller's
    fallback lane)."""
    B = t_u.shape[0] if t_u.dim() == 1 else -1
    n = mu.shape[0] if mu.dim() == 1 else -1
    _check_shapes("fused_select", (
        ("mu", mu, (n,)), ("sigma", sigma, (n,)), ("acc", acc, (n,)),
        ("rank", rank, (n,)), ("t_u", t_u, (B,)), ("t_l", t_l, (B,)),
        ("r01", r01, (B,))))
    _check_f32("fused_select", (mu, sigma, acc, rank, t_u, t_l, r01),
               mu.device)
    _check_pool("fused_select", n)
    if mu.device.type == "cpu":
        return ref.fused_select_ref(mu, sigma, acc, rank, t_u, t_l, r01,
                                    gamma=gamma, eps=EPS, pad_rank=PAD_RANK)
    out = torch.empty(B, dtype=torch.int32, device=mu.device)
    if B:
        _launch("fused_select_fwd", _FUSED_ARGS, mu.device,
                mu.data_ptr(), sigma.data_ptr(), acc.data_ptr(),
                rank.data_ptr(), t_u.data_ptr(), t_l.data_ptr(),
                r01.data_ptr(), out.data_ptr(), B, n, float(gamma))
        fused_select.launches += 1
    return out


fused_select.launches = 0
# The reference's name for this step (``_fused_select``).
_fused_select = fused_select


def charged_smem_bytes(n: int, R: int) -> int:
    """Shared memory of the charged kernel's block at n models and R
    replicas (mirrors ``charged_smem`` in the kernel): the pool, the
    waits, the ledger, ``CHARGED_CHUNK`` staged request rows and the
    (R × n) mask."""
    return 4 * (7 * n + 2 * R + 4 * CHARGED_CHUNK) + n * R


def charged_smem(n: int, R: int, device) -> tuple:
    """(bytes the charged block needs at n models and R replicas, bytes
    a block may have) on ``device``: from the kernel's library and the
    card on a CUDA device, from ``charged_smem_bytes`` and ``MAX_SMEM``
    on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return charged_smem_bytes(n, R), MAX_SMEM
    fn = build.function("policy_select", "charged_select_smem",
                        [_I, _I, _I, _P, _P])
    smem, limit = ctypes.c_longlong(), ctypes.c_int()
    err = fn(dev.index if dev.index is not None
             else torch.cuda.current_device(), n, R, ctypes.byref(smem),
             ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"charged_select_smem failed (error {err})")
    return smem.value, limit.value


def charged_select(mu, sigma, acc, rank, mu_charge, cand_mask, speed,
                   rep_wait, t_u, t_l, r01, lim, *, gamma: float = 1.0,
                   slack: float = 0.0, include_mu: bool = False,
                   fastest: int = 0):
    """The charged sequential-greedy pass over a batch, in order.

    Pool: mu/sigma/acc/rank/mu_charge (n,) float32, cand_mask (n, R)
    bool (replica r serves model m); ledger: speed/rep_wait (R,)
    float32 (``rep_wait`` is read, never written); per request:
    t_u/t_l/r01/lim (B,) float32, ``lim`` = +inf admits, −inf sheds.
    Returns ``(picks int32, admitted bool, has_base bool, replica int32,
    w_chosen float32)``, each (B,) — see ``ref.charged_select_ref``."""
    B = t_u.shape[0] if t_u.dim() == 1 else -1
    n = mu.shape[0] if mu.dim() == 1 else -1
    R = speed.shape[0] if speed.dim() == 1 else -1
    _check_shapes("charged_select", (
        ("mu", mu, (n,)), ("sigma", sigma, (n,)), ("acc", acc, (n,)),
        ("rank", rank, (n,)), ("mu_charge", mu_charge, (n,)),
        ("cand_mask", cand_mask, (n, R)), ("speed", speed, (R,)),
        ("rep_wait", rep_wait, (R,)), ("t_u", t_u, (B,)),
        ("t_l", t_l, (B,)), ("r01", r01, (B,)), ("lim", lim, (B,))))
    _check_f32("charged_select", (mu, sigma, acc, rank, mu_charge, speed,
                                  rep_wait, t_u, t_l, r01, lim), mu.device)
    if cand_mask.dtype != torch.bool or cand_mask.device != mu.device \
            or not cand_mask.is_contiguous():
        raise TypeError("charged_select: cand_mask must be a contiguous "
                        "bool tensor on the pool's device")
    if n < 1 or R < 1:
        raise ValueError(f"charged_select: {n} models over {R} replicas")
    need, limit = charged_smem(n, R, mu.device)
    if need > limit:
        raise ValueError(f"charged_select: {n} models over {R} replicas "
                         f"need {need} bytes of shared memory; a block has "
                         f"{limit}")
    kw = dict(gamma=gamma, slack=slack, include_mu=include_mu,
              fastest=fastest)
    if mu.device.type == "cpu":
        return ref.charged_select_ref(mu, sigma, acc, rank, mu_charge,
                                      cand_mask, speed, rep_wait, t_u, t_l,
                                      r01, lim, eps=EPS, pad_rank=PAD_RANK,
                                      **kw)
    ints = torch.empty((3, B), dtype=torch.int32, device=mu.device)
    flags = torch.empty((2, B), dtype=torch.uint8, device=mu.device)
    if B:
        _launch("charged_select_fwd", _CHARGED_ARGS, mu.device,
                mu.data_ptr(), sigma.data_ptr(), acc.data_ptr(),
                rank.data_ptr(), mu_charge.data_ptr(), cand_mask.data_ptr(),
                speed.data_ptr(), rep_wait.data_ptr(), t_u.data_ptr(),
                t_l.data_ptr(), r01.data_ptr(), lim.data_ptr(),
                ints.data_ptr(), flags.data_ptr(), B, n, R, float(gamma),
                float(slack), int(bool(include_mu)), int(fastest))
        charged_select.launches += 1
    return (ints[0], flags[0].view(torch.bool), flags[1].view(torch.bool),
            ints[1], ints[2].view(torch.float32))


charged_select.launches = 0


def stacked_select(mu, sigma, acc, rank, row, t_u, t_l, r01, *,
                   shifts=None, gamma: float = 1.0, fallback: bool = False):
    """Stages 1–3 and the inverse-CDF draw with a pool row per request.

    mu/sigma: (P, n) float32 pool rows; acc/rank: (n,), shared by every
    row, or (P, n), a row each; row: (B,) int32, each request's pool row
    (the host entry points build it in range); shifts: None or (n,)
    per-model waits added to every row's μ; t_u/t_l/r01: (B,) float32.
    Returns ``(picks int32, has_base bool)``, each (B,): where no base
    exists the pick is, with ``fallback``, the row's fastest model, else
    −1 — see ``ref.stacked_select_ref``."""
    if mu.dim() != 2:
        raise ValueError(f"stacked_select: mu must be (P, n); got "
                         f"{tuple(mu.shape)}")
    P, n = mu.shape
    B = t_u.shape[0] if t_u.dim() == 1 else -1
    per_row = acc.dim() == 2
    pool = (P, n) if per_row else (n,)
    f32 = (mu, sigma, acc, rank, t_u, t_l, r01)
    pairs = (("mu", mu, (P, n)), ("sigma", sigma, (P, n)),
             ("acc", acc, pool), ("rank", rank, pool), ("row", row, (B,)),
             ("t_u", t_u, (B,)), ("t_l", t_l, (B,)), ("r01", r01, (B,)))
    if shifts is not None:
        f32 += (shifts,)
        pairs += (("shifts", shifts, (n,)),)
    _check_shapes("stacked_select", pairs)
    _check_f32("stacked_select", f32, mu.device)
    if row.dtype != torch.int32 or row.device != mu.device \
            or not row.is_contiguous():
        raise TypeError("stacked_select: row must be a contiguous int32 "
                        "tensor on the pool's device")
    _check_pool("stacked_select", n)
    if P < 1:
        raise ValueError("stacked_select: no pool rows")
    kw = dict(shifts=shifts, gamma=gamma, fallback=fallback)
    if mu.device.type == "cpu":
        return ref.stacked_select_ref(mu, sigma, acc, rank, row, t_u, t_l,
                                      r01, eps=EPS, pad_rank=PAD_RANK, **kw)
    picks = torch.empty(B, dtype=torch.int32, device=mu.device)
    has = torch.empty(B, dtype=torch.uint8, device=mu.device)
    if B:
        _launch("stacked_select_fwd", _STACKED_ARGS, mu.device,
                mu.data_ptr(), sigma.data_ptr(), acc.data_ptr(),
                rank.data_ptr(), row.data_ptr(),
                None if shifts is None else shifts.data_ptr(),
                t_u.data_ptr(), t_l.data_ptr(), r01.data_ptr(),
                picks.data_ptr(), has.data_ptr(), B, n, n if per_row else 0,
                float(gamma), int(bool(fallback)))
        stacked_select.launches += 1
    return picks, has.view(torch.bool)


stacked_select.launches = 0


# ======================================================================
# Host entry points: numpy budget rows in, numpy picks out.
# ======================================================================

class DevicePool:
    """Pool-side operands of the device selection, uploaded once and
    kept on ``device`` at the pool's natural width.  Frozen against one
    ProfileTable snapshot — rebuild (cheap) when the profiles move.

    ``rank[i]`` is model ``i``'s position in the accuracy-descending
    order (the stable argsort the scalar path caches), so the stage-1
    "first eligible in accuracy order" is the eligible model of least
    rank.
    """

    __slots__ = ("n", "device", "mu", "sigma", "acc", "rank", "fastest")

    def __init__(self, mu, sigma, acc, acc_order, fastest: int, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n = len(mu)
        rank = np.empty(self.n, np.float32)
        rank[np.asarray(acc_order)] = np.arange(self.n, dtype=np.float32)
        ops = torch.from_numpy(np.stack([np.asarray(x, np.float32)
                                         for x in (mu, sigma, acc, rank)]))
        self.mu, self.sigma, self.acc, self.rank = ops.to(self.device)
        self.fastest = int(fastest)


def _stages12(mu, sig, rank, t_u, t_l):
    """Stages 1–2 as plain PyTorch on the pool's device.  mu/sig/rank:
    (n,); t_u/t_l: (B,).  Returns ``(base, has_base, eligible)``."""
    return ref.modipick_masks_ref(mu, sig, rank, t_u, t_l, pad_rank=PAD_RANK)


def _bucket(B: int, block_b: int) -> int:
    """Pad the batch axis to a bounded family of shapes: multiples of
    ``block_b`` up to 4096, multiples of 4096 beyond (≤4% padding waste
    at large B).  The reference draws its uniforms at this padded
    length, so the port does too."""
    step = block_b if B <= 4096 else 4096
    return max(block_b, -(-B // step) * step)


_GENERATORS: Dict[torch.device, torch.Generator] = {}


def uniforms(seed: int, n: int, device) -> torch.Tensor:
    """``n`` float32 uniforms in [0, 1) on ``device`` from the device's
    generator, reseeded with ``seed``."""
    dev = torch.device(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = _GENERATORS[dev] = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return torch.rand(n, generator=gen, device=dev, dtype=torch.float32)


def _upload(rows, dev) -> torch.Tensor:
    """float32 rows stacked on the host and copied to ``dev`` at once."""
    return torch.from_numpy(np.stack(rows).astype(np.float32, copy=False)
                            ).to(dev)


def select_fused(pool: DevicePool, t_u, t_l, *, gamma: float = 1.0,
                 seed: int = 0, block_b: int = BLOCK_B):
    """Device-resident batched ModiPick selection.

    ``t_u``/``t_l``: (B,) per-request budget bounds.  Returns
    ``(idx, has_base)`` numpy arrays — ``idx[b]`` is the sampled pool
    index (already routed to ``pool.fastest`` where ``~has_base``).
    One host→device copy (the budget rows), one launch, one
    device→host copy (the picks); the uniforms are drawn at the
    bucketed length, as the reference draws them."""
    B = len(t_u)
    dev = pool.device
    tu, tl = _upload((t_u, t_l), dev)
    r01 = uniforms(seed, _bucket(B, block_b), dev)[:B]
    out = fused_select(pool.mu, pool.sigma, pool.acc, pool.rank, tu, tl,
                       r01, gamma=gamma).cpu().numpy()
    has_base = out >= 0
    return np.where(has_base, out, pool.fastest), has_base


def select_charged(pool: DevicePool, t_u, t_l, state, *,
                   gamma: float = 1.0, adm_limit=None,
                   adm_slack: float = 0.0, adm_include_mu: bool = False,
                   seed: int = 0, block_b: int = BLOCK_B):
    """Device-resident charged batch selection (the reference's
    ``charged_select``): request ``i`` is admitted and selected against
    waits that include the charges of requests ``0..i-1``.

    ``state`` is a :class:`repro_torch.router.charging.ChargedWaits`
    (replica waits, model → candidate topology, speeds, live charge-μ);
    it is not written.  ``adm_limit`` (B,) enables the in-pass SLA-aware
    viability test (``W_queue + slack (+ μ) < limit``); ``None`` admits
    everything.  Returns numpy ``(picks, admitted, has_base, replica,
    w_chosen)``: the picked pool index, the admission verdict, the
    fallback indicator, the replica the charge landed on, and the
    chosen model's pre-charge wait (for shed rows: the pool's minimum
    wait)."""
    B, n, R = len(t_u), pool.n, len(state.rep_wait)
    dev = pool.device
    cand = np.zeros((n, R), dtype=bool)
    for m, c in enumerate(state.cand):
        cand[m, c] = True
    lim = np.full(B, np.inf) if adm_limit is None else adm_limit
    rows = _upload((t_u, t_l, lim), dev)
    ledger = _upload((np.asarray(state.speed), state.rep_wait), dev)
    mu_charge = torch.tensor(np.asarray(state.mu, np.float32)[:n],
                             device=dev)
    r01 = uniforms(seed, _bucket(B, block_b), dev)[:B]
    out = charged_select(pool.mu, pool.sigma, pool.acc, pool.rank,
                         mu_charge, torch.from_numpy(cand).to(dev),
                         ledger[0], ledger[1], rows[0], rows[1], r01,
                         rows[2], gamma=gamma, slack=adm_slack,
                         include_mu=adm_include_mu, fastest=pool.fastest)
    picks, admitted, has_base, rep, w_chosen = (t.cpu().numpy()
                                                for t in out)
    return picks, admitted, has_base, rep, w_chosen.astype(np.float64)


def select_classed(stacked, cls, t_u, t_l, *, shifts=None,
                   gamma: float = 1.0, seed: int = 0,
                   block_b: int = BLOCK_B):
    """Batched class-conditional ModiPick selection in one launch.

    ``stacked``: a ``premodel.conditional.StackedClassPools`` — (K, n)
    per-class mu/sigma plus shared (n,) acc/rank on one device.
    ``cls``: (B,) input-class ids; ``t_u``/``t_l``: (B,) budget bounds;
    ``shifts``: optional (n,) per-model queue-wait shifts (the same for
    every class: waits live at replicas, not input classes).  Returns
    ``(idx, has_base)`` numpy arrays, the fallback already resolved to
    the fastest model of the request's own (shifted) class row.  The
    uniforms are drawn at the bucketed length, as the reference draws
    them."""
    cls = np.asarray(cls, np.int32)
    if cls.size and not 0 <= int(cls.min()) <= int(cls.max()) < stacked.k:
        raise ValueError(f"class ids must lie in [0, {stacked.k})")
    B = len(t_u)
    dev = stacked.device
    tu, tl = _upload((t_u, t_l), dev)
    sh = None if shifts is None else _upload((shifts,), dev)[0]
    r01 = uniforms(seed, _bucket(B, block_b), dev)[:B]
    picks, has_base = stacked_select(
        stacked.mu, stacked.sigma, stacked.acc, stacked.rank,
        torch.from_numpy(cls).to(dev), tu, tl, r01, shifts=sh, gamma=gamma,
        fallback=True)
    return picks.cpu().numpy(), has_base.cpu().numpy()


def cell_uniforms(seed: int, C: int, n: int, device) -> torch.Tensor:
    """(C, n) float32 uniforms on ``device``: ``n`` for each of the C
    cells of a fleet, from the device's generator reseeded with
    ``seed``."""
    return uniforms(seed, C * n, device).view(C, n)


def select_fleet_stacked(mu, sig, acc, rank, t_u, t_l, *,
                         gamma: float = 1.0, seed: int = 0) -> np.ndarray:
    """All cells' pending batches in one launch.

    ``mu/sig/acc/rank``: (C, npad) stacked pool operands on one device
    (see ``fleet.device.stack_cell_tables``); ``t_u``/``t_l``: (C, B)
    budget bounds — row c is cell c's judgment of every pending request.
    Returns (C, B) int32 numpy picks, −1 where cell c has no eligible
    model for request b.  Each cell draws its own row of
    :func:`cell_uniforms` at the bucketed length, as the reference draws
    one PRNG fold a cell."""
    C, B = np.shape(t_u)
    dev = mu.device
    tu, tl = _upload((np.ravel(t_u), np.ravel(t_l)), dev)
    row = torch.from_numpy(np.repeat(np.arange(C, dtype=np.int32), B)
                           ).to(dev)
    r01 = cell_uniforms(seed, C, _bucket(B, BLOCK_B), dev)[:, :B]
    picks, _ = stacked_select(mu, sig, acc, rank, row, tu, tl,
                              r01.reshape(-1), gamma=gamma)
    return picks.view(C, B).cpu().numpy()


def sample_batch(mu, sigma, acc, t_u, t_l, elig, *, gamma: float = 1.0,
                 seed: int = 0, device="cuda") -> np.ndarray:
    """One Gumbel-top-1 pick per request from K1's probability rows;
    returns (B,) pool indices as numpy.  Rows with no eligible model
    return an arbitrary index — callers mask them with their fallback
    (``policy_vec`` routes those to the fastest model)."""
    dev = resolve_device(device)

    def upload(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    probs = modipick_probs(upload(mu), upload(sigma), upload(acc),
                           upload(t_u), upload(t_l), upload(elig),
                           gamma=gamma)
    u = uniforms(seed, probs.numel(), dev).view(probs.shape)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    logits = torch.where(probs > 0, torch.log(probs), -torch.inf)
    return torch.argmax(logits + g, dim=1).cpu().numpy()


def masks_device(pool: DevicePool, t_u, t_l):
    """Stages 1–2 alone, as plain PyTorch on the pool's device — the
    test surface for pinning the device masks against the
    ``policy_vec.modipick_masks`` numpy reference (the kernels compute
    the same masks row by row, never as a matrix).  Returns numpy
    ``(base, has_base, eligible)``."""
    dev = pool.device
    base, has, elig = _stages12(pool.mu, pool.sigma, pool.rank,
                                *_upload((t_u, t_l), dev))
    return base.cpu().numpy(), has.cpu().numpy(), elig.cpu().numpy()
