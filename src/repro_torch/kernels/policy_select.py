"""Device-resident ModiPick selection: stages 1–3 and the draw on one
device, with the stage-3 pass as a hand-written Triton kernel on the
card.

Two layers live here:

- the **stage-3 kernel** (``modipick_probs``, the port of the Pallas
  ``_probs_kernel``): the fused eligibility-mask / Eq. 3–4 utility /
  normalize pass over the (batch × pool) matrix, one program per block
  of 256 requests.  On the card it is a Triton kernel: one elementwise
  pass and a row reduction over a (B, n) matrix with n a handful of
  models, which needs nothing Triton cannot express.  What bounds it is
  memory — it reads the eligibility matrix once and writes the
  probability matrix once, about 8·n bytes per request, and does some
  ten flops per element — so the kernel computes the (B, n) utilities in
  registers and never writes them to memory (the normalising pass
  recomputes them instead of reading them back).  The
  pool keeps its natural width on the card: the TPU's 128-lane padding
  has no counterpart here.
- the **fused selection pipeline** (``select_fused``): stages 1–2 — the
  Eq. 2 eligibility matrix, the accuracy-order masked argmin and the
  window-membership mask — and the inverse-CDF categorical draw as plain
  PyTorch on the pool's device, feeding the stage-3 kernel.  Input is
  ``(mu, sigma, acc, t_u, t_l)`` plus one uniform per request; output is
  the sampled pool indices.  Nothing round-trips through the host
  between stages.

The uniforms come from a ``torch.Generator`` seeded from the caller's
numpy stream, as the reference seeds ``jax.random.PRNGKey`` there; the
two generators give different numbers, so parity tests hand the
reference's uniforms to ``_fused_select`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build, ref

EPS = 1e-9
PAD_RANK = 1e9
MAX_POOL = 128
BLOCK_B = 256

_KERNEL = None


def _probs_kernel():
    """Build (once) the Triton stage-3 kernel.  ``triton`` is imported
    here, at first launch, never when this module is imported."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    build.triton_env()
    import triton
    import triton.language as tl

    @triton.jit
    def utility(mu_ptr, sig_ptr, acc_ptr, e_ptr, rows, live, t_u, t_l, j,
                N: tl.constexpr, GAMMA: tl.constexpr, EPS: tl.constexpr):
        # Model j's Eq. 3–4 utility for a block of rows (0 where
        # ineligible), and its 0/1 eligibility.
        mu = tl.load(mu_ptr + j)
        a = tl.maximum(tl.load(acc_ptr + j), EPS)
        if GAMMA != 1.0:
            a = tl.exp2(GAMMA * tl.log2(a))
        e = tl.load(e_ptr + rows * N + j, mask=live, other=0.0) > 0
        num = t_u - (mu + tl.load(sig_ptr + j))
        den = tl.maximum(tl.abs(t_l - mu), EPS)
        # IEEE round-to-nearest division, as PyTorch divides.
        return tl.where(e, tl.div_rn(a * num, den), 0.0), tl.where(e, 1.0, 0.0)

    @triton.jit
    def probs_kernel(mu_ptr, sig_ptr, acc_ptr, tu_ptr, tl_ptr, e_ptr,
                     out_ptr, B, N: tl.constexpr, GAMMA: tl.constexpr,
                     EPS: tl.constexpr, BLOCK: tl.constexpr):
        rows = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        live = rows < B
        t_u = tl.load(tu_ptr + rows, mask=live, other=0.0)
        t_l = tl.load(tl_ptr + rows, mask=live, other=0.0)
        total = tl.zeros([BLOCK], dtype=tl.float32)
        cnt = tl.zeros([BLOCK], dtype=tl.float32)
        # Pass 1: the row mass, summed model by model in pool order (the
        # plain version sums in the same order, so both give the same
        # bits).  Pass 2 recomputes the utilities rather than storing them.
        for j in tl.static_range(N):
            u, ef = utility(mu_ptr, sig_ptr, acc_ptr, e_ptr, rows, live,
                            t_u, t_l, j, N, GAMMA, EPS)
            total += u
            cnt += ef
        good = (total > 0) & (total < float("inf"))
        safe = tl.where(good, total, 1.0)
        inv = tl.maximum(cnt, 1.0)
        # Pass 2: normalise; a degenerate row is uniform over its
        # eligible models.
        for j in tl.static_range(N):
            u, ef = utility(mu_ptr, sig_ptr, acc_ptr, e_ptr, rows, live,
                            t_u, t_l, j, N, GAMMA, EPS)
            p = tl.where(good, tl.div_rn(u, safe), tl.div_rn(ef, inv))
            tl.store(out_ptr + rows * N + j, p, mask=live)

    _KERNEL = probs_kernel
    return _KERNEL


def _check_probs(mu, sigma, acc, t_u, t_l, elig) -> None:
    if elig.dim() != 2:
        raise ValueError(f"elig must be (B, n); got {tuple(elig.shape)}")
    B, n = elig.shape
    for name, x, shape in (("mu", mu, (n,)), ("sigma", sigma, (n,)),
                           ("acc", acc, (n,)), ("t_u", t_u, (B,)),
                           ("t_l", t_l, (B,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(x.shape)}")
    xs = (mu, sigma, acc, t_u, t_l, elig)
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError("modipick_probs takes float32 tensors; got "
                        + ", ".join(str(x.dtype) for x in xs))
    if any(x.device != elig.device for x in xs):
        raise ValueError("modipick_probs operands must lie on one device")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError("modipick_probs operands must be contiguous")
    if not 1 <= n <= MAX_POOL:
        raise ValueError(f"pool of {n} models not supported (1..{MAX_POOL})")


def modipick_probs(mu, sigma, acc, t_u, t_l, elig, *, gamma: float = 1.0):
    """Fused stage-3 probability matrix.

    mu/sigma/acc: (n,) pool arrays; t_u/t_l: (B,) per-request bounds;
    elig: (B, n) float32 0/1 stage-2 eligibility → (B, n) float32
    probabilities (rows with no eligible model come back all-zero)."""
    _check_probs(mu, sigma, acc, t_u, t_l, elig)
    if elig.device.type == "cpu":
        return ref.policy_probs_ref(mu, sigma, acc, t_u, t_l, elig,
                                    gamma=gamma, eps=EPS)
    if elig.device.type != "cuda":
        raise ValueError(f"modipick_probs has no path for {elig.device}")
    B, n = elig.shape
    out = torch.empty((B, n), dtype=torch.float32, device=elig.device)
    if B:
        grid = (-(-B // BLOCK_B),)
        with torch.cuda.device(elig.device):
            _probs_kernel()[grid](mu, sigma, acc, t_u, t_l, elig, out, B,
                                  N=n, GAMMA=float(gamma), EPS=EPS,
                                  BLOCK=BLOCK_B,
                                  num_warps=4)
        modipick_probs.launches += 1
    return out


modipick_probs.launches = 0


# ======================================================================
# Device-resident stages 1–3: (mu, sigma, acc, t_u, t_l) plus one
# uniform per request straight to sampled pool indices.
# ======================================================================

class DevicePool:
    """Pool-side operands of the fused selection, uploaded once and kept
    on ``device`` at the pool's natural width.  Frozen against one
    ProfileTable snapshot — rebuild (cheap) when the profiles move.

    ``rank[i]`` is model ``i``'s position in the accuracy-descending
    order (the stable argsort the scalar path caches), so the stage-1
    "first eligible in accuracy order" is ``argmin`` of the masked rank
    row.
    """

    __slots__ = ("n", "device", "mu", "sigma", "acc", "rank", "fastest")

    def __init__(self, mu, sigma, acc, acc_order, fastest: int, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.n = len(mu)
        rank = np.empty(self.n, np.float32)
        rank[np.asarray(acc_order)] = np.arange(self.n, dtype=np.float32)

        def upload(x):
            return torch.tensor(np.asarray(x, np.float32), device=self.device)

        self.mu = upload(mu)
        self.sigma = upload(sigma)
        self.acc = upload(acc)
        self.rank = upload(rank)
        self.fastest = int(fastest)


def _stages12(mu, sig, rank, t_u, t_l):
    """Stages 1–2 on the pool's device.  mu/sig/rank: (n,); t_u/t_l:
    (B,).  Returns ``(base, has_base, eligible)``."""
    return ref.modipick_masks_ref(mu, sig, rank, t_u, t_l, pad_rank=PAD_RANK)


def _fused_select(mu, sig, acc, rank, t_u, t_l, r01, *, gamma: float,
                  stage3=modipick_probs):
    """The whole pipeline on one device: stages 1–2, the stage-3
    probability rows (``stage3``: the kernel wrapper; a check may pass
    the plain version), inverse-CDF categorical draw against the given
    uniforms ``r01`` (B,).  Returns (B,) int64: the sampled pool index,
    or -1 where no base model exists (the caller's fallback lane)."""
    base, has_base, eligible = _stages12(mu, sig, rank, t_u, t_l)
    w = stage3(mu, sig, acc, t_u, t_l, eligible.to(torch.float32),
               gamma=gamma)
    cdf = torch.cumsum(w, dim=1)
    total = cdf[:, -1]
    thresh = r01 * total
    # First index whose cumulative mass exceeds the threshold — exact
    # categorical sampling with ONE uniform per request.  Zero-probability
    # lanes have flat cdf segments and are never selected; the float edge
    # thresh == total falls back to the (always eligible) base.
    choice = torch.argmax((cdf > thresh[:, None]).to(torch.uint8), dim=1)
    choice = torch.where(total > thresh, choice, base)
    return torch.where(has_base, choice, -1)


def _bucket(B: int, block_b: int) -> int:
    """Pad the batch axis to a bounded family of shapes: multiples of
    ``block_b`` up to 4096, multiples of 4096 beyond (≤4% padding waste
    at large B).  The reference draws its uniforms at this padded
    length, so the port does too."""
    step = block_b if B <= 4096 else 4096
    return max(block_b, -(-B // step) * step)


def _pad_batch(x, bpad: int) -> np.ndarray:
    out = np.zeros(bpad, np.float32)
    out[:len(x)] = x
    return out


def uniforms(seed: int, n: int, device) -> torch.Tensor:
    """``n`` float32 uniforms in [0, 1) on ``device`` from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(n, generator=gen, device=device, dtype=torch.float32)


def select_fused(pool: DevicePool, t_u, t_l, *, gamma: float = 1.0,
                 seed: int = 0, block_b: int = BLOCK_B):
    """Device-resident batched ModiPick selection.

    ``t_u``/``t_l``: (B,) per-request budget bounds.  Returns
    ``(idx, has_base)`` numpy arrays — ``idx[b]`` is the sampled pool
    index (already routed to ``pool.fastest`` where ``~has_base``).
    One host→device transfer (the budget rows), one device→host
    transfer (the picks)."""
    B = len(t_u)
    bpad = _bucket(B, block_b)
    dev = pool.device
    tu = torch.from_numpy(_pad_batch(t_u, bpad)).to(dev)
    tl = torch.from_numpy(_pad_batch(t_l, bpad)).to(dev)
    out = _fused_select(pool.mu, pool.sigma, pool.acc, pool.rank, tu, tl,
                        uniforms(seed, bpad, dev), gamma=gamma)
    out = out.cpu().numpy()[:B]
    has_base = out >= 0
    return np.where(has_base, out, pool.fastest), has_base


def sample_batch(mu, sigma, acc, t_u, t_l, elig, *, gamma: float = 1.0,
                 seed: int = 0, device="cuda") -> np.ndarray:
    """One Gumbel-top-1 pick per request from the stage-3 probability
    rows; returns (B,) pool indices as numpy.  Rows with no eligible
    model return an arbitrary index — callers mask them with their
    fallback (``policy_vec`` routes those to the fastest model)."""
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
    """Stages 1–2 alone, through the same code as :func:`select_fused` —
    the test surface for pinning the device masks against the
    ``policy_vec.modipick_masks`` numpy reference.  Returns numpy
    ``(base, has_base, eligible)``."""
    B = len(t_u)
    bpad = _bucket(B, 8)
    dev = pool.device
    base, has, elig = _stages12(
        pool.mu, pool.sigma, pool.rank,
        torch.from_numpy(_pad_batch(t_u, bpad)).to(dev),
        torch.from_numpy(_pad_batch(t_l, bpad)).to(dev))
    return (base.cpu().numpy()[:B], has.cpu().numpy()[:B],
            elig.cpu().numpy()[:B])
