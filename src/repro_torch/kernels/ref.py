"""Plain PyTorch versions of the port's kernels: twins of the reference's
jnp oracles (``repro/kernels/ref.py``), with the same signatures and
layouts.

They are what a kernel wrapper runs for a tensor on the CPU, and what a
kernel is held against on the card.  They run on any device.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) → (B,H,Sq,hd). Naive full softmax."""
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    vx = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)


def attention_mask(Sq, Sk, causal, window, device):
    """(Sq, Sk) bool: which keys each query row sees."""
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return mask


def _scores(q, k, causal, window):
    """fp32 scaled scores (B,H,Sq,Sk) of q against the GQA-expanded k,
    masked to NEG_INF, and the mask."""
    group = q.shape[1] // k.shape[1]
    kx = k.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) \
        * q.shape[-1] ** -0.5
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_lse_ref(q, k, v, *, causal=True, window=0):
    """The forward's log-sum-exp (B,H,Sq) fp32: logsumexp over the
    visible keys of the scaled scores, the ``lse`` K2 writes for its
    backward."""
    s, _ = _scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, dout, *, causal=True,
                            window=0):
    """The FlashAttention-2 backward over full score matrices, in fp32:
    P = exp(S·scale − lse) on the visible keys, dV = Pᵀ dO, dP = dO Vᵀ,
    D = rowsum(dO ∘ O), dS = P ∘ (dP − D), dQ = dS K · scale,
    dK = dSᵀ Q · scale, dK and dV summed over each GQA group.  Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    s, mask = _scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    do, vx = dout.float(), v.repeat_interleave(group, dim=1).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vx)
    D = torch.sum(do * o.float(), dim=-1, keepdim=True)
    ds = p * (dp - D)
    scale = hd ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.view(B, KV, group, Sk, hd).sum(2)
    dv = dv.view(B, KV, group, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, pos, *, window=0):
    """q: (B,KV,G,hd); k,v: (B,KV,S,hd); pos: (B,) → (B,KV,G,hd)."""
    hd = q.shape[-1]
    S = k.shape[2]
    s = torch.einsum("bngd,bnkd->bngk", q.float(), k.float()) * hd ** -0.5
    kj = torch.arange(S, device=q.device)[None, None, None, :]
    p_ = pos.to(torch.int64)[:, None, None, None]
    mask = kj <= p_
    if window > 0:
        mask &= kj > p_ - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngk,bnkd->bngd", p, v.float()).to(q.dtype)


def quantize_kv(x):
    """x (..., hd) → (int8 values, fp32 scale over the trailing dim), the
    reference's ``_quantize_kv``: x / scale divided in fp32 and rounded
    half to even, so the int8 bits are the reference's."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    # by a tensor, not a Python number: PyTorch's CUDA division by a
    # scalar multiplies by its reciprocal, which can round the last bit
    # the other way
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """The reference's ``_dequantize_kv``: float(q) · scale, rounded to
    ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def decode_attention_int8_ref(q, k, v, k_scale, v_scale, pos, *, window=0,
                              k_new=None, v_new=None, slot=None):
    """``decode_attention_ref`` over an int8 cache: q: (B,KV,G,hd); k, v:
    (B,KV,S,hd) int8; k_scale, v_scale: (B,KV,S) fp32.  Each element is
    dequantized as the reference's ``_dequantize_kv(…, q.dtype)`` does,
    float(x) · scale rounded to q's dtype, before the products.

    With the new token's ``k_new``, ``v_new`` (B,KV,hd) and ``slot``
    (B,), they are first quantized (:func:`quantize_kv`) and written
    into k, v and their scales at ``slot`` in place (views write through
    to the cache they view), as the reference's decode step quantizes
    and writes before it attends."""
    if k_new is not None:
        rows = torch.arange(q.shape[0], device=q.device)
        at = slot.to(torch.int64)
        for c, sc, new in ((k, k_scale, k_new), (v, v_scale, v_new)):
            c[rows, :, at], sc[rows, :, at] = quantize_kv(new)
    return decode_attention_ref(q, dequantize_kv(k, k_scale, q.dtype),
                                dequantize_kv(v, v_scale, q.dtype), pos,
                                window=window)


def _utility_rows(mu, sigma, acc, t_u, t_l, e, gamma, eps):
    """The Eq. 3–4 utilities (B, n) masked by ``e`` (zero where
    ineligible) — mu/sigma/acc (n,), shared by every request, or (B, n),
    a pool row each — each row's mass summed model by model in pool order —
    the order the kernels sum in, so both give the same bits — and
    whether that mass is finite and positive."""
    f32 = torch.float32
    muf = mu.to(f32)
    num = t_u.to(f32)[:, None] - (muf + sigma.to(f32))
    den = torch.clamp_min(torch.abs(t_l.to(f32)[:, None] - muf), eps)
    u = torch.pow(torch.clamp_min(acc.to(f32), eps), gamma) * num / den
    u = torch.where(e, u, 0.0)
    total = torch.zeros(u.shape[0], dtype=f32, device=u.device)
    for j in range(u.shape[1]):
        total = total + u[:, j]
    return u, total, torch.isfinite(total) & (total > 0)


def policy_probs_ref(mu, sigma, acc, t_u, t_l, elig, *, gamma=1.0,
                     eps=1e-9):
    """Batched ModiPick stage-3 (Eqs. 3–4).  mu/sigma/acc: (n,);
    t_u/t_l: (B,); elig: (B, n) mask → (B, n) float32 probability rows
    (all-zero where a row has no eligible model); a row whose mass is
    not finite or not positive is uniform over its eligible models."""
    e = elig > 0
    u, total, good = _utility_rows(mu, sigma, acc, t_u, t_l, e, gamma, eps)
    ef = e.to(torch.float32)
    cnt = torch.zeros_like(total)
    for j in range(u.shape[1]):
        cnt = cnt + ef[:, j]
    good = good[:, None]
    uniform = ef / torch.clamp_min(cnt, 1.0)[:, None]
    return torch.where(good, u / torch.where(good, total[:, None], 1.0),
                       uniform)


def modipick_masks_ref(mu, sigma, rank, t_u, t_l, *, pad_rank=1e9):
    """Batched ModiPick stages 1–2 (plain torch, unpadded shapes).

    mu/sigma: (n,); rank: (n,) position of each model in the
    accuracy-descending order; t_u/t_l: (B,).  Returns
    ``(base, has_base, eligible)``: the Eq. 2 eligibility reduced by
    accuracy-order masked argmin (stage 1) and the window-membership
    matrix with the base forced in (stage 2)."""
    rows = (t_u.shape[0], mu.shape[0])
    return _masks_rows(mu.expand(rows), sigma.expand(rows),
                       rank.expand(rows), t_u, t_l, pad_rank)


def _masks_rows(mu, sigma, rank, t_u, t_l, pad_rank):
    """Stages 1–2 with a pool row per request: mu/sigma/rank (B, n),
    t_u/t_l (B,); the base's μ and σ are gathered from its own row."""
    tu, tl = t_u[:, None], t_l[:, None]
    mus = mu + sigma
    elig1 = (mus < tu) & ((mu - sigma) < tl)
    has_base = elig1.any(dim=1)
    base = torch.argmin(torch.where(elig1, rank, pad_rank + 1.0), dim=1)
    half = (torch.abs(t_l - mu.gather(1, base[:, None])[:, 0])
            + sigma.gather(1, base[:, None])[:, 0])
    lo, hi = (t_l - half)[:, None], (t_l + half)[:, None]
    natural = (lo <= mu) & (mu <= hi) & (mus < tu)
    idx = torch.arange(mu.shape[1], device=mu.device)
    eligible = natural | (idx[None, :] == base[:, None])
    eligible &= has_base[:, None]
    return base, has_base, eligible


def _running_sum(w):
    """(B, n) → (B, n): the running sum along the pool in pool order,
    one add per column (``torch.cumsum`` sums in another order on the
    card, and in double on the CPU)."""
    c = torch.zeros_like(w[:, 0])
    cols = []
    for j in range(w.shape[1]):
        c = c + w[:, j]
        cols.append(c)
    return torch.stack(cols, dim=1)


def _draw(w, r01, base):
    """The inverse-CDF draw: per row, the first index whose running sum
    of ``w`` exceeds ``r01 · total`` (total: the sum's last value), else
    ``base``.  Zero-weight models have flat segments and are never
    drawn."""
    cdf = _running_sum(w)
    total = cdf[:, -1]
    thresh = r01 * total
    choice = torch.argmax((cdf > thresh[:, None]).to(torch.uint8), dim=1)
    return torch.where(total > thresh, choice, base)


def fused_select_ref(mu, sigma, acc, rank, t_u, t_l, r01, *, gamma=1.0,
                     eps=1e-9, pad_rank=1e9):
    """Batched ModiPick stages 1–3 and the draw.  mu/sigma/acc/rank:
    (n,); t_u/t_l/r01: (B,) → (B,) int32: the drawn pool index, or −1
    where no base exists.  The draw runs on stage 3's normalised
    probabilities (:func:`policy_probs_ref`)."""
    base, has_base, eligible = modipick_masks_ref(mu, sigma, rank, t_u, t_l,
                                                  pad_rank=pad_rank)
    w = policy_probs_ref(mu, sigma, acc, t_u, t_l,
                         eligible.to(torch.float32), gamma=gamma, eps=eps)
    choice = _draw(w, r01, base)
    return torch.where(has_base, choice, -1).to(torch.int32)


def modipick_weights_ref(mu, sigma, acc, t_u, t_l, eligible, *, gamma=1.0,
                         eps=1e-9):
    """The unnormalised Eq. 3–4 utility rows of the charged pass (the
    reference's ``_utilities``): (B, n), zero where ineligible; a row
    whose mass is not finite or not positive weighs its eligible models
    1 each."""
    u, _, good = _utility_rows(mu, sigma, acc, t_u, t_l, eligible, gamma,
                               eps)
    return torch.where(good[:, None], u, eligible.to(torch.float32))


def stacked_select_ref(mu, sigma, acc, rank, row, t_u, t_l, r01, *,
                       shifts=None, gamma=1.0, fallback=False, eps=1e-9,
                       pad_rank=1e9):
    """Stages 1–3 and the draw with a pool row per request (the
    reference's ``_classed_select`` and ``fleet_select_body``).

    mu/sigma: (P, n) pool rows; acc/rank: (n,), shared by every row, or
    (P, n), one per pool row; row: (B,) each request's pool row (its
    input class, or its cell); shifts: None or (n,) per-model waits,
    added to every row's μ before stage 1; t_u/t_l/r01: (B,).  The draw
    runs on :func:`modipick_weights_ref`'s unnormalised weights.

    Returns ``(picks int32, has_base bool)``, each (B,).  Where a
    request has no base its pick is, with ``fallback``, the first index
    of least (shifted) μ in its own row, else −1."""
    r = row.long()
    mu_r = mu[r] if shifts is None else mu[r] + shifts
    sig_r = sigma[r]
    acc_r = acc[r] if acc.dim() == 2 else acc
    rank_r = rank[r] if rank.dim() == 2 else rank.expand(mu_r.shape)
    base, has_base, eligible = _masks_rows(mu_r, sig_r, rank_r, t_u, t_l,
                                           pad_rank)
    w = modipick_weights_ref(mu_r, sig_r, acc_r, t_u, t_l, eligible,
                             gamma=gamma, eps=eps)
    choice = _draw(w, r01, base)
    miss = (torch.argmin(mu_r, dim=1) if fallback
            else torch.full_like(choice, -1))
    return torch.where(has_base, choice, miss).to(torch.int32), has_base


def charged_select_ref(mu, sigma, acc, rank, mu_charge, cand_mask, speed,
                       rep_wait, t_u, t_l, r01, lim, *, gamma=1.0,
                       slack=0.0, include_mu=False, fastest=0, eps=1e-9,
                       pad_rank=1e9, cand_lists=None):
    """The charged sequential-greedy pass (the reference's
    ``_charged_step`` under ``lax.scan``), one request at a time in
    batch order.  Pool: mu/sigma/acc/rank/mu_charge (n,); cand_mask (n,
    R) bool: replica r serves model m; speed/rep_wait (R,): the ledger's
    start; t_u/t_l/r01/lim (B,).

    For request i: each model's wait W is the least over its candidate
    replicas in the ledger (a model with no finite wait is not
    shifted); it is admitted when some model has ``W + slack (+
    mu_charge) < lim[i]``; stages 1–3 and the draw run on ``mu + W``
    with :func:`modipick_weights_ref` (``fastest`` where no base
    exists); the pick's ``mu_charge / speed`` is charged, if admitted,
    to its least-loaded capable replica (first index on a tie).  The
    caller's ``rep_wait`` is not written.

    ``cand_lists`` is the kernel's compact form of ``cand_mask``
    (``policy_select.candidate_lists``), taken so that the two share a
    signature; this version reads the mask and ignores it.

    Returns ``(picks int32, admitted bool, has_base bool, replica int32,
    w_chosen float32)``, each (B,): ``w_chosen`` is the pick's wait, or
    the least raw wait where the request was shed."""
    f32 = torch.float32
    cand = cand_mask.to(torch.bool)
    ledger = rep_wait.to(f32).clone()
    inf = torch.tensor(float("inf"), dtype=f32, device=mu.device)
    outs = []
    for i in range(t_u.shape[0]):
        wq_raw = torch.where(cand, ledger[None, :], inf).amin(dim=1)
        wq = torch.where(torch.isfinite(wq_raw), wq_raw, 0.0)
        cost = wq_raw + slack
        if include_mu:
            cost = cost + mu_charge
        admitted = (cost < lim[i]).any()
        mu_i = mu + wq
        tu, tl = t_u[i:i + 1], t_l[i:i + 1]
        base, has_base, eligible = modipick_masks_ref(
            mu_i, sigma, rank, tu, tl, pad_rank=pad_rank)
        w = modipick_weights_ref(mu_i, sigma, acc, tu, tl, eligible,
                                 gamma=gamma, eps=eps)
        choice = _draw(w, r01[i:i + 1], base)[0]
        pick = torch.where(has_base[0], choice, fastest)
        rep = torch.argmin(torch.where(cand[pick], ledger, inf))
        delta = torch.where(admitted, mu_charge[pick] / speed[rep], 0.0)
        ledger[rep] += delta
        w_chosen = torch.where(admitted, wq[pick], wq_raw.amin())
        outs.append((pick, admitted, has_base[0], rep, w_chosen))
    if not outs:
        none = torch.zeros(0, dtype=torch.int32, device=mu.device)
        return none, none.bool(), none.bool(), none, none.float()
    picks, admitted, has_base, rep, w_chosen = (torch.stack(c)
                                                for c in zip(*outs))
    return (picks.to(torch.int32), admitted.to(torch.bool),
            has_base.to(torch.bool), rep.to(torch.int32),
            w_chosen.to(f32))


def ssd_scan_ref(x, dt, A, B_, C_, *, chunk: int = 256):
    """Sequential SSD recurrence.  x: (B,H,S,hd); dt: (B,H,S); A: (H,);
    B_, C_: (B,G,S,N) shared by the H // G heads of each group.
    h_t = exp(dt·A)·h + dt·B⊗x ; y = C·h, in fp32.

    Returns ``(y (B,H,S,hd) in x.dtype, final state (B,H,hd,N) fp32)``.
    ``chunk`` is the kernel's tile length along S; the recurrence has no
    chunks and ignores it (it is taken so that the two are
    interchangeable)."""
    Bb, H, S, hd = x.shape
    group = H // B_.shape[1]
    Bx = B_.repeat_interleave(group, dim=1).float()  # (B,H,S,N)
    Cx = C_.repeat_interleave(group, dim=1).float()
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf * A.float()[None, :, None])  # (B,H,S)
    h = torch.zeros((Bb, H, hd, Bx.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        upd = (dtf[:, :, t, None, None] * xf[:, :, t, :, None]
               * Bx[:, :, t, None, :])
        h = h * decay[:, :, t, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cx[:, :, t]))
    return torch.stack(ys, dim=2).to(x.dtype), h


def _ssd_operands(x, dt, A, B_, C_):
    """fp32 x, dt, B_ and C_ with B_ and C_ repeated over the heads of
    each group, and the per-step decay exp(dt·A) (B,H,S)."""
    group = x.shape[1] // B_.shape[1]
    Bx = B_.repeat_interleave(group, dim=1).float()
    Cx = C_.repeat_interleave(group, dim=1).float()
    dtf = dt.float()
    return x.float(), dtf, Bx, Cx, torch.exp(dtf * A.float()[None, :, None])


def ssd_chunk_states_ref(x, dt, A, B_, C_, *, chunk: int):
    """The state on entry to each chunk of ``chunk`` steps (B,H,n_chunks,
    hd,N) fp32, the first one zero: what K4 writes for its backward when
    asked."""
    xf, dtf, Bx, _, decay = _ssd_operands(x, dt, A, B_, C_)
    Bb, H, S, hd = x.shape
    h = torch.zeros((Bb, H, hd, Bx.shape[-1]), dtype=torch.float32,
                    device=x.device)
    out = []
    for t in range(S):
        if t % chunk == 0:
            out.append(h)
        h = h * decay[:, :, t, None, None] + (
            dtf[:, :, t, None, None] * xf[:, :, t, :, None]
            * Bx[:, :, t, None, :])
    return torch.stack(out, dim=2)


def ssd_scan_bwd_ref(x, dt, A, B_, C_, dy, dstate=None, *, chunk: int):
    """The backward of ``ssd_scan_ref`` as a reverse loop in fp32, for
    the output gradient dy (B,H,S,hd) and the final state's gradient
    ``dstate`` (B,H,hd,N), or none.  Each chunk's h_t are recomputed from
    its entry state (:func:`ssd_chunk_states_ref`), then walked back:
    g_t = decay_{t+1}·g_{t+1} + dy_t ⊗ C_t from g = dstate, dx_t =
    dt_t·g_t·B_t, dB_t = dt_t·g_tᵀ·x_t, dC_t = h_tᵀ·dy_t, ddt_t =
    ⟨g_t, x_t ⊗ B_t⟩ + A·decay_t·⟨g_t, h_{t−1}⟩ and dA = Σ dt_t·decay_t·
    ⟨g_t, h_{t−1}⟩; dB_ and dC_ are summed over the heads of each group.
    Returns (dx, ddt, dA, dB_, dC_), each in its input's dtype."""
    xf, dtf, Bx, Cx, decay = _ssd_operands(x, dt, A, B_, C_)
    Af, dyf = A.float(), dy.float()
    Bb, H, S, hd = x.shape
    G, N = B_.shape[1], B_.shape[3]
    starts = ssd_chunk_states_ref(x, dt, A, B_, C_, chunk=chunk)
    g = (torch.zeros((Bb, H, hd, N), dtype=torch.float32, device=x.device)
         if dstate is None else dstate.float())
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xf, dtf, Bx, Cx))
    dA = torch.zeros_like(Af)
    for c in range(starts.shape[2] - 1, -1, -1):
        s0 = c * chunk
        hs = [starts[:, :, c]]
        for t in range(s0, min(s0 + chunk, S)):
            hs.append(hs[-1] * decay[:, :, t, None, None] + (
                dtf[:, :, t, None, None] * xf[:, :, t, :, None]
                * Bx[:, :, t, None, :]))
        for t in range(min(s0 + chunk, S) - 1, s0 - 1, -1):
            h, h_prev = hs[t - s0 + 1], hs[t - s0]
            g = g + dyf[:, :, t, :, None] * Cx[:, :, t, None, :]
            gB = torch.einsum("bhpn,bhn->bhp", g, Bx[:, :, t])
            gh = (g * h_prev).sum(dim=(2, 3))
            dx[:, :, t] = dtf[:, :, t, None] * gB
            dB[:, :, t] = dtf[:, :, t, None] * torch.einsum(
                "bhpn,bhp->bhn", g, xf[:, :, t])
            dC[:, :, t] = torch.einsum("bhpn,bhp->bhn", h, dyf[:, :, t])
            ddt[:, :, t] = ((gB * xf[:, :, t]).sum(-1)
                            + Af[None, :] * decay[:, :, t] * gh)
            dA += (dtf[:, :, t] * decay[:, :, t] * gh).sum(0)
            g = g * decay[:, :, t, None, None]
    dB = dB.view(Bb, G, H // G, S, N).sum(2)
    dC = dC.view(Bb, G, H // G, S, N).sum(2)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B_.dtype), dC.to(C_.dtype))


def rglru_scan_ref(a, b):
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t over axis 1,
    in fp32.  a, b: (B,S,W) → h (B,S,W) in a.dtype."""
    af, bf = a.float(), b.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_scan_bwd_ref(a, h, dh):
    """The backward of ``rglru_scan_ref`` as a reverse loop in fp32, from
    a and the forward's output h: g_t = dh_t + a_{t+1} g_{t+1},
    da_t = g_t h_{t−1} (h_{−1} = 0), db_t = g_t.  Returns (da, db) in
    a.dtype."""
    af, hf, gf = a.float(), h.float(), dh.float()
    g = torch.zeros_like(af[:, 0])
    da, db = [], []
    for t in range(a.shape[1] - 1, -1, -1):
        if t + 1 < a.shape[1]:
            g = gf[:, t] + af[:, t + 1] * g
        else:
            g = gf[:, t]
        db.append(g)
        da.append(g * hf[:, t - 1] if t > 0 else torch.zeros_like(g))
    da = torch.stack(da[::-1], dim=1)
    db = torch.stack(db[::-1], dim=1)
    return da.to(a.dtype), db.to(a.dtype)


# ----------------------------------------------------------------------
# AdamW: the reference's step (``repro/training/optimizer.py``), op for op
# ----------------------------------------------------------------------
ADAM_ROWS = 1 << 24  # elements of a big leaf one plain update takes at a time


def global_norm(leaves) -> torch.Tensor:
    """√(Σ x²) over an iterable of tensors, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_scale(gnorm, grad_clip: float):
    """min(1, clip / (‖g‖ + 1e-9)) as a 0-dim tensor, or 1.0 without
    clipping."""
    if grad_clip <= 0:
        return 1.0
    return torch.clamp_max(torch.full_like(gnorm, grad_clip)
                           / (gnorm + 1e-9), 1.0)


def adam_ref(p, g, m, v, decay: bool, scale, bc1, bc2, lr, *, b1: float,
             b2: float, eps: float, weight_decay: float) -> None:
    """The reference's update of one leaf (or rows of one): m, v and p
    written in place, op for op the reference's rounding.  ``scale`` is
    the clip scale; ``bc1``, ``bc2`` the bias corrections."""
    g = g.to(torch.float32) * scale
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if decay:
        delta = delta + weight_decay * p.to(torch.float32)
    p.copy_(p.to(torch.float32) - lr * delta)


def adamw_ref(params, grads, mu, nu, decay, bc1, bc2, lr, *, b1: float,
              b2: float, eps: float, weight_decay: float,
              grad_clip: float, scale=None) -> torch.Tensor:
    """One AdamW step over lists of leaves (fp32 moments), in place: the
    global norm of ``grads``, the clip scale, then :func:`adam_ref` on
    each leaf, a big leaf some rows at a time so that its fp32
    transients stay bounded.  ``scale``, where given, is the clip scale
    to step with in place of the one from the norm (another
    implementation's, to compare the two at equal scale).  Returns the
    norm."""
    gnorm = global_norm(grads)
    if scale is None:
        scale = clip_scale(gnorm, grad_clip)
    for p, g, m, v, d in zip(params, grads, mu, nu, decay):
        rows = max(1, ADAM_ROWS // max(1, p[0].numel()))
        for r in range(0, p.shape[0], rows):
            sl = slice(r, r + rows)
            adam_ref(p[sl], g[sl], m[sl], v[sl], d, scale, bc1, bc2, lr,
                     b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return gnorm
