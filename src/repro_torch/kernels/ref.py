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
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * hd ** -0.5
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx.float()).to(q.dtype)


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


def policy_probs_ref(mu, sigma, acc, t_u, t_l, elig, *, gamma=1.0,
                     eps=1e-9):
    """Batched ModiPick stage-3 (Eqs. 3–4).  mu/sigma/acc: (n,);
    t_u/t_l: (B,); elig: (B, n) mask → (B, n) float32 probability rows
    (all-zero where a row has no eligible model).

    Each row's mass is summed model by model, in pool order — the order
    the stage-3 kernel sums in — so the kernel and this version give the
    same bits."""
    f32 = torch.float32
    muf = mu.to(f32)
    e = elig > 0
    num = t_u.to(f32)[:, None] - (muf + sigma.to(f32))[None, :]
    den = torch.clamp_min(torch.abs(t_l.to(f32)[:, None] - muf[None, :]), eps)
    u = torch.pow(torch.clamp_min(acc.to(f32), eps), gamma)[None, :] * num / den
    u = torch.where(e, u, 0.0)
    ef = e.to(f32)
    total = torch.zeros(u.shape[0], dtype=f32, device=u.device)
    cnt = torch.zeros_like(total)
    for j in range(u.shape[1]):
        total = total + u[:, j]
        cnt = cnt + ef[:, j]
    good = (torch.isfinite(total) & (total > 0))[:, None]
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
    tu, tl = t_u[:, None], t_l[:, None]
    mus = (mu + sigma)[None, :]
    elig1 = (mus < tu) & ((mu - sigma)[None, :] < tl)
    has_base = elig1.any(dim=1)
    base = torch.argmin(torch.where(elig1, rank[None, :], pad_rank + 1.0),
                        dim=1)
    half = torch.abs(t_l - mu[base]) + sigma[base]
    lo, hi = (t_l - half)[:, None], (t_l + half)[:, None]
    natural = (lo <= mu[None, :]) & (mu[None, :] <= hi) & (mus < tu)
    idx = torch.arange(mu.shape[0], device=mu.device)
    eligible = natural | (idx[None, :] == base[:, None])
    eligible &= has_base[:, None]
    return base, has_base, eligible
