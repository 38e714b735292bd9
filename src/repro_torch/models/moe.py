"""Mixture-of-experts feed-forward with the reference's GShard-style
capacity routing (``repro/models/moe.py``).

The flattened tokens are cut into groups of ``g = min(group_size, T)``
(the last group padded with zero tokens, which route after the real
ones).  Each token picks its top-k experts from an fp32 softmax, the k
gates renormalised; within a group each expert takes at most
``capacity`` (token, k) entries, token-major and k-minor, and drops the
rest (the residual carries a dropped entry's token).

The reference dispatches and combines with one-hot einsums.  Here the
routing (:func:`moe_route`) gives each entry its expert and slot, and
:func:`moe_apply` copies the tokens into an (E, G·C, D) buffer, runs the
experts as three batched products over all E experts, and gathers each
token's k outputs back: the same values, without the one-hot tensors.
Every expert runs its whole buffer, empty slots included; no kernel is
involved (the reference's MoE reaches no Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_normal


class Routing(NamedTuple):
    """Where each (token, k) entry of a batch goes; all (G, g, K)."""
    idx: torch.Tensor    # int64 expert
    gate: torch.Tensor   # fp32 renormalised top-k gate
    pos: torch.Tensor    # int64 entries of its expert ahead of it
    keep: torch.Tensor   # bool: pos < capacity
    aux: torch.Tensor    # () fp32 Switch load-balancing loss
    capacity: int


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype) -> dict:
    """The reference's ``moe_template``: router (D, E), wi and wg
    (E, D, F), and the out-projection wo (E, F, D)."""
    d, e = cfg.d_model, cfg.moe
    E, f = e.n_experts, e.d_ff_expert

    def normal(*shape, out_proj=False):
        return init_normal(shape, generator, dtype, out_proj=out_proj)

    return {"router": normal(d, E), "wi": normal(E, d, f),
            "wg": normal(E, d, f), "wo": normal(E, f, d, out_proj=True)}


def capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(group * top_k * factor / n_experts)
    return max(4, ((c + 3) // 4) * 4)


def _top_k(gates, k):
    """The k largest gates and their experts; ties go to the lower
    expert, as ``lax.top_k`` breaks them (a zero pad token's gates are
    all equal)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def moe_route(router, x, cfg: ModelConfig) -> Routing:
    """Route x (B, S, D) with the (D, E) router."""
    e = cfg.moe
    E, K = e.n_experts, e.top_k
    B, S, D = x.shape
    T = B * S
    g = min(e.group_size, T)
    G = -(-T // g)
    xf = x.reshape(T, D)
    if G * g != T:
        xf = F.pad(xf, (0, 0, 0, G * g - T))
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    gates = torch.softmax(logits, dim=-1).view(G, g, E)
    top, idx = _top_k(gates, K)
    top = top / torch.sum(top, dim=-1, keepdim=True)

    # hits[G, e, j]: entry j of a group (token-major, k-minor) goes to e
    flat = idx.view(G, 1, g * K)
    hits = flat == torch.arange(E, device=x.device).view(1, E, 1)
    me = torch.mean(gates, dim=(0, 1))
    ce = torch.sum(hits, dim=(0, 2)).to(torch.float32) / (G * g) / K
    aux = E * torch.sum(me * ce)

    # entries of the same expert ahead of each one (a scan along the
    # entries, the innermost dimension)
    ahead = torch.cumsum(hits, dim=2)
    pos = (torch.gather(ahead, 1, flat) - 1).view(G, g, K)
    C = capacity(g, K, E, e.capacity_factor)
    return Routing(idx, top, pos, pos < C, aux, C)


def expert_ffn(params, xin):
    """The experts' SwiGLU on their buffers: xin (E, N, D) → (E, N, D),
    three batched products over all E experts."""
    h = torch.bmm(xin, params["wi"])
    hg = torch.bmm(xin, params["wg"])
    return torch.bmm(F.silu(h) * hg, params["wo"])


def moe_apply(params, x, r: Routing, cfg: ModelConfig):
    """The experts' output for x (B, S, D) under routing ``r``.  Nothing
    here reads a value back to the host."""
    E = cfg.moe.n_experts
    B, S, D = x.shape
    T = B * S
    G, g, K = r.idx.shape
    n = E * G * r.capacity
    # an entry is sent where the reference's combine weight is > 0
    send = (r.keep & (r.gate > 0)).view(G * g, K)[:T]
    group = torch.arange(G, device=x.device).view(G, 1, 1)
    slot = ((r.idx * G + group) * r.capacity + r.pos).view(G * g, K)[:T]
    slot = torch.where(send, slot, 0)
    # copy each token into its experts' slots; entries not sent go to a
    # spare last row that no expert reads
    xf = x.reshape(T, D)
    buf = x.new_zeros(n + 1, D)
    buf.index_copy_(0, torch.where(send, slot, n).view(T * K),
                    xf.repeat_interleave(K, dim=0))
    out = expert_ffn(params, buf[:n].view(E, n // E, D)).view(n, D)
    # each token's k outputs weighted by its gates in x.dtype, as the
    # reference casts its combine weights, summed by one batched product
    w = (r.gate.view(G * g, K)[:T] * send).to(x.dtype)
    return torch.bmm(w[:, None, :], out[slot]).view(B, S, D)


def moe_ffn(params, x, cfg: ModelConfig, routing: Routing = None):
    """x: (B, S, D) → (out (B, S, D), aux_loss () fp32).  ``routing``,
    when given, replaces x's own (a check can then run two inputs
    through one routing)."""
    r = moe_route(params["router"], x, cfg) if routing is None else routing
    return moe_apply(params, x, r, cfg), r.aux


def moe_ffn_dense_eval(params, x, cfg: ModelConfig):
    """Dropless oracle: every token through all experts, weighted by its
    renormalised top-k gates.  O(E) work — for tests only."""
    e = cfg.moe
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    top, idx = _top_k(gates, e.top_k)
    top = top / torch.sum(top, dim=-1, keepdim=True)
    w = torch.sum(F.one_hot(idx, e.n_experts).to(torch.float32)
                  * top[..., None], dim=-2)               # (B, S, E)
    h = torch.einsum("bsd,Edf->bsEf", x, params["wi"])
    hg = torch.einsum("bsd,Edf->bsEf", x, params["wg"])
    o = torch.einsum("bsEf,Efd->bsEd", F.silu(h) * hg, params["wo"])
    return torch.einsum("bsE,bsEd->bsd", w.to(x.dtype), o)
