"""A plain fp32 training step: next-token cross-entropy over every
position of the batch, gradients by autograd (each layer recomputed in
the backward pass, which leaves the numbers as they are), then AdamW
with global-norm clipping, bias correction and decoupled weight decay
on matrices and on every leaf of a layer.  The leaves are the logical
leaves of ``bench/weights.py``, cloned to fp32."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from . import load
from .common import exact_fp32, tf32


def loss(family: str, v: dict, W: Dict[str, torch.Tensor], tokens,
         targets):
    """Mean next-token cross-entropy (fp32) of ``tokens`` (B, S)."""
    m = load(family)
    x = m.embed(W, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(v["num_hidden_layers"]):
        x = checkpoint(m.layer, v, W, i, x, positions, use_reentrant=False)
    logits = m.head(v, W, x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())


def decays(name: str, t) -> bool:
    return t.dim() >= 2 or name.startswith("layers.")


def run(family: str, v: dict, W: Dict[str, torch.Tensor], batches: List,
        opt: dict, exact: bool = True, after_update=None) -> dict:
    """Train ``W`` (fp32 leaves, updated in place) for ``len(batches)``
    steps, calling ``after_update(step)`` (from 1) after each step's
    update.  Returns each step's loss and each leaf's first gradient as
    the optimizer takes it (after clipping).  ``exact`` False (the
    control) lets the matmuls run in TF32."""
    names = list(W)
    for t in W.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in W.items()}
    s = {k: torch.zeros_like(t) for k, t in W.items()}
    b1, b2, lr = opt["b1"], opt["b2"], opt["learning_rate"]
    if opt.get("warmup_steps", 0) or opt.get("schedule") != "constant":
        raise ValueError("the reference steps at a constant learning rate")
    losses, first = [], {}
    with exact_fp32() if exact else tf32():
        for step, (tokens, targets) in enumerate(batches, start=1):
            lv = loss(family, v, W, tokens, targets)
            grads = torch.autograd.grad(lv, [W[k] for k in names])
            losses.append(float(lv.detach()))
            with torch.no_grad():
                gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                                      for g in grads))
                clip = min(opt["grad_clip"] / (gnorm + 1e-9), 1.0) \
                    if opt["grad_clip"] > 0 else 1.0
                bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for k, g in zip(names, grads):
                    g = g * clip
                    if step == 1:
                        first[k] = float(torch.linalg.vector_norm(g))
                    p = W[k]
                    m[k].mul_(b1).add_((1.0 - b1) * g)
                    s[k].mul_(b2).add_((1.0 - b2) * g * g)
                    delta = (m[k] / bc1) / (torch.sqrt(s[k] / bc2)
                                            + opt["eps"])
                    if decays(k, p):
                        delta = delta + opt["weight_decay"] * p
                    p.sub_(lr * delta)
                del grads
                if after_update is not None:
                    after_update(step)
    for t in W.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first}
