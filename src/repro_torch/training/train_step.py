"""The train step: loss, gradients and AdamW, the reference's
(``repro/training/train_step.py``), with optional gradient accumulation
over ``grad_accum`` microbatches: each microbatch's gradients are added
to fp32 accumulators divided by k, and its loss summed divided by k.

Gradients come from ``torch.autograd.grad`` over the parameter leaves;
on the card the attention, SSD and RG-LRU layers run their backward
kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import make_forward_loss
from repro_torch.models.convert import leaf_layout, named_leaves
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            init_opt_state)


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, {path: gradient}) of ``loss_fn(params, batch)``,
    every floating leaf of ``params`` set to require grad."""
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), metrics, {path: g for (path, _), g
                                    in zip(leaves, grads)}


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    the parameters are updated in place."""
    loss_fn = make_forward_loss(mcfg, remat=tcfg.remat != "none")

    def single(params, opt_state: OptState, batch):
        with obs.span("train.grads"):
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        with obs.span("train.optimizer"):
            params, opt_state, om = adamw_update(
                tcfg, params, grads, opt_state, leaf_layout(mcfg, params))
        return params, opt_state, {**metrics, **om, "total_loss": loss}

    if tcfg.grad_accum <= 1:
        return single

    k = tcfg.grad_accum

    def accumulated(params, opt_state: OptState, batch):
        micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                 for name, x in batch.items()}
        acc: Dict[str, torch.Tensor] = {
            path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for path, p in named_leaves(params)}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(acc.values())).device)
        for i in range(k):
            with obs.span("train.grads"):
                loss, _, grads = loss_and_grads(
                    loss_fn, params, {name: x[i] for name, x in micro.items()})
            for path, g in grads.items():
                acc[path] = acc[path] + g.to(torch.float32) / k
            loss_sum = loss_sum + loss / k
        with obs.span("train.optimizer"):
            params, opt_state, om = adamw_update(
                tcfg, params, acc, opt_state, leaf_layout(mcfg, params))
        return params, opt_state, {**om, "total_loss": loss_sum,
                                   "loss": loss_sum}

    return accumulated


def init_train_state(mcfg: ModelConfig, generator: torch.Generator,
                     dtype=torch.bfloat16, tcfg: TrainConfig = None,
                     device="cuda"):
    """Random parameters from ``generator`` (on ``device``) and zero
    moments, fp32 unless ``tcfg.opt_moments`` says int8."""
    from repro_torch.models import model as M
    params = M.init_params(mcfg, generator, dtype, device=resolve_device(device))
    moments = tcfg.opt_moments if tcfg else "fp32"
    return params, init_opt_state(params, moments, leaf_layout(mcfg, params))
