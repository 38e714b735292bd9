"""Public model API: the inputs of a batch and of a decode step as
(shape, dtype) pairs, the prefill and serve steps, and random batches.

The reference returns ``jax.ShapeDtypeStruct``s for its dry-run; the
port has none, so a spec is a ``(shape tuple, torch dtype)`` pair and a
decode step's cache is the port's per-layer list of such pairs
(``model.cache_specs``).  Nothing here allocates but
:func:`make_train_batch`.  Training's loss (``make_forward_loss``) is
not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, ModelKernels
from repro_torch.models import model as M


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """(shape, dtype) of each input of one forward batch (train and
    prefill modes).  An encoder-decoder adds precomputed frame
    embeddings, a VLM patch embeddings that take ``n_image_tokens`` of
    the sequence; train mode adds the targets."""
    B, S = shape.global_batch, shape.seq_len
    act = act_dtype(cfg)
    specs: Dict[str, Any] = {}
    if cfg.vlm is not None:
        n_img = cfg.vlm.n_image_tokens
        specs["tokens"] = ((B, S - n_img), torch.int32)
        specs["image_embeds"] = ((B, n_img, cfg.d_model), act)
    else:
        specs["tokens"] = ((B, S), torch.int32)
        if cfg.encdec is not None:
            specs["frames"] = ((B, cfg.encdec.n_frames, cfg.d_model), act)
    if shape.mode == "train":
        specs["targets"] = (specs["tokens"][0], torch.int32)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A decode step's inputs: one new token and its position per
    sequence, and the cache of ``seq_len`` slots."""
    B = shape.global_batch
    return {"tokens": ((B,), torch.int32), "pos": ((B,), torch.int32),
            "cache": M.cache_specs(cfg, B, shape.seq_len, act_dtype(cfg))}


def make_prefill_step(cfg: ModelConfig, cache_len: int,
                      impl: ModelKernels = KERNELS):
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len, impl)
    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: ModelKernels = KERNELS):
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos, impl)
    return serve_step


def make_train_batch(cfg: ModelConfig, shape: ShapeConfig,
                     generator: torch.Generator,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch of :func:`batch_specs` from ``generator`` on
    ``device`` (the card unless the caller asks for the CPU; the
    generator must live there): ids uniform in [0, vocab), embeddings
    0.02 · N(0, 1), drawn in fp32 and cast before the product as the
    reference casts them."""
    dev = resolve_device(device)
    gdev = generator.device
    if gdev.type != dev.type or dev.index not in (None, gdev.index):
        raise ValueError(f"the generator lives on {gdev}, but the batch "
                         f"was asked for on {dev}")
    out = {}
    for name, (shp, dtype) in batch_specs(cfg, shape).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shp,
                                      generator=generator, device=gdev,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(shp, generator=generator, device=gdev,
                                    dtype=torch.float32).to(dtype) * 0.02
    return out
