"""Gradient compression: int8 quantized all-reduce with error feedback,
the reference's (``repro/distributed/compression.py``).

Gradients are quantized to int8 with a per-tensor scale, summed in int32
(no overflow up to 2^23 summands), and dequantized with the largest of
the devices' scales.  The quantization residual is carried in an
error-feedback buffer (Seide et al. / EF-SGD) so the compression bias
vanishes over steps.  Where the reference reduces over a ``shard_map``
axis, the port reduces over a ``torch.distributed`` process group; a
group of one device (or none) leaves the quantize–dequantize round trip.
Nothing in the port or the reference reads ``TrainConfig.compress_grads``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale): ``round(x / scale)`` clipped to ±127,
    rounding half to even as ``jnp.round`` does.  The divisions are by
    tensors: the card divides by a Python number through its reciprocal,
    which can round the last bit the other way."""
    amax = torch.amax(torch.abs(x))
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _reduce(q: torch.Tensor, scale: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` of the payloads, each read at the largest
    scale: SUM of the int32 payloads and MAX of the scales."""
    import torch.distributed as dist
    n = 1 if group is None else dist.get_world_size(group)
    total = q.to(torch.int32)
    if n > 1:
        scale = scale.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return total.to(torch.float32) * scale / torch.full_like(scale, n)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed all-reduce mean of ``x`` over ``group`` (a
    ``torch.distributed`` process group; None is one device)."""
    q, scale = quantize_int8(x)
    return _reduce(q, scale, group)


def ef_compress(grad: torch.Tensor, error: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback step: corrected = grad + error; returns
    (int8 payload, scale, new_error)."""
    corrected = grad.to(torch.float32) + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def ef_compressed_psum_tree(grads: Any, errors: Any, group=None
                            ) -> Tuple[Any, Any]:
    """Tree-wise (dicts and lists) EF-compressed all-reduce mean over
    ``group``.  Returns (reduced, new_errors), each leaf reduced in its
    gradient's dtype."""
    if isinstance(grads, dict):
        pairs = {k: ef_compressed_psum_tree(g, errors[k], group)
                 for k, g in grads.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(grads, (list, tuple)):
        pairs = [ef_compressed_psum_tree(g, e, group)
                 for g, e in zip(grads, errors)]
        return (type(grads)(p[0] for p in pairs),
                type(grads)(p[1] for p in pairs))
    q, scale, new_e = ef_compress(grads, errors)
    return _reduce(q, scale, group).to(grads.dtype), new_e
