"""AdamW and its learning-rate schedules, the reference's
(``repro/training/optimizer.py``), in PyTorch.

The moments are kept in fp32 whatever the parameters' dtype, or as int8
with per-row scales (``opt_moments="int8"``).  The step's arithmetic is
the reference's, in fp32, op for op.  Two things follow from the port's
parameter layout (``models/convert.py``, :func:`leaf_layout`):

- Weight decay.  The reference decays "matrices only" (``ndim >= 2``),
  but it stacks the layers of its superblocks, so every 1-D leaf of a
  stacked layer (norm scales, biases, ``A_log``, ``D``, ...) reaches
  that test as 2-D and decays, while the same leaves of the unrolled
  tail and the final norms do not.  The port keeps a list of layers,
  every layer's leaf unstacked, so a leaf decays here when it is a
  matrix or the reference stacks it.
- int8 moments.  The reference quantizes per row of each leaf's last
  axis.  A fused leaf of the port (``wqkv`` = ``wq | wk | wv``, ...)
  spans several reference leaves along that axis, so it is quantized
  per segment, one reference leaf a segment, and keeps one scale a
  (row, segment): the reference's bits, as far as the two libraries'
  float32 log and exp agree (they differ in the last bit on a few per
  cent of inputs).

The state is keyed by leaf path (``models.convert.named_leaves``).
:func:`adamw_update` writes the new parameters and fp32 moments into
their tensors in place (the reference donates its buffers), so a step
holds no second copy of the state.  It takes one of two paths, by the
leaves' device and the moments' type:

- fused: fp32 moments on the card, or on ``meta`` inside
  ``cost.counting()`` (the dry-run): the hand-written multi-tensor
  kernels (``kernels/adamw.py``), one pass over p, g, m and v for every
  leaf after a global norm on the card, or on ``meta`` their recorded
  cost.  The wrapper raises a TypeError for leaves the kernels do not
  take, rather than step them another way;
- eager: CPU tensors, int8 moments and ``meta`` outside the dry-run's
  count: the plain step (``kernels/ref.py`` ``adamw_ref``), a big leaf
  some rows at a time, int8 moments dequantized and quantized again
  around it.

Both compute the same arithmetic; at equal clip scale the fused path's
p, m and v are the eager path's bits, and only the norm's sum runs in
another order.  :func:`update_counts` says how many elements each path
updated.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import adamw as fused
from repro_torch.kernels import cost
from repro_torch.kernels import ref
from repro_torch.kernels.ref import global_norm
from repro_torch.models.convert import LeafLayout, named_leaves


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Dict[str, Any]       # path → first moment (fp32, or int8 dict)
    nu: Dict[str, Any]       # path → second moment (fp32, or int8 dict)


def _div(x, d: float):
    """x / d with d as a tensor: PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which can round the last bit
    the other way."""
    return x / torch.full_like(x, d)


def _segments(x, segments):
    return (x,) if segments is None else torch.split(x, segments, dim=-1)


def _expand(scale, segments):
    """A per-(row, segment) value (..., k) spread over the segments'
    columns."""
    if segments is None:
        return scale
    reps = torch.tensor(segments, device=scale.device)
    return torch.repeat_interleave(scale, reps, dim=-1)


# ----------------------------------------------------------------------
# 8-bit moments (per-row dynamic quantization): int8 values with an fp32
# scale a row of the last axis, a row of each segment for a fused leaf.
# ----------------------------------------------------------------------
def _q8(x, segments: Optional[Tuple[int, ...]] = None) -> Dict[str, torch.Tensor]:
    """Linear per-row int8 — fine for the zero-mean first moment."""
    qs, scales = [], []
    for part in _segments(x, segments):
        amax = torch.amax(torch.abs(part), dim=-1, keepdim=True)
        scale = _div(amax, 127.0) + 1e-20
        qs.append(torch.clamp(torch.round(part / scale), -127, 127)
                  .to(torch.int8))
        scales.append(scale)
    return {"q": torch.cat(qs, dim=-1), "scale": torch.cat(scales, dim=-1)}


def _dq8(s: Dict[str, torch.Tensor], segments=None) -> torch.Tensor:
    return s["q"].to(torch.float32) * _expand(s["scale"], segments)


_LOG_FLOOR = -46.0  # exp(-46) ≈ 1e-20: below any meaningful v


def _q8_log(x, segments: Optional[Tuple[int, ...]] = None) -> Dict[str, torch.Tensor]:
    """Log-space per-row int8 for the (non-negative) second moment: v
    spans many decades within a row; quantizing log v caps the relative
    error at ~e^(range/254) per step."""
    qs, scales, los = [], [], []
    for part in _segments(x, segments):
        lg = torch.log(torch.clamp_min(part, 1e-20))
        hi = torch.amax(lg, dim=-1, keepdim=True)
        lo = torch.clamp_min(torch.amin(lg, dim=-1, keepdim=True),
                             _LOG_FLOOR)
        scale = _div(hi - lo, 254.0) + 1e-12
        q = torch.clamp(torch.round((lg - lo) / scale) - 127, -127, 127)
        qs.append(q.to(torch.int8))
        scales.append(scale)
        los.append(lo)
    return {"q": torch.cat(qs, dim=-1), "scale": torch.cat(scales, dim=-1),
            "lo": torch.cat(los, dim=-1)}


def _dq8_log(s: Dict[str, torch.Tensor], segments=None) -> torch.Tensor:
    lg = ((s["q"].to(torch.float32) + 127.0) * _expand(s["scale"], segments)
          + _expand(s["lo"], segments))
    v = torch.exp(lg)
    return torch.where(lg <= _LOG_FLOOR + 1e-6, 0.0, v)


def _segments_of(layout, path):
    if layout is None or len(layout[path].segments) == 1:
        return None
    return layout[path].segments


def init_opt_state(params, moments: str = "fp32",
                   layout: Optional[Dict[str, LeafLayout]] = None) -> OptState:
    """Zero moments for every leaf of ``params``, fp32 or int8 (quantized
    per segment of ``layout``, ``models.convert.leaf_layout``)."""
    leaves = named_leaves(params)
    step = torch.zeros((), dtype=torch.int32, device=leaves[0][1].device)
    if moments == "int8":
        mu, nu = {}, {}
        for path, p in leaves:
            segs = _segments_of(layout, path)
            zero = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            mu[path], nu[path] = _q8(zero, segs), _q8_log(zero, segs)
        return OptState(step, mu, nu)
    return OptState(step, {path: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                           for path, p in leaves},
                    {path: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for path, p in leaves})


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-dim tensor), fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(_div(step, float(max(cfg.warmup_steps, 1))), 1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            _div(step - cfg.warmup_steps,
                 float(max(cfg.total_steps - cfg.warmup_steps, 1))), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            # the cosine in float64, rounded once: the correctly rounded
            # value, which the reference's float32 cosine gives and
            # PyTorch's float32 one misses by an ulp at some steps
            cos = torch.cos((math.pi * frac).double()).to(torch.float32)
            decay = 0.5 * (1.0 + cos)
    return cfg.learning_rate * warm * decay


def decays(p, lay: Optional[LeafLayout]) -> bool:
    """Whether a leaf decays: the reference decays its matrices and every
    leaf of a layer it stacks (``lay.stacked``)."""
    return p.dim() >= 2 or (lay is not None and lay.stacked)


def update_counts() -> Dict[str, int]:
    """Elements :func:`adamw_update` updated on the fused and the eager
    path since the last ``kernels.ops.reset_launch_counts()``."""
    return dict(fused.UPDATES)


def adamw_update(cfg: TrainConfig, params, grads: Dict[str, torch.Tensor],
                 state: OptState,
                 layout: Optional[Dict[str, LeafLayout]] = None
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads``: path → gradient of each leaf of
    ``params``; ``layout`` (``models.convert.leaf_layout``): which
    leaves the reference stacks (they decay) and the segments of fused
    leaves (int8 moments); without it every leaf is one unstacked
    segment, as a plain tree is in the reference.  The parameters and
    moments are updated in place (the caller's state is consumed, as the
    reference's is donated); returns (params, new state,
    {"grad_norm", "lr"}), both 0-dim tensors on the leaves' device."""
    leaves = named_leaves(params)
    paths = [path for path, _ in leaves]
    ps = [p for _, p in leaves]
    gs = [grads[path] for path in paths]
    ms = [state.mu[path] for path in paths]
    vs = [state.nu[path] for path in paths]
    decay = [decays(p, None if layout is None else layout[path])
             for path, p in leaves]
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    lr = lr_schedule(cfg, step)
    hyper = dict(b1=b1, b2=b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    n = sum(p.numel() for p in ps)

    dev = ps[0].device.type
    int8 = isinstance(ms[0], dict)
    with torch.no_grad():
        if not int8 and (dev == "cuda"
                         or (dev == "meta" and cost.is_counting())):
            gnorm = fused.adamw(ps, gs, ms, vs, decay, bc1, bc2, lr,
                                grad_clip=cfg.grad_clip, **hyper)
            fused.UPDATES["fused"] += n
        elif not int8:
            gnorm = ref.adamw_ref(ps, gs, ms, vs, decay, bc1, bc2, lr,
                                  grad_clip=cfg.grad_clip, **hyper)
            fused.UPDATES["eager"] += n
        else:
            gnorm = global_norm(gs)
            scale = ref.clip_scale(gnorm, cfg.grad_clip)
            for i, (path, p) in enumerate(leaves):
                segs = _segments_of(layout, path)
                m, v = _dq8(ms[i], segs), _dq8_log(vs[i], segs)
                ref.adam_ref(p, gs[i], m, v, decay[i], scale, bc1, bc2, lr,
                             **hyper)
                ms[i], vs[i] = _q8(m, segs), _q8_log(v, segs)
            fused.UPDATES["eager"] += n
    return params, OptState(step, dict(zip(paths, ms)),
                            dict(zip(paths, vs))), {"grad_norm": gnorm,
                                                    "lr": lr}
