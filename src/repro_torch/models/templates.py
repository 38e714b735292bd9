"""Shape-only descriptions of the port's parameters and caches, with the
reference's logical axes: the counterpart of its ``param_template``,
``cache_template``, ``abstract`` and ``axes_tree``
(``repro/models/model.py``, ``layers.py``).

:func:`param_template` and :func:`cache_template` have the structure of
``model.init_params`` and ``model.init_cache`` (the same keys in the
same order, so the same leaf paths, ``convert.named_leaves``), with a
:class:`LeafSpec` at every leaf in place of a tensor.  A leaf the port
fuses from several reference leaves side by side along its last axis
(``wqkv`` = ``wq | wk | wv``, an SSD layer's ``w_in``, ...; the segments
of ``convert.leaf_layout``) carries one axes tuple a segment: the
reference's axes of each.  The port keeps its layers unstacked, so no
leaf has the reference's leading ``layers`` axis (whose rule is None).

:func:`empty` builds tensors of a template, on ``meta`` for the dry-run
(``launch/dryrun.py``), which has no generator for ``init_params``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (ATTENTION_KINDS, check_supported,
                                      layer_kinds)

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and dtype, and the reference's logical axes of each
    segment of its last axis (``segments``: their widths).  Not a tuple,
    so that ``convert.named_leaves`` stops at it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Axes, ...]
    segments: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * torch.empty((), dtype=self.dtype).element_size()

    def segment_shapes(self):
        """(shape, axes) of each segment: the reference leaf it holds."""
        return [(self.shape[:-1] + (w,), ax)
                for w, ax in zip(self.segments, self.axes)]


def _leaf(shape, dtype, *axes, segments=None) -> LeafSpec:
    """A leaf of ``shape``; one axes tuple, or one a segment of
    ``segments`` along the last axis."""
    shape = tuple(int(s) for s in shape)
    segments = (shape[-1],) if segments is None else tuple(segments)
    if len(axes) != len(segments) or sum(segments) != shape[-1]:
        raise ValueError(f"segments {segments} and {len(axes)} axes do not "
                         f"cover the last axis of {shape}")
    return LeafSpec(shape, dtype, tuple(tuple(a) for a in axes), segments)


def param_template(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The parameters ``model.init_params(cfg, ..., dtype)`` builds, as
    :class:`LeafSpec` leaves."""
    check_supported(cfg)
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv, v = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab

    def leaf(shape, *axes, segments=None):
        return _leaf(shape, dtype, *axes, segments=segments)

    def norm():
        return leaf((d,), (None,))

    def attention_layer():
        qkv = (h * hd, kv * hd, kv * hd)
        p = {"wqkv": leaf((d, sum(qkv)), ("embed_fsdp", "heads_merged"),
                          ("embed_fsdp", "kv_merged"),
                          ("embed_fsdp", "kv_merged"), segments=qkv),
             "wo": leaf((h * hd, d), ("heads_merged", "embed_fsdp"))}
        if cfg.qkv_bias:
            p["bqkv"] = leaf((sum(qkv),), (None,), (None,), (None,),
                             segments=qkv)
        return p

    def cross_attention():
        kv2 = (kv * hd, kv * hd)
        p = {"wq": leaf((d, h * hd), ("embed_fsdp", "heads_merged")),
             "wkv": leaf((d, sum(kv2)), ("embed_fsdp", "kv_merged"),
                         ("embed_fsdp", "kv_merged"), segments=kv2),
             "wo": leaf((h * hd, d), ("heads_merged", "embed_fsdp"))}
        if cfg.qkv_bias:
            p["bq"] = leaf((h * hd,), (None,))
            p["bkv"] = leaf((sum(kv2),), (None,), (None,), segments=kv2)
        return p

    def dense_mlp():
        mlp = {"wi": leaf((d, f), ("embed_fsdp", "ff")),
               "wo": leaf((f, d), ("ff", "embed_fsdp"))}
        if cfg.mlp in ("swiglu", "geglu"):
            mlp["wg"] = leaf((d, f), ("embed_fsdp", "ff"))
        return mlp

    def moe():
        E, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        return {"router": leaf((d, E), ("embed_fsdp", None)),
                "wi": leaf((E, d, fe), ("experts", "embed_fsdp", "expert_ff")),
                "wg": leaf((E, d, fe), ("experts", "embed_fsdp", "expert_ff")),
                "wo": leaf((E, fe, d), ("experts", "expert_ff", "embed_fsdp"))}

    def ssd():
        s = cfg.ssm
        d_in, n, H = s.d_inner(d), s.n_groups * s.d_state, s.n_heads(d)
        w_in = (d_in, d_in, n, n, H)
        conv = (d_in, n, n)
        return {
            "w_in": leaf((d, sum(w_in)), ("embed_fsdp", "heads_merged"),
                         ("embed_fsdp", "heads_merged"), ("embed_fsdp", None),
                         ("embed_fsdp", None), ("embed_fsdp", "heads"),
                         segments=w_in),
            "conv_w": leaf((s.conv_width, sum(conv)), (None, "heads_merged"),
                           (None, None), (None, None), segments=conv),
            "conv_b": leaf((sum(conv),), ("heads_merged",), (None,), (None,),
                           segments=conv),
            "A_log": leaf((H,), (None,)), "D": leaf((H,), (None,)),
            "dt_bias": leaf((H,), (None,)), "norm_z": leaf((d_in,), (None,)),
            "out_proj": leaf((d_in, d), ("heads_merged", "embed_fsdp"))}

    def rglru():
        w = cfg.rglru.width(d)
        return {
            "w_in": leaf((d, 2 * w), ("embed_fsdp", "rnn_width"),
                         ("embed_fsdp", "rnn_width"), segments=(w, w)),
            "conv_w": leaf((cfg.rglru.conv_width, w), (None, "rnn_width")),
            "conv_b": leaf((w,), ("rnn_width",)),
            "w_gates": leaf((w, 2 * w), ("rnn_width", None),
                            ("rnn_width", None), segments=(w, w)),
            "b_gates": leaf((2 * w,), ("rnn_width",), ("rnn_width",),
                            segments=(w, w)),
            "lam": leaf((w,), ("rnn_width",)),
            "out": leaf((w, d), ("rnn_width", "embed_fsdp"))}

    layers = []
    for kind in layer_kinds(cfg):
        p = {"norm1": norm()}
        if kind == "ssd":
            p["ssd"] = ssd()
            layers.append(p)
            continue
        if kind == "rglru":
            p["rglru"] = rglru()
        else:
            p.update(attention_layer())
        if kind == "xdec":
            p["norm_x"], p["xattn"] = norm(), cross_attention()
        p["norm2"] = norm()
        p["mlp"] = moe() if cfg.moe is not None else dense_mlp()
        layers.append(p)
    params = {"embed": leaf((v, d), ("vocab", "embed_fsdp")),
              "layers": layers, "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf((d, v), ("embed_fsdp", "vocab"))
    if cfg.encdec is not None:
        params["encoder"] = {
            "layers": [dict(norm1=norm(), **attention_layer(), norm2=norm(),
                            mlp=dense_mlp())
                       for _ in range(cfg.encdec.n_encoder_layers)],
            "final_norm": norm()}
    return params


def cache_template(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16) -> list:
    """The cache ``model.init_cache(cfg, batch, cache_len, dtype)``
    builds, one dict a layer, as :class:`LeafSpec` leaves."""
    hd, kv, d = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.d_model
    ax = ("batch", "cache_seq", "kv_heads", None)
    out = []
    for kind in layer_kinds(cfg):
        if kind in ATTENTION_KINDS:
            C = min(cache_len, cfg.window) if kind == "local" else cache_len
            if cfg.kv_cache_dtype == "int8":
                c = {"k": _leaf((batch, C, kv, hd), torch.int8, ax),
                     "v": _leaf((batch, C, kv, hd), torch.int8, ax),
                     "k_scale": _leaf((batch, C, kv), torch.float32, ax[:3]),
                     "v_scale": _leaf((batch, C, kv), torch.float32, ax[:3])}
            else:
                c = {"k": _leaf((batch, C, kv, hd), dtype, ax),
                     "v": _leaf((batch, C, kv, hd), dtype, ax)}
            if kind == "xdec":
                F = cfg.encdec.n_frames
                xax = ("batch", None, "kv_heads", None)
                c["xk"] = _leaf((batch, F, kv, hd), dtype, xax)
                c["xv"] = _leaf((batch, F, kv, hd), dtype, xax)
        elif kind == "ssd":
            s = cfg.ssm
            d_in, n = s.d_inner(d), s.n_groups * s.d_state
            w = s.conv_width - 1
            c = {"conv": _leaf((batch, w, d_in + 2 * n), dtype,
                               ("batch", None, "heads_merged"),
                               ("batch", None, None), ("batch", None, None),
                               segments=(d_in, n, n)),
                 "state": _leaf((batch, s.n_heads(d), s.head_dim, s.d_state),
                                dtype, ("batch", "heads", None, None))}
        else:
            w = cfg.rglru.width(d)
            c = {"conv": _leaf((batch, cfg.rglru.conv_width - 1, w), dtype,
                               ("batch", None, "rnn_width")),
                 "h": _leaf((batch, w), dtype, ("batch", "rnn_width"))}
        out.append(c)
    return out


def tree_map(fn, tree):
    """``fn`` of every :class:`LeafSpec` of a tree of dicts and lists."""
    if isinstance(tree, LeafSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def empty(template, device="meta") -> Any:
    """Uninitialised tensors of a template (``meta``: shapes only)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), template)
