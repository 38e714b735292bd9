"""Carry the reference's parameters into the port's layout.

The reference keeps layer i of superblock s of the pattern stacked under
``blocks/p{i}`` at index s and the tail layers under ``tail/t{j}``, the
embedding under ``embed/table`` and each norm's scale under
``.../scale``.  :func:`from_jax_params` takes that tree as numpy arrays
(or anything ``np.array`` accepts) and returns the port's per-layer
dictionaries in the order of ``cfg.block_kinds``, with the projections
the port runs as one matmul side by side: ``wq | wk | wv`` (and their
biases) as ``wqkv`` (``bqkv``), and a cross-attention's ``wk | wv`` as
``wkv`` (``bkv``); an SSD layer's ``in_z | in_x | in_B |
in_C | in_dt`` as ``w_in`` and its x, B and C convs as one; an RG-LRU
layer's ``in_x | in_gate`` as ``w_in`` and ``w_inp | w_rec`` (and their
biases) as ``w_gates`` (``b_gates``).  An MLP's leaves, or a MoE layer's
``router``, ``wi``, ``wg`` and ``wo``, and an untied ``lm_head`` are
carried as they are.  An encoder-decoder's ``encoder/blocks`` (stacked
over its layers) and ``encoder/final_norm`` become ``params["encoder"]``,
and each decoder layer's ``norm_x`` and ``xattn`` are carried beside its
self-attention.  Every leaf is copied with
``np.array`` before it becomes a tensor, so no tensor shares memory with
a read-only buffer.

:func:`from_jax_opt_state` carries the reference's optimizer state the
same way, and :func:`leaf_layout` says, for each leaf of the port's
parameters, what the reference's optimizer sees there: whether the
reference stacks it (a superblock's layer, or an encoder layer, gains a
leading layer axis there), and the widths of the reference leaves a
fused leaf holds side by side along its last axis.
"""
from __future__ import annotations

import numpy as np
import torch

from typing import Dict, List, NamedTuple, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Params, check_supported, layer_kinds


def _tensor(x, dtype, device) -> torch.Tensor:
    a = np.array(x)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _ssd(t) -> dict:
    cat = torch.cat
    return {"w_in": cat([t["in_z"], t["in_x"], t["in_B"], t["in_C"],
                         t["in_dt"]], dim=1),
            "conv_w": cat([t["conv_x_w"], t["conv_B_w"], t["conv_C_w"]],
                          dim=1),
            "conv_b": cat([t["conv_x_b"], t["conv_B_b"], t["conv_C_b"]]),
            "A_log": t["A_log"], "D": t["D"], "dt_bias": t["dt_bias"],
            "norm_z": t["norm_z"], "out_proj": t["out_proj"]}


def _rglru(t) -> dict:
    cat = torch.cat
    return {"w_in": cat([t["in_x"], t["in_gate"]], dim=1),
            "conv_w": t["conv_w"], "conv_b": t["conv_b"],
            "w_gates": cat([t["w_inp"], t["w_rec"]], dim=1),
            "b_gates": cat([t["b_inp"], t["b_rec"]]),
            "lam": t["lam"], "out": t["out"]}


def _attention(a, cfg: ModelConfig) -> dict:
    p = {"wo": a["wo"],
         "wqkv": torch.cat([a["wq"], a["wk"], a["wv"]], dim=1)}
    if cfg.qkv_bias:
        p["bqkv"] = torch.cat([a["bq"], a["bk"], a["bv"]])
    return p


def _cross(a, cfg: ModelConfig) -> dict:
    p = {"wq": a["wq"], "wkv": torch.cat([a["wk"], a["wv"]], dim=1),
         "wo": a["wo"]}
    if cfg.qkv_bias:
        p["bq"], p["bkv"] = a["bq"], torch.cat([a["bk"], a["bv"]])
    return p


def from_jax_params(cfg: ModelConfig, params_np, *, dtype=torch.float32,
                    device="cuda") -> Params:
    """Map the reference's parameter tree onto the port's parameters, on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    pat = len(cfg.pattern)

    def tensors(tree, index=None):
        return {k: (tensors(v, index) if isinstance(v, dict)
                    else _tensor(v if index is None else v[index], dtype,
                                 device))
                for k, v in tree.items()}

    layers = []
    for i, kind in enumerate(layer_kinds(cfg)):
        if i < cfg.n_superblocks * pat:
            b = tensors(params_np["blocks"][f"p{i % pat}"], i // pat)
        else:
            b = tensors(params_np["tail"][f"t{i - cfg.n_superblocks * pat}"])
        p = {"norm1": b["norm1"]["scale"]}
        if kind == "ssd":
            p["ssd"] = _ssd(b["ssd"])
            layers.append(p)
            continue
        if kind == "rglru":
            p["rglru"] = _rglru(b["rglru"])
        else:
            p.update(_attention(b["attn"], cfg))
        if kind == "xdec":
            p["norm_x"] = b["norm_x"]["scale"]
            p["xattn"] = _cross(b["xattn"], cfg)
        p["norm2"], p["mlp"] = b["norm2"]["scale"], b["mlp"]
        layers.append(p)
    params = {"embed": _tensor(params_np["embed"]["table"], dtype, device),
              "layers": layers,
              "final_norm": _tensor(params_np["final_norm"]["scale"], dtype,
                                    device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(params_np["lm_head"], dtype, device)
    if cfg.encdec is not None:
        enc = params_np["encoder"]
        params["encoder"] = {
            "layers": [
                dict(norm1=b["norm1"]["scale"], **_attention(b["attn"], cfg),
                     norm2=b["norm2"]["scale"], mlp=b["mlp"])
                for b in (tensors(enc["blocks"], j)
                          for j in range(cfg.encdec.n_encoder_layers))],
            "final_norm": _tensor(enc["final_norm"]["scale"], dtype, device)}
    return params


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) of every leaf of a tree of dicts and lists, in order;
    a path joins dict keys and list indices with ``/``
    (``layers/3/wqkv``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


class LeafLayout(NamedTuple):
    """What the reference's optimizer sees at a leaf of the port."""
    stacked: bool                # the reference holds it with a layer axis
    segments: Tuple[int, ...]    # widths of the fused reference leaves


def _fused_segments(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Segment widths of the fused leaves, by their path inside a layer."""
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    seg = {"wqkv": (H * hd, KV * hd, KV * hd),
           "xattn/wkv": (KV * hd, KV * hd)}
    seg["bqkv"], seg["xattn/bkv"] = seg["wqkv"], seg["xattn/wkv"]
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in, n = s.d_inner(cfg.d_model), s.n_groups * s.d_state
        seg["ssd/w_in"] = (d_in, d_in, n, n, s.n_heads(cfg.d_model))
        seg["ssd/conv_w"] = seg["ssd/conv_b"] = (d_in, n, n)
    if cfg.rglru is not None:
        w = cfg.rglru.width(cfg.d_model)
        for key in ("w_in", "w_gates", "b_gates"):
            seg[f"rglru/{key}"] = (w, w)
    return seg


def leaf_layout(cfg: ModelConfig, params) -> Dict[str, LeafLayout]:
    """Each leaf path of ``params`` (the port's parameters of ``cfg``)
    → its :class:`LeafLayout`.  The reference stacks the layers of its
    superblocks (layer ``i < n_superblocks · len(pattern)``) and every
    encoder layer; the tail, the embedding, the head and the final norms
    are unstacked.  An unfused leaf is one segment of its last axis."""
    fused = _fused_segments(cfg)
    n_stacked = cfg.n_superblocks * len(cfg.pattern)
    out = {}
    for path, leaf in named_leaves(params):
        parts = path.split("/")
        if parts[0] == "layers":
            stacked, inner = int(parts[1]) < n_stacked, "/".join(parts[2:])
        elif parts[:2] == ["encoder", "layers"]:
            stacked, inner = True, "/".join(parts[3:])
        else:
            stacked, inner = False, path
        last = leaf.shape[-1] if leaf.dim() else 1
        segs = fused.get(inner, (last,))
        if sum(segs) != last:
            raise ValueError(f"{path}: segments {segs} do not cover its "
                             f"last axis of {last}")
        out[path] = LeafLayout(stacked, segs)
    return out


def _split_q8(tree, field):
    """The reference's moment tree with each int8 leaf (a dict of ``q``,
    ``scale`` [and ``lo``]) replaced by its ``field``."""
    if isinstance(tree, dict):
        if "q" in tree and set(tree) <= {"q", "scale", "lo"}:
            return tree[field]
        return {k: _split_q8(v, field) for k, v in tree.items()}
    return tree


def from_jax_opt_state(cfg: ModelConfig, opt_np, *, device="cuda"):
    """Map the reference's ``OptState`` (``step``, ``mu``, ``nu`` as
    numpy trees, fp32 or int8 moments) onto the port's
    (``training.optimizer.OptState``), on ``device``.  An int8 moment's
    ``q`` is carried like its parameter, its per-row ``scale`` (and
    ``lo``) fused side by side in the order of the fused leaves: one
    scale per segment, the port's layout."""
    from repro_torch.training.optimizer import OptState
    dev = resolve_device(device)

    def moments(tree, fields):
        if not fields:
            return dict(named_leaves(from_jax_params(
                cfg, tree, dtype=torch.float32, device=dev)))
        parts = {f: dict(named_leaves(from_jax_params(
            cfg, _split_q8(tree, f),
            dtype=torch.int8 if f == "q" else torch.float32, device=dev)))
            for f in fields}
        return {path: {f: parts[f][path] for f in fields}
                for path in parts["q"]}

    int8 = isinstance(opt_np.mu["final_norm"]["scale"], dict)
    step = torch.tensor(int(np.asarray(opt_np.step)), dtype=torch.int32,
                        device=dev)
    return OptState(step, moments(opt_np.mu, ("q", "scale") if int8 else ()),
                    moments(opt_np.nu,
                            ("q", "scale", "lo") if int8 else ()))
