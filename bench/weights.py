"""Weights made by the benchmark from ``--seed``, handed to the program
and to the plain reference alike.

One variant's parameters are drawn on the device in one call of
``torch.randn`` (and, for Mamba2's A and dt, one of ``torch.rand``) into
a flat buffer of the served type, then scaled leaf by leaf in place.
:func:`make` returns the program's parameter tree, whose leaves are views
of that buffer laid out as ``repro_torch.models.model`` holds them
(``wqkv`` = q | k | v side by side, Mamba2's ``w_in`` = z | x | B | C |
dt, norm gains stored as ``gain − 1``), and the logical leaves by their
published names, views of the same tensors, which the reference reads.
The same seed gives the same bits on the same device.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (logical name, program path, index into the program leaf)
Spec = List[Tuple[str, str, tuple]]


def padded_vocab(v: dict) -> int:
    return -(-v["vocab_size"] // 256) * 256


def variant_seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B1 + 7919 * (index + 1)) % (1 << 63)


def _leaves(family: str, v: dict, init: dict):
    """(path, shape, std or a rule name) of every program leaf, in the
    order they are drawn."""
    d, L, V = v["hidden_size"], v["num_hidden_layers"], padded_vocab(v)
    out = [("embed", (V, d), init["embed_std"])]
    g = init["norm_scale_std"]
    for i in range(L):
        p = f"layers/{i}/"
        if family == "qwen2":
            H, KV, hd, f = (v["num_attention_heads"],
                            v["num_key_value_heads"], v["head_dim"],
                            v["intermediate_size"])
            s = init["linear_std"]
            out += [(p + "norm1", (d,), g),
                    (p + "wqkv", (d, (H + 2 * KV) * hd), s),
                    (p + "bqkv", ((H + 2 * KV) * hd,), init["bias_std"]),
                    (p + "wo", (H * hd, d), s),
                    (p + "norm2", (d,), g),
                    (p + "mlp/wi", (d, f), s),
                    (p + "mlp/wg", (d, f), s),
                    (p + "mlp/wo", (f, d), s)]
        else:
            c = v["ssm"]
            di = c["expand"] * d
            H, n, W = di // c["head_dim"], c["n_groups"] * c["d_state"], \
                c["conv_width"]
            conv_std = 1.0 / math.sqrt(3.0 * W)  # U(±1/√W): fan_in W
            out += [(p + "norm1", (d,), g),
                    (p + "ssd/w_in", (d, 2 * di + 2 * n + H),
                     1.0 / math.sqrt(3.0 * d)),
                    (p + "ssd/conv_w", (W, di + 2 * n), conv_std),
                    (p + "ssd/conv_b", (di + 2 * n,), conv_std),
                    (p + "ssd/A_log", (H,), "A_log"),
                    (p + "ssd/D", (H,), "one"),
                    (p + "ssd/dt_bias", (H,), "dt_bias"),
                    (p + "ssd/norm_z", (di,), g),
                    (p + "ssd/out_proj", (di, d),
                     1.0 / math.sqrt(3.0 * di) / math.sqrt(L))]
    out.append(("final_norm", (d,), g))
    if not v.get("tie_word_embeddings", True):
        out.append(("lm_head", (d, V), init["linear_std"]))
    return out


def _set(tree, path: str, t) -> None:
    keys = path.split("/")
    node = tree
    for k, nxt in zip(keys[:-1], keys[1:]):
        if k == "layers":
            node = node.setdefault("layers", [])
            continue
        if k.isdigit():
            i = int(k)
            while len(node) <= i:
                node.append({})
            node = node[i]
            continue
        node = node.setdefault(k, {})
    node[keys[-1]] = t


def get(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[int(k)] if k.isdigit() else node[k]
    return node


def make(family: str, v: dict, init: dict, seed: int, index: int,
         dtype: torch.dtype, device) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(program tree, logical leaves) of variant ``v`` (a ``variants``
    entry of a configuration file), drawn from ``seed`` and the variant's
    ``index`` in its pool."""
    leaves = _leaves(family, v, init)
    gen = torch.Generator(device=device)
    gen.manual_seed(variant_seed(seed, index))
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    special = [(path, shape, rule) for path, shape, rule in leaves
               if rule in ("A_log", "dt_bias")]
    u = None
    if special:
        u = torch.rand(sum(math.prod(s) for _, s, _ in special),
                       generator=gen, dtype=torch.float32, device=device)
    tree: dict = {}
    off = uoff = 0
    for path, shape, rule in leaves:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if rule == "one":
            t.fill_(1.0)
        elif rule in ("A_log", "dt_bias"):
            x = u[uoff:uoff + n].view(shape)
            uoff += n
            if rule == "A_log":
                a = init["A_min"] + x * (init["A_max"] - init["A_min"])
                t.copy_(torch.log(a))
            else:
                lo, hi = math.log(init["dt_min"]), math.log(init["dt_max"])
                dt = torch.clamp_min(torch.exp(lo + x * (hi - lo)),
                                     init["dt_floor"])
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            t.mul_(rule)
        _set(tree, path, t)
    return tree, logical(family, v, tree)


def spec(family: str, v: dict) -> Spec:
    """Each logical leaf: its name, the program leaf it lies in and where
    in that leaf."""
    d, L, V = v["hidden_size"], v["num_hidden_layers"], v["vocab_size"]
    all_ = slice(None)
    out: Spec = [("embed", "embed", (slice(0, V),))]
    for i in range(L):
        p, q = f"layers.{i}.", f"layers/{i}/"
        out.append((p + "norm1", q + "norm1", ()))
        if family == "qwen2":
            H, KV, hd = (v["num_attention_heads"], v["num_key_value_heads"],
                         v["head_dim"])
            a, b = H * hd, (H + KV) * hd
            c = b + KV * hd
            out += [(p + "wq", q + "wqkv", (all_, slice(0, a))),
                    (p + "wk", q + "wqkv", (all_, slice(a, b))),
                    (p + "wv", q + "wqkv", (all_, slice(b, c))),
                    (p + "bq", q + "bqkv", (slice(0, a),)),
                    (p + "bk", q + "bqkv", (slice(a, b),)),
                    (p + "bv", q + "bqkv", (slice(b, c),)),
                    (p + "wo", q + "wo", ()),
                    (p + "norm2", q + "norm2", ()),
                    (p + "gate", q + "mlp/wi", ()),
                    (p + "up", q + "mlp/wg", ()),
                    (p + "down", q + "mlp/wo", ())]
        else:
            c = v["ssm"]
            di = c["expand"] * d
            H, n = di // c["head_dim"], c["n_groups"] * c["d_state"]
            cuts = {"z": (0, di), "x": (di, 2 * di),
                    "B": (2 * di, 2 * di + n),
                    "C": (2 * di + n, 2 * di + 2 * n),
                    "dt": (2 * di + 2 * n, 2 * di + 2 * n + H)}
            for k, (lo, hi) in cuts.items():
                out.append((p + "in_" + k, q + "ssd/w_in",
                            (all_, slice(lo, hi))))
            for k, (lo, hi) in (("x", (0, di)), ("B", (di, di + n)),
                                ("C", (di + n, di + 2 * n))):
                out.append((p + "conv_" + k, q + "ssd/conv_w",
                            (all_, slice(lo, hi))))
                out.append((p + "convb_" + k, q + "ssd/conv_b",
                            (slice(lo, hi),)))
            out += [(p + k, q + "ssd/" + k, ())
                    for k in ("A_log", "D", "dt_bias", "norm_z",
                              "out_proj")]
    out.append(("final_norm", "final_norm", ()))
    if not v.get("tie_word_embeddings", True):
        out.append(("lm_head", "lm_head", (all_, slice(0, V))))
    return out


def logical(family: str, v: dict, tree) -> Dict[str, torch.Tensor]:
    """The logical leaves of a program tree (views)."""
    return {name: get(tree, path)[idx] for name, path, idx
            in spec(family, v)}


def logical_of_paths(family: str, v: dict,
                     by_path: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The logical leaves of tensors keyed by program path (an optimizer
    state's moments, say)."""
    return {name: by_path[path][idx] for name, path, idx
            in spec(family, v)}
