"""What every reference shares: fp32 matmuls with TF32 off, the RMSNorm,
the fp8 product that the control puts in the program's place, and the
parts of the weights' layout that lie outside the layers (the embedding,
the final norm and the untied head)."""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

import torch

FP8_MAX = 448.0  # float8_e4m3fn

# (logical name, program path, index into the program leaf)
Spec = List[Tuple[str, str, tuple]]


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32 inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextlib.contextmanager
def tf32():
    """fp32 matmuls and convolutions in TF32 inside the block: the
    control of an fp32 configuration."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def mm(a, w):
    """The fp32 product a @ w."""
    return a.float() @ w.float()


def _fp8(t):
    """t rounded to float8_e4m3fn under one scale for the tensor (its
    largest magnitude to the format's largest), back in fp32."""
    t = t.float()
    s = torch.clamp_min(t.abs().amax(), 1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def mm_fp8(a, w):
    """The control's product: both operands in fp8 with one scale each,
    accumulated in fp32, as an fp8 serving path would compute it."""
    return _fp8(a) @ _fp8(w)


def rms(x, scale, eps):
    """RMSNorm with gain 1 + scale (the weights' stored form), fp32."""
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def padded_vocab(v: dict) -> int:
    """The program's embedding rows: the vocabulary padded to 256."""
    return -(-v["vocab_size"] // 256) * 256


def model_leaves(v: dict, init: dict, layer_leaves: Callable) -> list:
    """(path, shape, std or a rule name) of every program leaf, in the
    order they are drawn: the embedding, ``layer_leaves(v, init, i)`` of
    each layer, the final norm and an untied head."""
    d, V = v["hidden_size"], padded_vocab(v)
    out = [("embed", (V, d), init["embed_std"])]
    for i in range(v["num_hidden_layers"]):
        out += layer_leaves(v, init, i)
    out.append(("final_norm", (d,), init["norm_scale_std"]))
    if not v.get("tie_word_embeddings", True):
        out.append(("lm_head", (d, V), init["linear_std"]))
    return out


def model_spec(v: dict, layer_spec: Callable) -> Spec:
    """Each logical leaf: its name, the program leaf it lies in and where
    in that leaf; ``layer_spec(v, i)`` gives layer i's."""
    V = v["vocab_size"]
    out: Spec = [("embed", "embed", (slice(0, V),))]
    for i in range(v["num_hidden_layers"]):
        out += layer_spec(v, i)
    out.append(("final_norm", "final_norm", ()))
    if not v.get("tie_word_embeddings", True):
        out.append(("lm_head", "lm_head", (slice(None), slice(0, V))))
    return out
