"""What both references share: fp32 matmuls with TF32 off, the RMSNorm,
and the fp8 product that the control puts in the program's place."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # float8_e4m3fn


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
