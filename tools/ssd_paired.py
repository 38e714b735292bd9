#!/usr/bin/env python3
"""Time K4's fp32 training path and K4-bwd on the card, for one tree.

    PYTHONPATH=<tree>/src python3 tools/ssd_paired.py [--label NAME]

``repro_torch`` is imported from the path the caller gives, so that two
trees of the port can be timed in turns on one card, in one command
(parent, change, change, parent).  The shapes are mamba2-1.3b's (H 64,
G 1, hd 64, N 128, chunk 256), inputs as ``chip_smoke.ssd_args`` draws
them: K4-bwd at the training shape (B 2, S 1024) in fp32 and bf16 and
at B 1, S 4096 in fp32 with a final-state gradient; K4's fp32 forward
at the training shape with and without its chunk states and at B 4,
S 128 and 600; the bf16 serve body at B 4, S 128.  Each time is device
time per call by CUDA events, the launch queue filled ahead behind a
sleep kernel (``chip_smoke.time_ms``'s scheme).

Prints one JSON line: the label, each time in ms, and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

H, G, HD, N, CHUNK = 64, 1, 64, 128, 256


def args_of(gen, B, S, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = (r(B, S, H, HD) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(r(B, S, H) - 2.0)
    A = -torch.exp(r(H) * 0.3)
    bc = (r(B, S, 2 * G * N) * 0.3).to(dtype)
    Bm = bc[..., :G * N].view(B, S, G, N)
    Cm = bc[..., G * N:].view(B, S, G, N)
    return (x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2),
            Cm.transpose(1, 2))


def device_ms(fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_paired: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": a.label}
    with torch.no_grad():
        for dtype, B, S, with_dstate, key in (
                (torch.float32, 2, 1024, False, "bwd_f32"),
                (torch.bfloat16, 2, 1024, False, "bwd_bf16"),
                (torch.float32, 1, 4096, True, "bwd_f32_s4096")):
            args = args_of(gen, B, S, dtype)
            dy = torch.randn(B, S, H, HD, generator=gen, device="cuda").to(
                dtype).transpose(1, 2)
            ds = (torch.randn(B, H, HD, N, generator=gen, device="cuda")
                  if with_dstate else None)
            _, _, states = ssd._forward(*args, CHUNK, with_states=True)
            out[key] = device_ms(lambda: ops.ssd_scan_bwd(
                *args, dy, ds, chunk=CHUNK, states=states), iters=20)
            if key == "bwd_f32":
                out["fwd_f32_states"] = device_ms(
                    lambda: ssd._forward(*args, CHUNK, with_states=True))
                out["fwd_f32"] = device_ms(
                    lambda: ssd._forward(*args, CHUNK, with_states=False))
            del args, dy, states
        for S in (128, 600):
            args = args_of(gen, 4, S, torch.float32)
            out[f"fwd_f32_b4_s{S}"] = device_ms(
                lambda: ops.ssd_scan(*args, chunk=CHUNK))
        args = args_of(gen, 4, 128, torch.bfloat16)
        out["fwd_bf16_b4_s128"] = device_ms(
            lambda: ops.ssd_scan(*args, chunk=CHUNK))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
