#!/usr/bin/env python3
"""How far a full-width model's first-step gradients on the kernel path
lie from the plain path's, against how far the kernel path's own
gradients move when the embedding moves by one ulp, over depth.

    python3 tools/train_grad_depth.py [--arch mamba2-1.3b] [--depths 1 4 48]

For each depth: a copy of the published config cut to that many layers
at full width, fp32 parameters from seed 23, one batch of B x S tokens
(``TokenStream``, seed 23), remat "full"; ``loss_and_grads`` on the
kernel path and on the plain path (``ops.PLAIN``), and on the kernel
path again with every embedding entry scaled by 1 ± 2^-23 (signs at
random).  Each gradient's difference is taken relative to its leaf's
max |value|.  Where the two columns agree the gradient is as far apart
as its rounding-level sensitivity allows, and no tolerance below that
can hold at that depth.  Prints one line a depth; needs one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[1, 2, 4, 12, 24, 48])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_grad_depth: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.training.train_step import loss_and_grads

    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda")
    for depth in args.depths:
        t0 = time.perf_counter()
        c = replace(cfg, n_layers=depth)
        gen.manual_seed(23)
        params = M.init_params(c, gen, torch.float32)
        batch = to_device(TokenStream(c.vocab_size, args.batch, args.seq,
                                      seed=23).batch_at(0), "cuda")
        runs = {}
        for name, impl in (("kernel", ops.KERNELS), ("plain", ops.PLAIN)):
            runs[name] = loss_and_grads(
                api.make_forward_loss(c, remat=True, impl=impl), params,
                batch)
        sign = torch.where(torch.rand(params["embed"].shape, generator=gen,
                                      device="cuda") < 0.5, -1.0, 1.0)
        moved = dict(params, embed=params["embed"] * (1 + sign * 2.0 ** -23))
        runs["moved"] = loss_and_grads(api.make_forward_loss(c, remat=True),
                                       moved, batch)
        (lk, _, gk), (lp, _, gp), (lm, _, gm) = (runs[k] for k in (
            "kernel", "plain", "moved"))
        plain = sorted((rel(g, gp[p]), p) for p, g in gk.items())
        move = sorted((rel(gm[p], g), p) for p, g in gk.items())
        d_loss = abs(float(lk) - float(lp)) / abs(float(lp))
        print(f"[grad depth] {args.arch} layers={depth} B={args.batch} "
              f"S={args.seq}: kernel vs plain: loss {d_loss:.3g}, "
              f"embed {rel(gk['embed'], gp['embed']):.3g}, median leaf "
              f"{plain[len(plain) // 2][0]:.3g}, worst {plain[-1][0]:.3g} "
              f"({plain[-1][1]}); kernel path, embedding moved one ulp: "
              f"loss {abs(float(lm) - float(lk)) / abs(float(lk)):.3g}, "
              f"embed {rel(gm['embed'], gk['embed']):.3g}, median leaf "
              f"{move[len(move) // 2][0]:.3g}, worst {move[-1][0]:.3g} "
              f"({move[-1][1]}) [{time.perf_counter() - t0:.1f}s]",
              flush=True)
        del params, moved, runs, gk, gp, gm
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
