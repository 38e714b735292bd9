"""Training launcher, on the card unless asked otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --ckpt-dir /tmp/ckpt [--device cuda]

``--device cpu`` runs the plain PyTorch path on the CPU; the default
``cuda`` raises without a card.  Parameters are fp32, as in the
reference's launcher.  On the card the attention and RG-LRU layers run
their kernels forward and backward; an SSD (mamba2) layer's kernel has
no backward yet, so mamba2 trains only on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.training.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(5, args.steps // 10),
                       grad_accum=args.grad_accum, seed=args.seed)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    loop = TrainLoop(cfg, tcfg, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, dtype=torch.float32,
                     device=args.device)

    def on_step(step, m):
        if step % 10 == 0:
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} {m['step_time_s']*1e3:.0f}ms")

    final = loop.run(stream, args.steps, on_step=on_step)
    print("final:", {k: round(float(v), 4) for k, v in final.items()})


if __name__ == "__main__":
    main()
