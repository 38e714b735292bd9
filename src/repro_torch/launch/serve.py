"""Serving launcher: a live model pool behind a selection policy, in
PyTorch on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --policy modipick --requests 100 --sla-ms 120 [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import (DynamicGreedy, ModiPick, PureRandom,
                                     RelatedAccurate, RelatedRandom,
                                     StaticGreedy)
from repro_torch.serving.executor import PoolExecutor
from repro_torch.serving.pool import scaled_family


def make_policy(name: str, sla: float, threshold: float, gamma: float):
    return {
        "modipick": lambda: ModiPick(threshold, gamma=gamma),
        "static_greedy": lambda: StaticGreedy(sla),
        "dynamic_greedy": lambda: DynamicGreedy(),
        "pure_random": lambda: PureRandom(),
        "related_random": lambda: RelatedRandom(threshold),
        "related_accurate": lambda: RelatedAccurate(threshold),
    }[name]()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS)
    ap.add_argument("--policy", default="modipick")
    ap.add_argument("--widths", default="0.5,1.0,2.0")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--sla-ms", type=float, default=120.0)
    ap.add_argument("--threshold-ms", type=float, default=25.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--net-mean-ms", type=float, default=20.0)
    ap.add_argument("--net-cv", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hedging", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the pool (default cuda; 'cpu' "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    variants = scaled_family(
        get_config(args.arch),
        widths=tuple(float(w) for w in args.widths.split(",")),
        cache_len=args.seq + 16, device=args.device)
    tokens = np.random.default_rng(0).integers(
        0, 500, (args.batch, args.seq), dtype=np.int32)
    net = NetworkModel.from_cv(args.net_mean_ms, args.net_cv)
    policy = make_policy(args.policy, args.sla_ms, args.threshold_ms, args.gamma)
    ex = PoolExecutor(variants, net, policy, hedging=args.hedging)
    ex.warm_up(tokens)
    for i in range(args.requests):
        r = ex.execute(tokens, t_sla=args.sla_ms)
        if i % 20 == 0:
            print(f"req {i:4d} -> {r.variant:24s} infer={r.t_infer_ms:6.1f}ms "
                  f"e2e={r.t_e2e_ms:6.1f}ms met={r.met_sla}")
    print(json.dumps(ex.summary(), indent=1))


if __name__ == "__main__":
    main()
