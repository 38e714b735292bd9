"""Readings that set a cell's limits, on the card, at the cell's size.

    python3 bench/control.py --workload qwen2-pool.train \\
        --seeds 11,12,13 [--seconds 10] [--control-seeds 3] \\
        [--faults frozen_in_window,half_batch] [--out readings.json]

For each seed, in one process: the program's readings as a run takes
them (the numbers that decide ``correct``), and the control's, the
plain reference put in the program's place one precision below the
configuration's: fp8 (e4m3, one scale a tensor) products for a bf16
serve cell, read at the positions and tokens the program served; TF32
matmuls for an fp32 training cell; the control is read on the first
``--control-seeds`` seeds.  ``--faults`` names faults planted in a
training cell's program (``FAULTS``), each read on the first
``--control-seeds`` seeds too.  Prints one JSON line per seed and the
record; the benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import run as runmod  # noqa: E402
from bench import serve, train  # noqa: E402

NO_LIMITS = {"widest_gap": float("inf"), "loss_gap": float("inf"),
             "window_loss_gap": float("inf"), "grad_gap": float("inf"),
             "change_gap": float("inf")}


@contextlib.contextmanager
def half_batch():
    """The program's loop feeds the step the first half of each batch."""
    from repro_torch.training import loop as L
    orig = L.to_device

    def to_device(batch, device):
        return orig({k: x[:x.shape[0] // 2] for k, x in batch.items()},
                    device)
    L.to_device = to_device
    try:
        yield
    finally:
        L.to_device = orig


@contextlib.contextmanager
def frozen_state(after: int = 0):
    """The program's step returns its parameters and moments unchanged,
    from its ``after``-th step on."""
    from repro_torch.training import train_step as T
    orig = T.adamw_update
    calls = [0]

    def adamw_update(cfg, params, grads, state, layout=None):
        calls[0] += 1
        if calls[0] <= after:
            return orig(cfg, params, grads, state, layout)
        return params, state._replace(step=state.step + 1), {}
    T.adamw_update = adamw_update
    try:
        yield
    finally:
        T.adamw_update = orig


def frozen_in_window():
    """The steps of the window leave the state unchanged; the warm steps
    update it."""
    return frozen_state(after=train.WARM_STEPS)


FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state,
          "frozen_in_window": frozen_in_window}


def serve_readings(cell, cfg, traffic, seed, seconds, device="cuda"):
    c = serve.Cell(cfg, traffic, seed, device)
    ctx = c.window(seconds, sample=serve.checked(traffic, seed, seconds))
    c.free()
    tokens = ctx["tokens"]
    variant_of = {i: ctx["requests"][i]["variant"] for i in tokens}
    prog = serve.gaps_of(cfg, ctx["prompts"], tokens, variant_of, seed,
                         device)
    ctl = serve.control_gaps(cfg, ctx["prompts"], tokens, variant_of, seed,
                             device)
    by_var = {}
    for i, toks in tokens.items():
        by_var[variant_of[i]] = by_var.get(variant_of[i], 0) + len(toks)
    return {"program": {"widest_gap": max(prog)},
            "control": {"widest_gap": max(ctl)},
            "tokens": len(prog), "by_variant": by_var,
            "program_gaps_sorted_top": sorted(prog)[-5:],
            "control_gaps_sorted_bottom": sorted(ctl)[:5]}


def train_readings(cell, cfg, traffic, seed, seconds, faults=(),
                   control=True, device="cuda"):
    out = {}
    ctx = train.run(cell, cfg, traffic, NO_LIMITS, seed, seconds, False,
                    device, time.time())
    out["program"] = {k: c["value"] for k, c in ctx["checks"].items()}
    out["excluded"] = ctx["excluded_leaves"]
    if control:
        v = next(x for x in cfg["variants"]
                 if x["name"] == cfg["train_variant"])
        ctl = train.reference(cfg["family"], v, cfg, traffic, seed, device,
                              exact=False)
        out["control"] = train.readings(ctl["losses"], ctl["first_grad"],
                                        ctl["change"], ctx["reference"])
    for name in faults:
        ctx = train.run(cell, cfg, traffic, NO_LIMITS, seed, seconds,
                        False, device, time.time(), fault=FAULTS[name])
        out[name] = {k: c["value"] for k, c in ctx["checks"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    runmod.prepare_env()
    _, cell, cfg, traffic, _ = runmod.load_cell(args.workload)
    rows = []
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        first = i < args.control_seeds
        if traffic["kind"] == "serve":
            row = serve_readings(cell, cfg, traffic, seed, args.seconds)
        else:
            row = train_readings(cell, cfg, traffic, seed, args.seconds,
                                 faults if first else (), first)
        row.update(seed=seed, seconds_taken=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps(row), flush=True)
    rec = dict(workload=args.workload, card=runmod.power_limit(), rows=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
