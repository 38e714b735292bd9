"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the entry of ``workloads`` in ``BENCHMARK.json`` named by
``--workload``; everything it needs is found by name: its configuration
(the ``file`` of its entry in ``configs``), its traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` picks the runner,
``bench/serve.py`` or ``bench/train.py``), its limits
(``bench/cells/<workload>.json``) and each metric's reader
(``bench/metrics/<metric>.py``, see ``reader_path``).  With ``--trace
0`` the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the trace's breakdown.  The last line of standard output is one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error.

A configuration of a new family enters by new files alone, each found
by a name: the configuration, ``bench/configs/<name>.json``, whose
``"family"`` names the family; its plain reference,
``bench/reference/<family>.py`` (the weights' layout, the layer kinds
and the fp32 forward, see ``bench/reference/__init__.py``); its program
side, ``bench/families/<family>.py`` (the port's ``ModelConfig``, the
model FLOPs and the tests' cut, see ``bench/families/__init__.py``); a
traffic mix where the cell needs a new one; the limits of each cell,
``bench/cells/<workload>.json``; and the entries of ``configs`` and
``workloads`` in ``BENCHMARK.json``.  A ``model_config`` change adds
all of these and edits no file that is here.  A family of a layer kind
the harness has (``"attn"``, ``"ssd"``) takes that kind's leaves and
forward from the family that has it.

Refuses to run without the CUDA cards the cell asks for, and refuses to
print a result if JAX or the JAX package was loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str):
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic
    mix, its limits), each found by name; the entry is None for an
    unknown workload."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        return bench, None, None, None, None
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(ROOT / entry["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "cells" / f"{workload}.json")["limits"])


def reader_path(name: str) -> Path:
    """``bench/metrics/<name>.py``, or, where there is no such file, the
    reader of the name without its last dotted part: one reader serves a
    quantity that each family reports under a name and bound of its own
    (``mfu.train.dense`` is read by ``mfu.train.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def reader(name: str):
    """The ``read`` function of the metric's reader (``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metrics_for(bench: dict, workload: str, trace: bool):
    """(name, unit) of the metrics the cell reports in this kind of run."""
    key = "per_layer" if trace else "end_to_end"
    return [(m["name"], m["unit"]) for m in bench[key]
            if workload in m.get("workloads", [workload])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # the reading is informative only
        return f"unknown ({e!r})"


def prepare_env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    bench, cell, cfg, traffic, limits = load_cell(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    runner = importlib.import_module(f"bench.{traffic['kind']}")
    runner.note(f"imports and CUDA start {time.time() - T_START:.3f} s")
    ctx = runner.run(cell, cfg, traffic, limits, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START)
    metrics = {}
    for name, unit in metrics_for(bench, cell["name"], bool(args.trace)):
        value = reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    result = {"correct": bool(ctx["correct"]),
              "attempted": int(ctx["attempted"]),
              "failed": int(ctx["failed"]), "metrics": metrics,
              "device": device}
    tr = ctx.get("trace")
    if args.trace and tr is not None:
        device["busy_s"] = float(tr.busy_s)
        device["window_s"] = float(tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    print(f"card: {power_limit()}", file=sys.stderr)
    if ctx.get("excluded_leaves"):
        print("leaves left out of the change: "
              + ", ".join(ctx["excluded_leaves"]), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print("refused: loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    result["checks"] = ctx["checks"]
    for name, c in ctx["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
