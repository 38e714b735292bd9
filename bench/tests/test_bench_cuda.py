"""On the card, at each cell's own size: the program's readings are
within the cell's limits and the control's are not (the reference one
precision below the configuration's, in the program's place).  Run with

    python -m pytest -m cuda bench/tests/test_bench_cuda.py

(about five minutes on one H100); on the CPU these skip.  ``bench/
control.py`` takes the same readings over more seeds."""
import json
from pathlib import Path

import pytest
import torch

from bench import control

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


def cell(name):
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(x for x in b["workloads"] if x["name"] == name)
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((ROOT / "bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    limits = json.loads((ROOT / "bench" / "cells"
                         / f"{name}.json").read_text())["limits"]
    return w, cfg, traffic, limits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_serve_control_fails_where_the_program_passes(card):
    w, cfg, traffic, limits = cell("qwen2-pool.serve")
    row = control.serve_readings(w, cfg, traffic, 901, 20.0)
    assert row["program"]["widest_gap"] <= limits["widest_gap"], row
    assert row["control"]["widest_gap"] > limits["widest_gap"], row


@pytest.mark.parametrize("name", ["qwen2-pool.train", "mamba2-pool.train"])
def test_train_control_fails_where_the_program_passes(card, name):
    w, cfg, traffic, limits = cell(name)
    row = control.train_readings(w, cfg, traffic, 902, 2.0)
    assert all(row["program"][k] <= limits[k] for k in limits), row
    assert any(row["control"][k] > limits[k] for k in limits), row
