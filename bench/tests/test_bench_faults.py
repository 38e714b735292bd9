"""A run with the timed path broken underneath comes out not correct
under each cell's limits: a served token altered where it is produced;
a training step that returns its state unchanged; a step that leaves
out half of the batch.  The sound run comes out correct.  These drive
the rest of a run on the CPU at a small size (the harness's look for a
card is skipped)."""
import json
import time
from pathlib import Path

import pytest
import torch

from bench import control, serve, train
from bench.tests import tiny

CELLS = Path(__file__).resolve().parents[1] / "cells"


def limits(cell):
    return json.loads((CELLS / f"{cell}.json").read_text())["limits"]


def altered_token(cap):
    """The decode step serves the token its logits put last."""
    decode = cap.orig[1]

    def bad(*a, **k):
        logits, cache = decode(*a, **k)
        logits = logits.clone()
        rows = torch.arange(logits.shape[0])
        worst = logits[:, :300].argmin(-1)
        logits[rows, worst] = logits.max() + 1.0
        return logits, cache
    cap.orig = (cap.orig[0], bad)


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
@pytest.mark.parametrize("fault", [None, altered_token])
def test_serve_fault_is_not_correct(family, fault):
    cell = "qwen2-pool.serve"
    ctx = serve.run({"name": cell}, tiny.config(family), tiny.serve_traffic(),
                    limits(cell), 17, 0.5, False, "cpu", time.time(),
                    fault=fault)
    assert ctx["correct"] is (fault is None), ctx["checks"]


@pytest.mark.parametrize("family,cell,traffic", [
    ("qwen2", "qwen2-pool.train", "train-b4s1024"),
    ("mamba2", "mamba2-pool.train", "train-b2s1024")])
@pytest.mark.parametrize("fault", [None, control.frozen_state,
                                   control.frozen_in_window,
                                   control.half_batch])
def test_train_fault_is_not_correct(family, cell, traffic, fault):
    cfg = tiny.config(family)
    cfg["train_variant"] = cfg["variants"][0]["name"]
    ctx = train.run({"name": cell}, cfg, tiny.train_traffic(traffic),
                    limits(cell), 19, 0.2, False, "cpu", time.time(),
                    fault=fault)
    assert ctx["correct"] is (fault is None), ctx["checks"]
