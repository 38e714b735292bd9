"""The plain references agree with the port's plain path at a small size
on the CPU: prefill and decode through the cache against the full
forward, and a training step's loss, gradients and AdamW update."""
import time

import numpy as np
import pytest
import torch

from bench import reference, serve, system, train, weights
from bench.tests import tiny


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
@pytest.mark.parametrize("index", [0, 2])
def test_reference_matches_prefill_and_decode(family, index):
    from repro_torch.models import model as M
    cfg = tiny.config(family)
    v = cfg["variants"][index]
    tree, W = weights.make(family, v, cfg["init"], 7, index, torch.float32,
                           "cpu")
    mcfg = system.model_config(family, v)
    S, steps = 40, 2
    toks = torch.tensor(np.random.default_rng(0).integers(0, v["vocab_size"],
                                                          (2, S)))
    with torch.no_grad():
        cache, lg = M.prefill(mcfg, tree, {"tokens": toks}, S + steps)
        got = [lg[:, :v["vocab_size"]]]
        nxt, pos = lg.argmax(-1), torch.full((2,), S, dtype=torch.int32)
        seq = [nxt]
        for _ in range(steps):
            lg, cache = M.decode_step(mcfg, tree, cache, nxt, pos)
            got.append(lg[:, :v["vocab_size"]])
            nxt, pos = lg.argmax(-1), pos + 1
            seq.append(nxt)
    full = torch.cat([toks, torch.stack(seq[:-1], 1)], dim=1)
    want = reference.load(family).logits(v, W, full, steps + 1)
    got = torch.stack(got, 1)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-4 * float(scale)


@pytest.mark.parametrize("family", ["qwen2", "mamba2"])
def test_reference_training_matches_the_programs_step(family):
    cfg = tiny.config(family)
    cfg["train_variant"] = cfg["variants"][1]["name"]
    tr = tiny.train_traffic()
    limits = {"loss_gap": 1e-5, "window_loss_gap": 1e-5, "grad_gap": 1e-4,
              "change_gap": 1e-4}
    ctx = train.run({"name": "t"}, cfg, tr, limits, 3, 0.2, False, "cpu",
                    time.time())
    assert ctx["correct"], ctx["checks"]
    assert ctx["steps"] >= train.WINDOW_CHECKED


def test_serve_gaps_are_zero_for_the_references_own_tokens():
    cfg = tiny.config("qwen2")
    v = cfg["variants"][0]
    _, W = weights.make("qwen2", v, cfg["init"], 9, 0, torch.bfloat16, "cpu")
    toks = serve.prompts(v["vocab_size"], 2, 24, 9)
    lg = reference.load("qwen2").logits(v, W, torch.tensor(toks), 1)
    tokens = {0: [int(lg[0, 0].argmax())], 1: [int(lg[1, 0].argmax())]}
    gaps = serve.gaps_of(cfg, toks, tokens, {0: v["name"], 1: v["name"]}, 9,
                         "cpu")
    assert gaps == [0.0, 0.0]
