"""Small configurations and traffic for the CPU tests: the benchmark's
files with their widths and lengths cut down, run on the port's plain
path."""
import copy
import json
from pathlib import Path

from bench import families

BENCH = Path(__file__).resolve().parent.parent


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def config(family: str) -> dict:
    """``configs/<family>-pool.json`` cut to the CPU tests' size: two
    layers, widths of 64 to 192, a vocabulary of 300, and the family's
    own cut (``tiny`` of ``bench/families/<family>.py``)."""
    c = load("configs", f"{family}-pool")
    cut = families.load(family).tiny
    c["init"]["embed_std"] = 1.0   # logits that spread at this width
    for i, v in enumerate(c["variants"]):
        v["num_hidden_layers"] = 2
        v["hidden_size"] = 64 * (i + 1)
        v["vocab_size"] = 300
        cut(v, i)
    return c


def serve_traffic(name: str = "mobile-2k") -> dict:
    t = load("traffic", name)
    t.update(prompt_tokens=40, rate_per_s=20, t_sla_ms=300.0)
    return t


def train_traffic(name: str = "train-b2s1024") -> dict:
    t = copy.deepcopy(load("traffic", name))
    t.update(batch=2, seq_len=24)
    return t
