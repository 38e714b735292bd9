"""The end-to-end metrics are taken over every request due in the
window, e2e counts the uplink twice and the wait from the due time, and
every name of BENCHMARK.json keeps to the contract's characters."""
import json
import math
import re
from pathlib import Path

import pytest

from bench import run as runmod
from bench import yardstick

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def req(due, start, end, t_input, quality=0.5, failed=False):
    e2e = math.inf if failed else 2 * t_input + (end - due) * 1e3
    return dict(due=due, start=start, end=end, t_input=t_input,
                quality=0.0 if failed else quality, failed=failed, e2e=e2e,
                variant="" if failed else "v")


def ctx(reqs, t_sla=200.0):
    return dict(requests=reqs, traffic={"t_sla_ms": t_sla})


def test_e2e_counts_the_round_trip_and_the_wait():
    from bench import serve
    assert serve.__doc__ and "2·T_input" in serve.__doc__
    r = req(1.0, 1.05, 1.10, 40.0)
    assert r["e2e"] == pytest.approx(80.0 + 100.0)


def test_serve_metrics_over_all_requests_failed_ones_missing():
    reqs = [req(0.0, 0.0, 0.05, 40.0, 0.7),      # 130 ms: met
            req(0.1, 0.2, 0.25, 40.0, 0.5),      # 80 + 150: missed
            req(0.3, 0.3, 0.3, 40.0, failed=True)]
    c = ctx(reqs)
    assert runmod.reader("attainment")(c) == pytest.approx(1 / 3)
    assert runmod.reader("accuracy")(c) == pytest.approx((0.7 + 0.5) / 3)
    assert runmod.reader("e2e_p95_ms")(c) == math.inf
    assert runmod.reader("queue_wait_ms.serve")(c) == \
        pytest.approx(1e3 * 0.1 / 3)


def test_a_family_name_falls_back_to_its_quantity_s_reader():
    metrics = ROOT / "bench" / "metrics"
    assert runmod.reader_path("mfu.train.dense") == metrics / "mfu.train.py"
    assert runmod.reader_path("mfu.train") == metrics / "mfu.train.py"
    # one dotted part only: an unknown quantity finds no reader
    assert not runmod.reader_path("mfu.x.dense").exists()
    c = dict(steps=4, window_s=2.0, tokens=8192)
    assert runmod.reader("train_tokens_per_s.ssm")(c) == 4096.0


def test_p95_is_nearest_rank():
    xs = list(range(1, 101))
    assert yardstick.p95(xs) == 95
    assert yardstick.p95([3.0]) == 3.0


def test_readers_find_nothing_and_return_none():
    for m in bench()["per_layer"] + bench()["end_to_end"]:
        assert runmod.reader(m["name"])({}) is None, m["name"]


def test_names_units_and_files_keep_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["traffic"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) \
        == len(b["end_to_end"]) + len(b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert runmod.reader_path(m["name"]).exists(), m["name"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "cells" / f"{w['name']}.json").exists()
    for c in b["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert len(c["source"]) <= 200
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        def has(ms):
            return [m["name"] for m in ms
                    if w["name"] in m.get("workloads", [w["name"]])]
        e2e = has(b["end_to_end"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert has(b["per_layer"])
