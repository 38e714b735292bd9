"""The port's spans (``repro_torch.obs``) on the CPU, at the reduced
configs: the span tree of one request and of one training step, in
memory and in a running ``torch.profiler``; nothing recorded, allocated
or read off; the same picks, draws, logits and losses on and off; and
the executor's e2e with an open loop's wait."""
import stat
import sys
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.policy import ModiPick
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels import build
from repro_torch.models import model as M
from repro_torch.models.convert import named_leaves
from repro_torch.serving.executor import PoolExecutor
from repro_torch.serving.pool import Variant, scaled_family
from repro_torch.training.loop import TrainLoop

T_SLA = 1000.0     # wide: ModiPick runs all three stages, no fallback
N_DECODE = 3


@pytest.fixture(autouse=True)
def spans_left_off():
    yield
    obs.disable()


def executor(seed=3):
    pool = scaled_family(get_config("qwen2-1.5b"), widths=(0.25, 0.5, 1.0),
                         cache_len=24, device="cpu")
    ex = PoolExecutor(pool, NetworkModel(15.0, 7.0), ModiPick(20.0),
                      seed=seed, warmup_requests=2)
    tokens = np.random.default_rng(0).integers(0, 500, (1, 12),
                                               dtype=np.int32)
    ex.warm_up(tokens, N_DECODE)
    return ex, tokens


def train_loop():
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=1e-3)
    return TrainLoop(cfg, tcfg, device="cpu"), \
        TokenStream(cfg.vocab_size, 2, 16, seed=7)


def profiled_spans(prof):
    """(name, start ns, end ns) of the profiler's host events that are
    program spans, in start order."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name() in obs.SPANS]
    return sorted(evs, key=lambda x: (x[1], -x[2]))


def profiler_tree(evs):
    """Each event's innermost enclosing event, by time: [(name, parent
    name or None)] in start order."""
    out = []
    for i, (n, s, e) in enumerate(evs):
        holders = [x for j, x in enumerate(evs)
                   if j != i and x[1] <= s and e <= x[2]]
        parent = min(holders, key=lambda x: x[2] - x[1]) if holders else None
        out.append((n, parent[0] if parent else None))
    return out


def memory_tree(recs):
    return [(r.name, recs[r.parent].name if r.parent is not None else None)
            for r in recs]


REQUEST_TREE = (
    [("executor.request", None), ("router.route", "executor.request"),
     ("policy.select", "router.route"), ("policy.base", "policy.select"),
     ("policy.window", "policy.select"), ("policy.draw", "policy.select"),
     ("variant.run", "executor.request"), ("variant.upload", "variant.run"),
     ("model.prefill", "variant.run")]
    + [("model.decode", "variant.run")] * N_DECODE
    + [("variant.sync", "variant.run"),
       ("profiles.observe", "executor.request")])
STEP_TREE = [("train.step", None), ("train.batch", "train.step"),
             ("train.sync", "train.step"), ("train.grads", "train.step"),
             ("train.optimizer", "train.step"), ("train.sync", "train.step")]


def test_one_request_gives_the_span_tree_in_memory_and_in_the_profiler():
    ex, tokens = executor()
    rid = len(ex.results)
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):      # the first call pays the profiler's start
            ex.execute(tokens, T_SLA, N_DECODE)
    obs.disable()
    recs = obs.records()
    assert memory_tree(recs) == REQUEST_TREE * 2
    assert [r.root for r in recs] == [rid] * len(REQUEST_TREE) \
        + [rid + 1] * len(REQUEST_TREE)
    evs = profiled_spans(prof)
    assert profiler_tree(evs) == REQUEST_TREE * 2
    assert {r.name for r in recs} <= set(obs.SPANS)
    for r, (name, s, e) in list(zip(recs, evs))[len(REQUEST_TREE):]:
        assert r.name == name
        assert abs(r.start_ns - s) < 500_000, (name, r.start_ns - s)
        assert r.start_ns <= r.end_ns
    assert all(r.device_ms() is None for r in recs)   # no card here


def test_one_training_step_gives_the_span_tree():
    loop, stream = train_loop()
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(stream, 2)
    obs.disable()
    recs = obs.records()
    assert memory_tree(recs) == STEP_TREE * 2
    assert [r.root for r in recs] == [0] * 6 + [1] * 6
    assert profiler_tree(profiled_spans(prof)) == STEP_TREE * 2
    step = recs[0]
    assert step.wall_ms >= loop.history[0]["step_time_s"] * 1e3


def test_a_name_outside_spans_is_refused_when_on():
    assert obs.span("no.such.span") is obs.span("router.route")   # off
    obs.enable()
    with pytest.raises(ValueError, match="no.such.span"):
        obs.span("no.such.span")


def test_off_records_nothing_allocates_nothing_and_reads_no_clock(
        monkeypatch):
    ex, tokens = executor()
    loop, stream = train_loop()

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"a span read the clock ({name})")

    def no_record_function(*a, **k):
        raise AssertionError("a span entered record_function")

    obs.enable()    # a fresh, empty list of records
    obs.disable()
    monkeypatch.setattr(obs, "time", NoClock())
    monkeypatch.setattr(torch.profiler, "record_function",
                        no_record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.execute(tokens, T_SLA, N_DECODE)
        loop.run(stream, 1)
    assert profiled_spans(prof) == []
    assert obs.records() == []
    assert obs.span("variant.run") is obs.span("train.step", ident=3)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with obs.span("model.decode", device=torch.device("cpu")):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename == obs.__file__ and s.size_diff > 0]
    assert grown == []


class StepClock:
    """``time`` for ``Variant.run``: each read 7 ms after the last, so
    the profiles, and the picks that follow them, repeat."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.007
        return self.t


def run_requests(spans: bool, monkeypatch):
    """Picks, the executor's RNG state, the logits of every prefill and
    decode step, and the results, of five requests."""
    from repro_torch.serving import pool
    monkeypatch.setattr(pool, "time", StepClock())
    logits = []
    prefill, decode_step = M.prefill, M.decode_step

    def keep_prefill(*a, **k):
        cache, lg = prefill(*a, **k)
        logits.append(lg)
        return cache, lg

    def keep_decode(*a, **k):
        lg, cache = decode_step(*a, **k)
        logits.append(lg)
        return lg, cache

    ex, tokens = executor(seed=5)
    monkeypatch.setattr(M, "prefill", keep_prefill)
    monkeypatch.setattr(M, "decode_step", keep_decode)
    if spans:
        obs.enable()
    res = [ex.execute(tokens, T_SLA if i % 2 else 35.0, N_DECODE)
           for i in range(5)]
    obs.disable()
    monkeypatch.undo()
    return ([r.variant for r in res], ex.rng.bit_generator.state, logits,
            [(r.t_input_ms, r.met_sla) for r in res])


def test_spans_change_no_pick_draw_or_logit(monkeypatch):
    off = run_requests(False, monkeypatch)
    on = run_requests(True, monkeypatch)
    assert on[0] == off[0] and on[1] == off[1]
    assert len(on[2]) == len(off[2]) == 5 * (1 + N_DECODE)
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))
    assert on[3] == off[3]


def test_spans_change_no_loss_or_parameter():
    runs = []
    for spans in (False, True):
        loop, stream = train_loop()
        if spans:
            obs.enable()
        loop.run(stream, 3)
        obs.disable()
        runs.append(loop)
    off, on = runs
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    for (_, a), (_, b) in zip(named_leaves(off._final_params),
                              named_leaves(on._final_params)):
        assert torch.equal(a, b)


def test_a_kernel_build_is_a_span_and_a_built_library_is_not(
        monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    obs.enable()
    build.build(("policy_select",))
    build.build(("policy_select",))     # built: nothing compiles
    obs.disable()
    assert [r.name for r in obs.records()] == ["kernels.build"]
    assert build.library_path("policy_select").exists()


# ----------------------------------------------------------------------
# The executor's e2e counts the wait before execute.
# ----------------------------------------------------------------------
def fixed_pool():
    """Three reduced qwen2 variants, unbuilt, replaying fixed service
    times (ms) instead of running their models."""
    base = get_config("qwen2-1.5b")
    pool = []
    rng = np.random.default_rng(11)
    for w, mu in ((0.25, 8.0), (0.5, 20.0), (1.0, 55.0)):
        cfg = base.reduced().scaled(w, name=f"{base.name}-w{w:g}")
        v = Variant(name=cfg.name, cfg=cfg, quality=0.4 + 0.3 * w)
        table = iter(np.tile(rng.normal(mu, mu * 0.1, 64), 8))
        v.run = lambda tokens, n_decode=2, t=table: float(next(t))
        pool.append(v)
    return pool


def test_an_open_loop_wait_raises_the_e2e_and_the_p95():
    tokens = np.zeros((1, 8), np.int32)
    exs = [PoolExecutor(fixed_pool(), NetworkModel(15.0, 7.0),
                        ModiPick(20.0), seed=4) for _ in range(3)]
    for ex in exs:
        ex.warm_up(tokens)
    closed, default, opened = exs
    free_at, waits = 0.0, []
    for i in range(80):
        due = 30.0 * i          # an arrival every 30 ms
        a = closed.execute(tokens, 150.0, waited_ms=0.0)
        b = default.execute(tokens, 150.0)
        wait = max(0.0, free_at - due)
        c = opened.execute(tokens, 150.0, waited_ms=wait)
        free_at = due + wait + c.t_infer_ms
        waits.append(wait)
        assert vars(a) == vars(b)
        assert c.waited_ms == wait
        assert c.t_e2e_ms == 2.0 * c.t_input_ms + wait + c.t_infer_ms
        assert c.met_sla == (c.t_e2e_ms <= 150.0)
    assert default.summary() == closed.summary()
    assert max(waits) > 0.0
    s0, s1 = closed.summary(), opened.summary()
    assert s1["p95_latency_ms"] > s0["p95_latency_ms"]
    assert s1["mean_latency_ms"] > s0["mean_latency_ms"]
    assert s1["sla_attainment"] <= s0["sla_attainment"]


# ----------------------------------------------------------------------
# tools/span_probe.py: kernels under the span that holds their launch.
# ----------------------------------------------------------------------
def span_probe():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "span_probe.py"
    spec = importlib.util.spec_from_file_location("span_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def us(name, s, e, dev=False, corr=0, ua=False):
    """A raw profiler event, times in µs: (name, start ns, duration ns,
    on the device, correlation id, user annotation)."""
    return (name, int(s * 1e3), int((e - s) * 1e3), dev, corr, ua)


def test_probe_puts_each_kernel_under_the_span_of_its_launch():
    raw = [us("bench.window", 0, 1000), us("serve.execute", 50, 650),
           us("variant.run", 100, 600), us("model.prefill", 120, 300),
           us("aten::mm", 130, 140, corr=2),     # a torch op's own id
           us("cudaLaunchKernel", 135, 138, corr=1),
           us("model.decode", 310, 400),
           us("cudaLaunchKernel", 320, 322, corr=2),
           us("cudaGraphLaunch", 410, 415, corr=3),
           us("gemm", 200, 250, dev=True, corr=1),
           us("model.prefill", 200, 250, dev=True, ua=True),   # its copy
           us("decode_kernel", 330, 360, dev=True, corr=2),
           us("graph_a", 420, 450, dev=True, corr=3),        # one replay,
           us("graph_b", 450, 480, dev=True, corr=3),        # two kernels
           us("Memcpy HtoD", 700, 750, dev=True, corr=99)]   # no launch
    ev = span_probe().Events(raw, obs.SPANS)
    assert (ev.dropped, ev.unlaunched) == (1, 1)
    got = ev.device_by_span()
    assert got.keys() == {"model.prefill", "model.decode", "variant.run"}
    assert got["model.prefill"] == pytest.approx(50e-6)
    assert got["model.decode"] == pytest.approx(30e-6)
    assert got["variant.run"] == pytest.approx(60e-6)   # the graph's
    (s, e), = ev.named("variant.run")
    assert [x[0] for x in ev.launched(s, e)] == ["gemm", "decode_kernel",
                                                 "graph_a", "graph_b"]
    assert ev.busy(ev.launched(s, e)) == pytest.approx(140e-6)
    idle = ev.idle_by_span()
    assert idle.keys() == {"variant.run", "model.prefill", "model.decode",
                           "host.none"}
    assert idle["variant.run"] == pytest.approx((200 + 220) * 1e-6)
    assert idle["model.prefill"] == pytest.approx(80e-6)
    assert idle["model.decode"] == pytest.approx(60e-6)
    assert idle["host.none"] == pytest.approx(250e-6)
