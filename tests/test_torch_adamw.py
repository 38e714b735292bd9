"""The fused AdamW (``kernels/adamw.py``, ``csrc/adamw.cu``) and the way
``training/optimizer.py`` dispatches to it.

On the CPU: the chunk table covers every element of every leaf once and
never crosses a leaf; the launch groups cover the table; the decay flags
follow the reference's rule (``test_torch_training.py``'s
``test_decay_rule_matches_reference`` cases); CPU tensors, int8 moments
and ``meta`` outside the dry-run's count take the eager path and
``update_counts()`` says so; ``meta`` inside ``cost.counting()`` records
``adamw`` at 4·esize + 16 bytes a parameter, and leaves the kernels do
not take raise there instead of stepping on the eager path; the plain
step at a given clip scale; the benchmark's reader of
``adamw_roofline.train.*``.

On the card (marked ``cuda``; this file imports no JAX):

    python -m pytest -m cuda tests/test_torch_adamw.py

at equal clip scale (no clipping, or gradients under the clip) the fused
p, m and v equal the eager path's bit for bit; with clipping active they
stay within ``test_adamw_step_from_reference_state``'s tolerances (m and
v to 1e-6 of each leaf's max, p to 2·lr, the norm to rel 1e-6: the
norm's sum runs in another order), and equal the plain step's bits at
the kernels' own clip scale; two runs give the same norm's bits; a step
syncs nothing with the host; a step launches at most 8 kernels; a leaf
the kernels do not take raises.
"""
import dataclasses
import functools
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import adamw as fused
from repro_torch.kernels import cost, ops, ref
from repro_torch.models import model as M
from repro_torch.models import templates
from repro_torch.models.convert import leaf_layout, named_leaves
from repro_torch.training import optimizer as O

ROOT = Path(__file__).resolve().parents[1]
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


# ----------------------------------------------------------------------
# On the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("numels,chunk", [
    ([1, 3, 4 * 1000 + 1, 0, 7], 64),
    ([fused.CHUNK - 1, fused.CHUNK, fused.CHUNK + 1, 1], fused.CHUNK),
    ([5 * fused.CHUNK + 3, 2, 0, 0, 3 * fused.CHUNK], fused.CHUNK),
    (list(range(0, 3000, 7)), 128)])
def test_chunk_table_covers_each_element_once_within_its_leaf(numels, chunk):
    t = fused.chunk_table(numels, chunk)
    assert t.dtype.itemsize == 16
    assert np.all(t["len"] >= 1) and np.all(t["len"] <= chunk)
    assert np.all(np.diff(t["leaf"]) >= 0)
    for leaf, n in enumerate(numels):
        mine = t[t["leaf"] == leaf]
        covered = np.zeros(n, np.int64)
        for off, ln in zip(mine["off"], mine["len"]):
            assert 0 <= off and off + ln <= n      # never crosses the leaf
            covered[off:off + ln] += 1
        assert np.all(covered == 1)


@pytest.mark.parametrize("n_leaves,max_leaves", [(5, 2), (448, 448),
                                                 (449, 448), (1000, 300)])
def test_launch_groups_cover_the_table(n_leaves, max_leaves):
    rng = np.random.default_rng(n_leaves)
    numels = rng.integers(0, 300, n_leaves)
    numels[:3] = 0
    t = fused.chunk_table(numels, 128)
    groups = fused.launch_groups(numels, 128, max_leaves)
    seen = []
    for l0, l1, c0, c1 in groups:
        assert 0 < l1 - l0 <= max_leaves and c1 > c0
        assert np.all((t["leaf"][c0:c1] >= l0) & (t["leaf"][c0:c1] < l1))
        seen.extend(range(c0, c1))
    assert seen == list(range(len(t)))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_launches_a_step_at_full_size(arch):
    """The kernels a step over a published model's leaves: 3 while the
    leaves fit one launch (qwen2-1.5b's 226, mamba2-1.3b's 434), never
    more than 8 for the benchmark's models."""
    params = templates.empty(templates.param_template(
        get_config(arch), torch.float32), "meta")
    numels = [p.numel() for _, p in named_leaves(params)]
    n = fused.launches(numels)
    assert n <= 8
    assert n == 3 or len(numels) > fused.MAX_LEAVES


def test_decay_flags_follow_the_reference_rule():
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              n_layers=8)
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, torch.float32, device="cpu")
    layout = leaf_layout(cfg, params)
    leaves = named_leaves(params)
    ps = [p for _, p in leaves]
    decay = [O.decays(p, layout[path]) for path, p in leaves]
    opt = O.init_opt_state(params)
    table, chunks = fused.plan(ps, ps, [opt.mu[k] for k, _ in leaves],
                               [opt.nu[k] for k, _ in leaves], decay)
    flags = {path: bool(f & fused.DECAY)
             for (path, _), f in zip(leaves, table["flags"])}
    assert flags == {path: p.dim() >= 2 or layout[path].stacked
                     for path, p in leaves}
    # the cases the reference's own step shows (both rules in one model)
    assert flags["layers/0/norm1"] and flags["layers/0/rglru/b_gates"]
    assert flags["layers/5/norm2"] and flags["layers/4/rglru/lam"]
    assert not flags["layers/6/norm1"] and not flags["final_norm"]
    assert not flags["layers/7/rglru/lam"] and flags["layers/7/rglru/w_in"]
    assert list(table["p"]) == [p.data_ptr() for p in ps]
    assert not np.any(table["flags"] & (fused.P_BF16 | fused.G_BF16))
    assert int(chunks["len"].sum()) == sum(p.numel() for p in ps)


def test_flags_of_bf16_leaves():
    p = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(3)]
    g = [torch.zeros(3), torch.zeros(3, dtype=torch.bfloat16)]
    assert list(fused.leaf_flags(p, g, [True, False])) == [
        fused.DECAY | fused.P_BF16, fused.G_BF16]


def _state(cfg, device, moments):
    if device == "cpu":
        params = M.init_params(cfg, torch.Generator().manual_seed(1),
                               torch.float32, device="cpu")
    else:
        params = templates.empty(templates.param_template(
            cfg, torch.float32), device)
    grads = {path: torch.full_like(p, 0.01) for path, p
             in named_leaves(params)}
    return params, grads, O.init_opt_state(params, moments,
                                           leaf_layout(cfg, params))


@pytest.mark.parametrize("device,moments,counting,path", [
    ("cpu", "fp32", False, "eager"), ("cpu", "int8", False, "eager"),
    ("meta", "fp32", False, "eager"), ("cpu", "fp32", True, "eager"),
    ("meta", "fp32", True, "fused")])
def test_dispatch_and_update_counts(device, moments, counting, path):
    cfg = get_config("qwen2-1.5b").reduced()
    params, grads, opt = _state(cfg, device, moments)
    n = sum(p.numel() for _, p in named_leaves(params))
    ops.reset_launch_counts()
    assert O.update_counts() == {"fused": 0, "eager": 0}
    tcfg = TrainConfig(opt_moments=moments)
    if counting:
        with cost.counting() as tally:
            _, new, m = O.adamw_update(tcfg, params, grads, opt,
                                       leaf_layout(cfg, params))
        assert tally.calls == ({"adamw": 1} if path == "fused" else {})
    else:
        _, new, m = O.adamw_update(tcfg, params, grads, opt,
                                   leaf_layout(cfg, params))
    assert O.update_counts() == {"fused": n if path == "fused" else 0,
                                 "eager": n if path == "eager" else 0}
    assert ops.launch_counts()["adamw"] == 0    # nothing launched here
    assert m["grad_norm"].shape == () and m["grad_norm"].device.type == device
    assert m["lr"].shape == ()
    ops.reset_launch_counts()
    assert O.update_counts() == {"fused": 0, "eager": 0}


@pytest.mark.parametrize("dtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_meta_records_its_bytes(dtype, gdtype):
    shapes = [(7, 5), (11,), (1,)]
    ps = [torch.empty(s, dtype=dtype, device="meta") for s in shapes]
    gs = [torch.empty(s, dtype=gdtype, device="meta") for s in shapes]
    ms = [torch.empty(s, device="meta") for s in shapes]
    sc = torch.empty((), device="meta")
    with cost.counting() as tally:
        out = ops.adamw(ps, gs, ms, ms, [True, False, False], sc, sc, sc,
                        grad_clip=1.0, **HYPER)
    assert out.is_meta and out.shape == ()
    n = 35 + 11 + 1
    esize = torch.empty((), dtype=dtype).element_size()
    gsize = torch.empty((), dtype=gdtype).element_size()
    assert tally.nbytes == n * (2 * esize + 2 * gsize + 16)
    if dtype == gdtype:
        assert tally.nbytes == n * (4 * esize + 16)
    assert tally.flops == n * 17 + 35 * 2
    assert tally.calls == {"adamw": 1}
    with pytest.raises(ValueError, match="counting"):
        ops.adamw(ps, gs, ms, ms, [True] * 3, sc, sc, sc, grad_clip=1.0,
                  **HYPER)


def _one_leaf(p, g=None, m=None, v=None):
    """adamw_update's input over the single leaf ``w``."""
    shape = p.shape
    g = torch.zeros(shape, device=p.device) if g is None else g
    m = torch.zeros(shape, device=p.device) if m is None else m
    v = torch.zeros(shape, device=p.device) if v is None else v
    step = torch.zeros((), dtype=torch.int32, device=p.device)
    return {"w": p}, {"w": g}, O.OptState(step, {"w": m}, {"w": v})


@pytest.mark.parametrize("case", ["p_transposed", "p_float16", "g_float64",
                                  "m_other_shape", "v_transposed"])
def test_meta_leaves_the_kernels_do_not_take_raise(case):
    """Inside the dry-run's count, fp32 moments go to the fused wrapper
    whatever the leaves, and it refuses what its kernels do not take:
    nothing falls back to the eager path."""
    meta = dict(device="meta")
    p = torch.empty(6, 4, **meta)
    kw = {}
    if case == "p_transposed":
        p = torch.empty(4, 6, **meta).t()
    elif case == "p_float16":
        p = p.half()
    elif case == "g_float64":
        kw["g"] = torch.empty(6, 4, dtype=torch.float64, **meta)
    elif case == "m_other_shape":
        kw["m"] = torch.empty(24, **meta)
    else:
        kw["v"] = torch.empty(4, 6, **meta).t()
    params, grads, opt = _one_leaf(p, **kw)
    ops.reset_launch_counts()
    with cost.counting() as tally:
        with pytest.raises(TypeError, match="adamw takes"):
            O.adamw_update(TrainConfig(), params, grads, opt)
    assert tally.calls == {}
    assert O.update_counts() == {"fused": 0, "eager": 0}
    # the same leaf on the CPU steps on the plain path
    params, grads, opt = _one_leaf(torch.zeros(p.shape, dtype=p.dtype))
    O.adamw_update(TrainConfig(), params, grads, opt)
    assert O.update_counts() == {"fused": 0, "eager": 24}


def test_plain_step_at_a_given_clip_scale():
    """``scale`` replaces the clip scale from the norm: at the scale the
    norm gives, the same bits; at another, other bits."""
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (7,)]

    def leaves():
        r = np.random.default_rng(6)
        return [[torch.from_numpy(np.abs(r.standard_normal(s))
                                  .astype(np.float32)) for s in shapes]
                for _ in range(3)]
    g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in shapes]
    sc = (torch.tensor(0.1), torch.tensor(0.05), torch.tensor(1e-2))
    a, b, c = leaves(), leaves(), leaves()
    n_a = ref.adamw_ref(a[0], g, a[1], a[2], [True, False], *sc,
                        grad_clip=0.5, **HYPER)
    scale = ref.clip_scale(n_a, 0.5)
    assert float(scale) < 1.0
    n_b = ref.adamw_ref(b[0], g, b[1], b[2], [True, False], *sc,
                        grad_clip=0.5, scale=scale, **HYPER)
    ref.adamw_ref(c[0], g, c[1], c[2], [True, False], *sc, grad_clip=0.5,
                  scale=1.0, **HYPER)
    assert torch.equal(n_a, n_b)
    for x, y, z in zip(a[0] + a[1] + a[2], b[0] + b[1] + b[2],
                       c[0] + c[1] + c[2]):
        assert torch.equal(x, y) and not torch.equal(x, z)


def test_clip_scale_of_takes_only_a_card_norm():
    with pytest.raises(ValueError, match="clip_scale_of"):
        fused.clip_scale_of(torch.zeros(()))


def test_cpu_wrapper_is_the_plain_step():
    rng = np.random.default_rng(3)
    shapes = [(4, 6), (5,), (3, 2)]

    def state():
        r = np.random.default_rng(4)
        return [[torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 for s in shapes] for _ in range(3)]
    g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in shapes]
    v_abs = lambda t: [x.abs() for x in t]  # noqa: E731
    a, b = state(), state()
    bc1, bc2, lr = torch.tensor(0.1), torch.tensor(0.05), torch.tensor(1e-2)
    n1 = ops.adamw(a[0], g, a[1], v_abs(a[2]), [True, False, True], bc1,
                   bc2, lr, grad_clip=1.0, **HYPER)
    n2 = ref.adamw_ref(b[0], g, b[1], v_abs(b[2]), [True, False, True], bc1,
                       bc2, lr, grad_clip=1.0, **HYPER)
    assert torch.equal(n1, n2)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert ops.launch_counts()["adamw"] == 0


def _reader():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import run as runmod
    return runmod.reader("adamw_roofline.train.dense")


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, pattern):
        return sum(s for name, s in self.seconds.items()
                   if re.search(pattern, name))


def test_roofline_reader():
    read = _reader()
    from bench import yardstick
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for fam, cell in (("dense", "qwen2-pool.train"),
                      ("ssm", "mamba2-pool.train")):
        m = metrics[f"adamw_roofline.train.{fam}"]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"], m["workloads"]) == (
            "%", "higher", "device_trace", "training",
            f"train_tokens_per_s.{fam}", [cell])
    cfg = json.loads((ROOT / "bench/configs/qwen2-pool.json").read_text())
    v = next(x for x in cfg["variants"] if x["name"] == cfg["train_variant"])
    names = {"void (anonymous namespace)::adamw_step_kernel(...)": 0.030,
             "(anonymous namespace)::adamw_norm_kernel(...)": 0.003,
             "(anonymous namespace)::adamw_finish_kernel(...)": 1e-5,
             "void bwd_dq_kernel<float>(...)": 5.0}
    ctx = dict(trace=_Trace(names), variant=v, traced_steps=2,
               traffic={"param_dtype": "float32"})
    least = 2 * 32 * yardstick.param_count(v) / yardstick.HBM_BW
    assert read(ctx) == pytest.approx(100 * least / 0.03301)
    assert 80 < read(ctx) < 100
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, variant=None)) is None
    assert read(dict(ctx, trace=_Trace({"bwd_dq_kernel": 1.0}))) is None


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


SIZES = (1, 3, 4 * 1000 + 1, 4096, fused.CHUNK + 5, 3 * fused.CHUNK)


def _rand(gen, n, dtype, shift, scale=1.0, positive=False):
    """n values as a slice that starts ``shift`` elements into a fresh
    buffer (off the 16-byte grid for a shift of 1)."""
    x = torch.randn(n + shift, generator=gen, device="cuda") * scale
    return (x.abs() if positive else x).to(dtype)[shift:]


def _leaves(gen, dtype, gdtype, sizes=SIZES):
    """[p, m, v, decay] a leaf with moments as after some steps, and the
    gradients; every third leaf's p, m and v, and every fourth leaf's g,
    unaligned slices."""
    leaves, grads = [], []
    for i, n in enumerate(sizes):
        s = 1 if i % 3 == 1 else 0
        leaves.append([_rand(gen, n, dtype, s),
                       _rand(gen, n, torch.float32, 3 * s, 0.01),
                       _rand(gen, n, torch.float32, 2 * s, 1e-4, True),
                       i % 2 == 0])
        grads.append(_rand(gen, n, gdtype, 1 if i % 4 == 2 else 0, 1e-3))
    return leaves, grads


def _clone(leaves):
    return [[x.clone() if torch.is_tensor(x) else x for x in leaf]
            for leaf in leaves]


def _run(step, leaves, grads, grad_clip, step_no=3):
    ps, ms, vs, decay = (list(x) for x in zip(*leaves))
    stepf = torch.tensor(float(step_no), device="cuda")
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, HYPER["b1"]), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, HYPER["b2"]), stepf)
    lr = torch.tensor(3e-2, device="cuda")
    return step(ps, grads, ms, vs, decay, bc1, bc2, lr,
                grad_clip=grad_clip, **HYPER)


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("grad_clip", [0.0, 1e4])
def test_fused_equals_eager_bit_for_bit(gen, dtype, gdtype, grad_clip):
    """No clipping, and a clip far above the norm: both paths step with a
    clip scale of exactly 1."""
    leaves, grads = _leaves(gen, dtype, gdtype)
    eager = _clone(leaves)
    for _ in range(2):
        n_f = _run(ops.adamw, leaves, grads, grad_clip)
        n_e = _run(ref.adamw_ref, eager, grads, grad_clip)
    torch.cuda.synchronize()
    assert float(n_f) == pytest.approx(float(n_e), rel=1e-6)
    for got, want in zip(leaves, eager):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_kernel_constants_match_the_wrapper(gen):
    import ctypes
    from repro_torch.kernels import build
    fn = build.function("adamw", "adamw_limits", [ctypes.c_void_p])
    out = (ctypes.c_int * 4)()
    assert fn(ctypes.addressof(out)) == 0
    assert list(out) == [fused.MAX_LEAVES, 256, fused.LEAF.itemsize,
                         fused.CHUNK_RECORD.itemsize]


@pytest.mark.cuda
def test_more_leaves_than_a_launch_takes(gen):
    sizes = [1 + (i * 37) % 300 for i in range(fused.MAX_LEAVES + 60)]
    leaves, grads = _leaves(gen, torch.float32, torch.float32, sizes)
    eager = _clone(leaves)
    ops.reset_launch_counts()
    _run(ops.adamw, leaves, grads, 0.0)
    assert ops.launch_counts()["adamw"] == 5
    _run(ref.adamw_ref, eager, grads, 0.0)
    for got, want in zip(leaves, eager):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_clipping_within_the_reference_tolerances(gen):
    leaves, grads = _leaves(gen, torch.float32, torch.float32)
    grads = [g * 1e3 for g in grads]       # a norm far above the clip
    eager = _clone(leaves)
    n_f = _run(ops.adamw, leaves, grads, 1.0)
    n_e = _run(ref.adamw_ref, eager, grads, 1.0)
    assert float(n_f) > 1.0
    assert float(n_f) == pytest.approx(float(n_e), rel=1e-6)
    for got, want in zip(leaves, eager):
        for a, b in zip(got[1:3], want[1:3]):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        assert float((got[0] - want[0]).abs().max()) <= 2 * 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_clipping_bit_for_bit_at_the_kernels_scale(gen, dtype, gdtype):
    """With clipping active, the plain step handed the clip scale the
    finish kernel wrote gives the fused step's p, m and v bit for bit,
    and that scale is the one ``ref.clip_scale`` makes of the norm."""
    leaves, grads = _leaves(gen, dtype, gdtype)
    for g in grads:
        g.mul_(1e3)                        # a norm far above the clip
    start = _clone(leaves)
    eager = _clone(leaves)
    n_f = _run(ops.adamw, leaves, grads, 1.0)
    scale = fused.clip_scale_of(n_f).clone()
    assert 0.0 < float(scale) < 1.0
    assert torch.equal(_bits(scale.reshape(1)),
                       _bits(ref.clip_scale(n_f, 1.0).reshape(1)))
    _run(functools.partial(ref.adamw_ref, scale=scale), eager, grads, 1.0)
    for got, want, was in zip(leaves, eager, start):
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(_bits(a), _bits(b))
        # p was stepped: most elements of a big leaf move (a bf16 p of a
        # few elements may round back to itself)
        if got[0].numel() > 1000:
            assert float((got[0] != was[0]).float().mean()) > 0.5


@pytest.mark.cuda
def test_a_leaf_the_kernels_do_not_take_raises_on_the_card(gen):
    """A transposed fp32 leaf on the card: adamw_update raises rather
    than step it on the plain path, and nothing is updated."""
    p = torch.randn(4, 6, generator=gen, device="cuda").t()
    params, grads, opt = _one_leaf(p, torch.zeros(6, 4, device="cuda"),
                                   torch.zeros(6, 4, device="cuda"),
                                   torch.zeros(6, 4, device="cuda"))
    was = p.clone()
    ops.reset_launch_counts()
    with pytest.raises(TypeError, match="adamw takes"):
        O.adamw_update(TrainConfig(), params, grads, opt)
    assert torch.equal(p, was)
    assert ops.launch_counts()["adamw"] == 0
    assert O.update_counts() == {"fused": 0, "eager": 0}


@pytest.mark.cuda
def test_norm_repeats_bit_for_bit(gen):
    leaves, grads = _leaves(gen, torch.float32, torch.float32)
    again = _clone(leaves)
    a = _run(ops.adamw, leaves, grads, 1.0)
    b = _run(ops.adamw, again, grads, 1.0)
    assert torch.equal(_bits(a.reshape(1)), _bits(b.reshape(1)))
    for got, want in zip(leaves, again):
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Synchronization debug mode is a "
                            "prototype feature:UserWarning")
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_a_train_step_syncs_nothing_and_launches_few(gen, arch):
    """adamw_update on the card over a model's leaf set (the reduced
    widths, the published number of layers): the fused path, at most 8
    launches, no host sync, the fused share 1."""
    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(), n_layers=full.n_layers)
    params = M.init_params(cfg, gen, torch.float32, device="cuda")
    layout = leaf_layout(cfg, params)
    opt = O.init_opt_state(params, "fp32", layout)
    leaves = named_leaves(params)
    grads = {path: torch.randn(p.shape, generator=gen, device="cuda")
             for path, p in leaves}
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=0,
                       schedule="constant", weight_decay=0.1, grad_clip=1.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            params, opt, m = O.adamw_update(tcfg, params, grads, opt, layout)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["adamw"] <= 2 * 8
    assert ops.launch_counts()["adamw"] == 2 * fused.launches(
        [p.numel() for _, p in leaves])
    counts = O.update_counts()
    assert counts["eager"] == 0 and counts["fused"] == 2 * sum(
        p.numel() for _, p in leaves)
    assert math.isfinite(float(m["grad_norm"]))
