"""The port's training substrate against the reference's: the data
pipeline, the optimizer, checkpoints and the training loop.

- ``TokenStream``: numpy on both sides, so batches equal the
  reference's bit for bit (``batch_at``, ``__next__``, ``state`` /
  ``restore``, ``reshard``).
- ``lr_schedule`` gives the reference's bits (the cosine schedule to
  an ulp: float32 cosines differ in the last bit); the linear int8
  quantizer ``_q8`` and its inverse give its bits, the log-space
  ``_q8_log`` its bits as far as a float32 log allows
  (``assert_q8_log_close``); ``global_norm`` matches to rtol 1e-6 (the
  sums run in another order).
- The eight tests of ``tests/test_training.py``, on the port.
- One ``adamw_update`` from a state the reference built (two reference
  steps, carried across by ``from_jax_opt_state``), on the same
  gradients: m and v leaf by leaf to 1e-6 of the leaf's max |value|
  (fp32; the clip scale's norm sums in another order), or the
  reference's int8 bits as ``assert_q8_log_close`` allows; the
  parameters within 2·lr of the reference's — where a gradient is near
  0, Adam's first steps divide noise by noise and can flip the sign of
  an element's update, and no tighter bound holds there.
- The reference's decay rule: on reduced recurrentgemma with 8 layers
  (2 superblocks and a 2-layer tail), the leaves a zero-gradient step
  shrinks are the same on both sides, 1-D leaves of stacked layers
  included and the tail's and final norm's excluded.
- int8 moments of fused leaves (``wqkv``, ``bqkv``, the SSD's and the
  RG-LRU's fused projections and convs) after two steps on the same
  gradients (no clipping): the reference's bits, segment by segment (m
  exactly, v as ``assert_q8_log_close``); a single scale over the fused
  row would give other bits.
- ``launch/train.py`` runs with ``--device cpu`` and, without a card,
  raises at its default ``cuda``.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import given, settings, st

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import model as JM
from repro.training import optimizer as JO
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import TokenStream, to_device
from repro_torch.models import model as M
from repro_torch.models.convert import (from_jax_opt_state, from_jax_params,
                                        leaf_layout, named_leaves)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training.loop import TrainLoop
from repro_torch.training.train_step import init_train_state, make_train_step


def _cpu_gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------
# the data pipeline
# ----------------------------------------------------------------------
def test_token_stream_equals_reference_bit_for_bit():
    for n_hosts in (1, 2, 4):
        for host in range(n_hosts):
            a = TokenStream(1000, 8, 16, seed=11, host_id=host,
                            n_hosts=n_hosts)
            b = JTokenStream(1000, 8, 16, seed=11, host_id=host,
                             n_hosts=n_hosts)
            for step in (0, 1, 57):
                x, y = a.batch_at(step), b.batch_at(step)
                for k in ("tokens", "targets"):
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])
    a, b = TokenStream(500, 4, 8, seed=3), JTokenStream(500, 4, 8, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    assert a.state() == b.state()
    ra, rb = a.reshard(1, 2), b.reshard(1, 2)
    np.testing.assert_array_equal(next(ra)["targets"], next(rb)["targets"])
    batch = to_device(a.batch_at(0), "cpu")
    assert batch["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  b.batch_at(0)["tokens"])


@given(st.integers(0, 1000), st.sampled_from([1, 2, 4, 8]),
       st.integers(0, 2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_data_pipeline_deterministic_and_elastic(step, n_hosts, seed):
    gb, seq, vocab = 8, 16, 1000
    full = TokenStream(vocab, gb, seq, seed=seed, host_id=0, n_hosts=1)
    ref_batch = full.batch_at(step)
    got = np.concatenate(
        [TokenStream(vocab, gb, seq, seed=seed, host_id=h,
                     n_hosts=n_hosts).batch_at(step)["tokens"]
         for h in range(n_hosts)], axis=0)
    np.testing.assert_array_equal(got, ref_batch["tokens"])
    assert ref_batch["tokens"].shape == (gb, seq)
    np.testing.assert_array_equal(ref_batch["targets"][:, :-1],
                                  ref_batch["tokens"][:, 1:])


def test_stream_state_restore():
    s = TokenStream(100, 4, 8, seed=3)
    b0, b1 = next(s), next(s)
    s2 = TokenStream(100, 4, 8, seed=3)
    s2.restore({"step": 1, "seed": 3})
    np.testing.assert_array_equal(next(s2)["tokens"], b1["tokens"])


# ----------------------------------------------------------------------
# optimizer pieces against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_bits_match_reference(schedule):
    """Bit for bit against the reference run op by op; the cosine to an
    ulp, since float32 cosines differ in their last bit (the port takes
    the correctly rounded value, the reference's cosine misses it at a
    few steps)."""
    worst = 0
    for total, warmup in ((50, 7), (1000, 0), (3000, 100)):
        kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total,
                  schedule=schedule)
        a, b = TrainConfig(**kw), JTrainConfig(**kw)
        for s in range(0, total + 20, max(1, total // 200)):
            got = O.lr_schedule(a, torch.tensor(s, dtype=torch.int32))
            want = np.float32(JO.lr_schedule(b, jnp.asarray(s, jnp.int32)))
            assert got.dtype == torch.float32
            ulps = abs(int(got.numpy().view(np.int32))
                       - int(want.view(np.int32)))
            worst = max(worst, ulps)
    assert worst <= (1 if schedule == "cosine" else 0), worst


def test_lr_schedule_shapes():
    tcfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                       schedule="cosine")
    lrs = [float(O.lr_schedule(tcfg, torch.tensor(s))) for s in
           range(0, 101, 10)]
    assert lrs[1] == pytest.approx(1.0)
    assert lrs[-1] == pytest.approx(0.0, abs=1e-6)
    assert all(l >= 0 for l in lrs)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((300,), (40, 70), (3, 5, 9))]
    got = float(O.global_norm(torch.from_numpy(x) for x in leaves))
    want = float(JO.global_norm([jnp.asarray(x) for x in leaves]))
    assert got == pytest.approx(want, rel=1e-6)


def _moment_like(rng, shape):
    """Rows spanning many decades, with zeros and a zero row."""
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-12, 2, shape)
    x[..., ::5] = 0.0
    x[0] = 0.0
    return x.astype(np.float32)


def assert_q8_log_close(got, want):
    """The quantizer's bits, as far as float32 allows: XLA's and
    PyTorch's logs (and exps) differ in the last bit on a few per cent of
    inputs, and a moment computed from a gradient clipped by a norm
    summed in another order differs by an ulp, which moves a scale (or
    ``lo``) by an ulp and, where a value sits within an ulp of a rounding
    edge, a ``q`` by one step.  So the scales to rtol 1e-6, ``q`` equal
    on all but 1e-3 of the entries and within one step there."""
    for key in set(want) - {"q"}:
        torch.testing.assert_close(got[key], torch.as_tensor(
            np.array(want[key])), rtol=1e-6, atol=0)
    q, wq = got["q"].to(torch.int32), torch.as_tensor(
        np.array(want["q"])).to(torch.int32)
    off = (q != wq)
    assert int((q - wq).abs().max()) <= 1
    assert float(off.float().mean()) <= 1e-3


def test_q8_bits_match_reference():
    rng = np.random.default_rng(1)
    for shape in ((6, 40), (3, 4, 17), (33,)):
        m = _moment_like(rng, shape)
        v = np.abs(_moment_like(rng, shape))
        got, want = O._q8(torch.from_numpy(m)), JO._q8(jnp.asarray(m))
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        np.testing.assert_array_equal(O._dq8(got).numpy(),
                                      np.asarray(JO._dq8(want)))
        got_l, want_l = O._q8_log(torch.from_numpy(v)), JO._q8_log(
            jnp.asarray(v))
        assert_q8_log_close(got_l, want_l)
        # the inverse on the same bits: exp to an ulp
        same = {k: torch.as_tensor(np.array(x)) for k, x in want_l.items()}
        torch.testing.assert_close(O._dq8_log(same), torch.as_tensor(
            np.array(JO._dq8_log(want_l))), rtol=3e-7, atol=0)


# ----------------------------------------------------------------------
# the eight tests of tests/test_training.py, on the port
# ----------------------------------------------------------------------
def test_adamw_decreases_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=100,
                       weight_decay=0.0, schedule="constant", grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = O.init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}
        params, opt, _ = O.adamw_update(tcfg, params, grads, opt)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def _qwen_step(tcfg, batch):
    cfg = get_config("qwen2-1.5b").reduced()
    params, opt = init_train_state(cfg, _cpu_gen(0), torch.float32, tcfg,
                                   device="cpu")
    return make_train_step(cfg, tcfg)(params, opt, batch)


def test_grad_accumulation_matches_full_batch():
    cfg = get_config("qwen2-1.5b").reduced()
    kw = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")
    batch = to_device(next(TokenStream(cfg.vocab_size, 8, 32, seed=1)), "cpu")
    p1, _, m1 = _qwen_step(TrainConfig(grad_accum=1, **kw), batch)
    p4, _, m4 = _qwen_step(TrainConfig(grad_accum=4, **kw), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for (_, a), (_, b) in zip(named_leaves(p1), named_leaves(p4)):
        # the reference's bounds: summation-order noise, eps-scaled Adam
        # noise on near-zero gradients
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-2, atol=2e-4)


def test_checkpoint_roundtrip_and_prune():
    cfg = get_config("whisper-tiny").reduced()
    params = M.init_params(cfg, _cpu_gen(0), torch.float32, device="cpu")
    opt = O.init_opt_state(params, "int8", leaf_layout(cfg, params))
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30, 40):
            ckpt.save(d, s, params, opt, extra={"data": {"step": s, "seed": 0}},
                      keep_last=2)
        assert ckpt.latest_step(d) == 40
        dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert dirs == ["step_00000030", "step_00000040"]
        assert not [x for x in os.listdir(d) if x.startswith("tmp.")]
        p_like = M.init_params(cfg, _cpu_gen(1), torch.float32, device="cpu")
        o_like = O.init_opt_state(p_like, "int8", leaf_layout(cfg, p_like))
        p2, o2, extra = ckpt.restore(d, 40, p_like, o_like)
        assert extra["data"]["step"] == 40
        for (_, a), (_, b) in zip(named_leaves((params, opt)),
                                  named_leaves((p2, o2))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        bad = M.init_params(cfg, _cpu_gen(1), torch.bfloat16, device="cpu")
        with pytest.raises(ValueError, match="bfloat16"):
            ckpt.restore(d, 40, bad)


def test_crash_resume_bitwise_identical():
    cfg = get_config("qwen2-1.5b").reduced()
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=1e-3)
    mk = lambda: TokenStream(cfg.vocab_size, 4, 32, seed=7)

    ref_loop = TrainLoop(cfg, tcfg, device="cpu")
    ref_loop.run(mk(), 10)
    with tempfile.TemporaryDirectory() as d:
        crash = TrainLoop(cfg, tcfg, ckpt_dir=d, ckpt_every=4, fail_at_step=7,
                          device="cpu")
        with pytest.raises(RuntimeError):
            crash.run(mk(), 10)
        resume = TrainLoop(cfg, tcfg, ckpt_dir=d, device="cpu")
        resume.run(mk(), 10)
    for (_, a), (_, b) in zip(named_leaves(ref_loop._final_params),
                              named_leaves(resume._final_params)):
        assert torch.equal(a, b)
    assert ref_loop.history[0]["step"] == 0
    assert ref_loop.history[0]["step_time_s"] > 0


def test_int8_adam_moments_match_fp32():
    cfg = get_config("qwen2-1.5b").reduced()
    losses = {}
    for moments in ("fp32", "int8"):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           total_steps=30, opt_moments=moments)
        params, opt = init_train_state(cfg, _cpu_gen(0), torch.float32, tcfg,
                                       device="cpu")
        if moments == "int8":
            assert {m["q"].dtype for m in opt.mu.values()} == {torch.int8}
        step = make_train_step(cfg, tcfg)
        stream = TokenStream(cfg.vocab_size, 4, 32, seed=7)
        for _ in range(15):
            params, opt, m = step(params, opt, to_device(next(stream), "cpu"))
        losses[moments] = float(m["loss"])
    assert abs(losses["int8"] - losses["fp32"]) < 0.05, losses


# ----------------------------------------------------------------------
# one step from the reference's state; the decay rule; int8 segments
# ----------------------------------------------------------------------
def _random_tree(tree, rng, scale=1.0):
    return jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)
                                   ).astype(np.float32), tree)


def _reference_state(jcfg, seed):
    params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return _random_tree(params, np.random.default_rng(seed))


def _port_grads(cfg, grads_np):
    return dict(named_leaves(from_jax_params(cfg, grads_np, device="cpu")))


def _configs(arch, n_layers=None):
    """The reduced reference and port configs, at ``n_layers`` if given."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


@pytest.mark.parametrize("arch,n_layers,moments", [
    ("qwen2-1.5b", None, "fp32"), ("recurrentgemma-2b", 8, "fp32"),
    ("qwen2-1.5b", None, "int8")])
def test_adamw_step_from_reference_state(arch, n_layers, moments):
    jcfg, cfg = _configs(arch, n_layers)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              opt_moments=moments)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    rng = np.random.default_rng(2)
    jparams = jax.tree.map(jnp.asarray, _reference_state(jcfg, 4))
    jopt = JO.init_opt_state(jparams, moments)
    for _ in range(2):  # the reference's own steps build the state
        jgrads = jax.tree.map(jnp.asarray, _random_tree(jparams, rng, 0.1))
        jparams, jopt, _ = JO.adamw_update(jtcfg, jparams, jgrads, jopt)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    opt = from_jax_opt_state(cfg, jax.tree.map(np.asarray, jopt),
                             device="cpu")
    grads_np = _random_tree(jparams, rng, 0.1)
    jparams, jopt, jm = JO.adamw_update(
        jtcfg, jparams, jax.tree.map(jnp.asarray, grads_np), jopt)
    params, opt, m = O.adamw_update(tcfg, params, _port_grads(cfg, grads_np),
                                    opt, leaf_layout(cfg, params))
    want = from_jax_opt_state(cfg, jax.tree.map(np.asarray, jopt),
                              device="cpu")
    assert int(opt.step) == int(want.step) == 3
    assert float(m["lr"]) == float(jm["lr"])
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    for got, exp in ((opt.mu, want.mu), (opt.nu, want.nu)):
        for path in exp:
            if moments == "int8":
                assert_q8_log_close(got[path], exp[path])
            else:
                # the clip scale's norm sums in another order: an ulp of
                # g, which b1·m + (1 − b1)·g can cancel down to
                scale = float(exp[path].abs().max())
                assert float((got[path] - exp[path]).abs().max()) <= \
                    1e-6 * scale, path
    lr = float(jm["lr"])
    want_p = dict(named_leaves(from_jax_params(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")))
    for path, p in named_leaves(params):
        assert float((p - want_p[path]).abs().max()) <= 2 * lr, path


def test_decay_rule_matches_reference():
    """A zero-gradient step leaves m, v and Adam's delta at 0, so only
    weight decay moves a leaf: the leaves that move are the ones each
    side decays."""
    jcfg, cfg = _configs("recurrentgemma-2b", 8)
    assert cfg.n_superblocks == 2 and len(cfg.tail_kinds) == 2
    kw = dict(learning_rate=1.0, warmup_steps=0, schedule="constant",
              weight_decay=0.5)
    params_np = _reference_state(jcfg, 6)
    jparams = jax.tree.map(jnp.asarray, params_np)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jnew, _, _ = JO.adamw_update(JTrainConfig(**kw), jparams, zeros,
                                 JO.init_opt_state(jparams))
    moved_np = jax.tree.map(lambda a, b: np.asarray(a != b, np.float32),
                            jnew, jparams)
    moved = {path: bool(t.all()) for path, t in named_leaves(
        from_jax_params(cfg, moved_np, device="cpu"))}
    assert all(bool(t.all()) == bool(t.any()) for _, t in named_leaves(
        from_jax_params(cfg, moved_np, device="cpu")))
    params = from_jax_params(cfg, params_np, device="cpu")
    before = {path: p.clone() for path, p in named_leaves(params)}
    grads = {path: torch.zeros_like(p) for path, p in before.items()}
    O.adamw_update(TrainConfig(**kw), params, grads,
                   O.init_opt_state(params), leaf_layout(cfg, params))
    got = {path: bool((p != before[path]).all())
           for path, p in named_leaves(params)}
    assert got == moved
    # both rules happen in one model
    assert moved["layers/0/norm1"] and moved["layers/0/rglru/b_gates"]
    assert moved["layers/5/norm2"] and moved["layers/4/rglru/lam"]
    assert not moved["layers/6/norm1"] and not moved["final_norm"]
    assert not moved["layers/7/rglru/lam"] and moved["layers/7/rglru/w_in"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "recurrentgemma-2b"])
def test_int8_moments_of_fused_leaves_match_reference_bits(arch):
    jcfg, cfg = _configs(arch)
    # no clipping, so that both sides step on the very same gradients
    kw = dict(learning_rate=1e-2, warmup_steps=1, opt_moments="int8",
              grad_clip=0.0)
    rng = np.random.default_rng(8)
    params_np = _reference_state(jcfg, 9)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = JO.init_opt_state(jparams, "int8")
    params = from_jax_params(cfg, params_np, device="cpu")
    layout = leaf_layout(cfg, params)
    opt = O.init_opt_state(params, "int8", layout)
    for _ in range(2):
        grads_np = _random_tree(params_np, rng, 0.1)
        jparams, jopt, _ = JO.adamw_update(
            JTrainConfig(**kw), jparams, jax.tree.map(jnp.asarray, grads_np),
            jopt)
        params, opt, _ = O.adamw_update(TrainConfig(**kw), params,
                                        _port_grads(cfg, grads_np), opt,
                                        layout)
    want = from_jax_opt_state(cfg, jax.tree.map(np.asarray, jopt),
                              device="cpu")
    fused = [p for p, lay in layout.items() if len(lay.segments) > 1]
    assert fused
    for path in fused:
        for got, exp in ((opt.mu[path], want.mu[path]),
                         (opt.nu[path], want.nu[path])):
            assert got["scale"].shape[-1] == len(layout[path].segments)
            if "lo" in exp:
                assert_q8_log_close(got, exp)
            else:
                assert torch.equal(got["q"], exp["q"]), path
                assert torch.equal(got["scale"], exp["scale"]), path


def test_train_launcher_runs_on_the_cpu_and_wants_a_card_by_default(capsys):
    from repro_torch.launch import train
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16"]
    train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "final:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(argv)
