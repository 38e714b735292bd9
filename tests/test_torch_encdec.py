"""whisper-tiny, the encoder-decoder, against the reference.

- The config equals the reference's, field for field and in
  ``param_count()`` (with its encoder and cross-attention terms), at
  full width, at widths 0.5 and 1.0, and reduced.
- ``sinusoidal_pos`` equals the reference's.
- On the reduced config in float32, with the reference's parameters
  carried across by ``from_jax_params`` (biases and norm scales
  perturbed) and numpy-seeded frames and tokens: the encoder's output,
  the prefill logits and the ``k``/``v``/``xk``/``xv`` caches, and four
  greedy decode steps' logits match the reference to rtol/atol 1e-4
  (fp32 on both sides; summation orders differ), greedy tokens exactly.
- A prefill of S and a decode of token S give the logits of a prefill
  of S + 1 (the port alone).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from test_torch_model import _perturbed_params
from test_torch_ssm import check_caches

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-tiny"


def assert_config_matches(arch):
    """Every field of the port's config (sub-configs as dicts) and its
    derived sizes equal the reference's, at full width, widths 0.5 and
    1.0, and reduced."""
    a, b = jax_config(arch), get_config(arch)
    pairs = [(a, b), (a.reduced(), b.reduced())] + [
        (a.scaled(w), b.scaled(w)) for w in (0.5, 1.0)]
    for a, b in pairs:
        for f in dataclasses.fields(b):
            got, want = getattr(b, f.name), getattr(a, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (b.name, f.name)
        for prop in ("resolved_head_dim", "padded_vocab", "block_kinds",
                     "sub_quadratic", "param_count"):
            got, want = getattr(b, prop), getattr(a, prop)
            if callable(got):
                got, want = got(), want()
            assert got == want, (b.name, prop)


def test_config_matches_reference():
    assert_config_matches(ARCH)
    full = get_config(ARCH)
    assert (full.encdec.n_encoder_layers, full.encdec.n_frames) == (4, 1500)
    assert not full.use_rope and full.qkv_bias and full.norm == "layer"


@pytest.mark.parametrize("shape,d", [((7,), 384), ((2, 1500), 384),
                                     ((3, 5), 128)])
def test_sinusoidal_pos_matches_reference(shape, d):
    pos = np.random.default_rng(0).integers(0, 1500, shape)
    want = jlayers.sinusoidal_pos(jnp.asarray(pos), d)
    got = layers.sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (*shape, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    params_np = _perturbed_params(jcfg)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, params_np),
            from_jax_params(cfg, params_np, device="cpu"))


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "frames": rng.standard_normal(
                (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)}


def test_encoder_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    frames = _batch(cfg, 2, 1, 1)["frames"]
    want, _ = JM._encode(jcfg, jparams, jnp.asarray(frames))
    got = M.encode(cfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_greedy_decode_match_reference(pair):
    jcfg, cfg, jparams, params = pair
    B, S, cache_len, steps = 2, 20, 32, 4
    batch = _batch(cfg, B, S, 2)
    jcache, jlogits = JM.prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len)
    cache, logits = M.prefill(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache[0]) == {"k", "v", "xk", "xv"}
    assert cache[0]["xk"].shape == (B, cfg.encdec.n_frames, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
    check_caches(cfg, cache, jcache)

    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jtok,
                                         jnp.full((B,), S + i, jnp.int32))
        logits, cache = M.decode_step(
            cfg, params, cache, tok, torch.full((B,), S + i,
                                                dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    check_caches(cfg, cache, jcache)


def test_decode_matches_a_longer_prefill():
    """Prefill S + decode of token S ≡ prefill of S + 1 over the same
    frames: the self cache, the cross cache and the absolute position of
    the decode step."""
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    B, S, cache_len = 2, 37, 64
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S + 1,
                                                       3).items()}
    toks = batch["tokens"]
    cache, _ = M.prefill(cfg, params, dict(batch, tokens=toks[:, :S]),
                         cache_len)
    step, _ = M.decode_step(cfg, params, cache, toks[:, S],
                            torch.full((B,), S, dtype=torch.int32))
    _, full = M.prefill(cfg, params, batch, cache_len)
    torch.testing.assert_close(step, full, **TOL)
