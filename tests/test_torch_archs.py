"""The five decoder architectures this slice adds to the port against the
reference: phi4-mini-3.8b, command-r-35b (LayerNorm), gemma3-4b (5
local : 1 global, geglu, embedding scale), dbrx-132b (MoE, LayerNorm,
untied lm_head) and moonshot-v1-16b-a3b (MoE).

- Each config equals the reference's, field for field and in
  ``param_count()``, at full width, at widths 0.25, 0.5 and 1.0, and
  reduced.
- On the reduced configs in float32, with the reference's parameters
  carried across by ``from_jax_params`` (norm scales and ``lm_head``
  perturbed), prefill logits and caches and two greedy decode steps
  match the reference to rtol/atol 1e-4 (fp32 on both sides; summation
  orders differ), greedy tokens exactly.
- A prefill of S and a decode of token S give the logits of a prefill
  of S + 1 (MoE at capacity 8.0, so that no drop depends on the group).
- ``layernorm`` equals the reference's.

The reference's MoE passes a float to ``jax.nn.one_hot``; its cases
ignore that DeprecationWarning.
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
from test_torch_ssm import check_caches, perturbed_params

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["phi4-mini-3.8b", "command-r-35b", "gemma3-4b", "dbrx-132b",
         "moonshot-v1-16b-a3b"]
ONE_HOT_FLOAT = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")


def _perturbed_params(cfg, seed=0):
    """``perturbed_params``, and an untied ``lm_head`` perturbed too."""
    params = perturbed_params(cfg, seed)
    if "lm_head" in params:
        rng = np.random.default_rng(seed + 1)
        params["lm_head"] = (params["lm_head"] + 0.1 * rng.standard_normal(
            params["lm_head"].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    a, b = jax_config(arch), get_config(arch)
    pairs = [(a, b), (a.reduced(), b.reduced())] + [
        (a.scaled(w), b.scaled(w)) for w in (0.25, 0.5, 1.0)]
    for a, b in pairs:
        for f in dataclasses.fields(b):
            got, want = getattr(b, f.name), getattr(a, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (b.name, f.name)
        for prop in ("resolved_head_dim", "padded_vocab", "block_kinds",
                     "param_count", "active_param_count"):
            got, want = getattr(b, prop), getattr(a, prop)
            if callable(got):
                got, want = got(), want()
            assert got == want, (b.name, prop)


@ONE_HOT_FLOAT
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params_np = _perturbed_params(jcfg)
    params = from_jax_params(cfg, params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    # a 40-token prompt and 80 slots: gemma3's 64-slot local ring is
    # gathered in prefill; the MoE pads 80 tokens to groups of 32
    B, S, cache_len, steps = 2, 40, 80, 2
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jcache, jlogits = JM.prefill(jcfg, jparams,
                                 {"tokens": jnp.asarray(tokens)}, cache_len)
    cache, logits = M.prefill(cfg, params,
                              {"tokens": torch.from_numpy(tokens)}, cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    check_caches(cfg, cache, jcache)

    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1)
    jpos = jnp.full((B,), S, jnp.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jtok, jpos)
        logits, cache = M.decode_step(cfg, params, cache, tok, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
        jpos, pos = jpos + 1, pos + 1
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    check_caches(cfg, cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_a_longer_prefill(arch):
    """Prefill S + decode of token S ≡ prefill of S + 1 (the port alone)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:  # no capacity drop that depends on the group
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, torch.float32, device="cpu")
    B, S, cache_len = 2, 37, 80
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1), dtype=np.int32))
    cache, _ = M.prefill(cfg, params, {"tokens": toks[:, :S]}, cache_len)
    pos = torch.full((B,), S, dtype=torch.int32)
    step, _ = M.decode_step(cfg, params, cache, toks[:, S], pos)
    _, full = M.prefill(cfg, params, {"tokens": toks}, cache_len)
    torch.testing.assert_close(step, full, **TOL)


@ONE_HOT_FLOAT
def test_short_prompt_under_a_local_ring():
    """gemma3 with a 9-token prompt, 96 cache slots and a 64-slot window:
    the ring's slots past the prompt are never read before they are
    written.  The reference fills some of them with NaN (an
    out-of-range ``jnp.take``), and its decode logits are NaN; the port
    holds zeros there, and its decode equals the reference's at 64
    slots (its padded branch) and the port's own prefill of S + 1."""
    jcfg, cfg = jax_config("gemma3-4b").reduced(), \
        get_config("gemma3-4b").reduced()
    params_np = _perturbed_params(jcfg, seed=5)
    params = from_jax_params(cfg, params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 10),
                                             dtype=np.int32)
    S = 9
    jpos = jnp.full((1,), S, jnp.int32)
    jcache, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                           96)
    nan_logits, _ = JM.decode_step(jcfg, jparams, jcache,
                                   jnp.asarray(toks[:, S]), jpos)
    assert np.isnan(np.asarray(nan_logits)).all()
    jcache, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                           64)
    want, _ = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, S]),
                             jpos)

    cache, _ = M.prefill(cfg, params,
                         {"tokens": torch.from_numpy(toks[:, :S])}, 96)
    assert cache[0]["k"].shape[1] == 64
    assert not bool(cache[0]["k"][:, S:64 - S].any())  # the reference's NaN
    got, _ = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, S]),
                           torch.full((1,), S, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _, full = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, 96)
    torch.testing.assert_close(got, full, **TOL)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(6)
    x = (3.0 * rng.standard_normal((2, 5, 96)) + 1.5).astype(np.float32)
    scale = (0.1 * rng.standard_normal(96)).astype(np.float32)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = layers.layernorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for kind in ("rms", "layer"):
        torch.testing.assert_close(
            layers.apply_norm(kind, torch.from_numpy(x),
                              torch.from_numpy(scale), 1e-6),
            torch.from_numpy(np.array(jlayers.apply_norm(
                kind, jnp.asarray(x), jnp.asarray(scale), 1e-6))),
            rtol=1e-5, atol=1e-5)
