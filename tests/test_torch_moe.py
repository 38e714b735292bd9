"""The port's mixture-of-experts feed-forward against the reference's
(``repro/models/moe.py``): reduced dbrx-132b and moonshot-v1-16b-a3b
(4 experts, top 2, groups of 32), the same numpy-seeded x and
parameters, capacity factors 8.0 (no drop), 1.25 and 0.5 (drops), with
T a multiple of the group, T padded to one, and T = 1 (a decode step of
batch 1).  fp32 on both sides; out and aux_loss to rtol/atol 1e-5, the
routing (each (token, k) entry's expert, its slot and whether it is
kept) exactly.

The reference's routing is read from its own calls to
``jax.nn.one_hot``: the first takes the top-k experts, the second the
slot positions (kept where below the capacity it is given).  Its
``moe.py:72`` passes a float ``pos`` to ``jax.nn.one_hot``, which warns;
the tests that call it ignore that DeprecationWarning.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.layers import materialize
from repro_torch.configs.registry import get_config
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)
ONE_HOT_FLOAT = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")


def _pair(arch, factor):
    """(reference cfg, port cfg) reduced, at capacity ``factor``."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=factor)),
            dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=factor)))


def _params(jcfg, seed=0):
    params = jax.tree.map(np.array, materialize(
        jmoe.moe_template(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    return params, {k: torch.from_numpy(np.array(v))
                    for k, v in params.items()}


def _reference(params_np, x, jcfg, monkeypatch):
    """(out, aux, top_idx, pos, capacity) of the reference's ``moe_ffn``,
    run eagerly with its ``one_hot`` calls recorded."""
    calls = []
    one_hot = jax.nn.one_hot

    def recording(v, n, **kw):
        calls.append((np.asarray(v), n))
        return one_hot(v, n, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", recording)
    out, aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params_np),
                            jnp.asarray(x), jcfg)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot)
    (idx, _), (pos, C) = calls
    return np.asarray(out), float(aux), idx, pos, C


SHAPES = {"group multiple": (2, 32), "padded": (3, 15), "T=1": (1, 1)}


@ONE_HOT_FLOAT
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("factor", [8.0, 1.25, 0.5])
@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_moe_ffn_matches_reference(arch, factor, shape, monkeypatch):
    jcfg, cfg = _pair(arch, factor)
    params_np, params = _params(jcfg)
    B, S = SHAPES[shape]
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    out, aux, idx, pos, C = _reference(params_np, x, jcfg, monkeypatch)

    r = moe.moe_route(params["router"], torch.from_numpy(x), cfg)
    assert r.capacity == C
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), pos < C)
    got, got_aux = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), out, **TOL)
    np.testing.assert_allclose(float(got_aux), aux, **TOL)
    T = B * S
    dropped = int((~r.keep.reshape(-1, cfg.moe.top_k)[:T]).sum())
    if factor == 8.0 or shape == "T=1":
        assert dropped == 0
    elif factor == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_moe_ffn_without_drops_equals_the_dense_oracle(arch):
    jcfg, cfg = _pair(arch, 8.0)
    _, params = _params(jcfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 15, cfg.d_model)).astype(np.float32))
    r = moe.moe_route(params["router"], x, cfg)
    assert bool(r.keep.all())
    got, aux = moe.moe_ffn(params, x, cfg)
    np.testing.assert_allclose(got.numpy(),
                               moe.moe_ffn_dense_eval(params, x, cfg).numpy(),
                               **TOL)
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_dense_oracle_matches_reference(arch):
    jcfg, cfg = _pair(arch, 1.25)
    params_np, params = _params(jcfg, seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want = jmoe.moe_ffn_dense_eval(jax.tree.map(jnp.asarray, params_np),
                                   jnp.asarray(x), jcfg)
    got = moe.moe_ffn_dense_eval(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_given_routing_replaces_the_inputs_own():
    """``moe_ffn`` under another input's routing: the routing's experts
    and slots, this input's values — equal to ``moe_apply``."""
    jcfg, cfg = _pair("moonshot-v1-16b-a3b", 1.25)
    _, params = _params(jcfg, seed=4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    y = x + 0.5 * torch.from_numpy(rng.standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    r = moe.moe_route(params["router"], x, cfg)
    out, aux = moe.moe_ffn(params, y, cfg, r)
    torch.testing.assert_close(out, moe.moe_apply(params, y, r, cfg),
                               rtol=0, atol=0)
    assert float(aux) == float(r.aux)
    own = moe.moe_route(params["router"], y, cfg)
    assert bool((own.idx != r.idx).any())


def test_pad_tokens_tie_to_the_lowest_experts():
    """A zero pad token's gates are all equal; like ``lax.top_k`` the
    port takes the lowest experts, which the aux loss counts."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router = torch.randn(cfg.d_model, cfg.moe.n_experts,
                         generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 3, cfg.d_model)
    x[0, 0] = 1.0
    r = moe.moe_route(router, x, cfg)
    assert r.idx.shape == (1, 3, cfg.moe.top_k)
    assert r.idx[0, 1:].tolist() == [[0, 1], [0, 1]]
    np.testing.assert_allclose(r.gate[0, 1:].numpy(), 0.5, rtol=0, atol=0)
