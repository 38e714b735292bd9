"""The port's dense decoder against the reference model: reduced
qwen2-1.5b in float32, the reference's parameters carried across with
``from_jax_params``, the same tokens through ``prefill`` and four greedy
``decode_step``s.  Tolerance rtol/atol 1e-4 on logits and caches (fp32
on both sides; matmul and softmax summation orders differ); greedy
tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.pool import Variant, scaled_family

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed_params(cfg, seed=0):
    """Reference parameters as numpy, with the zero-initialised biases
    and norm scales perturbed so those paths are exercised too."""
    params = jax.tree.map(np.array,
                          JM.init_params(cfg, jax.random.PRNGKey(seed),
                                         jnp.float32))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif key in ("bq", "bk", "bv", "scale"):
                tree[key] = (val + 0.1 * rng.standard_normal(val.shape)
                             ).astype(np.float32)
    perturb(params)
    return params


@pytest.fixture(scope="module")
def reduced_pair():
    jcfg = jax_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    params_np = _perturbed_params(jcfg)
    return jcfg, cfg, params_np, from_jax_params(cfg, params_np,
                                                 device="cpu")


def test_config_matches_reference():
    for w in (0.5, 1.0):
        a = jax_config("qwen2-1.5b").scaled(w)
        b = get_config("qwen2-1.5b").scaled(w)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "resolved_head_dim", "padded_vocab",
                  "rope_theta", "qkv_bias", "quality"):
            assert getattr(a, f) == getattr(b, f), f
    full = get_config("qwen2-1.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.padded_vocab) == \
        (28, 1536, 12, 2, 128, 8960, 152_064)


def test_prefill_and_greedy_decode_match_reference(reduced_pair):
    jcfg, cfg, params_np, params = reduced_pair
    B, S, cache_len, steps = 2, 12, 28, 4
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jcache, jlogits = JM.prefill(jcfg, jparams,
                                 {"tokens": jnp.asarray(tokens)}, cache_len)
    cache, logits = M.prefill(cfg, params, torch.from_numpy(tokens),
                              cache_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(cfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                cache[i][kv].numpy(),
                np.asarray(jcache["blocks"]["p0"][kv][i]), **TOL)

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
    for i in range(cfg.n_layers):
        np.testing.assert_allclose(
            cache[i]["k"].numpy(), np.asarray(jcache["blocks"]["p0"]["k"][i]),
            **TOL)


def test_padded_vocab_is_masked_as_the_reference_masks_it():
    from dataclasses import replace
    jcfg = replace(jax_config("qwen2-1.5b").reduced(), vocab_size=500)
    cfg = replace(get_config("qwen2-1.5b").reduced(), vocab_size=500)
    params_np = _perturbed_params(jcfg, seed=3)
    x = np.random.default_rng(3).standard_normal((2, 1, cfg.d_model))
    x = x.astype(np.float32)
    expect = JM.unembed(jcfg, jax.tree.map(jnp.asarray, params_np),
                        jnp.asarray(x))
    got = M.unembed(cfg, from_jax_params(cfg, params_np, device="cpu"),
                    torch.from_numpy(x))
    assert got.shape == (2, 1, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    assert float(got[..., 500:].max()) == pytest.approx(-1e30)


def test_from_jax_params_copies(reduced_pair):
    _, cfg, params_np, params = reduced_pair
    table = params_np["embed"]["table"]
    assert params["embed"].data_ptr() != table.ctypes.data
    np.testing.assert_array_equal(params["embed"].numpy(), table)
    np.testing.assert_array_equal(params["layers"][1]["mlp"]["wg"].numpy(),
                                  params_np["blocks"]["p0"]["mlp"]["wg"][1])


def test_variant_runs_on_cpu_when_asked():
    pool = scaled_family(get_config("qwen2-1.5b"), widths=(0.5, 1.0),
                         cache_len=20, device="cpu")
    assert [v.cfg.resolved_head_dim for v in pool] == [16, 32]
    tokens = np.random.default_rng(0).integers(0, 500, (2, 8),
                                               dtype=np.int32)
    for v in pool:
        assert v.run(tokens, n_decode=2) > 0.0


def test_entry_points_need_a_card_unless_asked_for_cpu(reduced_pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, cfg, params_np, _ = reduced_pair
    gen = torch.Generator()
    v = Variant("x", cfg, 0.5)
    for call in (lambda: scaled_family(get_config("qwen2-1.5b"),
                                       widths=(0.5,)),
                 lambda: M.init_cache(cfg, 1, 8),
                 lambda: M.init_params(cfg, gen),
                 lambda: v.build(gen),
                 lambda: from_jax_params(cfg, params_np)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert v.params is None
    built = v.build(gen, device="cpu")
    assert built.device.type == "cpu"
    assert built.params["embed"].dtype == torch.bfloat16


def test_generator_must_live_on_the_parameters_device():
    from types import SimpleNamespace
    cfg = get_config("qwen2-1.5b").reduced()
    card_gen = SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="generator lives on cuda:0"):
        M.init_params(cfg, card_gen, device="cpu")


def test_unsupported_configs_raise():
    from dataclasses import replace
    cfg = get_config("qwen2-1.5b").reduced()
    for bad in (dict(kv_cache_dtype="int8"), dict(family="moe"),
                dict(pattern=("attn", "local"))):
        with pytest.raises(NotImplementedError):
            M.init_params(replace(cfg, **bad), torch.Generator(),
                          device="cpu")
