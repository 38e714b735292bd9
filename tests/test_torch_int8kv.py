"""The int8 KV cache (``kv_cache_dtype="int8"``) against the reference.

- ``quantize_kv`` gives the reference's ``_quantize_kv`` int8 bits
  exactly (x / scale in fp32, rounded half to even, ties included) and
  its scales to 1 ulp; ``dequantize_kv`` its ``_dequantize_kv`` exactly
  in float32 and bfloat16.
- ``prefill_cache`` on the same k/v gives the reference's leaves
  exactly: the padded ``attn`` cache and a ``local`` ring, gathered and
  padded.
- A whole prefill on the reference's parameters (reduced qwen2 and
  gemma3 in float32, carried across by ``from_jax_params``): logits to
  rtol/atol 1e-4, scales to 1e-4, the int8 leaves within one step (the
  k/v projections sum in another order, and a value on a rounding
  boundary may round the other way).
- Decode logits for ``attn`` (qwen2) and ``local`` (gemma3 at 64 slots,
  where the reference pads its ring; see ROADMAP §C for the NaN of its
  gathered ring) match the reference to 1e-4 over three greedy steps,
  each side from the reference's prefill cache.
- ``ref.decode_attention_int8_ref`` equals the reference's dequantize
  and einsums (``models/attention.py`` ``decode_attention``) in float32,
  with a window and without.
- The reference's own bound (``tests/test_models.py``
  ``test_int8_kv_cache_decode_close_to_bf16``): a decode step on the
  int8 cache within 5e-2 of max |logit| of the full forward, on the
  port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ref
from repro_torch.models import api
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from test_torch_model import _perturbed_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _int8(arch, jax_side=False):
    cfg = (jax_config if jax_side else get_config)(arch).reduced()
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


def _rows(seed, shape):
    """Rows of assorted magnitudes, and one row of exact ties: its max is
    127, so scale = 1 and x / scale lands on .5 (half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 30, shape[:-1] + (1,))
    x = x.astype(np.float32)
    ties = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                    np.float32)
    x.reshape(-1, shape[-1])[0, :8] = ties
    x.reshape(-1, shape[-1])[0, 8:] = 0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bits_equal_reference(dtype):
    x = _rows(0, (4, 33, 2, 32))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JA._quantize_kv(jx)
    q, s = A.quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert list(q.numpy().reshape(-1, 32)[0, :8]) == [127, 0, 2, 2, 0, -2,
                                                      -2, 126]
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    for out in (torch.float32, torch.bfloat16):
        want = JA._dequantize_kv(jq, js, jnp.dtype(str(out)[6:]))
        got = A.dequantize_kv(q, torch.from_numpy(np.array(js)), out)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("kind,S,cache_len", [
    ("attn", 40, 64), ("local", 100, 128), ("local", 40, 64)])
def test_prefill_cache_leaves_equal_reference(kind, S, cache_len):
    """On the same k/v: the padded global cache, a local ring gathered
    from a prompt longer than the window (64), and a local cache padded
    where the window covers every slot."""
    jcfg, cfg = _int8("gemma3-4b", True), _int8("gemma3-4b")
    k, v = _rows(1, (2, S, 2, 32)), _rows(2, (2, S, 2, 32))
    want = JA.prefill_cache(jcfg, kind, jnp.asarray(k), jnp.asarray(v),
                            cache_len)
    got = A.prefill_cache(cfg, kind, torch.from_numpy(k),
                          torch.from_numpy(v), cache_len)
    assert set(got) == {"k", "v", "k_scale", "v_scale"}
    for key in ("k", "v"):
        assert got[key].dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_max_ulp(got[key].numpy(),
                                        np.asarray(want[key]), maxulp=1)


def _layer_caches(cfg, jcache):
    """The reference's stacked superblock and tail caches, layer by
    layer, as numpy."""
    pat, out = len(cfg.pattern), []
    for i in range(cfg.n_layers):
        if i < cfg.n_superblocks * pat:
            c = {k: np.asarray(v[i // pat])
                 for k, v in jcache["blocks"][f"p{i % pat}"].items()}
        else:
            c = {k: np.asarray(v) for k, v in
                 jcache["tail"][f"t{i - cfg.n_superblocks * pat}"].items()}
        out.append(c)
    return out


@pytest.fixture(scope="module", params=["qwen2-1.5b", "gemma3-4b"])
def prefilled(request):
    """Both sides' prefill of a 40-token prompt into 64 slots on the
    reference's parameters."""
    arch = request.param
    jcfg, cfg = _int8(arch, True), _int8(arch)
    params_np = _perturbed_params(jcfg, seed=3)
    params = from_jax_params(cfg, params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    B, S, cache_len = 2, 40, 64
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jcache, jlogits = JM.prefill(jcfg, jparams,
                                 {"tokens": jnp.asarray(tokens)}, cache_len)
    cache, logits = M.prefill(cfg, params,
                              {"tokens": torch.from_numpy(tokens)}, cache_len)
    return dict(cfg=cfg, jcfg=jcfg, params=params, jparams=jparams, S=S,
                jcache=jcache, jlogits=jlogits, cache=cache, logits=logits)


def test_prefill_matches_reference(prefilled):
    f = prefilled
    np.testing.assert_allclose(f["logits"].numpy(), np.asarray(f["jlogits"]),
                               **TOL)
    for got, want in zip(f["cache"], _layer_caches(f["cfg"], f["jcache"])):
        assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
        for key in ("k", "v"):
            assert got[key].dtype == torch.int8
            step = np.abs(got[key].numpy().astype(np.int32)
                          - want[key].astype(np.int32))
            assert step.max() <= 1 and step.mean() < 1e-3, key
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


def test_decode_matches_reference(prefilled):
    """Three greedy steps, each side from the reference's prefill cache
    (so that a prefill value rounded the other way does not enter)."""
    f = prefilled
    cfg, jcfg, B = f["cfg"], f["jcfg"], f["logits"].shape[0]
    jcache = f["jcache"]
    cache = [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
             for c in _layer_caches(cfg, jcache)]
    jtok = jnp.argmax(f["jlogits"], axis=-1).astype(jnp.int32)
    tok = torch.from_numpy(np.array(jtok))
    for i in range(3):
        p = f["S"] + i
        jlogits, jcache = JM.decode_step(jcfg, f["jparams"], jcache, jtok,
                                         jnp.full((B,), p, jnp.int32))
        logits, cache = M.decode_step(cfg, f["params"], cache, tok,
                                      torch.full((B,), p, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("window", [0, 20])
def test_int8_plain_version_equals_reference_math(window):
    """The reference's int8 decode after the write: dequantize the cache
    to the activation dtype, scores in fp32, the valid mask, softmax,
    P·V (``models/attention.py`` ``decode_attention``)."""
    rng = np.random.default_rng(4)
    B, C, KV, G, hd = 3, 50, 2, 3, 32
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, C, KV, hd), dtype=np.int8)
    v8 = rng.integers(-127, 128, (B, C, KV, hd), dtype=np.int8)
    ks = rng.uniform(1e-3, 0.05, (B, C, KV)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (B, C, KV)).astype(np.float32)
    pos = np.array([0, 25, C - 1], np.int32)

    new_k = JA._dequantize_kv(jnp.asarray(k8), jnp.asarray(ks), jnp.float32)
    new_v = JA._dequantize_kv(jnp.asarray(v8), jnp.asarray(vs), jnp.float32)
    slots = jnp.arange(C)[None, :]
    p_ = jnp.asarray(pos)[:, None]
    valid = (slots >= 0) & (slots <= p_) & (
        slots > p_ - (window if window else C + 1))
    s = jnp.einsum("bngh,bknh->bngk", jnp.asarray(q), new_k,
                   preferred_element_type=jnp.float32) * hd ** -0.5
    s = jnp.where(valid[:, None, None, :], s, JA.NEG_INF)
    want = jnp.einsum("bngk,bknh->bngh", jax.nn.softmax(s, axis=-1), new_v)

    perm = lambda a: torch.from_numpy(a).transpose(1, 2)  # (B,KV,C,...)
    got = ref.decode_attention_int8_ref(
        torch.from_numpy(q), perm(k8), perm(v8), perm(ks), perm(vs),
        torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_decode_close_to_full_forward():
    """The reference's own bound, on the port: int8 decode of token S
    against a full prefill of S + 1, 5e-2 of max |logit|."""
    cfg = _int8("qwen2-1.5b")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen, torch.float32, device="cpu")
    B, S = 2, 37
    full = api.make_train_batch(cfg, ShapeConfig("x", S + 1, B, "prefill"),
                                gen, device="cpu")
    toks = full["tokens"]
    cache, _ = M.prefill(cfg, params, {"tokens": toks[:, :S]}, 64)
    assert {c["k"].dtype for c in cache} == {torch.int8}
    dec, _ = M.decode_step(cfg, params, cache, toks[:, S],
                           torch.full((B,), S, dtype=torch.int32))
    _, want = M.prefill(cfg, params, full, 64)
    rel = float((dec - want).abs().max() / (want.abs().max() + 1e-9))
    assert rel < 5e-2, rel
    bf16 = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    cache, _ = M.prefill(bf16, params, {"tokens": toks[:, :S]}, 64)
    exact, _ = M.decode_step(bf16, params, cache, toks[:, S],
                             torch.full((B,), S, dtype=torch.int32))
    torch.testing.assert_close(exact, want, **TOL)
    assert float((dec - exact).abs().max()) > 0  # the cache was quantized
