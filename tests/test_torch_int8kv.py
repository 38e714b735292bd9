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


# ----------------------------------------------------------------------
# The decode step's write, fused into K3-int8's call: the plain path
# (``ref.decode_attention_int8_ref`` with the new token) against the
# reference's decode step on the same new token.
# ----------------------------------------------------------------------
def _one_hot_layer(seed, B):
    """One attention layer of reduced gemma3 (int8 cache, no RoPE, no
    bias) on both sides, and per-row inputs x = e_i: each side's
    projection of x is then row i of its weights, exactly, so both
    quantize the same new token."""
    jcfg = dataclasses.replace(_int8("gemma3-4b", True), use_rope=False)
    cfg = dataclasses.replace(_int8("gemma3-4b"), use_rope=False)
    H, KV, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.d_model
    rng = np.random.default_rng(seed)
    w = {k: (rng.standard_normal((D, n * hd)) * s).astype(np.float32)
         for k, n, s in (("wq", H, 0.5), ("wk", KV, 2.0), ("wv", KV, 1.0))}
    w["wo"] = (rng.standard_normal((H * hd, D)) * 0.1).astype(np.float32)
    x = np.zeros((B, 1, D), np.float32)
    x[np.arange(B), 0, rng.choice(D, B, replace=False)] = 1.0
    params = {"wqkv": torch.from_numpy(np.concatenate(
        [w["wq"], w["wk"], w["wv"]], axis=1)),
        "wo": torch.from_numpy(w["wo"])}
    return cfg, jcfg, params, {k: jnp.asarray(v) for k, v in w.items()}, x


@pytest.mark.parametrize("kind,C,pos", [
    ("attn", 64, [0, 17, 40, 63]),        # rows at different positions
    ("local", 64, [5, 30, 63, 20]),       # a ring before it wraps
    ("local", 64, [64, 100, 127, 200]),   # after the wrap
    ("local", 64, [3, 64, 90, 63])])      # both in one batch
def test_fused_plain_write_equals_reference(kind, C, pos):
    """The int8 bits and scales written at the new token's slot equal
    the reference's decode step's exactly, every other slot untouched,
    and the layer's output matches its ``decode_attention`` to 1e-4."""
    B = len(pos)
    cfg, jcfg, params, jparams, x = _one_hot_layer(7, B)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(8)
    cache = {"k": rng.integers(-127, 128, (B, C, KV, hd), dtype=np.int8),
             "v": rng.integers(-127, 128, (B, C, KV, hd), dtype=np.int8),
             "k_scale": rng.uniform(1e-3, 0.05, (B, C, KV)).astype(np.float32),
             "v_scale": rng.uniform(1e-3, 0.05, (B, C, KV)).astype(np.float32)}
    p = np.array(pos, np.int32)
    want, jcache = JA.decode_attention(
        jparams, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(x), jnp.asarray(p), jcfg, kind)
    got_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, out_cache = A.decode_attention(
        params, got_cache, torch.from_numpy(x), torch.from_numpy(p), None,
        cfg, kind)
    assert out_cache is got_cache
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got_cache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)
    slot = p % C if kind == "local" else p
    written = np.zeros((B, C), bool)
    written[np.arange(B), slot] = True
    assert (got_cache["k_scale"].numpy()[~written] ==
            cache["k_scale"][~written]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_plain_write_into_views():
    """``ref.decode_attention_int8_ref`` writes through the permuted and
    transposed views the model hands it, and only at each row's slot."""
    B, C, KV, G, hd = 3, 20, 2, 2, 16
    g = torch.Generator().manual_seed(0)
    base = {k: torch.randint(-127, 128, (B, C, KV, hd), generator=g,
                             dtype=torch.int8) for k in ("k", "v")}
    sc = {k: torch.rand(B, C, KV, generator=g) for k in ("ks", "vs")}
    keep = {k: t.clone() for k, t in {**base, **sc}.items()}
    q = torch.randn(B, KV, G, hd, generator=g)
    kn, vn = torch.randn(B, KV, hd, generator=g), torch.randn(B, KV, hd,
                                                              generator=g)
    slot = torch.tensor([0, 7, 19], dtype=torch.int32)
    ref.decode_attention_int8_ref(
        q, base["k"].permute(0, 2, 1, 3), base["v"].permute(0, 2, 1, 3),
        sc["ks"].transpose(1, 2), sc["vs"].transpose(1, 2),
        torch.tensor([5, 7, 19], dtype=torch.int32), k_new=kn, v_new=vn,
        slot=slot)
    rows = torch.arange(B)
    qk, sk = A.quantize_kv(kn)
    assert torch.equal(base["k"][rows, slot.long()], qk)
    assert torch.equal(sc["ks"][rows, slot.long()], sk)
    mask = torch.ones(B, C, dtype=torch.bool)
    mask[rows, slot.long()] = False
    assert torch.equal(base["v"][mask], keep["v"][mask])
    assert torch.equal(sc["vs"][mask], keep["vs"][mask])


# ----------------------------------------------------------------------
# The continuous batcher over an int8 cache (per-slot positions through
# the fused write).
# ----------------------------------------------------------------------
def _int8_batcher(max_slots, requests):
    from repro_torch.serving.batcher import ContinuousBatcher, GenRequest
    cfg = _int8("qwen2-1.5b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    eng = ContinuousBatcher(cfg, params, max_slots=max_slots, cache_len=48,
                            device="cpu")
    reqs = [GenRequest(rid=i, prompt=p, max_new=n)
            for i, (p, n) in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, reqs


def test_int8_batcher_equals_each_request_run_alone():
    """The port's batcher over reduced qwen2 with an int8 cache: 5
    requests on 2 slots (slots reused mid-run, rows at different
    positions in every batched step) give each request the tokens it
    gets run alone on one slot."""
    rng = np.random.default_rng(3)
    requests = [(i, (rng.integers(0, 500, n, dtype=np.int32), m))
                for i, (n, m) in enumerate(((5, 6), (17, 4), (9, 8),
                                            (30, 3), (2, 7)))]
    eng, reqs = _int8_batcher(2, requests)
    assert eng.n_steps > 0 and all(r.done for r in reqs)
    for (i, job), r in zip(requests, reqs):
        _, (alone,) = _int8_batcher(1, [(i, job)])
        assert r.generated == alone.generated, i
        assert len(r.generated) == job[1]


def test_reference_batcher_cannot_decode_an_int8_cache():
    """The reference's ``init_cache`` allocates every leaf in the
    activation dtype and drops the int8 spec's own dtype
    (``src/repro/models/model.py`` ``init_cache``), so its batcher's
    first decode step refuses to scatter the int8 prefill cache into a
    float32 pool (ROADMAP §C).  The port's batcher runs the same request
    (the test above)."""
    from repro.serving.batcher import ContinuousBatcher as JaxBatcher
    from repro.serving.batcher import GenRequest as JaxRequest
    jcfg = _int8("qwen2-1.5b", True)
    params = jax.tree.map(jnp.asarray, _perturbed_params(jcfg, seed=3))
    eng = JaxBatcher(jcfg, params, max_slots=2, cache_len=32)
    eng.submit(JaxRequest(rid=0, prompt=np.arange(5, dtype=np.int32),
                          max_new=3))
    with pytest.raises(TypeError, match="same dtypes"):
        for _ in range(10):
            if not eng.step():
                break
