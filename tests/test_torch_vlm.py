"""internvl2-2b, the VLM, against the reference.

- The config equals the reference's, field for field and in
  ``param_count()``, at full width, widths 0.5 and 1.0, and reduced.
- On the reduced config in float32 with a vocabulary of 500 (padded to
  512, so the padded logits are masked), the reference's parameters
  carried across by ``from_jax_params`` (norm scales and ``lm_head``
  perturbed) and numpy-seeded image embeddings placed before the text:
  the prefill logits and caches over ``n_img + S`` positions, and two
  greedy decode steps at ``pos = S + n_img`` onwards, match the
  reference to rtol/atol 1e-4 (fp32 on both sides), greedy tokens
  exactly; the padded logits are −1e30 on both sides.
- A prefill of S and a decode of token S give the logits of a prefill
  of S + 1 over the same image (the port alone).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from test_torch_archs import _perturbed_params
from test_torch_encdec import assert_config_matches
from test_torch_ssm import check_caches

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "internvl2-2b"


def test_config_matches_reference():
    assert_config_matches(ARCH)
    full = get_config(ARCH)
    assert full.vlm.n_image_tokens == 256 and not full.tie_embeddings
    assert full.padded_vocab == 92_672 > full.vocab_size


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "image_embeds": rng.standard_normal(
                (B, cfg.vlm.n_image_tokens, cfg.d_model)).astype(np.float32)}


def test_prefill_and_greedy_decode_match_reference():
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), vocab_size=500)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=500)
    params_np = _perturbed_params(jcfg)
    params = from_jax_params(cfg, params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    B, S, cache_len, steps = 2, 20, 48, 2
    n_img = cfg.vlm.n_image_tokens
    batch = _batch(cfg, B, S, 1)
    jcache, jlogits = JM.prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len)
    cache, logits = M.prefill(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        cache_len)
    assert logits.shape == (B, 512)
    assert (logits[:, 500:] == -1e30).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    check_caches(cfg, cache, jcache)
    # the image's n_img positions and the text's S are in the cache
    assert cache[0]["k"][:, S + n_img - 1].abs().sum() > 0
    assert not cache[0]["k"][:, S + n_img:].any()

    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        p = S + n_img + i
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jtok,
                                         jnp.full((B,), p, jnp.int32))
        logits, cache = M.decode_step(cfg, params, cache, tok,
                                      torch.full((B,), p, dtype=torch.int32))
        assert (logits[:, 500:] == -1e30).all()
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        tok = torch.argmax(logits, dim=-1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    check_caches(cfg, cache, jcache)


def test_decode_matches_a_longer_prefill():
    """Prefill of S text tokens after the image + a decode of token S at
    pos = S + n_img ≡ prefill of S + 1."""
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    B, S, cache_len = 2, 37, 64
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S + 1,
                                                       2).items()}
    toks = batch["tokens"]
    cache, _ = M.prefill(cfg, params, dict(batch, tokens=toks[:, :S]),
                         cache_len)
    pos = torch.full((B,), S + cfg.vlm.n_image_tokens, dtype=torch.int32)
    step, _ = M.decode_step(cfg, params, cache, toks[:, S], pos)
    _, full = M.prefill(cfg, params, batch, cache_len)
    torch.testing.assert_close(step, full, **TOL)
