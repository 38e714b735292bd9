"""The port's Mamba-2 SSD path against the reference.

- The plain SSD scan (what ``ops.ssd_scan`` runs for a CPU tensor, and
  what the kernel is held against on the card) against the Pallas
  ``_ssd_kernel`` in interpret mode and the jnp oracle, at several chunk
  counts and G in {1, 2}; its final state against
  ``ssd_chunked(..., return_final_state=True)``, ragged S included.
  Tolerances are ``tests/test_kernels.py``'s: 2e-5 in f32 and 2e-2 in
  bf16, relative to max |y|.
- The reduced mamba2-1.3b (S = 40 over chunks of 32, so the last chunk
  is ragged), with the reference's parameters carried across by
  ``from_jax_params``: prefill and four greedy decode steps against
  ``repro.models.model`` in f32 within rtol/atol 1e-4 on logits and
  caches, greedy tokens exactly.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.ssm import ssd_chunked
from repro_torch.configs.base import SSMConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import SMEM_LIMIT, smem_bytes
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),
              "bf16": dict(rtol=2e-2, atol=2e-2)}
# zero-initialised leaves of both families, perturbed so their paths
# are exercised too
ZERO_INIT = ("scale", "conv_x_b", "conv_B_b", "conv_C_b", "dt_bias",
             "norm_z", "conv_b", "b_inp", "b_rec")


def _inputs(seed, B, H, G, S, hd, N):
    """SSD inputs as test_kernels.py draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, hd)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S))))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, G, S, N)) * 0.3
    Cm = rng.standard_normal((B, G, S, N)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _pair(arrays, dtype):
    """The arrays as jnp and torch values; A stays float32 on both."""
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    j = [jnp.asarray(a).astype(jd) for a in arrays]
    t = [torch.from_numpy(np.array(a)).to(td) for a in arrays]
    j[2], t[2] = jnp.asarray(arrays[2]), torch.from_numpy(arrays[2])
    return j, t


def _close_scaled(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", [
    (1, 2, 1, 64, 16, 16, 32),     # two chunks
    (2, 4, 2, 96, 16, 16, 32),     # three chunks, two groups
    (1, 4, 2, 128, 32, 64, 64),    # two chunks, two groups
    (1, 2, 1, 64, 16, 32, 64),     # one chunk
])
def test_ssd_plain_matches_pallas(dtype, B, H, G, S, hd, N, chunk):
    j, t = _pair(_inputs(S + N, B, H, G, S, hd, N), dtype)
    y, state = ops.ssd_scan(*t, chunk=chunk)
    assert y.dtype == t[0].dtype and state.dtype == torch.float32
    assert state.shape == (B, H, hd, N)
    tol = KERNEL_TOL[dtype]
    _close_scaled(y.float().numpy(), jops.ssd_scan(*j, chunk=chunk), tol)
    _close_scaled(y.float().numpy(), jref.ssd_scan_ref(*j), tol)


@pytest.mark.parametrize("S,chunk", [(64, 32), (40, 32), (77, 16)])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_final_state_matches_chunked(S, chunk, G):
    """y and the final state against the reference's chunked XLA path,
    ragged S (padded there with dt = 0) included."""
    B, H, hd, N = 2, 4, 16, 16
    x, dt, A, Bm, Cm = _inputs(S * G, B, H, G, S, hd, N)
    y_ref, st_ref = ssd_chunked(
        jnp.asarray(x.transpose(0, 2, 1, 3)),
        jnp.asarray(dt.transpose(0, 2, 1)), jnp.asarray(A),
        jnp.asarray(Bm.transpose(0, 2, 1, 3)),
        jnp.asarray(Cm.transpose(0, 2, 1, 3)), chunk,
        return_final_state=True)
    y, state = ops.ssd_scan(*[torch.from_numpy(a) for a in
                              (x, dt, A, Bm, Cm)], chunk=chunk)
    tol = KERNEL_TOL["f32"]
    _close_scaled(y.numpy(), np.asarray(y_ref).transpose(0, 2, 1, 3), tol)
    _close_scaled(state.numpy(), st_ref, tol)


def test_ssd_takes_the_models_strided_views():
    """The model hands (B,S,H,hd), (B,S,H) and (B,S,G,N) activations as
    transposed views; the result equals that of contiguous copies."""
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in
                        _inputs(3, 2, 4, 2, 24, 16, 8)]
    views = (x.transpose(1, 2).contiguous().transpose(1, 2),
             dt.transpose(1, 2).contiguous().transpose(1, 2), A,
             Bm.transpose(1, 2).contiguous().transpose(1, 2),
             Cm.transpose(1, 2).contiguous().transpose(1, 2))
    assert not views[0].is_contiguous()
    for got, want in zip(ops.ssd_scan(*views, chunk=8),
                         ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["meta", "f16", "dt64", "a_bf16", "hd48",
                                  "groups", "shape", "stride", "chunk0",
                                  "smem"])
def test_ssd_wrapper_raises(case):
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in
                        _inputs(0, 1, 2, 1, 8, 16, 8)]
    kw = {}
    if case == "meta":
        x, dt, A, Bm, Cm = [a.to("meta") for a in (x, dt, A, Bm, Cm)]
    elif case == "f16":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif case == "dt64":
        dt = dt.double()
    elif case == "a_bf16":
        A = A.to(torch.bfloat16)
    elif case == "hd48":
        x = torch.zeros(1, 2, 8, 48)
    elif case == "groups":
        Bm, Cm = torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 8, 8)
    elif case == "shape":
        dt = dt[:, :, :7]
    elif case == "stride":
        x = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    elif case == "chunk0":
        kw = dict(chunk=0)
    else:  # a state too wide for one block's shared memory
        x, Bm, Cm = (torch.zeros(1, 2, 8, 128), torch.zeros(1, 1, 8, 512),
                     torch.zeros(1, 1, 8, 512))
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_scan(x, dt, A, Bm, Cm, **kw)


# (hd, N, chunk, S) of every SSD scan the tests on the card run
CARD_SHAPES = [(64, 128, 256, 128), (64, 128, 256, 600), (16, 16, 32, 96),
               (16, 16, 32, 40), (128, 64, 64, 130), (32, 32, 100, 70),
               (64, 128, 256, 257), (16, 16, 256, 50), (32, 32, 64, 75),
               (128, 24, 128, 600)]
SM_SHARED = 233_472  # bytes of shared memory an H100 SM holds for blocks


def test_ssd_smem_fits_two_blocks_at_the_serve_shape():
    """The bf16 kernel at mamba2-1.3b's serve shape (hd 64, N 128, chunk
    256 over S 128, and S past a chunk) leaves room for two blocks an SM
    (each also reserves 1 KB); every shape of the configs and the card's
    tests fits one block in both types."""
    s = get_config("mamba2-1.3b").ssm
    for cs in (128, s.chunk_size):
        assert 2 * (smem_bytes(s.head_dim, s.d_state, cs) + 1024) <= SM_SHARED
    shapes = [(c.head_dim, c.d_state, c.chunk_size, c.chunk_size)
              for c in (s, get_config("mamba2-1.3b").scaled(0.5).ssm,
                        get_config("mamba2-1.3b").reduced().ssm)]
    for hd, N, chunk, S in shapes + CARD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            assert smem_bytes(hd, N, min(chunk, S), dtype) <= SMEM_LIMIT


def test_ssd_takes_misaligned_views_on_the_cpu():
    """Rows that do not start on 16 bytes are refused only on the card:
    the plain path takes any view."""
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in
                        _inputs(5, 1, 2, 1, 24, 16, 16)]
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    wide = torch.zeros(1, 1, 24, 17, dtype=torch.bfloat16)
    wide[..., 1:] = Bm
    views = (x, dt, A, wide[..., 1:], Cm)
    assert views[3].data_ptr() % 16
    for got, want in zip(ops.ssd_scan(*views, chunk=8),
                         ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ----------------------------------------------------------------------
# The reduced model against the reference model
# ----------------------------------------------------------------------
def perturbed_params(cfg, seed=0):
    """The reference's parameters as numpy, with the zero-initialised
    leaves perturbed."""
    params = jax.tree.map(np.array,
                          JM.init_params(cfg, jax.random.PRNGKey(seed),
                                         jnp.float32))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif key in ZERO_INIT:
                tree[key] = (val + 0.1 * rng.standard_normal(val.shape)
                             ).astype(np.float32)
    perturb(params)
    return params


def check_caches(cfg, cache, jcache):
    """The port's per-layer caches against the reference's stacked
    superblock and tail caches; an SSD layer's conv history is the
    reference's x | B | C histories side by side."""
    pat = len(cfg.pattern)
    for i, kind in enumerate(cfg.block_kinds):
        if i < cfg.n_superblocks * pat:
            jc = {k: np.asarray(v[i // pat])
                  for k, v in jcache["blocks"][f"p{i % pat}"].items()}
        else:
            jc = {k: np.asarray(v) for k, v in
                  jcache["tail"][f"t{i - cfg.n_superblocks * pat}"].items()}
        if kind == "ssd":
            jc = {"state": jc["state"],
                  "conv": np.concatenate([jc[k] for k in "xBC"], -1)}
        assert set(cache[i]) == set(jc), (i, kind)
        for key, want in jc.items():
            np.testing.assert_allclose(cache[i][key].numpy(), want, **TOL,
                                       err_msg=f"layer {i} {kind} {key}")


@pytest.mark.parametrize("groups", [1, 2])
def test_reduced_mamba2_prefill_and_decode_match_reference(groups):
    jcfg = jax_config("mamba2-1.3b").reduced()
    cfg = get_config("mamba2-1.3b").reduced()
    if groups != 1:
        from repro.configs.base import SSMConfig as JSSMConfig
        jcfg = replace(jcfg, ssm=JSSMConfig(d_state=16, head_dim=16,
                                            chunk_size=32, n_groups=groups))
        cfg = replace(cfg, ssm=SSMConfig(d_state=16, head_dim=16,
                                         chunk_size=32, n_groups=groups))
    assert cfg.ssm.chunk_size == 32 and cfg.block_kinds == ("ssd", "ssd")
    params_np = perturbed_params(jcfg, seed=groups)
    params = from_jax_params(cfg, params_np, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params_np)
    B, S, cache_len, steps = 2, 40, 48, 4
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


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_configs_match_reference(arch):
    for w in (0.5, 1.0):
        for a, b in ((jax_config(arch).scaled(w), get_config(arch).scaled(w)),
                     (jax_config(arch).reduced(), get_config(arch).reduced())):
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab_size", "resolved_head_dim", "padded_vocab",
                      "window", "mlp", "embed_scale", "quality",
                      "block_kinds", "n_superblocks", "tail_kinds"):
                assert getattr(a, f) == getattr(b, f), (arch, w, f)
            for sub in ("ssm", "rglru"):
                ja, pb = getattr(a, sub), getattr(b, sub)
                assert (ja is None) == (pb is None)
                if ja is not None:
                    assert vars(ja) == vars(pb), (arch, w, sub)
