"""The port's RG-LRU and local-attention paths against the reference.

- The plain RG-LRU scan (what ``ops.rglru_scan`` runs for a CPU tensor,
  and what the kernel is held against on the card) against the Pallas
  ``_rglru_kernel`` in interpret mode and the jnp oracle; ragged S (which
  the Pallas wrapper refuses) against the oracle.  Tolerances are
  ``tests/test_kernels.py``'s: 2e-5 in f32, 2e-2 in bf16.
- A local layer's ring cache: decode steps that cross the wrap, against
  the reference's ``decode_attention(kind="local")`` — the check of
  calling the decode kernel with pos_eff = min(pos, C − 1) and no window.
- The reduced recurrentgemma-2b with 8 layers (two (rglru, rglru, local)
  superblocks and a two-layer rglru tail), window 64, a prompt of 80 and
  cache_len 96, so the local ring is gathered in prefill and written
  round in decode: prefill and four greedy decode steps against
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
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import (MAX_SEGMENTS, REG_STEPS,
                                            WARPS_PER_SM, segment_plan)
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import rope_tables
from repro_torch.serving.pool import scaled_family
from test_torch_ssm import check_caches, perturbed_params

TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),
              "bf16": dict(rtol=2e-2, atol=2e-2)}


def _ab(seed, B, S, W, dtype):
    """a in (0, 0.98) and b as test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    a = 0.98 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W)) * 0.1
    out = []
    for x in (a, b):
        x = x.astype(np.float32)
        j, t = jnp.asarray(x), torch.from_numpy(x)
        if dtype == "bf16":
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        out.append((j, t))
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,block", [
    (1, 128, 64, 32),
    (2, 256, 128, 64),
    (2, 512, 256, 256),
])
def test_rglru_plain_matches_pallas(dtype, B, S, W, block):
    (ja, ta), (jb, tb) = _ab(S + W, B, S, W, dtype)
    h = ops.rglru_scan(ta, tb)
    assert h.dtype == ta.dtype and h.shape == (B, S, W)
    _close(h, jops.rglru_scan(ja, jb, block_s=block), dtype)
    _close(h, jref.rglru_scan_ref(ja, jb), dtype)


@pytest.mark.parametrize("S", [1, 77, 300])
def test_rglru_ragged_matches_oracle(S):
    (ja, ta), (jb, tb) = _ab(S, 2, S, 40, "f32")
    _close(ops.rglru_scan(ta, tb), jref.rglru_scan_ref(ja, jb), "f32")
    # a view with W contiguous inside wider rows is read through strides
    wide = torch.cat([ta, ta], dim=2)[:, :, :40]
    _close(ops.rglru_scan(wide, tb), jref.rglru_scan_ref(ja, jb), "f32")


@pytest.mark.parametrize("case", ["meta", "f16", "mixed", "shape", "rank",
                                  "stride"])
def test_rglru_wrapper_raises(case):
    a, b = torch.zeros(2, 8, 16), torch.zeros(2, 8, 16)
    if case == "meta":
        a, b = a.to("meta"), b.to("meta")
    elif case == "f16":
        a, b = a.half(), b.half()
    elif case == "mixed":
        b = b.to(torch.bfloat16)
    elif case == "shape":
        b = b[:, :7]
    elif case == "rank":
        a, b = a[0], b[0]
    else:
        a = torch.zeros(2, 16, 8).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan(a, b)


@pytest.mark.parametrize("B,W,sms", [(4, 2560, 132), (1, 7, 132),
                                    (2, 300, 132), (4, 2560, 8)])
def test_segment_plan_covers_s(B, W, sms):
    """For every S from 1 to 5000 the segments cover S exactly, none is
    empty, and a block holds at most MAX_SEGMENTS of them; a segment
    fits in registers where S allows, and the grid reaches WARPS_PER_SM
    unless the segments are as short as a block allows."""
    warps_a_row = B * -(-W // 32)
    for S in range(1, 5001):
        seg, n = segment_plan(B, S, W, sms)
        assert 1 <= n <= min(MAX_SEGMENTS, S)
        assert (n - 1) * seg < S <= n * seg
        if S <= MAX_SEGMENTS * REG_STEPS:
            assert seg <= REG_STEPS
        if warps_a_row * n < WARPS_PER_SM * sms:
            assert seg == -(-S // MAX_SEGMENTS)
    # recurrentgemma-2b at the server's shape: 8 segments of 16
    assert segment_plan(4, 128, 2560) == (16, 8)
    assert 4 * 2560 // 32 * 8 >= WARPS_PER_SM * 132


# ----------------------------------------------------------------------
# Local attention: the ring cache and the decode kernel's pos_eff
# ----------------------------------------------------------------------
def _hybrid_pair(n_layers=8, window=64, seed=0):
    jcfg = replace(jax_config("recurrentgemma-2b").reduced(),
                   n_layers=n_layers, window=window)
    cfg = replace(get_config("recurrentgemma-2b").reduced(),
                  n_layers=n_layers, window=window)
    params_np = perturbed_params(jcfg, seed)
    return jcfg, cfg, params_np, from_jax_params(cfg, params_np,
                                                 device="cpu")


@pytest.mark.parametrize("S,cache_len,window", [
    (50, 96, 64),    # ring: prompt shorter than the window, wraps at 64
    (80, 96, 64),    # ring gathered in prefill, written round in decode
    (30, 48, 64),    # window ≥ cache_len: a plain, padded cache
])
def test_local_decode_over_the_ring_matches_reference(S, cache_len, window):
    jcfg, cfg, params_np, params = _hybrid_pair(window=window)
    i = cfg.block_kinds.index("local")
    jp = jax.tree.map(lambda a: jnp.asarray(a[i // 3]),
                      params_np["blocks"][f"p{i % 3}"])["attn"]
    p = params["layers"][i]
    B, D = 2, cfg.d_model
    rng = np.random.default_rng(S)
    xs = rng.standard_normal((B, S, D)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S))
    _, jc = JA.prefill_attention(jp, jnp.asarray(xs), jnp.asarray(positions),
                                 jcfg, "local", cache_len=cache_len)
    _, c = A.prefill_attention(
        p, torch.from_numpy(xs),
        rope_tables(torch.from_numpy(np.array(positions)), cfg.rope_theta,
                    cfg.resolved_head_dim), cfg, "local", cache_len=cache_len)
    assert c["k"].shape[1] == min(window, cache_len)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), **TOL)
    for step in range(cache_len - S):
        pos = np.full((B,), S + step, np.int32)
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        jout, jc = JA.decode_attention(jp, jc, jnp.asarray(x),
                                       jnp.asarray(pos), jcfg, "local")
        tpos = torch.from_numpy(pos)
        out, c = A.decode_attention(
            p, c, torch.from_numpy(x), tpos,
            rope_tables(tpos[:, None], cfg.rope_theta,
                        cfg.resolved_head_dim), cfg, "local")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(c["v"].numpy(), np.asarray(jc["v"]), **TOL)


# ----------------------------------------------------------------------
# The reduced model against the reference model
# ----------------------------------------------------------------------
def test_reduced_recurrentgemma_prefill_and_decode_match_reference():
    jcfg, cfg, params_np, params = _hybrid_pair(n_layers=8)
    assert cfg.tail_kinds == ("rglru", "rglru") and cfg.n_superblocks == 2
    B, S, cache_len, steps = 2, 80, 96, 4
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, params_np)
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
def test_new_families_serve_on_cpu(arch, capsys):
    """The server path of the reduced families: Variant.run over caches
    that are not a KV list, and the launcher with ``--device cpu``."""
    pool = scaled_family(get_config(arch), widths=(0.5, 1.0), cache_len=24,
                         device="cpu")
    tokens = np.random.default_rng(0).integers(0, 500, (2, 8),
                                               dtype=np.int32)
    ops.reset_launch_counts()
    for v in pool:
        assert v.run(tokens, n_decode=2) > 0.0
    assert set(ops.launch_counts().values()) == {0}
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--widths", "0.5", "--batch", "1", "--seq", "8"])
    assert '"n": 2' in capsys.readouterr().out


# ----------------------------------------------------------------------
# K5-bwd's chunk plan (``rglru_scan.bwd_plan``)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 7, 16, 17, 77, 255, 256, 257, 1000, 1024,
                               2048, 3000, 4096, 5000, 16384])
def test_rglru_bwd_plan_covers_s_once_in_registers(S):
    """The backward's segments cover [0, S) once, in chunks none of which
    is empty; a segment fits the registers a thread holds (``BWD_STEPS``
    steps) and a chunk is one block (``BWD_SEGMENTS`` segments); the
    forward's plan is untouched."""
    from repro_torch.kernels.rglru_scan import (BWD_SEGMENTS, BWD_STEPS,
                                                bwd_plan)
    seg, n_seg, n_chunk = bwd_plan(S)
    assert 1 <= seg <= BWD_STEPS and 1 <= n_seg <= BWD_SEGMENTS
    hit = np.zeros(S, dtype=np.int64)
    for c in range(n_chunk):
        lo = c * n_seg * seg
        assert lo < S  # no empty chunk
        for sg in range(n_seg):
            s0 = lo + sg * seg
            hit[s0:min(S, s0 + seg)] += 1
    assert (hit == 1).all()
    # as long as a block holds: a chain of ceil(S / 192) chunks
    assert n_chunk == -(-S // (BWD_SEGMENTS * BWD_STEPS))
    assert segment_plan(4, 128, 2560) == (16, 8)


def test_rglru_bwd_plan_fills_the_card_at_the_training_shape():
    """recurrentgemma-2b's training shape (B 2, S 1024, W 2560): 160
    channel groups × 6 chunks of 176 steps (16 segments of 11) = 960
    blocks of 512 threads, more than 2 an SM; the scratch is a ticket,
    then a flag and 32 carries a block."""
    from repro_torch.kernels.rglru_scan import (BWD_SEGMENTS, CHANNELS,
                                                bwd_plan, bwd_scratch_words)
    seg, n_seg, n_chunk = bwd_plan(1024)
    assert (seg, n_seg, n_chunk) == (11, 16, 6)
    blocks = 2 * 2560 // CHANNELS * n_chunk
    assert blocks == 960 and blocks >= 2 * 132
    assert CHANNELS * BWD_SEGMENTS == 512
    assert bwd_scratch_words(2, 1024, 2560) == 1 + 960 * 33
