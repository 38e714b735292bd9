"""The plain versions of the backward kernels against the reference's
autodiff, and the CPU path of the differentiable wrappers.

- ``flash_attention_bwd_ref`` (the FlashAttention-2 formulas over full
  score matrices, from ``flash_attention_lse_ref``'s log-sum-exp)
  against ``jax.grad`` of the reference's training attention,
  ``attention_full`` (causal, and unmasked with Sq ≠ Sk as whisper's
  cross-attention) and ``attention_windowed``, with GQA, in float32:
  dq, dk, dv to 2e-5 of each one's max |value| (summation orders
  differ; the reference's softmax is online and chunked).  The
  log-sum-exp against ``jax.nn.logsumexp`` of the masked scores to 2e-6.
- ``rglru_scan_bwd_ref`` against ``jax.grad`` of ``rglru_scan_xla``
  (its associative scan, and its blocked doubling scan at S = 1024, two
  blocks), float32, 2e-5 of max
  |value|.
- On the CPU, ``flash_attention_bwd`` and ``rglru_scan_bwd`` run their
  plain versions, and autograd of the wrappers gives the same gradients
  as the plain versions (torch alone, float64 inputs computed in fp32:
  order, 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_full, attention_windowed
from repro.models.rglru import rglru_scan_xla
from repro_torch.kernels import ops, ref

REL = 2e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, (err, scale)


def _inputs(B, H, KV, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # the reference's (B, S, heads, hd) layout
    return f(B, Sq, H, hd), f(B, Sk, KV, hd), f(B, Sk, KV, hd), f(B, Sq, H, hd)


def _reference_grads(q, k, v, do, causal, window):
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    qp = jnp.broadcast_to(jnp.arange(Sq), (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk), (B, Sk))

    def f(q, k, v):
        if window > 0:
            o = attention_windowed(q, k, v, qp, kp, window=window, q_chunk=8)
        else:
            o = attention_full(q, k, v, qp, kp, causal=causal, q_chunk=8,
                               kv_chunk=8)
        return jnp.sum(o * do), o

    (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (2, 4, 2, 24, 24, 16, True, 0),      # GQA, causal
    (1, 6, 1, 20, 20, 32, True, 0),      # one KV head (recurrentgemma)
    (2, 4, 4, 16, 16, 16, True, 0),      # G = 1
    (1, 4, 2, 24, 24, 16, True, 6),      # sliding window
    (2, 4, 2, 10, 22, 16, False, 0),     # unmasked, Sq ≠ Sk
])
def test_flash_attention_bwd_ref_matches_reference_grad(
        B, H, KV, Sq, Sk, hd, causal, window):
    q, k, v, do = _inputs(B, H, KV, Sq, Sk, hd, seed=Sq + hd)
    o_ref, (dq, dk, dv) = _reference_grads(q, k, v, do, causal, window)
    t = lambda x: torch.from_numpy(x).transpose(1, 2)
    tq, tk, tv, tdo = t(q), t(k), t(v), t(do)
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(o.transpose(1, 2), o_ref)
    lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                      window=window)
    s = jnp.einsum("bqhd,bkhd->bhqk", q,
                   np.repeat(k, H // KV, axis=2)) * hd ** -0.5
    qi, kj = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    _close(lse, jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1),
           rel=2e-6)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                      window=window)
    # the CPU path of the wrapper is the plain version
    same = ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                   window=window)
    for a, b, want in zip(got, same, (dq, dk, dv)):
        assert torch.equal(a, b)
        _close(a.transpose(1, 2), want)


@pytest.mark.parametrize("B,S,W", [(2, 9, 5), (1, 1024, 3)])
def test_rglru_scan_bwd_ref_matches_reference_grad(B, S, W):
    rng = np.random.default_rng(S)
    a = (0.98 / (1 + np.exp(-rng.standard_normal((B, S, W))))
         ).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, W))).astype(np.float32)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    h_ref, (da_ref, db_ref) = jax.value_and_grad(
        lambda a, b: jnp.sum(rglru_scan_xla(a, b) * dh), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb, tdh = (torch.from_numpy(x) for x in (a, b, dh))
    h = ref.rglru_scan_ref(ta, tb)
    da, db = ref.rglru_scan_bwd_ref(ta, h, tdh)
    _close(da, da_ref)
    _close(db, db_ref)
    same = ops.rglru_scan_bwd(ta, h, tdh)
    assert torch.equal(same[0], da) and torch.equal(same[1], db)


def test_cpu_autograd_of_the_wrappers_equals_the_plain_backward():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k, v = r(2, 4, 12, 16), r(2, 2, 12, 16), r(2, 2, 12, 16)
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ops.flash_attention(q, k, v, window=5)
    do = r(*o.shape)
    auto = torch.autograd.grad(o, (q, k, v), do)
    lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), v.detach(),
                                      window=5)
    plain = ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                    o.detach(), lse, do, window=5)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    a = (torch.rand(2, 30, 3, generator=g) * 0.9
         ).requires_grad_(True)
    b = r(2, 30, 3).requires_grad_(True)
    h = ops.rglru_scan(a, b)
    dh = r(*h.shape)
    auto = torch.autograd.grad(h, (a, b), dh)
    plain = ops.rglru_scan_bwd(a.detach(), h.detach(), dh)
    for x, y in zip(auto, plain):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)


# ----------------------------------------------------------------------
# K2-bwd's launch plan (``flash_attention.bwd_plan``): the launch takes
# its grids and scratch, and its tiles equal the kernels' own report
# (``flash_attention_bwd_plan``) on the card.
# ----------------------------------------------------------------------
from repro_torch.kernels import flash_attention as fa  # noqa: E402

H100_SMS = 132
TRAINING = {"qwen2": (4, 12, 2, 1024, 1024, 128),
            "recurrentgemma": (2, 10, 1, 1024, 1024, 256)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (4, 12, 2, 1024, 1024, 128), (2, 10, 1, 1024, 1024, 256),
    (1, 16, 1, 1024, 1024, 128), (1, 10, 1, 4096, 4096, 256),
    (2, 6, 6, 64, 1500, 64), (1, 4, 2, 1000, 1000, 128),
    (2, 4, 4, 77, 77, 32), (1, 2, 1, 40, 40, 16), (1, 4, 1, 300, 40, 256)])
def test_flash_bwd_plan_covers_keys_rows_and_heads_once(dtype, B, H, KV, Sq,
                                                        Sk, hd):
    """The dK/dV blocks cover every (batch, query head, key) once and the
    dQ blocks every (batch, head, q row) once, their warps' column groups
    every hd column once; the partials are (B, H, Sk, hd) fp32 for dK
    and dV when a KV head serves several query heads, and none
    otherwise."""
    p = fa.bwd_plan(B, H, KV, Sq, Sk, hd, dtype)
    assert p.splits * p.cols == hd and p.cols % 16 == 0
    assert p.threads == 32 * p.rows // 16 * p.splits
    seen = np.zeros((B, H, Sk), dtype=np.int64)
    for x in range(p.dkdv_grid[0]):
        b, h = divmod(x, H)
        for y in range(p.dkdv_grid[1]):
            seen[b, h, y * p.rows:min(Sk, (y + 1) * p.rows)] += 1
    assert (seen == 1).all()
    assert (p.dkdv_grid[1] - 1) * p.rows < Sk  # no empty key tile
    rows = np.zeros((B, H, Sq), dtype=np.int64)
    for x in range(p.dq_grid[0]):
        b, h = divmod(x, H)
        for y in range(p.dq_grid[1]):
            rows[b, h, y * p.rows:min(Sq, (y + 1) * p.rows)] += 1
    assert (rows == 1).all()
    assert p.scratch == (0 if H == KV else 2 * B * H * Sk * hd * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_bwd_plan_fits_shared_memory(dtype, hd):
    """A block of either kernel fits the SM's shared memory (two blocks an
    SM up to hd 128, where the fp32 walk is 16 rows); the walked tiles
    split into whole mma tiles (16 rows: a bf16 k-step, two fp32 ones).
    Registers and spills are ptxas's to report: ``chip_smoke.py`` holds
    them to its ``BWD_SPILLS`` on the card."""
    p = fa.bwd_plan(1, 1, 1, 64, 64, hd, dtype)
    assert p.smem <= fa.SMEM_LIMIT
    if hd <= 128:
        assert 2 * p.smem <= fa.SMEM_LIMIT
    assert p.rows == 16 * fa.BWD_WARPS
    assert p.threads == 32 * fa.BWD_WARPS * p.splits
    assert p.walk % 16 == 0 and p.cols % 16 == 0
    esize, pad = (4, 4) if dtype == torch.float32 else (2, 8)
    # a padded row starts on 16 bytes (cp.async) and is not a multiple
    # of 128 bytes (a warp's fragment reads fall in distinct banks)
    assert (hd + pad) * esize % 16 == 0 and (hd + pad) * esize % 128


@pytest.mark.parametrize("arch", sorted(TRAINING))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plan_fills_the_card_at_the_training_shapes(arch, dtype):
    """At both training shapes each kernel's grid holds at least two
    blocks an SM of the H100; qwen2's partials take about 50 MB."""
    B, H, KV, Sq, Sk, hd = TRAINING[arch]
    p = fa.bwd_plan(B, H, KV, Sq, Sk, hd, dtype)
    for grid in (p.dkdv_grid, p.dq_grid):
        assert grid[0] * grid[1] >= 2 * H100_SMS
    if arch == "qwen2":
        assert p.dkdv_grid == (48, 16) and p.scratch == 50331648
    else:  # hd 256: two warps of a block on each 16 rows
        assert p.dkdv_grid == p.dq_grid == (20, 16) and p.threads == 256
