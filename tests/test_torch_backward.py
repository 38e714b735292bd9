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
