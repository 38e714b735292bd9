"""The port's hand-written kernels against their plain versions on the
card.  Every test here needs an NVIDIA GPU and the CUDA toolkit; they are
marked ``cuda`` and skip elsewhere.  This file imports no JAX, so it runs
on a machine with only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol/rtol 2e-5 (summation order only), bfloat16
1e-2 (about one bf16 rounding of values up to 2); stage-3 probabilities
exactly and picks exactly (same operations in the same order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, policy_select, ref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (4, 12, 2, 128, 128, 0), (4, 12, 2, 200, 128, 0), (2, 12, 2, 144, 64, 0),
    (1, 4, 2, 77, 32, 0), (2, 4, 1, 130, 16, 0), (1, 8, 4, 300, 64, 50),
    (1, 2, 2, 40, 256, 0)])
def test_flash_kernel_matches_plain(gen, dtype, B, H, KV, S, hd, window):
    q = _randn(gen, B, S, H, hd, dtype=dtype).transpose(1, 2)
    k = _randn(gen, B, S, KV, hd, dtype=dtype).transpose(1, 2)
    v = _randn(gen, B, S, KV, hd, dtype=dtype).transpose(1, 2)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(
        out, ref.flash_attention_ref(q, k, v, causal=True, window=window),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,C,hd,window", [
    (4, 2, 6, 144, 128, 0), (4, 2, 6, 144, 64, 0), (3, 2, 2, 100, 32, 0),
    (2, 1, 8, 300, 256, 40), (2, 2, 3, 50, 16, 0)])
def test_decode_kernel_matches_plain(gen, dtype, B, KV, G, C, hd, window):
    # q as the model hands it: a view into the fused projection output
    q = _randn(gen, B, KV, G + 2, hd, dtype=dtype)[:, :, 1:G + 1]
    k = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    v = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    pos = torch.randint(C // 2, C, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = ops.decode_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.decode_attention_ref(q, k, v, pos, window=window),
        **TOL[dtype])


@pytest.mark.parametrize("n", [2, 3, 8])
def test_stage3_kernel_matches_plain_bit_for_bit(gen, n):
    rng = np.random.default_rng(n)
    mu, sig = rng.uniform(5, 60, n), rng.uniform(0, 5, n)
    acc = rng.uniform(0.3, 0.9, n)
    pool = policy_select.DevicePool(mu, sig, acc,
                                    np.argsort(-acc, kind="stable"),
                                    int(np.argmin(mu)), device="cuda")
    t_u = torch.tensor(rng.uniform(0, 90, 8192), dtype=torch.float32,
                       device="cuda")
    t_l = t_u - 25.0
    _, _, elig = policy_select._stages12(pool.mu, pool.sigma, pool.rank,
                                         t_u, t_l)
    args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, elig.float())
    assert torch.equal(ops.modipick_probs(*args), ref.policy_probs_ref(*args))
    r01 = torch.rand(8192, generator=gen, device="cuda")
    picks = [policy_select._fused_select(pool.mu, pool.sigma, pool.acc,
                                         pool.rank, t_u, t_l, r01, gamma=1.0,
                                         stage3=s3)
             for s3 in (ops.modipick_probs, ref.policy_probs_ref)]
    assert torch.equal(*picks)


def test_wrappers_raise_on_cuda_tensors_they_do_not_take(gen):
    q = torch.zeros(1, 4, 8, 32, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    qd = torch.zeros(1, 2, 2, 32, device="cuda")
    k = torch.zeros(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError):
        ops.decode_attention(qd, k, k, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.modipick_probs(*(torch.ones(3, device="cuda", dtype=torch.float64),) * 3,
                           torch.ones(4, device="cuda"),
                           torch.ones(4, device="cuda"),
                           torch.ones(4, 3, device="cuda"))
