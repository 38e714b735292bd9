"""The port's kernel modules against the reference: the plain PyTorch
version behind each wrapper (what a CPU tensor runs) against the
reference's Pallas kernels in interpret mode and against its jnp
oracles, on the same inputs made from a numpy seed.

Tolerances: float32 rtol/atol 2e-5 (both sides compute in fp32; only
summation order differs), bfloat16 2e-2 (one bf16 rounding of the
output); masks and picks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (MAX_SPLIT, MAX_SPLIT_INT8,
                                                  TILE, TILE_INT8,
                                                  WAVE_TILES, split_plan,
                                                  split_plan_int8)
from repro_torch.kernels.flash_attention import check_aligned
from repro_torch.kernels.policy_select import (MAX_SMEM,
                                               SELECT_FILL_WARPS,
                                               SELECT_LANE_SLOTS,
                                               SELECT_WARPS, DevicePool,
                                               _fused_select,
                                               masks_device, max_pool,
                                               probs_plan, select_plan)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _pair(x: np.ndarray, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.float32)
    t = torch.from_numpy(np.array(x, np.float32))
    if dtype == "bf16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(port, expect, dtype):
    np.testing.assert_allclose(
        port.to(torch.float32).numpy(), np.asarray(expect, np.float32),
        **(BF16_TOL if dtype == "bf16" else F32_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (1, 4, 2, 128, 32, 0),      # GQA causal
    (2, 4, 1, 128, 16, 32),     # MQA sliding window
])
def test_flash_plain_matches_pallas(dtype, B, H, KV, S, hd, window):
    rng = np.random.default_rng(0)
    q, tq = _pair(rng.standard_normal((B, H, S, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    expect = jops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=64, block_k=64)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(out, expect, dtype)


@pytest.mark.parametrize("S,window", [(77, 0), (144, 0), (200, 0),
                                      (130, 40)])
def test_flash_ragged_matches_oracle(S, window):
    """Lengths the Pallas kernel's block asserts refuse (the server's
    144, the smoke's 200) against the jnp oracle."""
    rng = np.random.default_rng(S)
    B, H, KV, hd = 2, 6, 2, 32
    q, tq = _pair(rng.standard_normal((B, H, S, hd)), "f32")
    k, tk = _pair(rng.standard_normal((B, KV, S, hd)), "f32")
    v, tv = _pair(rng.standard_normal((B, KV, S, hd)), "f32")
    expect = jref.flash_attention_ref(q, k, v, causal=True, window=window)
    _close(ops.flash_attention(tq, tk, tv, causal=True, window=window),
           expect, "f32")


def test_flash_takes_strided_views():
    """The model hands (B,S,H,hd) activations as transposed views."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 40, 6, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    got = ops.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                              kv.transpose(1, 2))
    want = ops.flash_attention(x.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,KV,G,S,hd,window", [
    (2, 2, 2, 128, 32, 0),
    (3, 2, 3, 128, 16, 48),
])
def test_decode_plain_matches_pallas(dtype, B, KV, G, S, hd, window):
    rng = np.random.default_rng(2)
    q, tq = _pair(rng.standard_normal((B, KV, G, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    pos = rng.integers(1, S, B).astype(np.int32)
    expect = jops.decode_attention(q, k, v, jnp.asarray(pos), window=window,
                                   block_k=64)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                               window=window)
    _close(out, expect, dtype)


def test_decode_ragged_cache_matches_oracle():
    """The server's cache of 144 slots, read through the model's
    (B, C, KV, hd) layout, with pos in [128, 143]."""
    rng = np.random.default_rng(3)
    B, KV, G, C, hd = 4, 2, 6, 144, 32
    q, tq = _pair(rng.standard_normal((B, KV, G, hd)), "f32")
    cache_k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    cache_v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    pos = rng.integers(128, 144, B).astype(np.int32)
    expect = jref.decode_attention_ref(
        q, jnp.asarray(cache_k.transpose(0, 2, 1, 3)),
        jnp.asarray(cache_v.transpose(0, 2, 1, 3)), jnp.asarray(pos))
    out = ops.decode_attention(
        tq, torch.from_numpy(cache_k).permute(0, 2, 1, 3),
        torch.from_numpy(cache_v).permute(0, 2, 1, 3), torch.from_numpy(pos))
    _close(out, expect, "f32")


def _pool_arrays(rng, n):
    mu = rng.uniform(5.0, 60.0, n).astype(np.float32)
    sig = rng.uniform(0.0, 6.0, n).astype(np.float32)
    acc = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return mu, sig, acc


@pytest.mark.parametrize("n,gamma", [(2, 1.0), (3, 1.0), (8, 2.0),
                                     (200, 1.0)])
def test_probs_plain_matches_pallas(n, gamma):
    rng = np.random.default_rng(n)
    B = 300
    mu, sig, acc = _pool_arrays(rng, n)
    t_u = rng.uniform(-5.0, 90.0, B).astype(np.float32)
    t_l = (t_u - 25.0).astype(np.float32)
    elig = (rng.random((B, n)) > 0.4).astype(np.float32)
    elig[:5] = 0.0                     # rows with no eligible model
    t_u[5:9] = mu.min() - 50.0         # negative mass: uniform fallback
    t_l[5:9] = t_u[5:9] - 25.0
    args = (mu, sig, acc, t_u, t_l, elig)
    expect = jops.modipick_probs(*map(jnp.asarray, args), gamma=gamma)
    oracle = jref.policy_probs_ref(*map(jnp.asarray, args), gamma=gamma)
    out = ops.modipick_probs(*(torch.from_numpy(a) for a in args),
                             gamma=gamma)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **F32_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **F32_TOL)


def _jax_pool(mu, sig, acc):
    from repro.kernels.policy_select import DevicePool as JaxPool
    order = np.argsort(-acc, kind="stable")
    return JaxPool(mu, sig, acc, order, int(np.argmin(mu))), order


def test_masks_match_oracle_and_numpy_reference():
    from repro.core.policy_vec import modipick_masks
    from repro.core.profiles import ModelProfile, ProfileStore
    rng = np.random.default_rng(7)
    n, B = 5, 257
    mu, sig, acc = _pool_arrays(rng, n)
    t_u = rng.uniform(0.0, 90.0, B).astype(np.float32)
    t_l = t_u - 20.0
    jpool, order = _jax_pool(mu, sig, acc)
    rank = np.asarray(jpool.rank)
    jb, jh, je = jref.modipick_masks_ref(jnp.asarray(mu), jnp.asarray(sig),
                                         jnp.asarray(rank), jnp.asarray(t_u),
                                         jnp.asarray(t_l))
    pool = DevicePool(mu, sig, acc, order, int(np.argmin(mu)), device="cpu")
    base, has, elig = masks_device(pool, t_u, t_l)
    np.testing.assert_array_equal(has, np.asarray(jh))
    np.testing.assert_array_equal(base[has], np.asarray(jb)[has])
    np.testing.assert_array_equal(elig, np.asarray(je))
    # and the host numpy stages 1-2 (float64 table from the same values)
    store = ProfileStore([ModelProfile(f"m{i}", float(a), mu=float(m),
                                       var=float(s) ** 2)
                          for i, (m, s, a) in enumerate(zip(mu, sig, acc))])
    nb, nh, ne, _ = modipick_masks(store.table(), t_u.astype(np.float64),
                                   t_l.astype(np.float64))
    np.testing.assert_array_equal(has, nh)
    np.testing.assert_array_equal(elig, ne)


@pytest.mark.parametrize("n,seed,gamma", [(3, 11, 1.0), (6, 12345, 1.0),
                                          (4, 7, 2.0), (129, 5, 1.0),
                                          (200, 6, 1.0)])
def test_fused_select_picks_equal_reference(n, seed, gamma):
    """Fed the reference's own uniforms, the port's stages 1-3 and draw
    pick exactly what the reference's ``_fused_select`` picks, also for
    pools wider than the reference's 128 lanes."""
    from repro.kernels.policy_select import _fused_select as jax_fused
    rng = np.random.default_rng(seed)
    bpad = 512
    mu, sig, acc = _pool_arrays(rng, n)
    t_u = rng.uniform(0.0, 90.0, bpad).astype(np.float32)
    t_l = t_u - 25.0
    jpool, order = _jax_pool(mu, sig, acc)
    expect = jax_fused(jpool.mu, jpool.sigma, jpool.acc, jpool.rank,
                       jnp.asarray(t_u), jnp.asarray(t_l), np.uint32(seed),
                       gamma=gamma, block_b=256, use_pallas=False)
    r01 = jax.random.uniform(jax.random.PRNGKey(seed), (bpad,),
                             dtype=jnp.float32)
    pool = DevicePool(mu, sig, acc, order, int(np.argmin(mu)), device="cpu")
    got = _fused_select(pool.mu, pool.sigma, pool.acc, pool.rank,
                        torch.from_numpy(t_u), torch.from_numpy(t_l),
                        torch.from_numpy(np.array(r01)), gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    assert (got.numpy() >= 0).any() and (got.numpy() < 0).any()


# ----------------------------------------------------------------------
# The wrappers refuse what the kernels do not take, on every device.
# ----------------------------------------------------------------------
def _attn_args(dtype=torch.float32, device="cpu"):
    q = torch.zeros(1, 4, 8, 32, dtype=dtype, device=device)
    k = torch.zeros(1, 2, 8, 32, dtype=dtype, device=device)
    return q, k, k.clone()


@pytest.mark.parametrize("case", ["meta", "f16", "f64", "hd48", "heads",
                                  "stride", "window"])
def test_flash_wrapper_raises(case):
    q, k, v = _attn_args()
    kw = {}
    if case == "meta":
        q, k, v = _attn_args(device="meta")
    elif case in ("f16", "f64"):
        dt = torch.float16 if case == "f16" else torch.float64
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    elif case == "hd48":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif case == "heads":
        q = torch.zeros(1, 3, 8, 32)
    elif case == "stride":
        q = torch.zeros(1, 4, 32, 8).transpose(2, 3)
    else:
        kw = dict(window=-1)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", ["meta", "bf16_mixed", "pos64", "group0",
                                  "q_strided"])
def test_decode_wrapper_raises(case):
    q = torch.zeros(2, 2, 3, 32)
    k = torch.zeros(2, 2, 16, 32)
    pos = torch.zeros(2, dtype=torch.int32)
    if case == "meta":
        q, k, pos = q.to("meta"), k.to("meta"), pos.to("meta")
    elif case == "bf16_mixed":
        q = q.to(torch.bfloat16)
    elif case == "pos64":
        pos = pos.to(torch.int64)
    elif case == "group0":
        q = torch.zeros(2, 2, 0, 32)
    else:
        q = torch.zeros(2, 2, 32, 3).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q, k, k, pos)


@pytest.mark.parametrize("case", ["meta", "f64", "shape"])
def test_probs_wrapper_raises(case):
    B, n = 4, 3
    args = [torch.zeros(n), torch.zeros(n), torch.ones(n), torch.ones(B),
            torch.ones(B), torch.ones(B, n)]
    if case == "meta":
        args = [a.to("meta") for a in args]
    elif case == "f64":
        args[3] = args[3].double()
    else:
        args[0] = torch.zeros(n + 1)
    with pytest.raises((ValueError, TypeError)):
        ops.modipick_probs(*args)


def _stacked_args(P=2, n=3, B=4):
    return [torch.ones(P, n), torch.ones(P, n), torch.ones(n), torch.ones(n),
            torch.zeros(B, dtype=torch.int32), torch.ones(B), torch.ones(B),
            torch.ones(B)]


@pytest.mark.parametrize("case", ["mu_1d", "row_int64", "row_length",
                                  "acc_shape", "rank_per_row_only",
                                  "shifts_shape", "float64", "no_rows"])
def test_stacked_wrapper_raises(case):
    """The stacked selection's wrapper refuses what its kernel does not
    take, on the CPU as on the card."""
    args, kw = _stacked_args(), {}
    if case == "mu_1d":
        args[0] = torch.ones(3)
    elif case == "row_int64":
        args[4] = torch.zeros(4, dtype=torch.int64)
    elif case == "row_length":
        args[4] = torch.zeros(5, dtype=torch.int32)
    elif case == "acc_shape":
        args[2] = torch.ones(3, 3)
    elif case == "rank_per_row_only":
        args[3] = torch.ones(2, 3)
    elif case == "shifts_shape":
        kw["shifts"] = torch.ones(4)
    elif case == "float64":
        args[5] = torch.ones(4, dtype=torch.float64)
    else:
        args = _stacked_args(P=0)
    with pytest.raises((ValueError, TypeError)):
        ops.stacked_select(*args, **kw)


# ----------------------------------------------------------------------
# The selection kernels' launch plans: the Python mirrors of the
# kernel's own (``chip_smoke.py`` and tests/test_torch_cuda.py hold the
# two equal on the card), and no cap on the plain path.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,n,lanes,slots,warps,blocks", [
    (200, 11, 16, 1, 4, 25),        # the engine's burst: 25 SMs
    (8192, 2, 2, 1, 4, 128),        # select_batch's operands
    (100_000, 3, 1, 3, 4, 782),     # fills the card a lane a request
    (100_000, 11, 4, 3, 4, 3125),
    (1, 1, 1, 1, 1, 1),
    (7, 33, 32, 2, 4, 2),
    (200, 4096, 32, 128, 2, 100)])  # two warps' state fill a block
def test_select_plan_at_known_shapes(B, n, lanes, slots, warps, blocks):
    plan = select_plan(B, n)
    assert (plan["lanes"], plan["slots"], plan["warps"], plan["blocks"]) \
        == (lanes, slots, warps, blocks)
    assert plan["requests_per_warp"] * lanes == 32


@pytest.mark.parametrize("n", [1, 3, 16, 17, 33, 129, 4096, 9664])
@pytest.mark.parametrize("B", [1, 7, 200, 8192, 100_000])
def test_select_plan_covers_the_batch(B, n):
    plan = select_plan(B, n)
    lanes, per = plan["lanes"], plan["requests_per_warp"]
    widest = 1 << (min(n, 32) - 1).bit_length()
    assert lanes * per == 32 and lanes <= widest
    assert plan["slots"] == -(-n // lanes)
    if lanes < widest:      # fewer lanes only where the batch fills the card
        assert -(-B // per) >= SELECT_FILL_WARPS
        assert plan["slots"] <= SELECT_LANE_SLOTS
    per_block = plan["warps"] * per
    assert (plan["blocks"] - 1) * per_block < B <= plan["blocks"] * per_block
    assert 1 <= plan["warps"] <= SELECT_WARPS
    assert 0 < plan["smem"] <= MAX_SMEM


def test_max_pool_takes_4096_models_and_stops_where_a_block_is_full():
    most = max_pool("select")
    assert most >= 4096
    assert select_plan(1, most)["warps"] == 1
    assert select_plan(1, most + 1)["warps"] == 0
    most = max_pool("probs")
    assert most >= 4096
    assert probs_plan(1, most)["rows"] >= 1
    assert probs_plan(1, most + 1)["rows"] == 0
    # K1 keeps its 64-row blocks in the default 48 KB up to 128 models
    assert probs_plan(8192, 128) == dict(rows=64, blocks=128, smem=34_560)
    assert probs_plan(8192, 200)["rows"] == 64


def test_cpu_path_takes_a_pool_wider_than_any_block():
    """The plain versions have no cap: a pool one model past what a
    block on the card holds runs on the CPU."""
    rng = np.random.default_rng(2)
    B = 6
    for kernel in ("select", "probs"):
        n = max_pool(kernel) + 1
        mu, sig, acc = (torch.from_numpy(a) for a in _pool_arrays(rng, n))
        rank = torch.from_numpy(np.argsort(np.argsort(-acc.numpy()))
                                .astype(np.float32))
        t_u = torch.full((B,), 70.0)
        t_l = t_u - 25.0
        r01 = torch.linspace(0.0, 0.9, B)
        if kernel == "probs":
            out = ops.modipick_probs(mu, sig, acc, t_u, t_l, torch.ones(B, n))
            assert out.shape == (B, n)
            torch.testing.assert_close(out.sum(1), torch.ones(B))
            continue
        picks = ops.fused_select(mu, sig, acc, rank, t_u, t_l, r01)
        sp, has = ops.stacked_select(mu[None], sig[None], acc, rank,
                                     torch.zeros(B, dtype=torch.int32), t_u,
                                     t_l, r01)
        assert (picks >= 0).all() and torch.equal(sp, picks) and has.all()


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    q, k, v = _attn_args()
    ops.flash_attention(q, k, v)
    ops.decode_attention(q.reshape(1, 2, 16, 32)[:, :, :2].contiguous(),
                         k, v, torch.zeros(1, dtype=torch.int32))
    ops.decode_attention_int8(
        q.reshape(1, 2, 16, 32)[:, :, :2].contiguous(),
        k.to(torch.int8), v.to(torch.int8), k[..., 0], v[..., 0],
        torch.zeros(1, dtype=torch.int32))
    ops.ssd_scan(torch.zeros(1, 2, 5, 16), torch.zeros(1, 2, 5),
                 torch.zeros(2), torch.zeros(1, 1, 5, 8),
                 torch.zeros(1, 1, 5, 8))
    ops.rglru_scan(torch.zeros(1, 5, 8), torch.zeros(1, 5, 8))
    pool, rows = torch.ones(3), torch.ones(4)
    ops.modipick_probs(pool, pool, pool, rows, rows, torch.ones(4, 3))
    ops.fused_select(pool, pool, pool, pool, rows, rows, rows)
    ops.charged_select(pool, pool, pool, pool, pool,
                       torch.ones(3, 2, dtype=torch.bool), torch.ones(2),
                       torch.zeros(2), rows, rows, rows, rows)
    ops.stacked_select(torch.ones(2, 3), torch.ones(2, 3), pool, pool,
                       torch.zeros(4, dtype=torch.int32), rows, rows, rows)
    ops.flash_attention_bwd(q, k, v, q, torch.zeros(1, 4, 8), q)
    a = torch.zeros(1, 5, 8)
    ops.rglru_scan_bwd(a, a, a)
    ssd = (torch.zeros(1, 2, 5, 16), torch.zeros(1, 2, 5), torch.zeros(2),
           torch.zeros(1, 1, 5, 8), torch.zeros(1, 1, 5, 8))
    ops.ssd_scan_bwd(*ssd, torch.zeros(1, 2, 5, 16), chunk=4)
    # under grad the CPU path is the plain version's own autograd
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*leaves).sum().backward()
    ops.rglru_scan(a.clone().requires_grad_(), a).sum().backward()
    ops.ssd_scan(*(t.clone().requires_grad_() for t in ssd))[0].sum(
        ).backward()
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0,
                                   "decode_attention_int8": 0,
                                   "ssd_scan": 0, "rglru_scan": 0,
                                   "modipick_probs": 0, "fused_select": 0,
                                   "charged_select": 0, "stacked_select": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan_bwd": 0, "ssd_scan_bwd": 0}


def test_plain_versions_are_the_reference_twins():
    """ref.* on random shapes against the jnp oracles."""
    rng = np.random.default_rng(5)
    q, tq = _pair(rng.standard_normal((1, 4, 33, 16)), "f32")
    k, tk = _pair(rng.standard_normal((1, 2, 33, 16)), "f32")
    _close(ref.flash_attention_ref(tq, tk, tk, causal=False),
           jref.flash_attention_ref(q, k, k, causal=False), "f32")
    pos = np.array([20], np.int32)
    qd, tqd = _pair(rng.standard_normal((1, 2, 2, 16)), "f32")
    _close(ref.decode_attention_ref(tqd, tk, tk, torch.from_numpy(pos),
                                    window=8),
           jref.decode_attention_ref(qd, k, k, jnp.asarray(pos), window=8),
           "f32")


@pytest.mark.parametrize("B,KV,C,sms", [
    (4, 2, 144, 132),      # qwen2 at the server's shape
    (4, 1, 144, 132),      # recurrentgemma's local layers
    (2, 1, 300, 132),
    (1, 1, 1, 132),
    (64, 8, 144, 132),     # enough (batch, KV head) pairs: no split
    (1, 1, 100_000, 132),  # a long cache: MAX_SPLIT chunks
    (3, 2, 50, 16),
])
def test_decode_split_plan_covers_the_cache(B, KV, C, sms):
    """Each slot lies in exactly one chunk, no chunk is empty, chunks are
    whole tiles, and the blocks cover the SMs where the cache allows."""
    chunk, n_split = split_plan(B, KV, C, sms)
    tiles = -(-C // TILE)
    assert chunk % TILE == 0 and 1 <= n_split <= MAX_SPLIT
    assert (n_split - 1) * chunk < C <= n_split * chunk
    assert B * KV * n_split >= sms or n_split == min(tiles, MAX_SPLIT)
    if (B, KV, C) in ((4, 2, 144), (4, 1, 144)):
        assert n_split > 1


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True), ("model_q_view", True), ("permuted_cache", True),
    ("f32_hd4", True), ("single_row", True), ("dropped_first", False),
    ("odd_offset", False), ("odd_row_stride", False)])
def test_check_aligned(case, ok):
    """Rows must start on 16 bytes: the model's views pass, a view that
    drops a row's first element does not."""
    bf = torch.bfloat16
    if case == "contiguous":
        t = torch.zeros(2, 2, 3, 64, dtype=bf)
    elif case == "model_q_view":  # (B, 1, H + 2 KV, hd) → (B, KV, G, hd)
        t = torch.zeros(2, 1, 14, 128, dtype=bf)[:, :, :12].reshape(2, 2, 6,
                                                                    128)
    elif case == "permuted_cache":
        t = torch.zeros(2, 144, 2, 128, dtype=bf).permute(0, 2, 1, 3)
    elif case == "f32_hd4":
        t = torch.zeros(2, 3, 8, 4)
    elif case == "single_row":  # a length-1 dimension's stride is unused
        t = torch.zeros(64, dtype=bf).as_strided((1, 2, 1, 8), (3, 16, 5, 1))
    elif case == "dropped_first":
        t = torch.zeros(2, 2, 3, 33, dtype=bf)[..., 1:]
    elif case == "odd_offset":
        t = torch.zeros(2 * 2 * 3 * 64 + 1, dtype=bf)[1:].view(2, 2, 3, 64)
    else:
        t = torch.zeros(2, 1, 3, 68, dtype=bf)[..., :64]
    good = torch.zeros(1, 1, 2, 8, dtype=t.dtype)
    if ok:
        check_aligned("kernel", good, t, good)
    else:
        with pytest.raises(ValueError, match="k on 16 bytes"):
            check_aligned("kernel", good, t, good)


def _grad_inputs(name):
    """(wrapper, args, kwargs) at a small shape on the CPU, with the
    floating inputs the plain version differentiates requiring grad."""
    r = lambda *shape: torch.rand(*shape).requires_grad_()
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)
    if name == "flash_attention":
        return ops.flash_attention, (r(1, 2, 8, 32), r(1, 2, 8, 32),
                                     r(1, 2, 8, 32)), {}
    if name == "decode_attention":
        return ops.decode_attention, (r(1, 2, 2, 32), r(1, 2, 8, 32),
                                      r(1, 2, 8, 32), i32(5)), {}
    if name == "decode_attention_int8":
        k8 = torch.ones(1, 2, 8, 32, dtype=torch.int8)
        return ops.decode_attention_int8, (
            r(1, 2, 2, 32), k8, k8.clone(), torch.ones(1, 2, 8),
            torch.ones(1, 2, 8), i32(5)), dict(k_new=torch.rand(1, 2, 32),
                                               v_new=torch.rand(1, 2, 32),
                                               slot=i32(5))
    if name == "ssd_scan":
        return ops.ssd_scan, (r(1, 2, 8, 16), r(1, 2, 8), -r(2),
                              r(1, 1, 8, 16), r(1, 1, 8, 16)), {}
    if name == "rglru_scan":
        return ops.rglru_scan, (r(1, 8, 16), r(1, 8, 16)), {}
    return ops.modipick_probs, (r(3), r(3), r(3), r(4) * 90, r(4) * 60,
                                torch.ones(4, 3)), {}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_int8", "ssd_scan",
                                  "rglru_scan", "modipick_probs"])
def test_plain_path_keeps_its_grad_fn(name):
    """On the CPU a wrapper runs its plain version, which stays
    differentiable: the output has a grad_fn and a backward pass reaches
    the first input (the CUDA path refuses such inputs instead)."""
    fn, args, kw = _grad_inputs(name)
    out = fn(*args, **kw)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert args[0].grad is not None


@pytest.mark.parametrize("B,KV,C,sms", [
    (4, 2, 144, 132),         # qwen2 at the int8 serve shape
    (8, 2, 32768, 132),       # a long cache: more than one wave
    (1, 1, 1, 132),
    (64, 8, 144, 132),
    (1, 1, 1_000_000, 132),   # MAX_SPLIT_INT8 chunks
    (3, 2, 50, 16)])
def test_int8_split_plan_covers_the_cache(B, KV, C, sms):
    """Each slot lies in exactly one chunk of whole 32-slot tiles; a
    block walks at most WAVE_TILES tiles unless MAX_SPLIT_INT8 forces
    more; short caches split down to one tile a block."""
    chunk, n_split = split_plan_int8(B, KV, C, sms)
    tiles = -(-C // TILE_INT8)
    assert chunk % TILE_INT8 == 0 and 1 <= n_split <= MAX_SPLIT_INT8
    assert (n_split - 1) * chunk < C <= n_split * chunk
    assert chunk // TILE_INT8 <= max(WAVE_TILES, -(-tiles // MAX_SPLIT_INT8))
    if B * KV * tiles <= sms:
        assert chunk == TILE_INT8
    if (B, KV, C) == (8, 2, 32768):
        assert B * KV * n_split > sms and chunk // TILE_INT8 == WAVE_TILES

