"""The port's hand-written kernels against their plain versions on the
card.  Every test here needs an NVIDIA GPU and the CUDA toolkit; they are
marked ``cuda`` and skip elsewhere.  This file imports no JAX, so it runs
on a machine with only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol/rtol 2e-5 (summation order only), bfloat16
1e-2 (about one bf16 rounding of values up to 2); the SSD scan relative
to max |y| (2e-5 in float32, 2e-2 in bfloat16, as
``tests/test_kernels.py`` holds the Pallas kernel: the chunked kernel
and the sequential plain version sum in different orders); stage-3
probabilities exactly at gamma 1 and to the float32 tolerance at gamma 2
(torch.pow special-cases an exponent of 2), picks and all of the charged
pass's outputs exactly (same operations in the same order).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, policy_select, ref
from repro_torch.kernels.decode_attention import split_plan
from repro_torch.models import attention
from repro_torch.models.layers import rope_tables

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
    (1, 2, 2, 40, 256, 0), (4, 10, 1, 128, 256, 2048),
    (1, 10, 1, 300, 256, 64), (1, 10, 1, 16, 256, 64),
    (2, 10, 1, 17, 256, 64), (1, 10, 1, 200, 256, 64)])
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
    (2, 1, 8, 300, 256, 40), (2, 2, 3, 50, 16, 0), (4, 1, 10, 144, 256, 0),
    (2, 1, 17, 64, 64, 0)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 6, 10, 17])
@pytest.mark.parametrize("hd,window", [(128, 0), (256, 0), (64, 20)])
def test_decode_kernel_at_split_edges(gen, dtype, G, hd, window):
    """pos at 0, at the last slot of the first chunk, at the first slot of
    the second and at the last slot, in one batch; with a window the
    first and last case drop whole chunks."""
    B, KV, C = 4, 2, 144
    chunk, n_split = split_plan(B, KV, C)
    assert n_split > 1
    q = _randn(gen, B, KV, G, hd, dtype=dtype)
    k = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    v = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    pos = torch.tensor([0, chunk - 1, chunk, C - 1], dtype=torch.int32,
                       device="cuda")
    before = ops.decode_attention.launches
    for _ in range(2):  # the second launch finds the counters reset
        out = ops.decode_attention(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, ref.decode_attention_ref(q, k, v, pos, window=window),
            **TOL[dtype])
    assert ops.decode_attention.launches == before + 2


def test_decode_kernel_over_a_local_ring(gen):
    """recurrentgemma's local layer at half width with a 64-slot ring:
    one sequence past the wrap (every slot valid) and one before it
    (slots past pos hold stale values that must not be read), through
    the model's call with pos_eff = min(pos, C − 1) and no window."""
    cfg = replace(get_config("recurrentgemma-2b").scaled(0.5), window=64)
    hd, KV, H, D = (cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads,
                    cfg.d_model)
    B, C = 2, cfg.window
    p = {"wqkv": _randn(gen, D, (H + 2 * KV) * hd, dtype=torch.float32) / 30,
         "wo": _randn(gen, H * hd, D, dtype=torch.float32) / 30}
    x = _randn(gen, B, 1, D, dtype=torch.float32)
    k = _randn(gen, B, C, KV, hd, dtype=torch.float32)
    v = _randn(gen, B, C, KV, hd, dtype=torch.float32)
    pos = torch.tensor([100, 30], dtype=torch.int32, device="cuda")
    tables = rope_tables(pos[:, None], cfg.rope_theta, hd)
    before = ops.decode_attention.launches
    outs = [attention.decode_attention(p, {"k": k.clone(), "v": v.clone()},
                                       x, pos, tables, cfg, "local",
                                       impl=impl)[0]
            for impl in (ops.KERNELS, ops.PLAIN)]
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    torch.testing.assert_close(outs[0], outs[1], **TOL[torch.float32])


def _ssd_inputs(gen, B, H, G, S, hd, N, dtype):
    """SSD inputs laid out as the model hands them: (B,S,H,hd),
    (B,S,H) and (B,S,G,N) activations seen through transposed views."""
    x = (_randn(gen, B, S, H, hd, dtype=torch.float32) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(
        _randn(gen, B, S, H, dtype=torch.float32))
    A = -torch.exp(_randn(gen, H, dtype=torch.float32) * 0.3)
    Bm = (_randn(gen, B, S, G, N, dtype=torch.float32) * 0.3).to(dtype)
    Cm = (_randn(gen, B, S, G, N, dtype=torch.float32) * 0.3).to(dtype)
    return (x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2),
            Cm.transpose(1, 2))


SSD_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", [
    (4, 64, 1, 128, 64, 128, 256),   # mamba2-1.3b at the server's shape
    (1, 8, 1, 600, 64, 128, 256),    # three chunks, the last one ragged
    (2, 4, 2, 96, 16, 16, 32),       # two groups, three chunks
    (1, 4, 1, 40, 16, 16, 32),       # the reduced config: ragged tail
    (1, 4, 2, 130, 128, 64, 64),     # hd 128, ragged
    (1, 2, 1, 70, 32, 32, 100),      # one short chunk
    (2, 4, 1, 257, 64, 128, 256),    # a one-row second chunk, state != 0
    (1, 4, 1, 50, 16, 16, 256),      # the smallest mma tiles, one chunk
    (1, 8, 2, 75, 32, 32, 64),       # G 2, 8 heads; len 64 + 11
    (1, 2, 1, 600, 128, 24, 128),    # N 24 (padded to 32), hd 128
])
def test_ssd_kernel_matches_plain(gen, dtype, B, H, G, S, hd, N, chunk):
    args = _ssd_inputs(gen, B, H, G, S, hd, N, dtype)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    _ssd_close(y, state, ops.PLAIN.ssd_scan(*args, chunk=chunk), dtype)


def _ssd_close(y, state, want, dtype):
    for got, ref_ in zip((y, state), want):
        scale = max(float(ref_.float().abs().max()), 1.0)
        torch.testing.assert_close(got.float() / scale, ref_.float() / scale,
                                   **SSD_TOL[dtype])


@pytest.mark.parametrize("N", [12, 136])
def test_ssd_bf16_refuses_n_it_cannot_take(gen, N):
    """The bfloat16 kernel copies rows in 16-byte vectors and holds C's
    row over N in registers: N must be a multiple of 8 and at most 128.
    The float32 kernel takes the same inputs."""
    args = _ssd_inputs(gen, 1, 2, 1, 8, 16, N, torch.bfloat16)
    before = ops.ssd_scan.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.ssd_scan(*args)
    assert ops.ssd_scan.launches == before
    f32 = [t.float() for t in args]
    _ssd_close(*ops.ssd_scan(*f32), ops.PLAIN.ssd_scan(*f32), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [
    (4, 128, 2560), (2, 600, 300), (1, 1, 7), (3, 77, 128),
    # segment edges at recurrentgemma's width: 8 segments of 16 at S 128
    (4, 127, 2560), (4, 129, 2560),
    # 32 segments held in registers, and one step past them (walked from
    # memory), and a long S
    (1, 512, 64), (1, 513, 64), (2, 5000, 40)])
def test_rglru_kernel_matches_plain(gen, dtype, B, S, W):
    a = torch.sigmoid(_randn(gen, B, S, W, dtype=torch.float32)) * 0.98
    b = _randn(gen, B, S, W, dtype=torch.float32) * 0.1
    a, b = a.to(dtype), b.to(dtype)
    before = ops.rglru_scan.launches
    h = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    torch.testing.assert_close(h, ops.PLAIN.rglru_scan(a, b), **TOL[dtype])


def _select_pool(n, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    mu, sig = rng.uniform(5, 60, n), rng.uniform(0, 5, n)
    acc = rng.uniform(0.3, 0.9, n)
    return rng, policy_select.DevicePool(mu, sig, acc,
                                         np.argsort(-acc, kind="stable"),
                                         int(np.argmin(mu)), device="cuda")


@pytest.mark.parametrize("n", [2, 3, 8])
def test_stage3_kernel_matches_plain_bit_for_bit(gen, n):
    rng, pool = _select_pool(n)
    t_u = torch.tensor(rng.uniform(0, 90, 8192), dtype=torch.float32,
                       device="cuda")
    t_l = t_u - 25.0
    _, _, elig = policy_select._stages12(pool.mu, pool.sigma, pool.rank,
                                         t_u, t_l)
    args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, elig.float())
    before = ops.modipick_probs.launches
    assert torch.equal(ops.modipick_probs(*args), ref.policy_probs_ref(*args))
    assert ops.modipick_probs.launches == before + 1
    r01 = torch.rand(8192, generator=gen, device="cuda")
    sel = (pool.mu, pool.sigma, pool.acc, pool.rank, t_u, t_l, r01)
    assert torch.equal(ops.fused_select(*sel), ref.fused_select_ref(*sel))


@pytest.mark.parametrize("n", [1, 3, 128])
def test_stage3_kernel_at_gamma_2_within_tolerance(gen, n):
    """torch.pow special-cases an exponent of 2, powf does not: one ulp
    of the accuracy weight, well inside the float32 tolerance."""
    rng, pool = _select_pool(n)
    B = 1000
    t_u = torch.tensor(rng.uniform(0, 90, B), dtype=torch.float32,
                       device="cuda")
    t_l = t_u - 25.0
    elig = (torch.rand(B, n, generator=gen, device="cuda") > 0.3).float()
    args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, elig)
    torch.testing.assert_close(ops.modipick_probs(*args, gamma=2.0),
                               ref.policy_probs_ref(*args, gamma=2.0),
                               **TOL[torch.float32])


@pytest.mark.parametrize("n", [2, 3, 8, 128])
@pytest.mark.parametrize("B", [8192, 1000, 1])
def test_fused_kernel_matches_plain(gen, n, B):
    """Picks equal, with rows that have no base and rows whose mass is
    negative (uniform over the eligible models)."""
    rng, pool = _select_pool(n, seed=n + B)
    t_u = rng.uniform(-5, 90, B).astype(np.float32)
    t_u[: B // 50] = float(pool.mu.min()) - 50.0
    t_l = t_u - 25.0
    t_l[B // 50: B // 20] = t_u[B // 50: B // 20] + 40.0
    t_u, t_l = (torch.tensor(x, device="cuda") for x in (t_u, t_l))
    r01 = torch.rand(B, generator=gen, device="cuda")
    sel = (pool.mu, pool.sigma, pool.acc, pool.rank, t_u, t_l, r01)
    before = ops.fused_select.launches
    got = ops.fused_select(*sel)
    torch.cuda.synchronize()
    assert ops.fused_select.launches == before + 1
    assert torch.equal(got, ref.fused_select_ref(*sel))
    if B > 100:
        assert (got == -1).any() and (got >= 0).any()


def test_select_fused_launches_once(gen):
    _, pool = _select_pool(3)
    t_u = np.linspace(5.0, 100.0, 5000)
    before = ops.launch_counts()
    idx, has = policy_select.select_fused(pool, t_u, t_u - 25.0, seed=3)
    after = ops.launch_counts()
    assert after["fused_select"] == before["fused_select"] + 1
    assert {k: after[k] - before[k] for k in after if k != "fused_select"} \
        == dict.fromkeys(set(after) - {"fused_select"}, 0)
    assert idx.shape == has.shape == (5000,)


# case → (n, R, speeds vary, a replica down, slack, include_mu or None
# for AdmitAll, the charge a pick as a share of mu).  Every SLA-aware
# case sheds some of its requests: "wide" spreads 600 requests over 300
# replicas, so only a charge of the whole mu makes its waits cross the
# budgets.
CHARGED = {"admit_all": (5, 8, False, False, 0.0, None, 0.02),
           "sla": (5, 8, False, False, 0.0, False, 0.02),
           "sla_mu": (5, 8, False, False, 4.0, True, 0.02),
           "speeds": (6, 8, True, False, 2.0, True, 0.02),
           "down": (5, 7, False, True, 0.0, True, 0.02),
           "n1": (1, 2, False, False, 0.0, True, 0.02),
           "n8": (8, 16, True, False, 0.0, None, 0.02),
           "wide": (128, 300, True, True, 1.0, True, 1.0)}


def charged_inputs(gen, name, B):
    """The charged pass's operands on the card for case ``name``."""
    n, R, speeds, down, slack, include_mu, charge = CHARGED[name]
    rng, pool = _select_pool(n, seed=len(name))
    cand = torch.zeros(n, R, dtype=torch.bool)
    for m in range(n):
        cand[m, rng.choice(R, size=min(R, 3), replace=False)] = True
    rep_wait = rng.uniform(0.0, 30.0, R)
    if down:
        rep_wait[0] = np.inf
        cand[0] = False
        cand[0, 0] = True
    speed = rng.uniform(0.5, 2.0, R) if speeds else np.ones(R)
    budgets = rng.uniform(20.0, 160.0, B)
    lim = budgets if include_mu is not None else np.full(B, np.inf)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device="cuda")

    args = (pool.mu, pool.sigma, pool.acc, pool.rank,
            pool.mu * charge, cand.cuda(), f32(speed), f32(rep_wait),
            f32(budgets), f32(budgets - 20.0),
            torch.rand(B, generator=gen, device="cuda"), f32(lim))
    kw = dict(slack=slack, include_mu=bool(include_mu), fastest=pool.fastest)
    return args, kw


@pytest.mark.parametrize("name", sorted(CHARGED))
def test_charged_kernel_matches_plain(gen, name):
    """All five outputs equal; 600 requests cross the kernel's staging
    chunk of 256.  Each SLA-aware case admits some requests and sheds
    others, so both branches of the admission run."""
    args, kw = charged_inputs(gen, name, 600)
    before = ops.charged_select.launches
    got = ops.charged_select(*args, **kw)
    torch.cuda.synchronize()
    assert ops.charged_select.launches == before + 1
    want = ref.charged_select_ref(*args, **kw)
    for what, g, w in zip(("picks", "admitted", "has_base", "replica",
                           "w_chosen"), got, want):
        assert g.dtype == w.dtype, what
        assert torch.equal(g, w), what
    assert got[1].any() and got[2].any()
    if CHARGED[name][5] is not None:
        assert not got[1].all()


@pytest.mark.parametrize("n,R", [(1, 1), (3, 6), (128, 300), (128, 1500)])
def test_charged_smem_mirrors_the_kernel(gen, n, R):
    """The Python mirror of the charged block's shared memory (the
    bound a CPU call is held to) equals the kernel's own; the card's
    limit is the H100's that the mirror's callers assume."""
    need, limit = policy_select.charged_smem(n, R, "cuda")
    assert need == policy_select.charged_smem_bytes(n, R)
    assert limit == torch.cuda.get_device_properties(0) \
        .shared_memory_per_block_optin
    if "H100" in torch.cuda.get_device_name(0):
        assert limit == policy_select.MAX_SMEM


def test_charged_kernel_refuses_what_does_not_fit(gen):
    args, kw = charged_inputs(gen, "n8", 4)
    args = list(args)
    args[5] = torch.ones(8, 20_000, dtype=torch.bool, device="cuda")
    args[6] = args[7] = torch.ones(20_000, device="cuda")
    before = ops.charged_select.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.charged_select(*args, **kw)
    assert ops.charged_select.launches == before


@pytest.mark.parametrize("which", ["flash", "decode", "ssd"])
def test_misaligned_views_raise_on_the_card(gen, which):
    """A row that does not start on 16 bytes (a view that drops the first
    element of each row) is refused, not read."""
    if which == "ssd":
        args = list(_ssd_inputs(gen, 1, 2, 1, 8, 32, 32, torch.bfloat16))
        bad = torch.zeros(1, 1, 8, 33, device="cuda",
                          dtype=torch.bfloat16)[..., 1:]
        before = ops.launch_counts()
        for i in (0, 3, 4):  # x, B_, C_
            wrong = list(args)
            wrong[i] = bad.expand(1, 2, 8, 32) if i == 0 else bad
            with pytest.raises(ValueError, match="16 bytes"):
                ops.ssd_scan(*wrong)
        assert ops.launch_counts() == before
        return
    bad = torch.zeros(2, 2, 8, 33, device="cuda",
                      dtype=torch.bfloat16)[..., 1:]
    good = torch.zeros(2, 2, 8, 32, device="cuda", dtype=torch.bfloat16)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        if which == "flash":
            ops.flash_attention(bad, good, good)
        else:
            ops.decode_attention(bad[:, :, :3], good, good,
                                 torch.zeros(2, dtype=torch.int32,
                                             device="cuda"))
    with pytest.raises(ValueError, match="16 bytes"):
        if which == "flash":
            ops.flash_attention(good, good, bad)
        else:
            ops.decode_attention(good[:, :, :3], bad, good,
                                 torch.zeros(2, dtype=torch.int32,
                                             device="cuda"))
    assert ops.launch_counts() == before


def test_wrappers_raise_on_cuda_tensors_they_do_not_take(gen):
    q = torch.zeros(1, 4, 8, 32, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    qd = torch.zeros(1, 2, 2, 32, device="cuda")
    k = torch.zeros(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError):
        ops.decode_attention(qd, k, k, torch.zeros(1, dtype=torch.int32))
    xs = torch.zeros(1, 2, 8, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.ssd_scan(xs, torch.zeros(1, 2, 8, device="cuda"),
                     torch.zeros(2, device="cuda"), xs[:, :1], xs[:, :1])
    with pytest.raises(ValueError):
        ops.ssd_scan(xs.float(), torch.zeros(1, 2, 8, device="cuda"),
                     torch.zeros(2, device="cuda"),
                     torch.zeros(1, 1, 8, 8, device="cuda"),
                     torch.zeros(1, 1, 8, 8, device="cuda"), chunk=0)
    with pytest.raises(TypeError):
        ops.rglru_scan(xs[0], xs[0])
    with pytest.raises(ValueError):
        ops.rglru_scan(xs[0].float(), xs[0].float()[:, :4])
    with pytest.raises(TypeError):
        ops.modipick_probs(*(torch.ones(3, device="cuda", dtype=torch.float64),) * 3,
                           torch.ones(4, device="cuda"),
                           torch.ones(4, device="cuda"),
                           torch.ones(4, 3, device="cuda"))
    pool = torch.ones(3, device="cuda")
    with pytest.raises(ValueError):
        ops.fused_select(pool, pool, pool, pool.cpu(), pool, pool, pool)
    with pytest.raises(TypeError):
        ops.charged_select(pool, pool, pool, pool, pool,
                           torch.ones(3, 2, device="cuda"),
                           *(torch.ones(2, device="cuda"),) * 2,
                           *(torch.ones(4, device="cuda"),) * 4)
