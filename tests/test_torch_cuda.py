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
pass's outputs exactly (same operations in the same order), and the
stacked selection's picks and has_base flags exactly, in its classed
(premodel) and fleet forms.
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, policy_select, ref
from repro_torch.kernels.decode_attention import split_plan, split_plan_int8
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
    (1, 10, 1, 1024, 64, 128, 256),  # 10 heads: uneven head splits
    (2, 10, 1, 1024, 64, 128, 256),
    (1, 4, 1, 300, 128, 128, 256),   # hd 128 at G 1
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


@pytest.mark.parametrize("n", [2, 3, 8, 129, 200, 1000])
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


# Pool widths at the edges of the fused and stacked kernels' segments
# (1-32 lanes a request) and lane slots (two or more models a lane past
# 32, shared memory past 128), and batches that are no multiple of the
# requests a warp.
EDGE_N = [1, 2, 3, 4, 5, 15, 16, 17, 31, 32, 33, 64, 127, 128, 129, 200,
          1000]
EDGE_B = [1, 7, 200, 8192]


def _fused_inputs(gen, n, B, seed, rank=None):
    """The fused kernel's operands: the first 2% of the rows with no
    base, the next 3% with a negative mass (uniform over their eligible
    models)."""
    rng, pool = _select_pool(n, seed=seed)
    t_u = rng.uniform(-5, 90, B).astype(np.float32)
    t_u[: B // 50] = float(pool.mu.min()) - 50.0
    t_l = t_u - 25.0
    t_l[B // 50: B // 20] = t_u[B // 50: B // 20] + 40.0
    t_u, t_l = (torch.tensor(x, device="cuda") for x in (t_u, t_l))
    r01 = torch.rand(B, generator=gen, device="cuda")
    return (pool.mu, pool.sigma, pool.acc,
            pool.rank if rank is None else rank(pool.rank), t_u, t_l, r01)


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("B", EDGE_B)
def test_fused_kernel_matches_plain(gen, n, B):
    """Picks equal, with rows that have no base and rows whose mass is
    negative, at every segment and slot edge; one launch a call."""
    sel = _fused_inputs(gen, n, B, seed=n + B)
    before = ops.fused_select.launches
    got = ops.fused_select(*sel)
    torch.cuda.synchronize()
    assert ops.fused_select.launches == before + 1
    assert torch.equal(got, ref.fused_select_ref(*sel))
    if B > 100:
        assert (got == -1).any() and (got >= 0).any()


@pytest.mark.parametrize("ties", ["thirds", "all"])
@pytest.mark.parametrize("n", [5, 40, 64, 200])
def test_selection_kernels_break_rank_ties_by_index(gen, n, ties):
    """Tied ranks: the base is the first eligible index of least rank,
    as torch.argmin gives, in both kernels."""
    tie = ((lambda r: torch.floor(r / 3)) if ties == "thirds"
           else torch.zeros_like)
    sel = _fused_inputs(gen, n, 1000, seed=n, rank=tie)
    assert torch.equal(ops.fused_select(*sel), ref.fused_select_ref(*sel))
    args, kw = stacked_inputs(gen, "classed", 3, n, 1000, True, seed=n)
    args = args[:3] + (tie(args[3]),) + args[4:]
    for g, w in zip(ops.stacked_select(*args, **kw),
                    ref.stacked_select_ref(*args, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [11, 33, 200])
def test_fused_kernel_at_gamma_2(gen, n):
    """At gamma 2 powf and torch.pow may round the accuracy weight
    differently, so a pick may differ where a draw lands on a boundary:
    all but a few equal."""
    sel = _fused_inputs(gen, n, 4000, seed=n)
    got = ops.fused_select(*sel, gamma=2.0)
    want = ref.fused_select_ref(*sel, gamma=2.0)
    assert torch.equal(got < 0, want < 0)
    assert (got != want).sum().item() <= 4


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
# case sheds some of its requests: "wide" and the n33–n160 cases spread
# 600 requests over many replicas, so only a charge of the whole mu makes
# their waits cross the budgets.
CHARGED = {"admit_all": (5, 8, False, False, 0.0, None, 0.02),
           "sla": (5, 8, False, False, 0.0, False, 0.02),
           "sla_mu": (5, 8, False, False, 4.0, True, 0.02),
           "speeds": (6, 8, True, False, 2.0, True, 0.02),
           "down": (5, 7, False, True, 0.0, True, 0.02),
           "n1": (1, 2, False, False, 0.0, True, 0.02),
           "n8": (8, 16, True, False, 0.0, None, 0.02),
           "wide": (128, 300, True, True, 1.0, True, 1.0),
           # a lane holds two models (33), two full slots (64), and past
           # 128 the lanes' state lives in shared memory (160)
           "n33": (33, 40, True, False, 1.0, True, 1.0),
           "n64": (64, 100, True, True, 1.0, True, 1.0),
           "n160": (160, 300, True, True, 1.0, True, 1.0)}


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


@pytest.mark.parametrize("n,R,nnz", [(1, 1, 1), (3, 6, 6), (11, 44, 44),
                                     (128, 300, 384), (160, 300, 480),
                                     (128, 1500, 192_000)])
def test_charged_smem_mirrors_the_kernel(gen, n, R, nnz):
    """The Python mirror of the charged block's shared memory (the
    bound a CPU call is held to) equals the kernel's own at n models, R
    replicas and nnz candidate pairs; the card's limit is the H100's
    that the mirror's callers assume."""
    need, limit = policy_select.charged_smem(n, R, "cuda", nnz)
    assert need == policy_select.charged_smem_bytes(n, R, nnz)
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


def test_charged_kernel_at_the_engine_pool_with_dead_models(gen):
    """B3 at the engine's pool (n = 11 models over R = 44 replicas, four
    a model) with every replica of three models at +inf, among them
    replica 0's: all five outputs equal to the plain version's, with
    and without SLA-aware admission.  A dead model's wait is taken as 0
    and its pick lands on replica 0, as the reference's scan does."""
    n, R, B = 11, 44, 600
    rng, pool = _select_pool(n, seed=44)
    cand = torch.zeros(n, R, dtype=torch.bool)
    for m in range(n):
        cand[m, 4 * m:4 * m + 4] = True
    rep_wait = rng.uniform(0.0, 30.0, R)
    rep_wait[0:4] = rep_wait[20:24] = rep_wait[40:44] = np.inf

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device="cuda")

    budgets = rng.uniform(20.0, 160.0, B)
    for lim, include_mu in ((np.full(B, np.inf), False), (budgets, True)):
        args = (pool.mu, pool.sigma, pool.acc, pool.rank, pool.mu * 0.05,
                cand.cuda(), f32(np.ones(R)), f32(rep_wait), f32(budgets),
                f32(budgets - 20.0),
                torch.rand(B, generator=gen, device="cuda"), f32(lim))
        kw = dict(slack=0.0, include_mu=include_mu, fastest=pool.fastest)
        got = ops.charged_select(*args, **kw)
        want = ref.charged_select_ref(*args, **kw)
        for what, g, w in zip(("picks", "admitted", "has_base", "replica",
                               "w_chosen"), got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), what
        dead = torch.isin(got[0].long(), torch.tensor([0, 5, 10],
                                                      device="cuda"))
        assert dead.any() and (got[3][dead & got[1]] == 0).all()


def _engine_run(monkeypatch, charge, faults=()):
    """The reference engine benchmark's ``batched`` configuration
    (``batched_snapshot`` with ``charge=False``) at 2,000 requests in
    200-wide bursts on ``backend="cuda"``, with every launch of the
    kernel in use recorded: (engine, summary, [(operands, kwargs,
    outputs)])."""
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.core.zoo import TABLE2
    from repro_torch.router import RetryPolicy
    from repro_torch.sim import (ServingSimulator, TraceArrivals,
                                 per_model_replicas)

    name = "charged_select" if charge else "fused_select"
    wrapper, calls = getattr(policy_select, name), []

    class Record:
        # the wrapper's ``launches += 1`` lands on the wrapper's count
        launches = property(lambda self: wrapper.launches,
                            lambda self, v: setattr(wrapper, "launches", v))

        def __call__(self, *a, **kw):
            out = wrapper(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((a, kw, tuple(o.clone() for o in outs)))
            return out

    monkeypatch.setattr(policy_select, name, Record())
    before = wrapper.launches
    eng = ServingSimulator(
        TABLE2, NetworkModel(50.0, 0.0),
        per_model_replicas(TABLE2, replicas_per_model=4), seed=3,
        queue_aware=True, backend="cuda", charge_batches=charge,
        faults=faults, retry=RetryPolicy(max_attempts=2) if faults else None)
    times = np.repeat(np.arange(10) * 400.0, 200)
    res = eng.run(ModiPick(t_threshold=20.0), 250.0, 2000,
                  arrivals=TraceArrivals(times))
    assert wrapper.launches - before == len(calls)
    return eng, res, calls


@pytest.mark.parametrize("charge", [True, False],
                         ids=["batched", "batched_snapshot"])
def test_engine_bursts_hold_every_launch_to_plain(gen, monkeypatch, charge):
    """One kernel launch a burst, each one's outputs equal to the plain
    version's on the same operands."""
    eng, res, calls = _engine_run(monkeypatch, charge)
    assert eng.router.stats()["n_batches"] == len(calls) == 10
    plain = ref.charged_select_ref if charge else ref.fused_select_ref
    for a, kw, outs in calls:
        want = plain(*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(outs, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert res.n_arrived == 2000
    if charge:
        assert res.sla_attainment >= 0.5
        assert calls[0][0][0].shape == (11,) and calls[0][0][6].shape == (44,)


def test_engine_bursts_with_dead_models(gen, monkeypatch):
    """Every replica of SqueezeNet (replica 0 among them) and of
    NasNet-Large killed mid-run: each charged launch equal to the plain
    version, and picks that land on dead replica 0 fall back to the
    live-pool pick, which rejects."""
    from repro_torch.sim import ReplicaFault
    faults = [ReplicaFault(at_ms=1_260.0, kind="kill", replica=f"{m}/{k}")
              for m in ("SqueezeNet", "NasNet-Large") for k in range(4)]
    faults += [ReplicaFault(at_ms=3_000.0, kind="recover",
                            replica=f"SqueezeNet/{k}") for k in (0, 1)]
    eng, res, calls = _engine_run(monkeypatch, True, faults)
    assert len(calls) == 10
    for a, kw, outs in calls:
        for g, w in zip(outs, ref.charged_select_ref(*a, **kw)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    c = eng._cols
    reasons = {eng._reasons[r] for r in c.reason[c.rejected]}
    assert res.n_completed + res.n_rejected == 2000
    assert (c.replica[~c.rejected] >= 0).all()
    assert "no live replica for NasNet-Large" in reasons


# ----------------------------------------------------------------------
# B4: the stacked selection (premodel's classed form, the fleet's form)
# ----------------------------------------------------------------------

def stacked_inputs(gen, form, P, n, B, shifts=False, seed=0):
    """The stacked kernel's operands on the card.  ``classed``: P class
    rows of mu/sigma over one shared acc/rank, a random class a request;
    ``fleet``: P cells of B requests each (B·P rows in all), acc/rank a
    row each, every cell but the first narrower than n, its padded lanes
    at PAD_MU/0/1/PAD_RANK.  The first 2% of the requests have no base,
    the next 3% a negative mass (uniform over their eligible models)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(5.0, 60.0, (P, n))
    sig = rng.uniform(0.0, 5.0, (P, n))
    if form == "classed":
        acc = rng.uniform(0.3, 0.9, n)
        rank = np.argsort(np.argsort(-acc, kind="stable"))
        row = rng.integers(0, P, B)
    else:
        acc = rng.uniform(0.3, 0.9, (P, n))
        rank = np.argsort(np.argsort(-acc, kind="stable", axis=1), axis=1)
        for c, w in enumerate(rng.integers(1, n + 1, P)):
            w = n if c == 0 else w
            mu[c, w:], sig[c, w:] = policy_select.PAD_MU, 0.0
            acc[c, w:], rank[c, w:] = 1.0, policy_select.PAD_RANK
        row = np.repeat(np.arange(P), B)
        B = P * B
    t_u = rng.uniform(-5.0, 90.0, B)
    t_u[: B // 50] = float(mu.min()) - 50.0
    t_l = t_u - 25.0
    t_l[B // 50: B // 20] = t_u[B // 50: B // 20] + 40.0

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device="cuda")

    args = (f32(mu), f32(sig), f32(acc), f32(rank),
            torch.tensor(row, dtype=torch.int32, device="cuda"), f32(t_u),
            f32(t_l), torch.rand(B, generator=gen, device="cuda"))
    kw = dict(shifts=f32(rng.uniform(0.0, 20.0, n)) if shifts else None,
              fallback=form == "classed")
    return args, kw


# (form, P, n, B (a cell's B in the fleet form), shifts)
STACKED = {"classed_k1": ("classed", 1, 11, 200, True),
           "classed_k2": ("classed", 2, 11, 200, True),
           "classed_k2_noshift": ("classed", 2, 11, 97, False),
           "classed_k8": ("classed", 8, 3, 97, True),
           "classed_b1": ("classed", 2, 11, 1, True),
           "classed_n128": ("classed", 3, 128, 500, True),
           "fleet_6x5": ("fleet", 6, 5, 2550, False),
           "fleet_4x11": ("fleet", 4, 11, 1200, False),
           "fleet_b97": ("fleet", 3, 11, 97, False),
           "fleet_b1": ("fleet", 2, 4, 1, False)}


@pytest.mark.parametrize("name", sorted(STACKED))
def test_stacked_kernel_matches_plain(gen, name):
    form, P, n, B, shifts = STACKED[name]
    args, kw = stacked_inputs(gen, form, P, n, B, shifts, seed=len(name))
    before = ops.stacked_select.launches
    picks, has = ops.stacked_select(*args, **kw)
    torch.cuda.synchronize()
    assert ops.stacked_select.launches == before + 1
    want, whas = ref.stacked_select_ref(*args, **kw)
    assert picks.dtype == want.dtype and has.dtype == whas.dtype
    assert torch.equal(picks, want) and torch.equal(has, whas)
    if args[5].shape[0] > 50:
        assert (~has).any() and has.any()
        assert ((picks >= 0) == has).all() if form == "fleet" \
            else (picks >= 0).all()


# (form, queue shifts, fallback): the classed form as premodel calls it
# and bare; the fleet form with its padded lanes, and with shifts and the
# fallback too.
STACKED_VARIANTS = [("classed", True, True), ("classed", False, False),
                    ("fleet", False, False), ("fleet", True, True)]


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("B", EDGE_B)
def test_stacked_kernel_at_segment_and_slot_edges(gen, n, B):
    """Picks and has_base equal at every segment and slot edge, each
    (n, B) in one of the four variants in turn; one launch a call."""
    i = EDGE_N.index(n) + EDGE_B.index(B)
    form, shifts, fallback = STACKED_VARIANTS[i % len(STACKED_VARIANTS)]
    args, kw = stacked_inputs(gen, form, 3, n, B if form == "classed"
                              else max(1, B // 3), shifts, seed=n + B)
    kw["fallback"] = fallback
    before = ops.stacked_select.launches
    picks, has = ops.stacked_select(*args, **kw)
    torch.cuda.synchronize()
    assert ops.stacked_select.launches == before + 1
    want, whas = ref.stacked_select_ref(*args, **kw)
    assert torch.equal(picks, want) and torch.equal(has, whas)
    if args[5].shape[0] > 100:
        assert (~has).any() and has.any()


@pytest.mark.parametrize("kernel,B", [("probs", 1), ("probs", 8192),
                                      ("select", 1), ("select", 7),
                                      ("select", 200), ("select", 8192)])
@pytest.mark.parametrize("n", [1, 2, 11, 33, 128, 129, 200, 1000, 4096])
def test_selection_plan_mirrors_the_kernel(gen, kernel, B, n):
    """The launch plan the kernel's library reports on the card equals
    its Python mirror under the card's limit."""
    got = policy_select.selection_plan(kernel, B, n, "cuda")
    mirror = (policy_select.probs_plan if kernel == "probs"
              else policy_select.select_plan)
    assert got == dict(mirror(B, n, got["limit"]), limit=got["limit"])


def test_selection_kernels_take_4096_models_and_refuse_past_the_limit(gen):
    """K1, B2 and B4 at 4096 models and at the largest pool a block
    holds equal to their plain versions; one model more raises a
    ValueError that names the limit, and launches nothing."""
    limit = policy_select.selection_plan("select", 1, 1, "cuda")["limit"]
    for n in (4096, policy_select.max_pool("select", limit)):
        sel = _fused_inputs(gen, n, 7, seed=n)
        assert torch.equal(ops.fused_select(*sel),
                           ref.fused_select_ref(*sel))
        args, kw = stacked_inputs(gen, "classed", 2, n, 7, True, seed=n)
        for g, w in zip(ops.stacked_select(*args, **kw),
                        ref.stacked_select_ref(*args, **kw)):
            assert torch.equal(g, w)
    for n in (4096, policy_select.max_pool("probs", limit)):
        _, pool = _select_pool(n, seed=n)
        k1 = (pool.mu, pool.sigma, pool.acc) + sel[4:6] \
            + (torch.ones(7, n, device="cuda"),)
        assert torch.equal(ops.modipick_probs(*k1),
                           ref.policy_probs_ref(*k1))
    before = ops.launch_counts()
    n = policy_select.max_pool("select", limit) + 1
    sel = _fused_inputs(gen, n, 7, seed=1)
    with pytest.raises(ValueError, match=f"{limit} bytes"):
        ops.fused_select(*sel)
    args, kw = stacked_inputs(gen, "fleet", 2, n, 3, seed=1)
    with pytest.raises(ValueError, match=f"{limit} bytes"):
        ops.stacked_select(*args, **kw)
    n = policy_select.max_pool("probs", limit) + 1
    _, pool = _select_pool(n, seed=1)
    with pytest.raises(ValueError, match=f"{limit} bytes"):
        ops.modipick_probs(pool.mu, pool.sigma, pool.acc, sel[4], sel[5],
                           torch.ones(7, n, device="cuda"))
    assert ops.launch_counts() == before


def test_stacked_kernel_at_gamma_2(gen):
    """At gamma 2 powf and torch.pow may round differently, so a pick
    may differ where a draw lands on a boundary: all but a few equal."""
    args, kw = stacked_inputs(gen, "classed", 2, 11, 4000, True, seed=3)
    picks, has = ops.stacked_select(*args, gamma=2.0, **kw)
    want, whas = ref.stacked_select_ref(*args, gamma=2.0, **kw)
    assert torch.equal(has, whas)
    assert (picks != want).sum().item() <= 4


def test_stacked_host_entry_points_launch_once(gen):
    from repro_torch.core.profiles import ModelProfile
    from repro_torch.core.zoo import TABLE2
    from repro_torch.premodel import ConditionalProfileStore
    store = ConditionalProfileStore(
        [ModelProfile(name=e.name, accuracy=e.top1 / 100.0) for e in TABLE2],
        n_classes=2)
    for i, e in enumerate(TABLE2):
        store.observe_class(i % 2, e.name, e.mu_ms)
    t_u = np.linspace(5.0, 400.0, 300)
    before = ops.launch_counts()
    idx, has = policy_select.select_classed(
        store.stacked_pool("cuda"), np.arange(300) % 2, t_u, t_u - 20.0,
        shifts=np.linspace(0.0, 30.0, len(TABLE2)), seed=3)
    fleet = policy_select.select_fleet_stacked(
        *stacked_inputs(gen, "fleet", 3, 5, 1)[0][:4],
        np.tile(t_u, (3, 1)), np.tile(t_u - 20.0, (3, 1)), seed=4)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * (k == "stacked_select") for k in after}
    assert idx.shape == has.shape == (300,) and fleet.shape == (3, 300)
    assert (~has).any() and has.any() and (fleet == -1).any()


def test_stacked_wrapper_raises_on_the_card(gen):
    args, kw = stacked_inputs(gen, "classed", 2, 3, 8)
    for i, bad in ((4, args[4].long()), (0, args[0].double()),
                   (5, args[5].cpu())):
        a = list(args)
        a[i] = bad
        with pytest.raises((ValueError, TypeError)):
            ops.stacked_select(*a, **kw)


def _recorded(monkeypatch, name="stacked_select"):
    wrapper, calls = getattr(policy_select, name), []

    class Record:
        launches = property(lambda self: wrapper.launches,
                            lambda self, v: setattr(wrapper, "launches", v))

        def __call__(self, *a, **kw):
            out = wrapper(*a, **kw)
            calls.append((a, kw, tuple(o.clone() for o in out)))
            return out

    monkeypatch.setattr(policy_select, name, Record())
    return wrapper, calls


def test_premodel_bursts_on_the_card(gen, monkeypatch):
    """The registered ``premodel_mix`` as 5 simultaneous bursts of 200
    on ``backend="cuda"``: one stacked launch a burst, each equal to the
    plain version on its operands."""
    import dataclasses
    from repro_torch.scenario import build, get_scenario
    sc = get_scenario("premodel_mix")
    times = np.repeat(np.arange(5) * 2000.0, 200)
    sc = dataclasses.replace(
        sc, workload=dataclasses.replace(sc.workload, arrival="trace",
                                         n_requests=1000,
                                         times_ms=tuple(times.tolist())),
        network=dataclasses.replace(sc.network, std_ms=0.0),
        policy=dataclasses.replace(sc.policy, backend="cuda"))
    wrapper, calls = _recorded(monkeypatch)
    before = wrapper.launches
    out = build(sc).run()
    assert wrapper.launches - before == len(calls) == 5
    for a, kw, outs in calls:
        assert a[0].shape == (2, 11) and a[4].shape == (200,)
        for g, w in zip(outs, ref.stacked_select_ref(*a, **kw)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert out.result.n_arrived == 1000


def test_fleet_on_the_card(gen, monkeypatch):
    """A 3-cell fleet on ``backend="cuda"``: one stacked launch an epoch
    with pending requests, each equal to the plain version."""
    import dataclasses
    from repro_torch.fleet import FleetEngine
    from repro_torch.scenario import fleet_scenario
    sc = fleet_scenario(n_cells=3, rate_rps=90.0, n_requests=3000,
                        subset=("DenseNet", "InceptionV3", "NasNet-Large"),
                        spill_threshold_ms=20.0)
    sc = dataclasses.replace(sc, policy=dataclasses.replace(
        sc.policy, backend="cuda"))
    wrapper, calls = _recorded(monkeypatch)
    before = wrapper.launches
    res = FleetEngine(sc).run()
    assert wrapper.launches - before == len(calls) == len(res.epochs) > 1
    for a, kw, outs in calls:
        assert a[0].shape == (3, 3)
        for g, w in zip(outs, ref.stacked_select_ref(*a, **kw)):
            assert torch.equal(g, w)
    assert res.n_arrived == 3000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (4, 16, 16, 128, 128, 0),     # moonshot-v1-16b-a3b: G = 1
    (1, 8, 4, 1100, 256, 1024),   # gemma3-4b local, G = 2
    (1, 8, 4, 1100, 256, 0)])     # gemma3-4b global
def test_flash_kernel_at_the_new_serving_shapes(gen, dtype, B, H, KV, S,
                                                hd, window):
    q = _randn(gen, B, S, H, hd, dtype=dtype).transpose(1, 2)
    k = _randn(gen, B, S, KV, hd, dtype=dtype).transpose(1, 2)
    v = _randn(gen, B, S, KV, hd, dtype=dtype).transpose(1, 2)
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.flash_attention_ref(q, k, v, window=window), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,C,hd,pos", [
    (16, 1, 144, 128, [128, 133, 139, 143]),     # moonshot: G = 1
    (4, 2, 1024, 256, [5, 300, 1023, 1023]),     # gemma3's wrapped ring
    (4, 2, 1152, 256, [5, 300, 1030, 1100])])    # gemma3 global, per slot
def test_decode_kernel_at_the_new_serving_shapes(gen, dtype, KV, G, C, hd,
                                                 pos):
    B = len(pos)
    q = _randn(gen, B, 1, KV * (G + 2), hd, dtype=dtype)[:, :, :KV * G]
    q = q.reshape(B, KV, G, hd)
    k = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    v = _randn(gen, B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    out = ops.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.decode_attention_ref(q, k, v, pos),
                               **TOL[dtype])


@pytest.mark.parametrize("width,shape,factor", [
    (None, (3, 15), 1.25), (None, (2, 32), 0.5), (0.25, (4, 32), 1.25),
    (0.25, (4, 1), 1.25)])
def test_moe_ffn_on_the_card_matches_the_cpu(gen, width, shape, factor):
    """moonshot's MoE feed-forward in float32 (reduced, and the width-0.25
    layer of the published config: 64 experts, top 6) on the card against
    the same call on the CPU: the same routing, the output to the float32
    tolerance.  No kernel of the port runs in it."""
    from repro_torch.models import moe
    base = get_config("moonshot-v1-16b-a3b")
    cfg = base.reduced() if width is None else base.scaled(width)
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=factor))
    params = moe.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32))
    want, want_aux = moe.moe_ffn(params, x, cfg)
    card = {k: w.cuda() for k, w in params.items()}
    before = ops.launch_counts()
    got, aux = moe.moe_ffn(card, x.cuda(), cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    r, r_cpu = (moe.moe_route(card["router"], x.cuda(), cfg),
                moe.moe_route(params["router"], x, cfg))
    assert torch.equal(r.idx.cpu(), r_cpu.idx)
    assert torch.equal(r.keep.cpu(), r_cpu.keep)
    torch.testing.assert_close(got.cpu(), want, **TOL[torch.float32])
    torch.testing.assert_close(aux.cpu(), want_aux, **TOL[torch.float32])


def test_batcher_on_the_card_matches_the_cpu(gen):
    """The continuous batcher over reduced gemma3-4b (a 64-slot local
    ring, 96 cache slots) in float32 on the card and on the CPU: the
    same tokens for every request; each prefill launches the prefill
    kernel once per attention layer, each batched step the decode kernel
    once per attention layer."""
    from repro_torch.models import model as M
    from repro_torch.serving.batcher import ContinuousBatcher, GenRequest
    cfg = get_config("gemma3-4b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 40, 70, 90)]
    runs = []
    for device in ("cpu", "cuda"):
        p = {"embed": params["embed"].to(device),
             "final_norm": params["final_norm"].to(device),
             "layers": [{k: ({kk: t.to(device) for kk, t in w.items()}
                             if isinstance(w, dict) else w.to(device))
                         for k, w in layer.items()}
                        for layer in params["layers"]]}
        eng = ContinuousBatcher(cfg, p, max_slots=2, cache_len=96,
                                device=device)
        reqs = [GenRequest(rid=i, prompt=q, max_new=4 + i % 3)
                for i, q in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = ops.launch_counts()
        eng.run_to_completion()
        after = ops.launch_counts()
        runs.append([r.generated for r in reqs])
    assert after["flash_attention"] - before["flash_attention"] == \
        cfg.n_layers * len(prompts)
    assert after["decode_attention"] - before["decode_attention"] == \
        cfg.n_layers * eng.n_steps
    assert runs[0] == runs[1]


def _int8_cache(gen, B, C, KV, hd):
    """An int8 cache as the model holds it, (B,C,KV,hd) int8 and (B,C,KV)
    float32 scales, quantized from normal values, and its (B,KV,C,...)
    views as the model hands them to the kernel."""
    k8, ks = attention.quantize_kv(_randn(gen, B, C, KV, hd,
                                          dtype=torch.float32))
    v8, vs = attention.quantize_kv(_randn(gen, B, C, KV, hd,
                                          dtype=torch.float32))
    return (k8.permute(0, 2, 1, 3), v8.permute(0, 2, 1, 3),
            ks.transpose(1, 2), vs.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("C,window", [(144, 0), (100, 0), (1500, 0),
                                      (300, 40)])
def test_decode_int8_kernel_matches_plain(gen, dtype, G, hd, C, window):
    """K3 over an int8 cache against its plain version: ragged lengths
    (100 and 1500 slots are no multiple of the 16-slot tile), per-row
    positions at the edges, a window that drops whole chunks."""
    B, KV = 4, 2
    q = _randn(gen, B, KV, G + 2, hd, dtype=dtype)[:, :, 1:G + 1]
    k, v, ks, vs = _int8_cache(gen, B, C, KV, hd)
    pos = torch.tensor([0, C // 3, C - 2, C - 1], dtype=torch.int32,
                       device="cuda")
    before = ops.decode_attention_int8.launches
    for _ in range(2):  # the second launch finds the counters reset
        out = ops.decode_attention_int8(q, k, v, ks, vs, pos, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, ref.decode_attention_int8_ref(q, k, v, ks, vs, pos,
                                               window=window), **TOL[dtype])
    assert ops.decode_attention_int8.launches == before + 2


def test_decode_int8_kernel_over_a_wrapped_ring(gen):
    """A local layer's int8 ring through the model's call: one sequence
    past the wrap, one before it, pos_eff = min(pos, C − 1)."""
    cfg = replace(get_config("gemma3-4b").scaled(0.25), window=64,
                  kv_cache_dtype="int8")
    hd, KV, H, D = (cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads,
                    cfg.d_model)
    B, C = 2, cfg.window
    p = {"wqkv": _randn(gen, D, (H + 2 * KV) * hd, dtype=torch.bfloat16)
         / 30, "wo": _randn(gen, H * hd, D, dtype=torch.bfloat16) / 30}
    x = _randn(gen, B, 1, D, dtype=torch.bfloat16)
    k8, ks = attention.quantize_kv(_randn(gen, B, C, KV, hd,
                                          dtype=torch.float32))
    v8, vs = attention.quantize_kv(_randn(gen, B, C, KV, hd,
                                          dtype=torch.float32))
    pos = torch.tensor([100, 30], dtype=torch.int32, device="cuda")
    tables = rope_tables(pos[:, None], cfg.rope_theta, hd)
    before = ops.decode_attention_int8.launches
    outs = []
    for impl in (ops.KERNELS, ops.PLAIN):
        cache = {"k": k8.clone(), "v": v8.clone(), "k_scale": ks.clone(),
                 "v_scale": vs.clone()}
        outs.append(attention.decode_attention(p, cache, x, pos, tables,
                                               cfg, "local", impl=impl))
    torch.cuda.synchronize()
    assert ops.decode_attention_int8.launches == before + 1
    torch.testing.assert_close(outs[0][0], outs[1][0], **TOL[torch.bfloat16])
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(outs[0][1][key], outs[1][1][key]), key


def _fused_write(gen, dtype, q, C, KV, hd, pos, slot, window=0):
    """K3-int8 with the new token's write against its plain version, each
    on its own copy of one int8 cache: the written cache equal bit for
    bit, the output within TOL.  Returns the kernel's output."""
    B = q.shape[0]
    k, v, ks, vs = _int8_cache(gen, B, C, KV, hd)
    # the new token's k and v as the model hands them: strided views
    kn = (_randn(gen, B, KV + 1, hd, dtype=torch.float32) * 3)[:, 1:]
    vn = _randn(gen, B, 2 * KV, hd, dtype=torch.float32)[:, ::2]
    kn, vn = kn.to(dtype), vn.to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    slot = torch.tensor(slot, dtype=torch.int32, device="cuda")
    got_cache = [t.clone() for t in (k, v, ks, vs)]
    want_cache = [t.clone() for t in (k, v, ks, vs)]
    before = ops.decode_attention_int8.launches
    out = ops.decode_attention_int8(q, *got_cache, pos, window=window,
                                    k_new=kn, v_new=vn, slot=slot)
    torch.cuda.synchronize()
    assert ops.decode_attention_int8.launches == before + 1
    want = ref.decode_attention_int8_ref(q, *want_cache, pos, window=window,
                                         k_new=kn, v_new=vn, slot=slot)
    for what, g, w in zip(("k", "v", "k_scale", "v_scale"), got_cache,
                          want_cache):
        assert torch.equal(g, w), what
    rows = torch.arange(B, device="cuda")
    assert not torch.equal(got_cache[0][rows, :, slot.long()],
                           k[rows, :, slot.long()])  # the slot was written
    torch.testing.assert_close(out, want, **TOL[dtype])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("C,window", [(144, 0), (100, 0), (1500, 0),
                                      (300, 40)])
def test_decode_int8_fused_write_matches_plain(gen, dtype, G, hd, C, window):
    """K3-int8 writing the new token at slot = pos (per-row positions at
    the edges, a ragged length, a window that drops whole chunks)."""
    B, KV = 4, 2
    q = _randn(gen, B, KV, G + 2, hd, dtype=dtype)[:, :, 1:G + 1]
    pos = [0, C // 3, C - 2, C - 1]
    _fused_write(gen, dtype, q, C, KV, hd, pos, pos, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_int8_fused_write_at_chunk_edges(gen, dtype):
    """The written slot at the last and the first slot of a chunk of the
    int8 plan, and on a wrapped ring (slot = pos % C, pos_eff = C − 1)."""
    B, KV, G, C, hd = 4, 2, 6, 144, 128
    chunk, n_split = split_plan_int8(B, KV, C)
    assert n_split > 1
    q = _randn(gen, B, KV, G, hd, dtype=dtype)
    edges = [chunk - 1, chunk, 2 * chunk - 1, 2 * chunk]
    _fused_write(gen, dtype, q, C, KV, hd, edges, edges)
    ring = [C + 5, 3 * C - 1, 2 * C + chunk, 5 * C + chunk - 1]
    _fused_write(gen, dtype, q, C, KV, hd, [C - 1] * B, [p % C for p in ring])


def test_decode_int8_fused_write_at_32768_slots(gen):
    """A long cache: the plan takes more than one wave of blocks."""
    B, KV, G, C, hd = 2, 2, 6, 32768, 128
    chunk, n_split = split_plan_int8(B, KV, C)
    assert B * KV * n_split > 132
    q = _randn(gen, B, KV, G, hd, dtype=torch.bfloat16)
    _fused_write(gen, torch.bfloat16, q, C, KV, hd, [C - 1, C - 700],
                 [C - 1, C - 700])


def _grad_case(name):
    """(wrapper, args, kwargs) for one CUDA wrapper at a small shape, its
    floating inputs requiring grad."""
    f = dict(device="cuda")
    r = lambda *shape: torch.rand(*shape, **f).requires_grad_()
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32, device="cuda")
    pool = lambda n: [r(n) for _ in range(4)]
    if name == "flash_attention":
        return ops.flash_attention, (r(1, 2, 8, 32), r(1, 2, 8, 32),
                                     r(1, 2, 8, 32)), {}
    if name == "decode_attention":
        return ops.decode_attention, (r(1, 2, 2, 32), r(1, 2, 8, 32),
                                      r(1, 2, 8, 32), i32(5)), {}
    if name == "decode_attention_int8":
        k8 = torch.zeros(1, 2, 8, 32, dtype=torch.int8, device="cuda")
        sc = torch.ones(1, 2, 8, device="cuda")
        return ops.decode_attention_int8, (r(1, 2, 2, 32), k8, k8.clone(),
                                           sc, sc.clone(), i32(5)), \
            dict(k_new=r(1, 2, 32), v_new=r(1, 2, 32), slot=i32(5))
    if name == "rglru_scan":
        return ops.rglru_scan, (r(1, 8, 16), r(1, 8, 16)), {}
    if name == "flash_attention_bwd":
        lse = torch.zeros(1, 2, 8, device="cuda")
        return ops.flash_attention_bwd, (r(1, 2, 8, 32), r(1, 2, 8, 32),
                                         r(1, 2, 8, 32), r(1, 2, 8, 32), lse,
                                         r(1, 2, 8, 32)), {}
    if name == "rglru_scan_bwd":
        return ops.rglru_scan_bwd, (r(1, 8, 16), r(1, 8, 16),
                                    r(1, 8, 16)), {}
    if name == "ssd_scan_bwd":
        return ops.ssd_scan_bwd, (r(1, 2, 8, 16), r(1, 2, 8), -r(2),
                                  r(1, 1, 8, 16), r(1, 1, 8, 16),
                                  r(1, 2, 8, 16), r(1, 2, 16, 16)), \
            dict(chunk=4, states=r(1, 2, 2, 16, 16))
    if name == "modipick_probs":
        return ops.modipick_probs, (*pool(3)[:3], r(4), r(4),
                                    torch.ones(4, 3, **f)), {}
    if name == "fused_select":
        return ops.fused_select, (*pool(3), r(4), r(4), r(4)), {}
    if name == "charged_select":
        return ops.charged_select, (*pool(3), r(3),
                                    torch.ones(3, 2, dtype=torch.bool, **f),
                                    r(2) + 0.5, r(2), r(4), r(4), r(4),
                                    r(4)), {}
    return ops.stacked_select, (r(2, 3), r(2, 3), r(3), r(3),
                                i32(0, 1, 0, 1), r(4), r(4), r(4)), {}


@pytest.mark.parametrize("name", [w.__name__ for w in ops.WRAPPERS
                                  if w not in ops.DIFFERENTIABLE])
def test_wrappers_refuse_inputs_that_require_grad(gen, name):
    """A CUDA kernel without a backward kernel (every one but K2's, K4's
    and K5's, and those three's backward kernels, which take no second
    derivative): under grad mode an input that requires grad raises
    (naming the wrapper) before anything launches; under
    torch.no_grad() the same call runs."""
    fn, args, kw = _grad_case(name)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match=name):
        fn(*args, **kw)
    assert ops.launch_counts() == before
    with torch.no_grad():
        fn(*args, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before[name] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (4, 6, 6, 64, 1500, 64),     # whisper's cross-attention prefill
    (1, 6, 6, 1500, 1500, 64),   # whisper's encoder
    (2, 8, 2, 77, 300, 128), (1, 4, 1, 300, 40, 256), (2, 4, 4, 1, 33, 32)])
def test_flash_kernel_without_the_causal_mask(gen, dtype, B, H, KV, Sq, Sk,
                                              hd):
    q = _randn(gen, B, Sq, H, hd, dtype=dtype).transpose(1, 2)
    k = _randn(gen, B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
    v = _randn(gen, B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ref.flash_attention_ref(q, k, v, causal=False), **TOL[dtype])


@pytest.mark.parametrize("arch,int8", [("whisper-tiny", False),
                                       ("internvl2-2b", False),
                                       ("qwen2-1.5b", True),
                                       ("whisper-tiny", True)])
def test_reduced_models_kernel_path_matches_plain_path(gen, arch, int8):
    """A reduced model in float32 on the card: prefill and three greedy
    decode steps on the kernel path against the plain path, logits to
    1e-4; every attention layer launches its kernels (the encoder's and
    the cross-attention's K2, the cross decode's K3)."""
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config(arch).reduced()
    if int8:
        cfg = replace(cfg, kv_cache_dtype="int8")
    params = M.init_params(cfg, gen, torch.float32)
    B, S = 2, 24
    n_img = cfg.vlm.n_image_tokens if cfg.vlm else 0
    batch = api.make_train_batch(cfg, ShapeConfig("p", S + n_img, B,
                                                  "prefill"), gen)
    batch = {k: (v * 50 if v.is_floating_point() else v)
             for k, v in batch.items()}  # embeddings of unit scale
    runs, launched = [], []
    for impl in (ops.KERNELS, ops.PLAIN):
        before = ops.launch_counts()
        cache, logits = M.prefill(cfg, params, batch, 48, impl=impl)
        out = [logits]
        for i in range(3):
            pos = torch.full((B,), S + n_img + i, dtype=torch.int32,
                             device="cuda")
            logits, cache = M.decode_step(cfg, params, cache,
                                          torch.argmax(out[-1], -1), pos,
                                          impl=impl)
            out.append(logits)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        runs.append(out)
        launched.append({k: after[k] - before[k] for k in after})
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    n = cfg.n_layers
    want = dict.fromkeys(launched[0], 0)
    # the encoder's layers, then the decoder's self (and cross) attention
    want["flash_attention"] = ((cfg.encdec.n_encoder_layers + 2 * n)
                               if cfg.encdec else n)
    want["decode_attention_int8" if int8 else "decode_attention"] += 3 * n
    if cfg.encdec:
        want["decode_attention"] += 3 * n  # the cross decode
    assert launched == [want, dict.fromkeys(want, 0)]


# ----------------------------------------------------------------------
# The backward kernels (K2, K5).  Tolerance relative to max(max |want|,
# 1): 1e-5 in float32 (summation order), 1e-2 in bfloat16 (one rounding
# of the output; the kernels and the plain versions both accumulate in
# fp32).
# ----------------------------------------------------------------------
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _close_scaled(got, want, dtype):
    scale = max(float(want.float().abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max()) / scale
    assert got.dtype == want.dtype and got.shape == want.shape
    assert err <= BWD_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (4, 12, 2, 1024, 1024, 128, True, 0),   # qwen2's training shape
    (2, 10, 1, 1024, 1024, 256, True, 2048),  # recurrentgemma's local
    (1, 6, 6, 1500, 1500, 64, False, 0),    # whisper's encoder
    (2, 6, 6, 64, 1500, 64, False, 0),      # whisper's cross-attention
    (1, 4, 2, 1024, 1024, 128, True, 256),  # a window inside S
    (1, 4, 2, 1000, 1000, 128, True, 0),    # ragged S
    (2, 8, 8, 200, 200, 128, True, 0),      # G = 1
    (2, 4, 4, 77, 77, 32, True, 0), (1, 2, 1, 40, 40, 16, True, 0),
    (1, 8, 4, 300, 300, 64, True, 50), (1, 4, 1, 300, 40, 256, False, 0),
    (1, 16, 1, 1024, 1024, 128, True, 0),    # a small grid the blocks fill
    (1, 10, 1, 4096, 4096, 256, True, 2048),  # recurrentgemma's window bites
])
def test_flash_bwd_kernel_matches_plain(gen, dtype, B, H, KV, Sq, Sk, hd,
                                        causal, window):
    q = _randn(gen, B, Sq, H, hd, dtype=dtype).transpose(1, 2)
    k = _randn(gen, B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
    v = _randn(gen, B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
    dout = _randn(gen, B, H, Sq, hd, dtype=dtype)  # another layout than o
    o, lse = _flash_with_lse(q, k, v, causal, window)
    torch.testing.assert_close(
        lse, ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                         window=window), rtol=2e-6,
        atol=2e-6)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal,
                                  window=window)
    again = ops.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal=causal,
                                       window=window)
    for g, a, w, t in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)  # no atomics: the same bits every run
        # the gradient has its input's memory order
        assert sorted(range(4), key=lambda i: -g.stride(i)) == \
            sorted(range(4), key=lambda i: -t.stride(i))
        _close_scaled(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_takes_rows_off_16_bytes(gen, dtype):
    """The backward kernels copy rows 16 bytes at a time: q, k, v and
    dout whose rows start off 16 bytes (views one element into a larger
    buffer) are copied first, and the gradients match the plain
    version."""
    B, H, KV, S, hd = 1, 4, 2, 96, 64

    def shifted(*shape):
        flat = _randn(gen, math.prod(shape) + 1, dtype=dtype)
        return flat[1:].view(*shape)

    q = shifted(B, S, H, hd).transpose(1, 2)
    k = shifted(B, S, KV, hd).transpose(1, 2)
    v = shifted(B, S, KV, hd).transpose(1, 2)
    dout = shifted(B, H, S, hd)
    assert q.data_ptr() % 16 and dout.data_ptr() % 16
    o, lse = _flash_with_lse(q.contiguous(), k.contiguous(), v.contiguous(),
                             True, 0)
    got = ops.flash_attention_bwd(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, dout)
    for g, w in zip(got, want):
        _close_scaled(g, w, dtype)


@pytest.mark.parametrize("field,bad", [
    ("dq_grid", lambda g: (g[0], g[1] - 1)),    # a q tile left out
    ("dkdv_grid", lambda g: (g[0], g[1] + 1)),  # an empty key tile
    ("dkdv_grid", lambda g: (g[0] - 1, g[1])),  # a head left out
    ("scratch", lambda n: n - 4)])              # partials too small
def test_flash_bwd_launch_refuses_a_plan_that_does_not_cover(
        gen, monkeypatch, field, bad):
    """The launch takes its grids and scratch from ``bwd_plan`` and
    refuses ones that do not cover the shapes, launching nothing."""
    from repro_torch.kernels import flash_attention as fa
    B, H, KV, S, hd = 1, 4, 2, 200, 64
    q = _randn(gen, B, H, S, hd, dtype=torch.float32)
    k = _randn(gen, B, KV, S, hd, dtype=torch.float32)
    v = _randn(gen, B, KV, S, hd, dtype=torch.float32)
    dout = _randn(gen, B, H, S, hd, dtype=torch.float32)
    o, lse = _flash_with_lse(q, k, v, True, 0)
    plan = fa.bwd_plan

    def wrong(*args):
        p = plan(*args)
        return p._replace(**{field: bad(getattr(p, field))})

    monkeypatch.setattr(fa, "bwd_plan", wrong)
    before = ops.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.flash_attention_bwd(q, k, v, o, lse, dout)
    assert ops.flash_attention_bwd.launches == before


def _flash_with_lse(q, k, v, causal, window):
    from repro_torch.kernels import flash_attention as fa
    with torch.no_grad():
        return fa._forward(q, k, v, causal, window, with_lse=True)


def test_flash_serve_call_writes_no_lse_and_grad_call_goes_through_bwd(gen):
    """Under no_grad K2 launches once and nothing else; on inputs that
    require grad it launches its forward once and, in backward, its
    backward kernel once, and the gradients match autograd of the plain
    version."""
    q = _randn(gen, 2, 64, 4, 64, dtype=torch.float32).transpose(1, 2)
    k = _randn(gen, 2, 64, 2, 64, dtype=torch.float32).transpose(1, 2)
    v = _randn(gen, 2, 64, 2, 64, dtype=torch.float32).transpose(1, 2)
    before = ops.launch_counts()
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=20)
    grads = torch.autograd.grad((out * out).sum(), leaves)
    end = ops.launch_counts()
    assert end["flash_attention"] == after["flash_attention"] + 1
    assert end["flash_attention_bwd"] == after["flash_attention_bwd"] + 1
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    out_p = ref.flash_attention_ref(*plain, window=20)
    want = torch.autograd.grad((out_p * out_p).sum(), plain)
    for g, w in zip(grads, want):
        _close_scaled(g, w, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [
    (2, 1024, 2560),   # recurrentgemma-2b's training shape
    (2, 1000, 2560),   # ragged S
    (1, 600, 64),      # several chunks at a narrow width
    (1, 5000, 40), (1, 1, 7), (3, 77, 128), (4, 129, 2560),
    (2, 2048, 2560), (2, 4096, 2560),  # 11 and 22 chained chunks
    (2, 3000, 2560)])  # ragged: the last chunk is short
def test_rglru_bwd_kernel_matches_plain(gen, dtype, B, S, W):
    a = (torch.sigmoid(_randn(gen, B, S, W, dtype=torch.float32)) * 0.98
         ).to(dtype)
    b = (_randn(gen, B, S, W, dtype=torch.float32) * 0.1).to(dtype)
    dh = _randn(gen, B, S, W, dtype=dtype)
    with torch.no_grad():
        h = ops.rglru_scan(a, b)
    before = ops.rglru_scan_bwd.launches
    got = ops.rglru_scan_bwd(a, h, dh)
    again = ops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert ops.rglru_scan_bwd.launches == before + 2
    want = ref.rglru_scan_bwd_ref(a, h, dh)
    for g, x, w in zip(got, again, want):
        assert torch.equal(g, x)
        _close_scaled(g, w, dtype)


def test_rglru_grad_call_goes_through_bwd(gen):
    a = (torch.sigmoid(_randn(gen, 2, 300, 96, dtype=torch.float32)) * 0.9
         ).requires_grad_()
    b = _randn(gen, 2, 300, 96, dtype=torch.float32).requires_grad_()
    before = ops.launch_counts()
    h = ops.rglru_scan(a, b)
    grads = torch.autograd.grad((h * h).sum(), (a, b))
    after = ops.launch_counts()
    assert after["rglru_scan"] == before["rglru_scan"] + 1
    assert after["rglru_scan_bwd"] == before["rglru_scan_bwd"] + 1
    ap, bp = a.detach().requires_grad_(), b.detach().requires_grad_()
    hp = ref.rglru_scan_ref(ap, bp)
    want = torch.autograd.grad((hp * hp).sum(), (ap, bp))
    for g, w in zip(grads, want):
        _close_scaled(g, w, torch.float32)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "whisper-tiny", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b", "internvl2-2b"])
def test_reduced_train_step_kernel_path_matches_plain_path(gen, arch):
    """A reduced model's loss and every gradient on the card, kernel
    path against plain path, fp32, 1e-4 of each leaf's max |gradient|;
    K2's, K4's and K5's backward kernels launch once per layer that runs
    them (mamba2's S 40 over chunks of 32: a ragged second chunk;
    moonshot's MoE under autograd; internvl2's K2-bwd behind its image
    prefix)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.training.train_step import loss_and_grads
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, gen, torch.float32)
    batch = api.make_train_batch(cfg, ShapeConfig("t", 40, 2, "train"), gen)
    runs = []
    for impl in (ops.KERNELS, ops.PLAIN):
        before = ops.launch_counts()
        loss, _, grads = loss_and_grads(
            api.make_forward_loss(cfg, remat=True, impl=impl), params, batch)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        runs.append((loss, grads, {k: after[k] - before[k] for k in after}))
    (lk, gk, nk), (lp, gp, np_) = runs
    assert float(lk) == pytest.approx(float(lp), rel=1e-5)
    for path, g in gk.items():
        scale = max(float(gp[path].abs().max()), 1e-12)
        assert float((g - gp[path]).abs().max()) <= 1e-4 * scale, path
    assert not any(np_.values())
    attn_layers = sum(k in ("attn", "local") for k in cfg.block_kinds)
    if cfg.encdec:
        attn_layers = cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    assert nk["flash_attention_bwd"] == attn_layers
    assert nk["rglru_scan_bwd"] == sum(k == "rglru" for k in cfg.block_kinds)
    assert nk["ssd_scan_bwd"] == sum(k == "ssd" for k in cfg.block_kinds)


# (B, H, G, S, hd, N, chunk) of K4-bwd against its plain version
SSD_BWD_SHAPES = [
    (2, 8, 1, 1024, 64, 128, 256),   # mamba2's training shape, 8 heads
    (1, 8, 2, 600, 64, 128, 256),    # groups, the last chunk ragged
    (2, 4, 1, 128, 64, 128, 256),    # one short chunk
    (1, 4, 2, 130, 128, 64, 64),     # hd 128, a two-row last chunk
    (2, 4, 2, 96, 16, 16, 32),       # hd 16, three chunks
    (1, 2, 1, 600, 128, 24, 128),    # N 24
    (1, 4, 1, 40, 16, 16, 32),       # the reduced config
    (1, 8, 4, 512, 32, 64, 128),     # four groups
    (1, 10, 1, 1024, 64, 128, 256),  # 10 heads in 7 splits of 2: two empty
    (2, 10, 1, 1024, 64, 128, 256),  # 10 heads in 4 splits: 3, 3, 3 and 1
    (1, 4, 1, 300, 128, 128, 256),   # hd 128 at G 1
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain(gen, dtype, B, H, G, S, hd, N, chunk):
    """dx, ddt, dA, dB_ and dC_ against ``ref.ssd_scan_bwd_ref``, each
    relative to max(max |value|, 1): in float32 to ``SSD_TOL`` (the
    chunked and the sequential forms sum in different orders), in
    bfloat16 to 1e-2 (one rounding of the output; the forward's bf16
    chunk states are themselves within ``SSD_TOL``'s 2e-2), with and
    without a final-state gradient; the forward's chunk states against
    ``ref.ssd_chunk_states_ref``; two calls equal bit for bit."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(gen, B, H, G, S, hd, N, dtype)
    dy = _randn(gen, B, H, S, hd, dtype=dtype)
    dstate = _randn(gen, B, H, hd, N, dtype=torch.float32)
    with torch.no_grad():
        _, _, states = ssd._forward(*args, chunk, with_states=True)
    want_states = ref.ssd_chunk_states_ref(*args, chunk=chunk)
    scale = max(float(want_states.abs().max()), 1.0)
    torch.testing.assert_close(states / scale, want_states / scale,
                               **SSD_TOL[dtype])
    tol = {torch.float32: SSD_TOL[torch.float32],
           torch.bfloat16: dict(atol=1e-2, rtol=0.0)}[dtype]
    for ds in (None, dstate):
        before = ops.ssd_scan_bwd.launches
        got = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk, states=states)
        again = ops.ssd_scan_bwd(*args, dy, ds, chunk=chunk, states=states)
        torch.cuda.synchronize()
        assert ops.ssd_scan_bwd.launches == before + 2
        want = ref.ssd_scan_bwd_ref(*args, dy, ds, chunk=chunk)
        for g, a, w, t in zip(got, again, want, args):
            assert torch.equal(g, a)
            assert g.dtype == t.dtype and g.shape == t.shape
            scale = max(float(w.float().abs().max()), 1.0)
            torch.testing.assert_close(g.float() / scale, w.float() / scale,
                                       **tol)


def test_ssd_grad_call_goes_through_bwd(gen):
    """Under no_grad K4 launches once and nothing else; on inputs that
    require grad it launches its forward once and, in backward, its
    backward kernels once, and the gradients match autograd of the plain
    version, with and without the final state's gradient."""
    args = _ssd_inputs(gen, 2, 4, 2, 300, 32, 64, torch.float32)
    before = ops.launch_counts()
    with torch.no_grad():
        ops.ssd_scan(*args, chunk=128)
    after = ops.launch_counts()
    assert after["ssd_scan"] == before["ssd_scan"] + 1
    assert after["ssd_scan_bwd"] == before["ssd_scan_bwd"]
    for use_state in (False, True):
        leaves = [t.detach().requires_grad_() for t in args]
        start = ops.launch_counts()
        y, st = ops.ssd_scan(*leaves, chunk=128)
        loss = (y * y).sum() + ((st * st).sum() if use_state else 0.0)
        grads = torch.autograd.grad(loss, leaves)
        end = ops.launch_counts()
        assert end["ssd_scan"] == start["ssd_scan"] + 1
        assert end["ssd_scan_bwd"] == start["ssd_scan_bwd"] + 1
        plain = [t.detach().requires_grad_() for t in args]
        yp, sp = ref.ssd_scan_ref(*plain)
        lp = (yp * yp).sum() + ((sp * sp).sum() if use_state else 0.0)
        want = torch.autograd.grad(lp, plain)
        for g, w in zip(grads, want):
            _close_scaled(g, w, torch.float32)


def _bad_grid(i, fix):
    """The plan's grids with pass i's grid changed by fix."""
    return lambda g: g[:i] + (fix(g[i]),) + g[i + 1:]


@pytest.mark.parametrize("field,bad", [
    ("grids", _bad_grid(1, lambda g: (g[0] - 1, g[1], g[2]))),  # a chunk left out
    ("grids", _bad_grid(3, lambda g: (g[0], g[1] + 1, g[2]))),  # an empty head row
    ("grids", _bad_grid(5, lambda g: (g[0] - 1, g[1], g[2]))),  # columns left out
    ("grids", _bad_grid(2, lambda g: (g[0] + 1, g[1], g[2]))),  # a split too many
    ("nsplit", lambda n: n + 1),
    ("n_chunks", lambda n: n + 1)])
def test_ssd_bwd_launch_refuses_a_plan_that_does_not_cover(
        gen, monkeypatch, field, bad):
    """The launch takes its grids from ``bwd_plan`` and refuses ones that
    do not cover the shapes, launching nothing."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(gen, 1, 4, 1, 200, 32, 32, torch.float32)
    dy = _randn(gen, 1, 4, 200, 32, dtype=torch.float32)
    with torch.no_grad():
        _, _, states = ssd._forward(*args, 64, with_states=True)
    plan = ssd.bwd_plan

    def wrong(*a):
        p = plan(*a)
        return p._replace(**{field: bad(getattr(p, field))})

    monkeypatch.setattr(ssd, "bwd_plan", wrong)
    before = ops.ssd_scan_bwd.launches
    with pytest.raises((RuntimeError, ValueError)):
        ops.ssd_scan_bwd(*args, dy, chunk=64, states=states)
    assert ops.ssd_scan_bwd.launches == before


def test_ssd_bwd_plan_mirrors_the_kernel(gen):
    """The shared memory the training path's kernels take, as they report
    it, equals ``train_smem``'s at every head size, and ``fwd_plan`` and
    ``bwd_plan`` hand it to the passes."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd
    fn = build.function("ssd_scan", "ssd_scan_train_smem",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for hd in ssd.HEAD_DIMS:
        for N, cs in ((128, 256), (24, 100), (64, 64), (136, 128)):
            out = (ctypes.c_longlong * 8)()
            assert fn(hd, N, cs, ctypes.cast(out, ctypes.c_void_p)) == 0
            sm = ssd.train_smem(hd, N, cs)
            assert list(out) == list(sm)
            f = ssd.fwd_plan(1, 1, 1, cs, hd, N, cs)
            b = ssd.bwd_plan(1, 1, 1, cs, hd, N, cs)
            assert f.smem == (sm.scores, sm.fwd_state, 0, sm.fwd_out)
            assert b.smem == (sm.scores, sm.local, sm.ds, 0, sm.dx, sm.dbdc,
                              sm.dt, 0)


@pytest.mark.parametrize("bad", [
    _bad_grid(0, lambda g: (g[0] - 1, g[1], g[2])),  # a tile pair left out
    _bad_grid(1, lambda g: (g[0], g[1] - 1, g[2])),  # a head left out
    _bad_grid(3, lambda g: (g[0] - 1, g[1], g[2]))])  # a row tile left out
def test_ssd_f32_launch_refuses_a_plan_that_does_not_cover(gen, monkeypatch,
                                                          bad):
    """The fp32 forward takes its grids from ``fwd_plan`` and refuses
    ones that do not cover the shapes, launching nothing."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(gen, 1, 4, 1, 200, 32, 32, torch.float32)
    plan = ssd.fwd_plan

    def wrong(*a):
        p = plan(*a)
        return p._replace(grids=bad(p.grids))

    monkeypatch.setattr(ssd, "fwd_plan", wrong)
    before = ops.ssd_scan.launches
    with pytest.raises(RuntimeError):
        with torch.no_grad():
            ops.ssd_scan(*args, chunk=64)
    assert ops.ssd_scan.launches == before
