"""K4's fp32 training path (the forward's fp32 body and K4-bwd) on the
CPU: its launch plans, its numerics, and its decomposition.

- ``ssd_scan.fwd_plan`` / ``bwd_plan``: every (chunk, head, batch), every
  row and every 64 × 64 tile pair of a chunk is covered once, the heads
  of the dscores pass's splits cover each group once and never cross a
  group, every block fits the card's shared memory at every head size,
  and the scratch is what the kernels carve from it.
- 3xTF32 (``split_tf32`` and ``mma_3xtf32`` in ``csrc/ssd_train.cuh``)
  emulated bit for bit in torch on the products of one chunk at
  mamba2-1.3b's training shape: the fp32 operands split by bits, the
  tensor core's TF32 inputs (13 low bits ignored), its sums truncated
  toward zero, each 32-deep slice added in fp32.  Held in float64 to
  ``SSD_TOL``'s 2e-5 of the product's max |value| (one TF32 product is
  not).
- The three-pass decomposition the kernels run (per chunk local states
  or local dS terms, an elementwise chain, a chunk pass; the scores
  once per group; dB and dC from the dscores summed over the heads;
  ddt by a reverse running sum; dA from paired d(cum) terms), in
  float64, against the reference's ``ssd_chunked``
  (``src/repro/models/ssm.py``) and its ``jax.grad``, ragged S and
  G 2 included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ssd_scan as ssd

REL = 2e-5

# (B, H, G, S, hd, N, chunk): the card's checks (chip_smoke's SSD_BWD,
# tests/test_torch_cuda.py's shapes), 10 heads of one group (in the
# dscores pass's splits: five of 2 heads and two empty; 3, 3, 3 and 1),
# hd 128 at G 1, N 136.
SHAPES = [(2, 64, 1, 1024, 64, 128, 256), (2, 64, 1, 1000, 64, 128, 256),
          (2, 64, 1, 128, 64, 128, 256), (1, 8, 2, 600, 64, 128, 256),
          (2, 16, 4, 512, 32, 64, 128), (1, 64, 1, 4096, 64, 128, 256),
          (1, 10, 1, 1024, 64, 128, 256), (2, 10, 1, 1024, 64, 128, 256),
          (1, 4, 1, 300, 128, 128, 256),
          (1, 4, 2, 130, 128, 64, 64), (2, 4, 2, 96, 16, 16, 32),
          (1, 2, 1, 600, 128, 24, 128), (1, 4, 1, 40, 16, 16, 32),
          (1, 2, 1, 70, 32, 32, 100), (1, 3, 1, 200, 32, 136, 256)]


def _chunk_rows(S, cs):
    return [(c * cs, min(cs, S - c * cs)) for c in range(-(-S // cs))]


@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", SHAPES)
def test_fwd_plan_covers_every_row_and_pair_once(B, H, G, S, hd, N, chunk):
    """The state pass a block a (chunk, head, batch); the out pass every
    row of every (batch, head) once over its 64-row tiles (empty tiles
    past a short chunk return); the chain every element of (hd, N) a
    (head, batch) once; the scores pass every live tile pair of each
    (batch, group, chunk) once; the scratch holds the scores, the
    totals and, without the states, the states."""
    for with_states in (True, False):
        p = ssd.fwd_plan(B, H, G, S, hd, N, chunk, with_states)
        nc, cs, nt = p.n_chunks, p.cs, p.tiles
        assert nt == -(-cs // 64) and p.pairs == nt * (nt + 1) // 2
        scores, state, chain, out = p.grids
        assert state == (nc, H, B)
        rows = np.zeros(S, dtype=np.int64)
        for x in range(out[0]):
            c, it = x // nt, nt - 1 - x % nt
            s0, ln = _chunk_rows(S, cs)[c]
            lo = s0 + 64 * it
            if 64 * it < ln:
                rows[lo:s0 + min(ln, 64 * it + 64)] += 1
        assert out[1:] == (H, B) and (rows == 1).all()
        assert chain[1:] == (H, B) and chain[0] * 256 >= hd * N > (
            chain[0] - 1) * 256
        assert scores[1:] == (nc, B * G) and scores[0] == p.pairs
        for s0, ln in _chunk_rows(S, cs):
            live = -(-ln // 64)
            pairs = {(it, jt) for it in range(nt) for jt in range(it + 1)
                     if 64 * it < ln}
            assert len(pairs) == live * (live + 1) // 2
        cs64 = 64 * nt
        assert p.scratch == 4 * (B * G * nc * cs64 * cs64 + B * H * nc + (
            0 if with_states else B * H * nc * hd * N))


@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", SHAPES)
def test_bwd_plan_splits_heads_within_their_group(B, H, G, S, hd, N, chunk):
    """The dscores pass's splits cover every head of every group once,
    and no split crosses a group; the splits are the fewest that give
    the pass two blocks an SM, and never more than a group's heads;
    the dx pass covers every row of every (batch, head) once and the
    dB / dC pass every (row, column of N) of every (batch, group) once
    for each of the two."""
    p = ssd.bwd_plan(B, H, G, S, hd, N, chunk)
    hg = H // G
    assert 1 <= p.nsplit <= hg
    units = p.pairs * p.n_chunks * B * G
    assert p.nsplit == hg or p.nsplit * units >= 2 * ssd.SMS
    assert p.nsplit == 1 or (p.nsplit - 1) * units < 2 * ssd.SMS
    seen = np.zeros(H, dtype=np.int64)
    for g, splits in enumerate(ssd.split_heads(H, G, p.nsplit)):
        assert len(splits) == p.nsplit
        for lo, hi in splits:
            assert g * hg <= lo <= hi <= (g + 1) * hg
            seen[lo:hi] += 1
    assert (seen == 1).all()
    assert p.grids[2] == (p.pairs * p.nsplit, p.n_chunks, B * G)
    nt, cs = p.tiles, p.cs
    rows = np.zeros(S, dtype=np.int64)
    for x in range(p.grids[4][0]):
        s0, ln = _chunk_rows(S, cs)[x // nt]
        jt = x % nt
        if 64 * jt < ln:
            rows[s0 + 64 * jt:s0 + min(ln, 64 * jt + 64)] += 1
    assert p.grids[4][1:] == (H, B) and (rows == 1).all()
    nslab = -(-N // 64)
    cover = np.zeros((2, S, nslab * 64), dtype=np.int64)
    for x in range(p.grids[5][0]):
        rt, ns, which = x % nt, x // nt % nslab, x // (nt * nslab)
        for s0, ln in _chunk_rows(S, cs):
            if 64 * rt < ln:
                cover[which, s0 + 64 * rt:s0 + min(ln, 64 * rt + 64),
                      64 * ns:64 * ns + 64] += 1
    assert p.grids[5][1:] == (p.n_chunks, B * G)
    assert (cover[:, :, :N] == 1).all()


@pytest.mark.parametrize("hd", ssd.HEAD_DIMS)
def test_training_path_fits_shared_memory(hd):
    """Every block of the training path, forward and backward, fits the
    card's shared memory at every head size at mamba2's N 128 and chunk
    256, and at every shape the card's checks run; the fp32 forward's
    ``smem_bytes`` is its largest pass."""
    shapes = [(1, 1, 1, 256, hd, 128, 256)] + SHAPES
    for B, H, G, S, hd_, N, chunk in shapes:
        f = ssd.fwd_plan(B, H, G, S, hd_, N, chunk)
        b = ssd.bwd_plan(B, H, G, S, hd_, N, chunk)
        assert max(f.smem + b.smem) <= ssd.SMEM_LIMIT
        assert ssd.smem_bytes(hd_, N, f.cs, torch.float32) == max(f.smem)


def test_training_scratch_is_what_the_kernels_carve():
    """The backward's scratch: the scores and nsplit dscores sums (B G,
    nc, cs64, cs64); dS_out (B, H, nc, hd, N); cum, q and dw (B, H, S);
    the totals, ⟨G, S_in⟩, the paired dA sums a tile pair and the dA
    partials; the d(cum) row and column sums (64 a tile pair)."""
    B, H, G, S, hd, N, chunk = 2, 64, 1, 1024, 64, 128, 256
    p = ssd.bwd_plan(B, H, G, S, hd, N, chunk)
    nc, cs64 = p.n_chunks, 64 * p.tiles
    floats = ((1 + p.nsplit) * B * G * nc * cs64 ** 2 + B * H * nc * hd * N
              + 3 * B * H * S + 2 * B * H * nc + 2 * B * H * nc * p.pairs
              * 64 + B * H * nc * p.pairs + B * H * nc)
    assert p.scratch == 4 * floats
    assert p.nsplit == 4 and p.grids[2] == (40, 4, 2)


# ----------------------------------------------------------------------
# 3xTF32, bit for bit.
# ----------------------------------------------------------------------
def _bits(x):
    return x.contiguous().view(torch.int32)


def _split_tf32(x):
    """x = big + small: big x rounded to TF32 (13 low bits cleared, half
    away from zero), small the exact remainder (``split_tf32``)."""
    big = ((_bits(x) + 0x1000) & -8192).view(torch.float32)
    return big, x - big


def _tf32(x):
    """What the tensor core reads of an fp32 operand: its 13 low bits
    ignored."""
    return (_bits(x) & -8192).view(torch.float32)


def _rz(d):
    """float64 to float32 rounded toward zero (the tensor core's sums)."""
    f = d.float()
    return torch.where(f.double().abs() > d.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(a, b, split=True):
    """a (M, K) · b (K, N) in fp32 as ``warp_mma`` runs it: 8-deep
    k-steps, each three TF32 products (small·big, big·small, big·big;
    one big·big without ``split``) summed on the tensor core, the sum
    of 4 k-steps added to the running fp32 sum."""
    K = a.shape[1]
    pad = -K % 32
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, K + pad, 32):
        p = torch.zeros_like(acc)
        for k in range(k0, k0 + 32, 8):
            ab, as_ = _split_tf32(a[:, k:k + 8])
            bb, bs = _split_tf32(b[k:k + 8])
            terms = ((as_, bb), (ab, bs), (ab, bb)) if split else \
                ((_tf32(a[:, k:k + 8]), _tf32(b[k:k + 8])),)
            for x, y in terms:
                p = _rz(p.double() + _tf32(x).double() @ _tf32(y).double())
        acc = acc + p
    return acc


def _chunk_operands(seed):
    """One chunk of 256 rows at mamba2-1.3b's training shape (hd 64,
    N 128), inputs as ``chip_smoke.ssd_args`` draws them, and the
    chunk's entry state from the 256 rows before it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    cs, hd, N = 256, 64, 128
    x = torch.from_numpy(f(2 * cs, hd) * 0.5).float()
    Bm = torch.from_numpy(f(2 * cs, N) * 0.3).float()
    Cm = torch.from_numpy(f(2 * cs, N) * 0.3).float()
    dt = torch.nn.functional.softplus(torch.from_numpy(f(2 * cs) - 2.0)).float()
    A = -float(np.exp(f() * 0.3))
    cum = torch.cumsum(dt.double() * A, 0)
    w = torch.exp(cum[cs - 1] - cum[:cs]) * dt[:cs].double()
    S_in = ((x[:cs].double() * w[:, None]).T @ Bm[:cs].double()).float()
    cum = torch.cumsum(dt[cs:].double() * A, 0)
    L = torch.exp((cum[:, None] - cum[None, :]).clamp(-60, 0)).tril()
    sc = Cm[cs:] @ Bm[cs:].T
    M = (sc.double() * L * dt[cs:].double()[None, :]).float()
    return x[cs:], Bm[cs:], Cm[cs:], S_in, M, cum


@pytest.mark.parametrize("product", ["scores", "MX", "inter", "state"])
def test_3xtf32_holds_ssd_tol_on_the_training_chunk(product):
    """Each product of the forward's chunk, bit for bit as the kernel
    runs it, within 2e-5 of its max |value| of the float64 product of
    the same fp32 operands; one TF32 product is not."""
    x, Bm, Cm, S_in, M, cum = _chunk_operands(26)
    w = (torch.exp(cum[-1] - cum) * 1.0).float()
    a, b = {"scores": (Cm, Bm.T), "MX": (M, x), "inter": (Cm, S_in.T),
            "state": ((x * w[:, None]).T.contiguous(), Bm)}[product]
    a, b = a.contiguous(), b.contiguous()
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err = float((_mma(a, b).double() - exact).abs().max()) / scale
    assert err <= REL, err
    err1 = float((_mma(a, b, split=False).double() - exact).abs().max()) \
        / scale
    assert err1 > REL, err1


def test_split_tf32_is_exact_and_small_fits_tf32():
    """big + small == x exactly; big has 13 clear low bits; what the
    tensor core reads of small is within 2^-21 of |x| of it."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(4096) * 10 ** rng.uniform(
        -3, 3, 4096)).float()
    big, small = _split_tf32(x)
    assert torch.equal(big + small, x)
    assert not (_bits(big) & 0x1fff).any()
    assert ((x.double() - big.double() - _tf32(small).double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()


# ----------------------------------------------------------------------
# The decomposition, in float64, against the reference.
# ----------------------------------------------------------------------
def _clip_exp(v):
    return torch.exp(v.clamp(-60.0, 0.0))


def _per_chunk(S, cs):
    return [slice(c * cs, min(S, (c + 1) * cs)) for c in range(-(-S // cs))]


def three_pass_forward(x, dt, A, Bm, Cm, chunk):
    """y, the final state and the chunk-entry states as the fp32 body's
    passes compute them (float64): each chunk's S_loc; the chain; the
    outputs, the scores C·Bᵀ once per (batch, group, chunk)."""
    Bb, H, S, hd = x.shape
    G = Bm.shape[1]
    hg = H // G
    cs = min(chunk, S)
    Bx, Cx = Bm.repeat_interleave(hg, 1), Cm.repeat_interleave(hg, 1)
    locs, cums, totals = [], [], []
    for sl in _per_chunk(S, cs):
        cum = torch.cumsum(dt[:, :, sl] * A[None, :, None], -1)
        total = cum[..., -1:]
        w = _clip_exp(total - cum) * dt[:, :, sl]
        locs.append(torch.einsum("bhj,bhjp,bhjn->bhpn", w, x[:, :, sl],
                                 Bx[:, :, sl]))
        cums.append(cum)
        totals.append(total[..., 0])
    states = [torch.zeros_like(locs[0])]
    for c in range(len(locs)):  # the chain, elementwise
        states.append(_clip_exp(totals[c])[..., None, None] * states[-1]
                      + locs[c])
    ys = []
    for c, sl in enumerate(_per_chunk(S, cs)):
        sc = torch.einsum("bgin,bgjn->bgij", Cm[:, :, sl], Bm[:, :, sl])
        cum = cums[c]
        L = _clip_exp(cum[..., :, None] - cum[..., None, :]).tril()
        M = sc.repeat_interleave(hg, 1) * L * dt[:, :, sl][..., None, :]
        ys.append(_clip_exp(cum)[..., None] * torch.einsum(
            "bhin,bhpn->bhip", Cx[:, :, sl], states[c])
            + M @ x[:, :, sl])
    return torch.cat(ys, 2), states[-1], torch.stack(states[:-1], 2)


def three_pass_backward(x, dt, A, Bm, Cm, dy, dstate, chunk):
    """(dx, ddt, dA, dB_, dC_) as K4-bwd's passes compute them (float64):
    per chunk the chain's local term Σ e^{cum_i} dy_i ⊗ C_i and q_i =
    e^{cum_i}⟨dy_i, C_i S_inᵀ⟩; the chain of dS_out; dx; the dscores
    summed over each group's heads, with each head's d(cum) row and
    column sums of R = (dy·xᵀ) ⊙ sc ⊙ L; dB_ and dC_ from the summed
    dscores and the heads' inter-chunk terms as one product over (head,
    hd); ddt by a reverse running sum of d(cum); dA from the paired
    terms."""
    Bb, H, S, hd = x.shape
    G = Bm.shape[1]
    hg = H // G
    cs = min(chunk, S)
    _, _, states = three_pass_forward(x, dt, A, Bm, Cm, chunk)
    chunks = _per_chunk(S, cs)
    cum = [torch.cumsum(dt[:, :, sl] * A[None, :, None], -1) for sl in chunks]
    total = [c[..., -1] for c in cum]
    Cx, Bx = Cm.repeat_interleave(hg, 1), Bm.repeat_interleave(hg, 1)
    # local terms and q
    local = [torch.einsum("bhi,bhip,bhin->bhpn", _clip_exp(cum[c]),
                          dy[:, :, sl], Cx[:, :, sl])
             for c, sl in enumerate(chunks)]
    q = [_clip_exp(cum[c]) * torch.einsum(
        "bhip,bhin,bhpn->bhi", dy[:, :, sl], Cx[:, :, sl], states[:, :, c])
        for c, sl in enumerate(chunks)]
    # the chain, elementwise, right to left
    dSo = [None] * len(chunks)
    carry = torch.zeros_like(states[:, :, 0]) if dstate is None else dstate
    for c in range(len(chunks) - 1, -1, -1):
        dSo[c] = carry
        carry = _clip_exp(total[c])[..., None, None] * carry + local[c]
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (x, dt, Bm, Cm))
    dA = torch.zeros_like(A)
    for c, sl in enumerate(chunks):
        cm, G_, S_in = cum[c], dSo[c], states[:, :, c]
        xs, dys, dts = x[:, :, sl], dy[:, :, sl], dt[:, :, sl]
        sc = torch.einsum("bgin,bgjn->bgij", Cm[:, :, sl], Bm[:, :, sl])
        scx = sc.repeat_interleave(hg, 1)
        d = cm[..., :, None] - cm[..., None, :]
        L = _clip_exp(d).tril()
        ew = _clip_exp(total[c][..., None] - cm)
        w = ew * dts
        BG = torch.einsum("bhjn,bhpn->bhjp", Bx[:, :, sl], G_)
        dw = (BG * xs).sum(-1)
        dx[:, :, sl] = w[..., None] * BG + (scx * L * dts[..., None, :]
                                            ).transpose(-1, -2) @ dys
        dm = dys @ xs.transpose(-1, -2)
        R = dm * scx * L
        dsc = (dm * L * dts[..., None, :]).view(Bb, G, hg, *dm.shape[2:])
        dS = dsc.sum(2)  # over each group's heads
        dC[:, :, sl] = torch.einsum(
            "bghip,bghpn->bgin",
            (_clip_exp(cm)[..., None] * dys).view(Bb, G, hg, -1, hd),
            S_in.view(Bb, G, hg, hd, -1)) + dS @ Bm[:, :, sl]
        dB[:, :, sl] = torch.einsum(
            "bghjp,bghpn->bgjn", (w[..., None] * xs).view(Bb, G, hg, -1, hd),
            G_.view(Bb, G, hg, hd, -1)) + dS.transpose(-1, -2) @ Cm[:, :, sl]
        rowR = (R * dts[..., None, :]).sum(-1)
        colR = R.sum(-2)
        gs = (G_ * S_in).sum((-1, -2))
        dcum = q[c] + rowR - dts * colR - w * dw
        dtot = (w * dw).sum(-1) + _clip_exp(total[c]) * gs
        suffix = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
        ddt[:, :, sl] = colR + ew * dw + A[None, :, None] * (
            suffix + dtot[..., None])
        dA += ((q[c] * cm).sum(-1) + (R * dts[..., None, :] * d).sum((-1, -2))
               + (w * dw * (total[c][..., None] - cm)).sum(-1)
               + _clip_exp(total[c]) * gs * total[c]).sum(0) / A
    return dx, ddt, dA, dB, dC


def _inputs(seed, B, H, G, S, hd, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    return [a.astype(np.float32) for a in (
        f(B, H, S, hd) * 0.5, np.log1p(np.exp(f(B, H, S))),
        -np.exp(f(H) * 0.3), f(B, G, S, N) * 0.3, f(B, G, S, N) * 0.3,
        f(B, H, S, hd), f(B, H, hd, N))]


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.detach().double().numpy() - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", [
    (2, 4, 1, 64, 16, 16, 32),    # two chunks, G 1
    (1, 4, 2, 96, 16, 8, 32),     # three chunks, two groups
    (2, 4, 2, 40, 16, 16, 32),    # ragged: a chunk of 32 and one of 8
    (1, 6, 2, 77, 16, 12, 16),    # five chunks, the last of 13
])
def test_three_pass_decomposition_matches_reference(B, H, G, S, hd, N, chunk,
                                                    with_dstate):
    """The passes' float64 decomposition against the reference's chunked
    XLA path (float32): y and the final state, and every gradient of
    ⟨y, dy⟩ (+ ⟨final state, dstate⟩) against ``jax.grad``, to 2e-5 of
    each one's max |value|."""
    x, dt, A, Bm, Cm, dy, dstate = _inputs(S + 3 * G + N, B, H, G, S, hd, N)
    if not with_dstate:
        dstate = None
    seq = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))

    def f(x_, dt_, A_, B_, C_):
        y, st = ssd_chunked(x_, dt_, A_, B_, C_, chunk,
                            return_final_state=True)
        out = jnp.sum(y * seq(dy))
        return out + (0.0 if dstate is None else jnp.sum(st * dstate)), (y, st)

    (_, (y_r, st_r)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            seq(x), seq(dt), jnp.asarray(A), seq(Bm), seq(Cm))
    t = [torch.from_numpy(a).double() for a in (x, dt, A, Bm, Cm, dy)]
    ds = None if dstate is None else torch.from_numpy(dstate).double()
    y, st, _ = three_pass_forward(*t[:5], chunk)
    _close(y, np.swapaxes(np.asarray(y_r), 1, 2))
    _close(st, st_r)
    got = three_pass_backward(*t, ds, chunk)
    back = [np.swapaxes(np.asarray(grads[i]), 1, 2) if i != 2
            else np.asarray(grads[i]) for i in range(5)]
    for g, w in zip(got, back):
        _close(g, w)
