"""The SSD scan's backward (K4-bwd): its plain version against the
reference's autodiff, the CPU path of the wrapper under autograd, and
the launch plan of the kernels.

- ``ssd_scan_bwd_ref`` (the reverse recurrence in fp32, each chunk's h_t
  recomputed from its entry state) against ``jax.grad`` of the
  reference's ``ssd_chunked`` (``src/repro/models/ssm.py``) in float32:
  dx, ddt, dA, dB_ and dC_ to 2e-5 of each one's max |value| (the
  chunked and the sequential forms sum in different orders), over G 1
  and 2, S a multiple of the chunk and ragged, one chunk and several,
  with and without a gradient on the final state
  (``return_final_state=True``).
- ``ssd_chunk_states_ref`` (the entry states K4 writes for the
  backward) against the reference's chunked states.
- Torch autograd of ``ssd_scan_ref`` equals ``ssd_scan_bwd_ref``, and
  ``ops.ssd_scan`` under autograd on the CPU keeps its ``grad_fn``.
- ``ssd_scan.bwd_plan``: every (batch, head, chunk) is covered once,
  and a block of every pass fits the card's shared memory at every head
  size (``tests/test_torch_ssd_redesign.py`` holds the rest of the
  plans).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

REL = 2e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got.detach().float()) - want).max())
    assert err <= rel * scale, (err, scale)


def _inputs(seed, B, H, G, S, hd, N):
    """SSD inputs, dy and a final-state gradient from a numpy seed, in
    the port's (B,H,S,hd) / (B,G,S,N) layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    x = f(B, H, S, hd) * 0.5
    dt = np.log1p(np.exp(f(B, H, S)))
    A = -np.exp(f(H) * 0.3)
    Bm, Cm = f(B, G, S, N) * 0.3, f(B, G, S, N) * 0.3
    dy, dstate = f(B, H, S, hd), f(B, H, hd, N)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, dy, dstate)]


def _reference_grads(x, dt, A, Bm, Cm, dy, dstate, chunk):
    """jax.grad of ⟨y, dy⟩ (+ ⟨final state, dstate⟩) through the
    reference's chunked XLA path, in the port's layouts."""
    seq = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))

    def f(x, dt, A, Bm, Cm):
        y, st = ssd_chunked(x, dt, A, Bm, Cm, chunk,
                            return_final_state=True)
        out = jnp.sum(y * seq(dy))
        if dstate is not None:
            out = out + jnp.sum(st * dstate)
        return out

    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        seq(x), seq(dt), jnp.asarray(A), seq(Bm), seq(Cm))
    back = lambda a: np.swapaxes(np.asarray(a), 1, 2)
    return back(g[0]), back(g[1]), np.asarray(g[2]), back(g[3]), back(g[4])


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", [
    (2, 4, 1, 64, 16, 16, 32),    # two chunks, G 1
    (1, 4, 2, 96, 16, 8, 32),     # three chunks, two groups
    (2, 4, 2, 40, 16, 16, 32),    # ragged: a chunk of 32 and one of 8
    (1, 2, 1, 24, 16, 16, 32),    # one short chunk
    (1, 6, 2, 77, 16, 12, 16),    # five chunks, the last of 13
])
def test_ssd_scan_bwd_ref_matches_reference_grad(B, H, G, S, hd, N, chunk,
                                                 with_dstate):
    x, dt, A, Bm, Cm, dy, dstate = _inputs(S + 7 * G + N, B, H, G, S, hd,
                                           N)
    if not with_dstate:
        dstate = None
    want = _reference_grads(x, dt, A, Bm, Cm, dy, dstate, chunk)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    ds = None if dstate is None else torch.from_numpy(dstate)
    got = ref.ssd_scan_bwd_ref(*t, ds, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    # the CPU path of the wrapper is the plain version
    same = ops.ssd_scan_bwd(*t, ds, chunk=chunk)
    for a, b in zip(got, same):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,chunk,G", [(64, 32, 1), (77, 16, 2), (20, 32, 1)])
def test_ssd_chunk_states_match_reference(S, chunk, G):
    """The entry state of every chunk against the reference's chunked
    form: chunk c's entry state is the final state of the first c
    chunks."""
    B, H, hd, N = 2, 4, 16, 16
    x, dt, A, Bm, Cm, _, _ = _inputs(S, B, H, G, S, hd, N)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    states = ref.ssd_chunk_states_ref(*t, chunk=chunk)
    n_chunks = -(-S // chunk)
    assert states.shape == (B, H, n_chunks, hd, N)
    assert not states[:, :, 0].any()
    for c in range(1, n_chunks):
        s = c * chunk
        _, st = ssd_chunked(*(jnp.asarray(np.swapaxes(a[:, :, :s], 1, 2))
                              for a in (x, dt)), jnp.asarray(A),
                            *(jnp.asarray(np.swapaxes(a[:, :, :s], 1, 2))
                              for a in (Bm, Cm)), chunk,
                            return_final_state=True)
        _close(states[:, :, c], st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_torch_autograd_of_the_plain_scan_equals_its_backward(dtype,
                                                              with_dstate):
    """Autograd of the sequential ``ssd_scan_ref`` and the plain
    backward agree (fp32 math both: order only), and the wrapper's CPU
    path keeps its grad_fn; each gradient is in its input's dtype."""
    x, dt, A, Bm, Cm, dy, dstate = (torch.from_numpy(a) for a in _inputs(
        3, 2, 4, 2, 45, 16, 8))
    x, Bm, Cm, dy = (a.to(dtype) for a in (x, Bm, Cm, dy))
    leaves = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, st = ops.ssd_scan(*leaves, chunk=16)
    assert y.grad_fn is not None and st.grad_fn is not None
    outs, grads = (y, st), (dy, dstate) if with_dstate else (dy, None)
    auto = torch.autograd.grad([o for o, g in zip(outs, grads)
                                if g is not None],
                               leaves, [g for g in grads if g is not None])
    plain = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy,
                                 dstate if with_dstate else None, chunk=16)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for a, b, leaf in zip(auto, plain, leaves):
        assert b.dtype == leaf.dtype
        scale = max(float(a.float().abs().max()), 1.0)
        torch.testing.assert_close(b.float() / scale, a.float() / scale,
                                   **tol)


def test_ssd_scan_bwd_refuses_what_it_cannot_take():
    x, dt, A, Bm, Cm, dy, dstate = (torch.from_numpy(a) for a in _inputs(
        1, 1, 2, 1, 8, 16, 8))
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy[:, :, :4], chunk=4)
    with pytest.raises(ValueError, match="dstate"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate[:, :1], chunk=4)
    with pytest.raises(ValueError, match="states"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=4,
                         states=torch.zeros(1, 2, 3, 16, 8))


# ----------------------------------------------------------------------
# K4-bwd's launch plan (``ssd_scan.bwd_plan``).
# ----------------------------------------------------------------------
H100_SMS = 132
# (B, H, G, S, hd, N, chunk) of every backward the card runs
CARD_BWD = [(2, 64, 1, 1024, 64, 128, 256), (2, 64, 1, 1000, 64, 128, 256),
            (2, 64, 1, 128, 64, 128, 256), (1, 8, 2, 600, 64, 128, 256),
            (2, 16, 4, 512, 32, 64, 128), (1, 64, 1, 4096, 64, 128, 256),
            (1, 4, 2, 130, 128, 64, 64), (2, 4, 2, 96, 16, 16, 32),
            (1, 2, 1, 600, 128, 24, 128), (1, 4, 1, 40, 16, 16, 32)]


@pytest.mark.parametrize("B,H,G,S,hd,N,chunk", CARD_BWD)
def test_ssd_bwd_plan_covers_every_chunk_once(B, H, G, S, hd, N, chunk):
    """The passes a block a (chunk, head, batch) (local, dt) cover every
    (batch, head, chunk) once, and the chunks every step once, none
    empty; the chain every element of (hd, N) a (head, batch) once; the
    scores and dscores passes a block a tile pair (and split) of every
    (batch, group, chunk); dA one block; the scratch holds the scores,
    the dscores sums, dS_out, the per-row and per-chunk vectors and the
    per-tile-pair d(cum) sums."""
    p = ssd.bwd_plan(B, H, G, S, hd, N, chunk)
    nc, cs = p.n_chunks, p.cs
    scores, local, ds, chain, dx, dbdc, dt, da = p.grids
    assert local == dt == (nc, H, B)
    steps = np.zeros((B, H, S), dtype=np.int64)
    for z in range(local[2]):
        for y in range(local[1]):
            for x in range(local[0]):
                lo = x * cs
                assert lo < S  # no empty chunk
                steps[z, y, lo:min(S, lo + cs)] += 1
    assert (steps == 1).all()
    assert chain[1:] == (H, B) and chain[0] * 256 >= hd * N > (
        chain[0] - 1) * 256
    assert scores == (p.pairs, nc, B * G)
    assert ds == (p.pairs * p.nsplit, nc, B * G)
    assert dx == (p.tiles * nc, H, B) and da == (1, 1, 1)
    assert dbdc == (p.tiles * 2 * -(-N // 64), nc, B * G)
    assert p.tiles == -(-cs // 64) and p.pairs == p.tiles * (p.tiles + 1) // 2
    sq = B * G * nc * (64 * p.tiles) ** 2
    bhc = B * H * nc
    assert p.scratch == 4 * ((1 + p.nsplit) * sq + bhc * hd * N
                             + 3 * B * H * S + bhc * (3 + 129 * p.pairs))


@pytest.mark.parametrize("hd", ssd.HEAD_DIMS)
def test_ssd_bwd_smem_fits_at_every_head_size(hd):
    """Every backward block at N 128 and a chunk of 256 (mamba2's) fits
    the SM's shared memory at every head size, and so does every shape
    the card's checks run; at mamba2's training shape every pass a
    block a (chunk, head, batch) or a tile of one, and the dscores pass,
    hold more blocks than the H100 has SMs."""
    p = ssd.bwd_plan(1, 1, 1, 256, hd, 128, 256)
    assert max(p.smem) <= ssd.SMEM_LIMIT
    for B, H, G, S, hd_, N, chunk in CARD_BWD:
        p = ssd.bwd_plan(B, H, G, S, hd_, N, chunk)
        assert max(p.smem) <= ssd.SMEM_LIMIT
    s = get_config("mamba2-1.3b").ssm
    p = ssd.bwd_plan(2, 64, s.n_groups, 1024, s.head_dim, s.d_state,
                     s.chunk_size)
    assert p.n_chunks == 4
    for g in (p.grids[1], p.grids[2], p.grids[4]):
        assert np.prod(g) > H100_SMS
