"""Sharded kernel wrappers: the port's kernels composed with a device
mesh, the counterpart of the reference's ``shard_map`` wrappers
(``repro/distributed/shardmap_ops.py``).

The reference runs each Pallas kernel under ``shard_map`` with manual
specs: batch over the data axes, heads over 'model' (when divisible —
otherwise heads replicate and batch carries the parallelism), KV
broadcast for GQA.  Here the same specs cut the operands into blocks,
one a device of the mesh (row-major over its axes, ``launch/mesh.py``):
each device's block goes to its device, the port's kernel runs there
(its plain version on the CPU, as every wrapper does), and the blocks of
the output are put back together on the mesh's first device.  A device
whose block repeats another's (an axis its specs do not use) computes it
too, as every device of a ``shard_map`` does; one copy is kept.  On the
one card's (1, 1) mesh this is one direct kernel call; on a debug mesh
that names one card eight times it is eight calls on that card.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import P, PartitionSpec, spec_axes
from repro_torch.kernels import ops


def _data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _head_axis(mesh, n_heads: int, n_kv: int) -> Optional[str]:
    tp = "model" if "model" in mesh.shape else None
    if tp and n_heads % mesh.shape[tp] == 0 and n_kv % mesh.shape[tp] == 0:
        return tp
    return None


def _index(spec: PartitionSpec, coord: Dict[str, int], mesh) -> Tuple:
    """(block index, blocks) along each dimension of ``spec`` for the
    device at ``coord``: mixed radix over the entry's axes, in order."""
    out = []
    for entry in spec:
        i, n = 0, 1
        for a in spec_axes(entry):
            i, n = i * mesh.shape[a] + coord[a], n * mesh.shape[a]
        out.append((i, n))
    return tuple(out)


def _block(x: torch.Tensor, spec: PartitionSpec, coord, mesh):
    """The device at ``coord``'s block of ``x`` under ``spec``."""
    for dim, (i, n) in enumerate(_index(spec, coord, mesh)):
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x


def _assemble(blocks: Dict[Tuple, torch.Tensor], spec: PartitionSpec, mesh,
              device) -> torch.Tensor:
    """The whole tensor on ``device`` from its blocks, keyed by their
    block index along each dimension."""
    ndim = len(spec)
    counts = [n for _, n in _index(spec, {a: 0 for a in mesh.shape}, mesh)]

    def join(prefix: Tuple, dim: int):
        if dim == ndim:
            return blocks[prefix].to(device)
        parts = [join(prefix + (i,), dim + 1) for i in range(counts[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    return join((), 0)


def shard_blocks(fn: Callable, mesh, in_specs: Sequence[PartitionSpec],
                 out_specs, *args):
    """``fn`` on each device's blocks of ``args`` (cut by ``in_specs``,
    moved to the device), its outputs (one tensor, or a tuple with
    ``out_specs`` a tuple of specs) put back together by ``out_specs``
    on the mesh's first device."""
    if mesh.devices is None:
        raise ValueError(f"{mesh} is abstract: a sharded call needs devices")
    for x, spec in zip(args, in_specs):
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec} for a {x.dim()}-D operand")
        for dim, (_, n) in enumerate(_index(spec, {a: 0 for a in mesh.shape},
                                            mesh)):
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not divide into {n} blocks ({spec})")
    single = isinstance(out_specs, PartitionSpec)
    specs = (out_specs,) if single else tuple(out_specs)
    kept = [dict() for _ in specs]
    for coord_t, dev in zip(mesh.coords(), mesh.devices):
        coord = dict(zip(mesh.axis_names, coord_t))
        out = fn(*(_block(x, s, coord, mesh).to(dev)
                   for x, s in zip(args, in_specs)))
        outs = (out,) if single else tuple(out)
        for k, (o, s) in enumerate(zip(outs, specs)):
            key = tuple(i for i, _ in _index(s, coord, mesh))
            kept[k].setdefault(key, o)
    res = tuple(_assemble(b, s, mesh, mesh.devices[0])
                for b, s in zip(kept, specs))
    return res[0] if single else res


def sharded_flash_attention(q, k, v, mesh, *, causal: bool = True,
                            window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) — batch over data axes,
    heads over 'model' when both H and KV divide it."""
    dp = _data_axes(mesh)
    hax = _head_axis(mesh, q.shape[1], k.shape[1])
    spec = P(dp or None, hax, None, None)
    fn = partial(ops.flash_attention, causal=causal, window=window)
    return shard_blocks(fn, mesh, (spec, spec, spec), spec, q, k, v)


def sharded_decode_attention(q, k, v, pos, mesh, *, window: int = 0):
    """q: (B, KV, G, hd); k, v: (B, KV, S, hd); pos: (B,)."""
    dp = _data_axes(mesh)
    hax = _head_axis(mesh, k.shape[1], k.shape[1])
    spec_q = P(dp or None, hax, None, None)
    spec_kv = P(dp or None, hax, None, None)
    spec_pos = P(dp or None)
    fn = partial(ops.decode_attention, window=window)
    return shard_blocks(fn, mesh, (spec_q, spec_kv, spec_kv, spec_pos),
                        spec_q, q, k, v, pos)


def sharded_ssd_scan(x, dt, A, B_, C_, mesh, *, chunk: int = 128):
    """x: (B, H, S, hd); dt: (B, H, S); A: (H,); B_, C_: (B, G, S, N).
    Heads shard over 'model' only when the group count divides too
    (otherwise B_/C_ would need replication-aware splitting).  Returns
    the port's ``ssd_scan`` outputs, (y (B, H, S, hd), final state
    (B, H, hd, N)), each sharded as x."""
    dp = _data_axes(mesh)
    hax = _head_axis(mesh, x.shape[1], B_.shape[1])
    fn = partial(ops.ssd_scan, chunk=chunk)
    out = P(dp or None, hax, None, None)
    return shard_blocks(
        fn, mesh,
        (P(dp or None, hax, None, None), P(dp or None, hax, None), P(hax),
         P(dp or None, hax, None, None), P(dp or None, hax, None, None)),
        (out, out), x, dt, A, B_, C_)


def sharded_fleet_select(mu, sig, acc, rank, t_u, t_l, r01, mesh, *,
                         gamma: float = 1.0):
    """Fleet-wide ModiPick selection with the cell axis sharded.

    Every operand carries the cell on its leading axis — mu/sig/acc/rank
    (C, npad), t_u/t_l/r01 (C, B): r01 the cells' own uniforms
    (``policy_select.cell_uniforms``, where the reference takes a PRNG
    key a cell) — and shards over the mesh's ``cell`` axis (falling back
    to ``data`` when the fleet mesh reuses the training mesh's naming).
    Each device runs the stacked selection (B4) over its cells' rows, so
    the sharded call is bit-identical to the single-device
    ``select_fleet_stacked`` on the same uniforms whenever C divides the
    axis; when it does not, the divisibility-aware rule drops the
    mapping and the call replicates (still correct, just not parallel).
    Returns (C, B) int32 picks, −1 where a cell has no eligible model."""
    from repro_torch.distributed.sharding import axis_rules, logical_to_spec
    ax = next((a for a in ("cell", "data") if a in mesh.shape), None)
    with axis_rules({"cell": ax}, mesh):
        spec = logical_to_spec(("cell", None), shape=t_u.shape, mesh=mesh)

    def body(mu, sig, acc, rank, t_u, t_l, r01):
        C, B = t_u.shape
        row = torch.arange(C, dtype=torch.int32, device=mu.device
                           ).repeat_interleave(B)
        picks, _ = ops.stacked_select(
            mu.contiguous(), sig.contiguous(), acc.contiguous(),
            rank.contiguous(), row, t_u.reshape(-1), t_l.reshape(-1),
            r01.reshape(-1), gamma=gamma)
        return picks.view(C, B)

    return shard_blocks(body, mesh, (spec,) * 7, spec,
                        mu, sig, acc, rank, t_u, t_l, r01)


def sharded_rglru_scan(a, b, mesh, *, block_s: int = 256):
    """a, b: (B, S, W) — batch over data, channels over 'model'.
    ``block_s`` is the reference's Pallas block length; the port's
    kernel plans its own segments (``rglru_scan.segment_plan``), so it
    is taken and unused."""
    dp = _data_axes(mesh)
    tp = "model" if "model" in mesh.shape and a.shape[2] % mesh.shape["model"] == 0 else None
    spec = P(dp or None, None, tp)
    return shard_blocks(ops.rglru_scan, mesh, (spec, spec), spec, a, b)
