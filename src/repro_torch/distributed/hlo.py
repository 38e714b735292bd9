"""The H100's roofline and the wire bytes of collectives.

The reference (``repro/distributed/hlo.py``) reads collective traffic
from XLA's post-SPMD HLO text and holds a step to a TPU v5e roofline.
The port runs eager PyTorch and produces no HLO; it keeps the same
model with the H100's numbers (NVIDIA's data sheet, SXM part, dense
rates): its dry-run (``launch/dryrun.py``) counts a step's FLOPs and HBM
bytes on the ``meta`` device and holds them to :class:`Roofline`, and
``chip_smoke.py``'s kernel bounds use the same constants
(``kernels/cost.py``).  :func:`wire_bytes` is the ring model of each
collective; :func:`collective_bytes` applies it to HLO text, as the
reference does, for text from elsewhere.
"""
from __future__ import annotations

from re import compile as regex
from dataclasses import dataclass, field
from typing import Dict, Optional

# --- hardware constants (one NVIDIA H100 SXM) -------------------------
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense tensor-core bf16
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, dense tensor-core TF32
PEAK_FLOPS_FP32 = 67e12        # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s a direction, NVLink 4 (the ICI's place)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = regex(r"(\w+)\[([\d,]*)\]")
# `%op.N = TYPE kind(...operands...), ... replica_groups=...`
# TYPE is a shape or a tuple of shapes; operands carry no inline types in
# post-optimization HLO, so sizes come from the RESULT type.
_COLLECTIVE_RE = regex(
    r"=\s*(\([^)]*\)|\w+\[[\d,]*\](?:\{[^}]*\})?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_RE = regex(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    m = _SHAPE_RE.match(type_str.strip())
    if not m:
        return 0
    dtype, dims = m.groups()
    nbytes = _DTYPE_BYTES.get(dtype)
    if nbytes is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * nbytes


def _result_bytes(type_str: str, is_start: bool) -> int:
    type_str = type_str.strip()
    if type_str.startswith("("):
        parts = [p for p in type_str[1:-1].split(",") if "[" in p]
        sizes = [_shape_bytes(p) for p in parts]
        if not sizes:
            return 0
        # async -start ops: (operand, destination, ...) — use the destination
        return sizes[1] if is_start and len(sizes) > 1 else max(sizes)
    return _shape_bytes(type_str)


def wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes a device sends for one collective of ``kind`` whose result
    is ``size`` bytes, over a ring of ``n`` devices: all-gather and
    all-to-all ≈ size·(n−1)/n, all-reduce ≈ 2·size·(n−1)/n
    (reduce-scatter then all-gather), reduce-scatter size·(n−1),
    collective-permute size.  0 on one device."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * size * frac
    if kind in ("all-gather", "all-to-all"):
        return size * frac
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "collective-permute":
        return size
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class CollectiveStats:
    # wire bytes PER DEVICE (ring-algorithm estimates from result sizes)
    by_kind: Dict[str, float] = field(default_factory=dict)
    by_kind_count: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.by_kind.values())


def collective_bytes(hlo_text: str) -> CollectiveStats:
    """Per-device wire bytes of each collective in HLO text
    (:func:`wire_bytes` of its result size over its replica group; a
    group of 2 where the line names none)."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        type_str, kind, start = m.group(1), m.group(2), m.group(3)
        size = _result_bytes(type_str, start is not None)
        gm = _GROUPS_RE.search(line)
        n = int(gm.group(2)) if gm else 2
        wire = wire_bytes(kind, size, n)
        stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + wire
        stats.by_kind_count[kind] = stats.by_kind_count.get(kind, 0) + 1
    return stats


# ----------------------------------------------------------------------
@dataclass
class Roofline:
    """A step's least time on ``n_chips`` H100s: the larger of its FLOPs
    over the bf16 peak, its HBM bytes over the HBM rate and its wire
    bytes over NVLink.  ``coll_bytes_per_chip`` None means not counted:
    its term is None and the other two decide."""
    n_chips: int
    hlo_flops: float            # whole-step FLOPs (all devices)
    hlo_bytes: float            # whole-step HBM bytes
    coll_bytes_per_chip: Optional[float]  # wire bytes per device
    model_flops: float          # analytic 6·N·D (active params)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.n_chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.n_chips * HBM_BW)

    @property
    def collective_s(self) -> Optional[float]:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / NVLINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        if self.step_s <= 0:
            return 0.0
        return self.model_flops / (self.step_s * self.n_chips * PEAK_FLOPS_BF16)

    def to_dict(self) -> dict:
        return {
            "n_chips": self.n_chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for a
    forward-only phase (prefill), 2·N_active·B for one decode token."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq
