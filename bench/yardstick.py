"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move it: the H100's published peaks, the operation and
byte counts of the kernels whose roofline share the benchmark reports
(copied from ``repro_torch/kernels/cost.py`` as it stood when the
benchmark was defined, over plain integers instead of tensors), the
model FLOPs of a training step, and the statistics of a run.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, tensor-core bf16
PEAK_FLOPS_TF32 = 495e12       # FLOP/s, tensor-core TF32
PEAK_FLOPS_FP32 = 67e12        # FLOP/s, CUDA cores
HBM_BW = 3.35e12               # B/s

# rate -> (products issued a product, operations a second); "tf32x3" is an
# fp32 body that issues three TF32 products a product.
RATES = {"bf16": (1, PEAK_FLOPS_BF16), "fp32": (1, PEAK_FLOPS_FP32),
         "tf32x3": (3, PEAK_FLOPS_TF32)}


def least_seconds(flops: float, nbytes: float, rate: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the rate's peak."""
    issue, peak = RATES[rate]
    return max(nbytes / HBM_BW, issue * flops / peak)


def visible_pairs(Sq: int, Sk: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs a causal (and windowed) mask lets through."""
    total = 0
    for i in range(Sq):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(i - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def k2_cost(B: int, H: int, KV: int, S: int, hd: int, esize: int,
            causal: bool = True) -> Tuple[float, float, str]:
    """K2 (flash attention forward): q, k, v read once, the output
    written once; QKᵀ and PV, 2·hd operations each, over the visible
    pairs.  (flops, bytes, rate)."""
    pairs = visible_pairs(S, S, causal)
    nbytes = esize * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    return 4.0 * hd * pairs * B * H, float(nbytes), \
        "bf16" if esize == 2 else "fp32"


def k2_bwd_cost(B: int, H: int, KV: int, S: int, hd: int, esize: int,
                causal: bool = True) -> Tuple[float, float, str]:
    """K2-bwd: q, k, v, o, dO and the lse read once, dq, dk, dv written
    once; five products of 2·hd operations over the visible pairs.  The
    fp32 body issues 3xTF32."""
    pairs = visible_pairs(S, S, causal)
    nbytes = esize * 4 * (B * H * S * hd + B * KV * S * hd) + 4 * B * H * S
    return 10.0 * hd * pairs * B * H, float(nbytes), \
        "tf32x3" if esize == 4 else "bf16"


def _ssd_chunks(S: int, chunk: int):
    cs = min(chunk, S)
    for s0 in range(0, S, cs):
        yield s0, min(cs, S - s0)


def k4_cost(B: int, H: int, G: int, S: int, hd: int, N: int, chunk: int,
            esize: int) -> Tuple[float, float, str]:
    """K4 (SSD scan forward): x, B, C, dt, A read once, y and the final
    state written once; the scores once per (batch, group) and chunk,
    M·X and the state update per head and chunk, the inter-chunk term on
    every chunk but the first."""
    nbytes = (esize * (2 * B * H * S * hd + 2 * B * G * S * N)
              + 4 * (B * H * S + H + B * H * hd * N))
    ops = 0
    for s0, ln in _ssd_chunks(S, chunk):
        pairs = ln * (ln + 1) // 2
        ops += 2 * B * G * pairs * N + 2 * B * H * (
            pairs * hd + ln * hd * N * (2 if s0 else 1))
    return float(ops), float(nbytes), "tf32x3" if esize == 4 else "bf16"


def k4_bwd_cost(B: int, H: int, G: int, S: int, hd: int, N: int,
                chunk: int, esize: int,
                dstate: bool = False) -> Tuple[float, float, str]:
    """K4-bwd: x, dy, dt, A, B, C, the chunk states (and dstate) read
    once, dx, ddt, dA, dB, dC written once; per chunk the scores once
    per (batch, group) and per head four products over the pairs, two
    over the rows, and two more on every chunk but the first."""
    cs = min(chunk, S)
    nc = -(-S // cs)
    nbytes = (esize * (3 * B * H * S * hd + 4 * B * G * S * N)
              + 4 * (2 * B * H * S + 2 * H + B * H * nc * hd * N
                     + (B * H * hd * N if dstate else 0)))
    ops = 0
    for s0, ln in _ssd_chunks(S, chunk):
        pairs = ln * (ln + 1) // 2
        ops += 2 * B * G * pairs * N + 2 * B * H * (
            2 * pairs * hd + 2 * pairs * N + ln * hd * N * (4 if s0 else 2))
    return float(ops), float(nbytes), "tf32x3" if esize == 4 else "bf16"


# ----------------------------------------------------------------------
# Model FLOPs
# ----------------------------------------------------------------------
def param_count(v: dict) -> int:
    """Every parameter of a published variant (``configs/*.json``), with
    the vocabulary unpadded and a tied embedding counted once."""
    d, V = v["hidden_size"], v["vocab_size"]
    n = V * d * (1 if v.get("tie_word_embeddings", True) else 2) + d
    if "ssm" in v:
        s = v["ssm"]
        di = s["expand"] * d
        H = di // s["head_dim"]
        gn = s["n_groups"] * s["d_state"]
        per = (d * (2 * di + 2 * gn + H) + (di + 2 * gn) * (s["conv_width"]
                                                          + 1)
               + 3 * H + di + di * d + d)
    else:
        H, KV, hd = (v["num_attention_heads"], v["num_key_value_heads"],
                     v["head_dim"])
        per = (d * (H + 2 * KV) * hd + (H + 2 * KV) * hd + H * hd * d
               + 3 * d * v["intermediate_size"] + 2 * d)
    return n + v["num_hidden_layers"] * per


def train_step_flops(v: dict, B: int, S: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recomputation): 6 × parameters × tokens, plus for attention layers
    the score and value products, 4·hd operations a visible (query, key)
    pair and head forward, three times that for the step.  A model of
    one layer kind, attention or SSD: the count of Qwen2's and Mamba-2's
    family modules (``bench/families/``)."""
    flops = 6.0 * param_count(v) * B * S
    if "ssm" not in v:
        attn = 4.0 * v["head_dim"] * v["num_attention_heads"] \
            * visible_pairs(S, S) * B
        flops += 3.0 * attn * v["num_hidden_layers"]
    return flops


def mfu_pct(flops: float, seconds: float) -> float:
    """Model FLOPs done in ``seconds`` over seconds × the bf16 peak, in
    %."""
    return 100.0 * flops / (seconds * PEAK_FLOPS_BF16)


# ----------------------------------------------------------------------
# Statistics
# ----------------------------------------------------------------------
def attainment(requests, t_sla_ms: float) -> float:
    """Share of ``requests`` whose e2e was within ``t_sla_ms`` (a failed
    request's e2e is infinite)."""
    return sum(r["e2e"] <= t_sla_ms for r in requests) / len(requests)


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile: the ⌈0.95·n⌉-th smallest value
    (an infinite value, a failed request, sorts last)."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def merged_busy(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy
