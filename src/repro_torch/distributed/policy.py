"""Sharding policy: logical-axis rules per (arch × shape × mesh).

The reference's policy (``repro/distributed/policy.py``), verbatim over
the port's configs: the same rules, thresholds and microbatch counts,
which the reference sized for TPU v5e chips (16 GB each); the port's
dry-run applies them unchanged so that its cells are the reference's.

Baseline strategy (what the dry-run lowers):

- train: 2D FSDP×TP.  Batch and the `embed_fsdp` weight dim shard over
  ('pod','data'); `ff`/`heads_merged`/`vocab`/`experts`/`rnn_width` shard
  over 'model'.  The layer scan amortizes FSDP all-gathers and GSPMD's
  latency-hiding scheduler overlaps the next superblock's gather with
  compute.
- prefill/decode: TP over 'model', batch over ('pod','data'); params
  replicated across data (latency path) unless the per-chip footprint
  exceeds a threshold, in which case `expert_ff` additionally shards over
  ('pod','data') (weight-2D, costs one psum — needed for dbrx serving).
- long_500k (batch=1): context parallelism — `cache_seq` shards over
  'data' with softmax combining handled by GSPMD reductions; recurrent
  state (O(1) in seq) stays TP-sharded.

Divisibility-aware fallbacks live in ``sharding.logical_to_spec``: any
rule whose mesh axis does not divide the dim is dropped (⇒ replicated),
which is how odd head counts (qwen2 12H, phi4 24H, rg 10H, whisper 6H)
degrade gracefully; the §Perf pass quantifies and fixes the big ones via
head padding.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

# Per-chip bytes above which serving weights also shard over data axes.
SERVE_WEIGHT_SHARD_THRESHOLD = 8 << 30

# Microbatch counts for train_4k so per-chip activation temps fit v5e HBM
# (16 GB).  Sized from the measured baseline temp_size_in_bytes.
TRAIN_GRAD_ACCUM = {
    "recurrentgemma-2b": 4,
    "mamba2-1.3b": 4,
    "qwen2-1.5b": 2,
    "phi4-mini-3.8b": 4,
    "command-r-35b": 16,
    "gemma3-4b": 4,
    "whisper-tiny": 2,
    "dbrx-132b": 16,
    "moonshot-v1-16b-a3b": 4,
    "internvl2-2b": 2,
}


# 8-bit Adam moments where fp32 optimizer state alone would break the
# per-chip HBM budget (see EXPERIMENTS.md §fit).
TRAIN_OPT_MOMENTS = {"dbrx-132b": "int8"}


def train_grad_accum(arch: str, global_batch: int, mesh) -> int:
    """Accumulation capped so each microbatch still covers the DP axes —
    a microbatch smaller than the data-parallel degree replicates
    activations (observed: command-r train on multi-pod, 10.7 → 64.5 GB
    temps when micro=16 < dp=32)."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    want = TRAIN_GRAD_ACCUM.get(arch, 1)
    return max(1, min(want, global_batch // max(dp, 1)))


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh,
               overrides: Optional[Dict] = None) -> Dict:
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    tp = "model" if "model" in mesh.shape else None
    mode = shape.mode

    rules: Dict = {
        "batch": dp,
        "seq": None,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "expert_ff": None,
        "experts": tp,
        "vocab": tp,
        "rnn_width": tp,
        "layers": None,
        "cache_seq": None,
        "heads_merged": tp,
        "kv_merged": tp,
        "embed_fsdp": None,
    }

    if mode == "train":
        rules["embed_fsdp"] = dp  # FSDP: weights + optimizer state over data
    else:
        # Serving: replicate weights across data for latency, unless the
        # model doesn't fit TP-only — then 2D-shard the expert ffn dim.
        tp_deg = mesh.shape.get("model", 1)
        per_chip = 2 * cfg.param_count() / max(tp_deg, 1)  # bf16
        if per_chip > SERVE_WEIGHT_SHARD_THRESHOLD:
            rules["expert_ff"] = dp
            rules["embed_fsdp"] = None

    if mode == "decode" and shape.global_batch < _prod(mesh, dp):
        # batch can't cover the data axes (long_500k B=1): context-parallel
        # the KV cache over 'data' instead.
        rules["batch"] = None
        rules["cache_seq"] = "data" if "data" in mesh.shape else None
    elif mode == "decode" and tp and cfg.n_kv_heads % mesh.shape[tp] != 0:
        # KV heads don't divide TP ⇒ the cache would replicate across the
        # model axis (observed: 5× the per-chip KV-floor bytes on
        # command-r decode).  Context-parallel the cache sequence over
        # 'model' instead: flash-decode partial softmax combines via the
        # GSPMD-inserted reductions; per-chip cache traffic drops ×tp.
        rules["cache_seq"] = tp

    if overrides:
        rules.update(overrides)
    return rules


def _prod(mesh, axes) -> int:
    p = 1
    for a in axes:
        p *= mesh.shape[a]
    return p
