"""ModiPick over H100 pool configurations: the counterpart of the
reference's ``repro/core/tpu_pool.py``.

At datacenter scale the natural pool is (architecture × mesh): the same
request can be served by a small model on one card or a large model on
a bigger mesh, with latencies that follow from the roofline.  This
module builds a ModiPick zoo from the port's dry-run records
(``launch/dryrun.py``, JSON files named ``<arch>__<shape>__<mesh>.json``),
so the selection policy the paper runs over ``{MobileNet … NasNet}``
runs unchanged over ``{qwen2@single … command-r@single}``, ``single``
being one H100.

Latency model per request (prefill P tokens + emit T tokens), the
reference's:
  t(m) = prefill_bound(m) · P/P₀ + T · decode_bound(m) + t_dispatch
with bounds = max(compute, memory, collective) roofline terms of the
``prefill_32k`` and ``decode_32k`` records (a term not counted is left
out); σ from a configurable jitter CV (co-tenancy and link congestion
take the role the paper gives to cloud co-tenants).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.zoo import ZooEntry

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


@dataclass(frozen=True)
class GPUPoolMember:
    arch: str
    mesh: str
    prefill_bound_s: float   # for the 32k-token prefill shape
    decode_bound_s: float    # per token
    quality: float


def _bound(ro: dict) -> float:
    return max(v for v in (ro["compute_s"], ro["memory_s"],
                           ro["collective_s"]) if v is not None)


def load_pool(results_dir: str = DEFAULT_DIR, mesh: str = "single"
              ) -> List[GPUPoolMember]:
    from repro_torch.configs.registry import get_config
    by_arch: Dict[str, Dict[str, dict]] = {}
    for f in glob.glob(os.path.join(results_dir, f"*__{mesh}.json")):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("status") != "ok":
            continue
        by_arch.setdefault(r["arch"], {})[r["shape"]] = r
    pool = []
    for arch, shapes in sorted(by_arch.items()):
        if "prefill_32k" not in shapes or "decode_32k" not in shapes:
            continue
        pre = shapes["prefill_32k"]["roofline"]
        dec = shapes["decode_32k"]["roofline"]
        # per-request bounds: prefill is per batch-of-32 32k sequences ⇒
        # per sequence; decode bound is per step for the whole 128-batch.
        pool.append(GPUPoolMember(
            arch=arch, mesh=mesh,
            prefill_bound_s=_bound(pre) / 32.0,
            decode_bound_s=_bound(dec),
            quality=get_config(arch).quality))
    return pool


def to_zoo(pool: List[GPUPoolMember], *, prefill_tokens: int = 2048,
           decode_tokens: int = 16, jitter_cv: float = 0.05,
           dispatch_ms: float = 2.0) -> List[ZooEntry]:
    """Convert pool members to ModiPick ZooEntries (ms latencies)."""
    entries = []
    for m in pool:
        # scale the 32k prefill bound to the request's prompt length
        t = (m.prefill_bound_s * (prefill_tokens / 32768.0)
             + decode_tokens * m.decode_bound_s) * 1e3 + dispatch_ms
        entries.append(ZooEntry(name=f"{m.arch}@{m.mesh}",
                                top1=m.quality * 100.0,
                                mu_ms=t, sigma_ms=t * jitter_cv))
    return entries
