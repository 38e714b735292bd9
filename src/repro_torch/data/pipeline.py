"""Deterministic synthetic token pipeline, the reference's
(``repro/data/pipeline.py``), in numpy: the same seeds give the same
tokens bit for bit.

- deterministic random access: the batch at step s is a pure function
  of (seed, step, host), so a restart resumes exactly and any host can
  regenerate any shard;
- host sharding: host i of n serves rows i::n of the global batch;
- checkpointable: the state is a single integer step.

Batches are numpy arrays; they become tensors at the device boundary
(:func:`to_device`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class TokenStream:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int, host_id: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Host shard of the global batch at `step`.  The GLOBAL batch is a
        pure function of (seed, step) — independent of the host topology —
        so elastic restarts onto a different host count replay the exact
        same token stream."""
        host = self.host_id if host_id is None else host_id
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        tokens = rng.integers(0, self.vocab_size,
                              size=(self.global_batch, self.seq_len + 1),
                              dtype=np.int32)
        hb = self.host_batch
        shard = tokens[host * hb:(host + 1) * hb]
        return {"tokens": shard[:, :-1], "targets": shard[:, 1:]}

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    # -- checkpointing ---------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.seed:
            raise ValueError(f"seed mismatch on restore: {state['seed']} "
                             f"!= {self.seed}")
        self.step = int(state["step"])

    def reshard(self, host_id: int, n_hosts: int) -> "TokenStream":
        """Elastic restart onto a different host topology; determinism keeps
        the global stream identical as long as global_batch divides."""
        return TokenStream(self.vocab_size, self.global_batch, self.seq_len,
                           self.seed, host_id, n_hosts, self.step)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (token ids stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
