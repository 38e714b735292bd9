"""Continuous batching: slot-based decode over a shared cache.

The engine keeps a fixed decode batch of ``max_slots`` sequences.  New
requests are prefilled (batch 1) and inserted into free slots; every
engine step runs ONE batched ``decode_step`` with per-slot positions
(every cache kind is slot-isolated: attention rings, SSD and RG-LRU
states).  Finished sequences retire and free their slot at once — no
head-of-line blocking on long generations (Orca-style continuous
batching).  The behaviour is the reference's
(``repro/serving/batcher.py``), on the port's model.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    arrival_s: float = field(default_factory=time.perf_counter)
    generated: List[int] = field(default_factory=list)
    done: bool = False
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    queue_wait_s: Optional[float] = None  # submit → slot insert


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 cache_len: int = 256, eos_id: Optional[int] = None,
                 dtype=torch.float32, store=None, model_name: str = "",
                 device="cuda"):
        # ``store``: optional repro_torch.core.profiles.ProfileStore —
        # queue waits observed here feed W_queue(m) for queue-aware
        # selection.  ``device`` holds the cache (the card unless the
        # caller asks for the CPU); ``params`` must live there too.
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.store = store
        self.model_name = model_name or cfg.name
        self.device = resolve_device(device)
        self.cache = M.init_cache(cfg, max_slots, cache_len, dtype,
                                  self.device)
        self.slots: List[Optional[GenRequest]] = [None] * max_slots
        self.pos = np.zeros(max_slots, np.int32)
        self.next_tok = np.zeros(max_slots, np.int32)
        self.waiting: List[GenRequest] = []
        self.n_steps = 0

    # ------------------------------------------------------------------
    def _prefill(self, tokens: np.ndarray):
        """(cache, logits (1, Vpad)) of one prompt (S,)."""
        tok = torch.as_tensor(tokens[None, :], device=self.device)
        return M.prefill(self.cfg, self.params, {"tokens": tok},
                         self.cache_len)

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, pos: np.ndarray):
        """Logits (max_slots, Vpad) of one decode step over every slot;
        the cache is updated."""
        logits, self.cache = M.decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(pos, device=self.device))
        return logits

    def submit(self, req: GenRequest) -> None:
        # queue wait is measured from here, not from request construction
        req.arrival_s = time.perf_counter()
        self.waiting.append(req)

    @torch.inference_mode()
    def _insert_slot(self, slot: int, req: GenRequest) -> None:
        req.queue_wait_s = time.perf_counter() - req.arrival_s
        if self.store is not None:
            self.store.observe_queue(self.model_name,
                                     req.queue_wait_s * 1e3)
        cache1, logits = self._prefill(req.prompt)
        # every cache tensor of the port leads with the batch dimension
        for pool, one in zip(self.cache, cache1):
            for key, t in pool.items():
                t[slot:slot + 1] = one[key]
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        tok = int(torch.argmax(logits[0]))
        req.generated.append(tok)
        req.first_token_s = time.perf_counter()
        self.next_tok[slot] = tok

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slots[slot] is None and self.waiting:
                self._insert_slot(slot, self.waiting.pop(0))

    def _retire(self) -> None:
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = self.eos_id is not None and req.generated and \
                req.generated[-1] == self.eos_id
            if len(req.generated) >= req.max_new or hit_eos or \
                    int(self.pos[slot]) >= self.cache_len - 1:
                req.done = True
                req.finish_s = time.perf_counter()
                self.slots[slot] = None

    # ------------------------------------------------------------------
    def queue_depth(self) -> int:
        """Waiting + in-flight requests (the replica's FIFO depth)."""
        return len(self.waiting) + sum(r is not None for r in self.slots)

    def telemetry(self) -> Dict:
        """Queue-depth / queue-wait snapshot for the profile store."""
        waits = [r.queue_wait_s for r in self.slots
                 if r is not None and r.queue_wait_s is not None]
        return {
            "model": self.model_name,
            "queue_depth": self.queue_depth(),
            "waiting": len(self.waiting),
            "active": sum(r is not None for r in self.slots),
            "mean_queue_wait_ms":
                float(np.mean(waits)) * 1e3 if waits else 0.0,
        }

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine step. Returns False when fully idle."""
        self._admit()
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return bool(self.waiting)
        logits = self._decode(self.next_tok, self.pos)
        toks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for slot in active:
            req = self.slots[slot]
            req.generated.append(int(toks[slot]))
            self.next_tok[slot] = toks[slot]
            self.pos[slot] += 1
        self.n_steps += 1
        self._retire()
        return True

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step() and not self.waiting and \
                    all(s is None for s in self.slots):
                return
        raise RuntimeError("batcher did not drain")
