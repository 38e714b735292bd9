"""Live model pool: PyTorch-served variants exposing accuracy/latency
trade-offs (the LLM analogue of the paper's CNN zoo).

Each variant owns its parameters on one device; ``scaled_family`` builds
a pool from one architecture at several widths — e.g. qwen2-family at
0.5×/1×/2× of the reduced config — exactly the MobileNet-vs-Inception
spectrum ModiPick exploits.  A pool at published widths is built from
``Variant``\\ s directly (``Variant(cfg=get_config(...).scaled(w))``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclass
class Variant:
    name: str
    cfg: ModelConfig
    quality: float
    params: object = None
    device: Optional[torch.device] = None
    cache_len: int = 128
    inflight: int = 0           # requests dispatched but not finished

    def estimated_wait_ms(self, profile) -> float:
        """Queue-wait estimate for one more request on this variant.
        The two signals overlap — observed queue waits (queue_mu, see
        ProfileStore.observe_queue) already include time spent behind
        in-flight work — so take the max rather than the sum."""
        return max(self.inflight * max(profile.mu, 0.0), profile.queue_mu)

    def build(self, generator: torch.Generator, dtype=torch.bfloat16,
              device="cuda"):
        """Random parameters from ``generator`` on ``device``: the card
        unless the caller asks for the CPU.  ``generator`` must live on
        that device."""
        self.device = resolve_device(device)
        self.params = M.init_params(self.cfg, generator, dtype, self.device)
        return self

    @torch.inference_mode()
    def run(self, tokens: np.ndarray, n_decode: int = 4) -> float:
        """Execute prefill + n_decode greedy steps; returns wall ms.

        On the card the clock is read after ``torch.cuda.synchronize``:
        kernels launch asynchronously, and without it the measured time
        would be the launch time, not the inference time the profiles
        feed ModiPick."""
        t0 = time.perf_counter()
        tok = torch.as_tensor(tokens, device=self.device)
        cache, logits = M.prefill(self.cfg, self.params, tok, self.cache_len)
        B, S = tokens.shape
        pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        nxt = torch.argmax(logits, dim=-1)
        for _ in range(n_decode):
            logits, cache = M.decode_step(self.cfg, self.params, cache, nxt,
                                          pos)
            nxt = torch.argmax(logits, dim=-1)
            pos = pos + 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) * 1e3


def scaled_family(base: ModelConfig, *, widths=(0.25, 0.5, 1.0),
                  qualities=None, seed: int = 0, cache_len: int = 128,
                  dtype=torch.bfloat16, device="cuda") -> List[Variant]:
    """Build a pool of width-scaled variants of one family (of the
    reduced config, as the reference does)."""
    reduced = base.reduced()
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for i, w in enumerate(widths):
        cfg = reduced.scaled(w, name=f"{base.name}-w{w:g}")
        q = qualities[i] if qualities else base.quality * (0.6 + 0.4 * w)
        v = Variant(name=cfg.name, cfg=cfg, quality=q, cache_len=cache_len)
        v.build(gen, dtype, device)
        out.append(v)
    return out
