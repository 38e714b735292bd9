"""Fault-tolerant training loop, the reference's
(``repro/training/loop.py``): periodic checkpoints, resume from the
latest one, failure injection for tests.

The parameters are drawn from a ``torch.Generator`` seeded with
``tcfg.seed`` on the loop's device (the card unless the caller asks for
the CPU).  ``step_time_s`` is taken on the host clock around the step,
after ``torch.cuda.synchronize()`` on the card.  The moments follow
``tcfg.opt_moments`` (the reference's loop always starts fp32 moments).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import TokenStream, to_device
from repro_torch.device import resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_step import init_train_state, make_train_step


@dataclass
class TrainLoop:
    mcfg: ModelConfig
    tcfg: TrainConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last: int = 3
    dtype: torch.dtype = torch.float32
    # failure injection: raise at this step (tests crash/recovery)
    fail_at_step: Optional[int] = None
    log_every: int = 10
    history: List[Dict] = field(default_factory=list)
    device: str = "cuda"

    def _sync(self, dev) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, stream: TokenStream, n_steps: int,
            on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict:
        dev = resolve_device(self.device)
        step_fn = make_train_step(self.mcfg, self.tcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.tcfg.seed)
        params, opt_state = init_train_state(self.mcfg, gen, self.dtype,
                                             self.tcfg, dev)

        start = 0
        if self.ckpt_dir:
            last = ckpt.latest_step(self.ckpt_dir)
            if last is not None:
                params, opt_state, extra = ckpt.restore(
                    self.ckpt_dir, last, params, opt_state)
                stream.restore(extra["data"])
                start = last

        metrics = {}
        for step in range(start, n_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = to_device(next(stream), dev)
            self._sync(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            self._sync(dev)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
            if on_step:
                on_step(step, metrics)
            if step % self.log_every == 0:
                self.history.append({"step": step, **metrics})
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, step + 1, params, opt_state,
                          extra={"data": stream.state()},
                          keep_last=self.keep_last)
        if self.ckpt_dir:
            ckpt.save(self.ckpt_dir, n_steps, params, opt_state,
                      extra={"data": stream.state()}, keep_last=self.keep_last)
        self._final_params = params
        self._final_opt_state = opt_state
        return metrics
