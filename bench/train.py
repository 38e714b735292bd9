"""A training cell: the port's ``TrainLoop`` on the benchmark's batches.

Set-up makes the variant's fp32 weights on the card from ``--seed``
(``weights.py``) and hands them to ``TrainLoop`` in place of the
parameters it would draw itself (its ``init_train_state``), with the
port's own zero moments.  The loop then runs on a feed of batches drawn
from the seed, a new one every step, through its own step call.  Its
first WARM_STEPS steps are set-up; after the last of them the
harness reads, from the same objects, the first gradient as AdamW took
it (its first moment after one step over 1 − β1) and each leaf's change
since the start.  The window is the steps after them, until the step
that ends past ``--seconds`` (and at least WINDOW_CHECKED steps);
tokens/s is all their tokens over the window's time.  A traced run
profiles TRACE_STEPS more steps after the window.

Afterwards the program's state is freed, and the plain fp32 reference
(``reference/train.py``) takes the same weights and batches through the
warm steps and the window's first WINDOW_CHECKED steps.  The numbers
compared: the loss of each warm step (``loss_gap``) and of each checked
window step (``window_loss_gap``, which a window step that updates the
state wrongly moves), each as the relative gap to the reference's; each
logical leaf's first gradient and its change over the warm steps, each
as the gap between the program's norm and the reference's over the
larger of the reference's norm of that leaf and of the median leaf.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from . import system, weights
from .reference import train as ref_train
from .serve import note
from .trace import Tracer

EXCLUDE = 1e-3   # leaves whose first gradient is under this × the median's
WARM_STEPS = 3   # set-up steps, the ones the reference follows
WINDOW_CHECKED = 3  # the window's first steps whose losses are compared
TRACE_STEPS = 2  # steps a traced run profiles after its window


class WindowClosed(Exception):
    pass


class Feed:
    """The batches: step s's token ids drawn from (seed, s); targets the
    ids shifted by one."""

    def __init__(self, vocab: int, B: int, S: int, seed: int):
        self.vocab, self.B, self.S, self.seed = vocab, B, S, seed
        self.step = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 4, step])
        t = rng.integers(0, self.vocab, size=(self.B, self.S + 1),
                         dtype=np.int32)
        return {"tokens": t[:, :-1], "targets": t[:, 1:]}

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self):
        return self


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in tensors.items()}


def worst_gap(got: Dict[str, float], want: Dict[str, float],
              keep=None) -> float:
    """max over leaves of |got − want| / max(want, the median leaf's
    want)."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got.get(k, math.inf) - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def kept(ref: dict):
    """The leaves whose change is compared: those whose first gradient in
    the reference is at least EXCLUDE × the median leaf's (the others
    move under Adam by round-off alone)."""
    med = statistics.median(ref["first_grad"].values())
    return {k for k, g in ref["first_grad"].items() if g >= EXCLUDE * med}


def loss_gap(losses, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(losses, want))


def readings(losses, first, change, ref) -> Dict[str, float]:
    """The numbers compared with the reference's: the widest relative
    gap of a warm step's loss and of a checked window step's (``losses``
    holds both, in order), and the worst leaf's gap of the first gradient
    and of the change over the warm steps."""
    if len(losses) != len(ref["losses"]) or not all(map(math.isfinite,
                                                        losses)):
        return {"loss_gap": math.inf, "window_loss_gap": math.inf,
                "grad_gap": math.inf, "change_gap": math.inf}
    w = WARM_STEPS
    return {"loss_gap": loss_gap(losses[:w], ref["losses"][:w]),
            "window_loss_gap": loss_gap(losses[w:], ref["losses"][w:]),
            "grad_gap": worst_gap(first, ref["first_grad"]),
            "change_gap": worst_gap(change, ref["change"], kept(ref))}


def run(cell: dict, cfg: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device: str, t_start: float,
        fault=None) -> dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.convert import leaf_layout
    from repro_torch.training import loop as loop_mod
    from repro_torch.training.optimizer import init_opt_state

    fam = cfg["family"]
    v = next(x for x in cfg["variants"] if x["name"] == cfg["train_variant"])
    idx = cfg["variants"].index(v)
    B, S, warm = traffic["batch"], traffic["seq_len"], WARM_STEPS
    opt = traffic["optimizer"]
    dtype = getattr(torch, traffic["param_dtype"])
    mcfg = system.model_config(fam, v)
    tcfg = TrainConfig(seed=seed % (1 << 31), **opt)
    t = time.perf_counter()
    tree, _ = weights.make(fam, v, cfg["init"], seed, idx, dtype, device)
    tree = _clone(tree)
    note(f"weights made in {time.perf_counter() - t:.3f} s")
    held: dict = {}

    def init_train_state(mcfg_, gen, dtype_, tcfg_, dev):
        held["opt"] = init_opt_state(tree, tcfg_.opt_moments,
                                     leaf_layout(mcfg_, tree))
        return tree, held["opt"]

    feed = Feed(v["vocab_size"], B, S, seed)
    tl = loop_mod.TrainLoop(mcfg, tcfg, dtype=dtype, device=device,
                            log_every=1 << 30)
    tracer = Tracer(trace)
    if trace:   # the profiler's own first start, outside the window
        tracer.start()
        tracer.stop()
    st = dict(losses=[], t0=None, steps=0, t_end=None, setup_s=None,
              traced_steps=0)
    first: Dict[str, float] = {}
    change: Dict[str, float] = {}

    def on_step(step: int, metrics: dict) -> None:
        now = time.perf_counter()
        if step < warm:
            note(f"warm step {step}: {metrics['step_time_s']:.3f} s, loss "
                 f"{metrics['loss']!r}")
            st["losses"].append(metrics["loss"])
            if step == 0:
                mu = weights.logical_of_paths(fam, v, held["opt"].mu)
                b1 = opt["b1"]
                first.update({k: x / (1.0 - b1)
                              for k, x in norms(mu).items()})
            if step == warm - 1:
                _, p0 = weights.make(fam, v, cfg["init"], seed, idx, dtype,
                                     device)
                now_ = weights.logical(fam, v, tree)
                with torch.no_grad():
                    change.update({k: float(torch.linalg.vector_norm(
                        now_[k].float() - p0[k].float())) for k in p0})
                del p0, _
                # the allocator keeps its blocks: the window's first
                # step does not pay for fresh ones
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                st["setup_s"] = time.time() - t_start
                st["t0"] = time.perf_counter()
            return
        if tracer.running:      # the traced steps after the window
            st["traced_steps"] += 1
            if st["traced_steps"] == TRACE_STEPS:
                tracer.stop()
                raise WindowClosed
            return
        if st["steps"] < WINDOW_CHECKED:
            st["losses"].append(metrics["loss"])
        st["steps"] += 1
        elapsed = now - st["t0"]
        if elapsed >= seconds and st["steps"] >= WINDOW_CHECKED:
            st["t_end"] = elapsed
            if not trace:
                raise WindowClosed
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            tracer.start()

    orig_init = loop_mod.init_train_state
    loop_mod.init_train_state = init_train_state
    try:
        with fault() if fault is not None else contextlib.nullcontext():
            tl.run(feed, n_steps=1 << 30, on_step=on_step)
    except WindowClosed:
        pass
    finally:
        loop_mod.init_train_state = orig_init
        tracer.stop()
    mem = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
           else 0)
    ctx = dict(cell=cell, config=cfg, traffic=traffic, variant=v,
               seconds=seconds, setup_s=st["setup_s"],
               attempted=st["steps"], failed=0,
               window_s=st["t_end"], steps=st["steps"], tokens=st["steps"]
               * B * S, trace=tracer.trace,
               traced_steps=TRACE_STEPS, memory_peak_bytes=mem)
    del tl, tree, held
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference(fam, v, cfg, traffic, seed, device)
    note(f"reference {len(ref['losses'])} steps in "
         f"{time.perf_counter() - t:.3f} s, losses {ref['losses']}")
    got = readings(st["losses"], first, change, ref)
    ctx["checks"] = {name: {"value": val, "limit": limits[name]}
                     for name, val in got.items()}
    ctx["excluded_leaves"] = sorted(set(ref["first_grad"]) - kept(ref))
    ctx["reference"] = ref
    ctx["correct"] = all(c["value"] <= c["limit"]
                         for c in ctx["checks"].values())
    return ctx


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(x) for k, x in tree.items()}
    if isinstance(tree, list):
        return [_clone(x) for x in tree]
    return tree.clone()


def reference(fam, v, cfg, traffic, seed, device, exact=True) -> dict:
    """The reference's warm steps and the window's checked steps from the
    same weights on the same batches: their losses, the first gradients
    and each leaf's change over the warm steps.  With ``exact`` False
    (the control) its matmuls run in TF32."""
    dtype = getattr(torch, traffic["param_dtype"])
    idx = cfg["variants"].index(v)
    _, W0 = weights.make(fam, v, cfg["init"], seed, idx, dtype, device)
    W = {k: t.float().clone() for k, t in W0.items()}
    feed = Feed(v["vocab_size"], traffic["batch"], traffic["seq_len"], seed)
    batches = []
    for s in range(WARM_STEPS + WINDOW_CHECKED):
        b = feed.batch_at(s)
        batches.append((torch.from_numpy(b["tokens"]).to(device),
                        torch.from_numpy(b["targets"]).to(device)))
    change: Dict[str, float] = {}

    def after_update(step: int) -> None:
        if step == WARM_STEPS:
            change.update({k: float(torch.linalg.vector_norm(
                W[k] - W0[k].float())) for k in W})
    out = ref_train.run(fam, v, W, batches, traffic["optimizer"],
                        exact=exact, after_update=after_update)
    out["change"] = change
    return out
