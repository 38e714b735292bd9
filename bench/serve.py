"""A serve cell: ModiPick over a pool of variants, driven by an open loop.

Set-up makes each variant's weights on the card from ``--seed``
(``weights.py``), hands them to the port's ``Variant`` objects and
builds the port's ``PoolExecutor`` (ModiPick, queue-aware, no admission,
no hedging), whose ``warm_up`` builds the kernels and the profiles.  The
window then offers the traffic file's fixed rate: request i is due at
its arrival time; the harness sleeps until it is due when nothing is
waiting, tells the executor how long it has already waited
(``w_queue_fn``), and calls ``execute``.  Every request due in the
window is served, the backlog after the window too, and each one's e2e
is 2·T_input + (the time ``execute`` returned − its due time).

Afterwards the program's state is freed, and the plain reference reads
a sample of the served requests: each prompt with the tokens the
program served, in fp32.  The number compared is the widest gap by
which a served token's logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import reference, system, weights
from .reference.common import mm, mm_fp8
from .trace import Tracer, span

REF_BLOCK = 4         # sequences the reference runs together
CHECK_REQUESTS = 48   # requests of a window the reference reads
TRACE_REQUESTS = 40   # requests a traced run profiles after its window
LARGEST_CALLS = 10    # Variant.run calls behind largest_ms.serve


def note(msg: str) -> None:
    """A timestamped line on standard error (what set-up spends)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


class Uplinks:
    """The network the executor samples: the traffic's uplink times, one
    per ``execute`` call in order (``NetworkModel``'s ``sample``)."""

    def __init__(self, values):
        self.values = [float(x) for x in values]
        self.i = 0

    def sample(self, rng, n: int = 1):
        out = np.asarray(self.values[self.i:self.i + n])
        self.i += n
        return out


def schedule(traffic: dict, seed: int, seconds: float):
    """(arrival offsets s, uplink ms) of the window's requests: the
    N = rate × seconds quantiles at (i + ½)/N of the exponential gaps and
    of the truncated normal uplink, each put in an order drawn from the
    seed; the gaps are scaled to fill the window exactly."""
    n = max(1, int(round(traffic["rate_per_s"] * seconds)))
    q = (np.arange(n) + 0.5) / n
    rng = np.random.default_rng([seed, 1])
    gaps = -np.log1p(-q)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    net = traffic["network"]
    nd = statistics.NormalDist(net["mean_ms"], net["std_ms"])
    up = np.maximum([nd.inv_cdf(x) for x in q], net["floor_ms"])
    return arrivals, rng.permutation(up)


def checked(traffic: dict, seed: int, seconds: float) -> List[int]:
    """The requests of the window whose served tokens the reference
    reads: CHECK_REQUESTS of them, drawn from the seed."""
    n = len(schedule(traffic, seed, seconds)[0])
    rng = np.random.default_rng([seed, 3])
    return rng.choice(n, size=min(CHECK_REQUESTS, n),
                      replace=False).tolist()


def prompts(vocab: int, n: int, S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 2])
    return rng.integers(0, vocab, size=(n, S), dtype=np.int64)


class Capture:
    """Wraps the port's ``prefill`` and ``decode_step`` (which
    ``Variant.run`` calls) and keeps the logits they return while on."""

    def __init__(self):
        from repro_torch.models import model as M
        self.M = M
        self.saved = self.orig = (M.prefill, M.decode_step)
        self.on = False
        self.out: List[torch.Tensor] = []

        def prefill(*a, **k):
            cache, logits = self.orig[0](*a, **k)
            if self.on:
                self.out.append(logits)
            return cache, logits

        def decode_step(*a, **k):
            logits, cache = self.orig[1](*a, **k)
            if self.on:
                self.out.append(logits)
            return logits, cache

        M.prefill, M.decode_step = prefill, decode_step

    def restore(self) -> None:
        self.M.prefill, self.M.decode_step = self.saved


def build_pool(cfg: dict, traffic: dict, seed: int, device):
    from repro_torch.serving.pool import Variant
    dtype = getattr(torch, cfg["serve_dtype"])
    pool = []
    for i, v in enumerate(cfg["variants"]):
        tree, _ = weights.make(cfg["family"], v, cfg["init"], seed, i,
                               dtype, device)
        var = Variant(name=v["name"], cfg=system.model_config(cfg["family"],
                                                              v),
                      quality=v["quality"],
                      cache_len=traffic["prompt_tokens"]
                      + traffic["decode_steps"])
        var.params, var.device = tree, torch.device(device)
        pool.append(var)
    return pool


class Cell:
    """A serve cell's system: the pool and the executor, built and warmed
    (set-up), then driven by :meth:`window`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 trace: bool = False):
        from repro_torch.core.policy import ModiPick
        from repro_torch.serving.executor import PoolExecutor
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.trace = device, trace
        self.S, self.n_dec = traffic["prompt_tokens"], traffic["decode_steps"]
        self.vocab = min(v["vocab_size"] for v in cfg["variants"])
        t = time.perf_counter()
        self.pool = build_pool(cfg, traffic, seed, device)
        note(f"weights of {len(self.pool)} variants made in "
             f"{time.perf_counter() - t:.3f} s")
        self.wait = {"ms": 0.0}
        self.uplinks = Uplinks([])
        pol = traffic["policy"]
        self.ex = PoolExecutor(
            variants=self.pool, network=self.uplinks,
            policy=ModiPick(pol["t_threshold_ms"], pol["gamma"]),
            seed=seed % (1 << 32), hedging=False, queue_aware=True,
            w_queue_fn=lambda name: self.wait["ms"])
        self.warm = prompts(self.vocab, 1, self.S, seed + 1)
        t = time.perf_counter()
        self.ex.warm_up(self.warm, self.n_dec)
        note(f"warm-up (kernel builds, profiles) {time.perf_counter() - t:.3f}"
             " s; profiles " + ", ".join(
                 f"{p.name} {p.mu:.3f}±{p.sigma:.3f} ms"
                 for p in self.ex.store.profiles.values()))
        self.route_s: List[float] = []
        if trace:   # the profiler's own first start, outside the window
            t = Tracer(True)
            t.start()
            t.stop()
            route = self.ex.router.route

            def timed_route(*a, **k):
                t = time.perf_counter()
                out = route(*a, **k)
                self.route_s.append(time.perf_counter() - t)
                return out
            self.ex.router.route = timed_route

    def window(self, seconds: float, rate=None, sample=(), fault=None,
               t_start=None) -> dict:
        """Offer the traffic for ``seconds`` (at ``rate`` if given), serve
        the backlog, and return the context the metric readers read; the
        program's logits of the requests in ``sample`` are kept.  In a
        traced run, TRACE_REQUESTS more requests at the same rate follow
        the window under the profiler."""
        tr = dict(self.traffic)
        if rate is not None:
            tr["rate_per_s"] = rate
        arrivals, uplinks = schedule(tr, self.seed, seconds)
        n = len(arrivals)
        toks = prompts(self.vocab, n, self.S, self.seed)
        cap = Capture()
        if fault is not None:
            fault(cap)
        try:
            self.route_s.clear()
            system.reset_launch_counts()
            setup_s = None if t_start is None else time.time() - t_start
            reqs, served, t_end = self._offer(arrivals, uplinks, toks, tr,
                                              cap, set(sample))
            launches = system.launch_counts()
            route_s = list(self.route_s)
            tracer = Tracer(self.trace)
            traced = []
            if self.trace:
                k = min(n, TRACE_REQUESTS)
                tracer.start()
                traced, _, _ = self._offer(arrivals[:k], uplinks[:k],
                                           toks[:k], tr, cap, set())
                tracer.stop()
        finally:
            cap.restore()
        return dict(config=self.cfg, traffic=tr, seconds=seconds,
                    requests=reqs, window_end_s=t_end, setup_s=setup_s,
                    route_s=route_s, launches=launches,
                    trace=tracer.trace, traced=traced,
                    variants={v["name"]: v for v in self.cfg["variants"]},
                    prompts=toks,
                    tokens={i: [int(torch.argmax(lg[0].float()))
                                for lg in out]
                            for i, out in served.items()})

    def _offer(self, arrivals, uplinks, toks, tr, cap, sample):
        """The open loop over one schedule: (request records, the kept
        logits by request, seconds from the first due time to the last
        request's end)."""
        self.uplinks.values, self.uplinks.i = list(uplinks), 0
        reqs: List[dict] = []
        served: Dict[int, list] = {}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(arrivals)):
            due = t0 + arrivals[i]
            now = time.perf_counter()
            if now < due:
                with span("serve.idle", self.trace):
                    time.sleep(due - now)
            start = time.perf_counter()
            self.wait["ms"] = max(0.0, (start - due) * 1e3)
            cap.on, cap.out = i in sample, []
            rec = dict(due=due - t0, start=start - t0, failed=False)
            try:
                with span("serve.execute", self.trace):
                    res = self.ex.execute(toks[i:i + 1], tr["t_sla_ms"],
                                          self.n_dec)
                rec.update(variant=res.variant, t_input=res.t_input_ms,
                           t_infer=res.t_infer_ms, quality=res.quality)
            except Exception as e:  # a failed request: a miss, scores 0
                rec.update(failed=True, error=repr(e)[:200], variant="",
                           t_input=float(uplinks[i]), t_infer=math.nan,
                           quality=0.0)
            end = time.perf_counter()
            rec["end"] = end - t0
            rec["e2e"] = (math.inf if rec["failed"] else
                          2.0 * rec["t_input"] + (end - due) * 1e3)
            if cap.on and not rec["failed"]:
                served[i] = list(cap.out)
            cap.on = False
            reqs.append(rec)
        return reqs, served, time.perf_counter() - t0

    def service_ms(self, name: str, calls: int) -> List[float]:
        """Wall ms of ``calls`` runs of one variant on the warm-up prompt
        (``Variant.run`` synchronizes)."""
        v = self.ex.by_name[name]
        return [v.run(self.warm, self.n_dec) for _ in range(calls)]

    def free(self) -> None:
        del self.ex, self.pool
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def run(cell: dict, cfg: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device: str, t_start: float,
        fault=None) -> dict:
    """One run of a serve cell: set-up, the window, then the check.
    Returns the context the metric readers read, with ``checks`` and
    ``correct``."""
    c = Cell(cfg, traffic, seed, device, trace)
    ctx = c.window(seconds, sample=checked(traffic, seed, seconds),
                   fault=fault, t_start=t_start)
    ctx["cell"] = cell
    ctx["attempted"] = len(ctx["requests"])
    ctx["failed"] = sum(r["failed"] for r in ctx["requests"])
    if trace:
        ctx["largest_ms"] = c.service_ms(cfg["variants"][-1]["name"],
                                         LARGEST_CALLS)
    ctx["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.cuda.is_available() else 0)
    c.free()
    tokens = ctx["tokens"]
    variant_of = {i: ctx["requests"][i]["variant"] for i in tokens}
    t = time.perf_counter()
    gap = check(cfg, ctx["prompts"], tokens, variant_of, seed, device)
    note(f"reference over {len(tokens)} requests in "
         f"{time.perf_counter() - t:.3f} s")
    n_tok = sum(map(len, tokens.values()))
    ctx["checks"] = {"widest_gap": {"value": gap,
                                    "limit": limits["widest_gap"]},
                     "tokens_compared": {"value": n_tok, "limit": 1}}
    ctx["correct"] = bool(gap <= limits["widest_gap"]) and n_tok >= 1
    return ctx


def gaps_of(cfg: dict, toks, tokens: Dict[int, List[int]],
            variant_of: Dict[int, str], seed: int, device,
            product=mm, rank=None) -> List[float]:
    """Each compared position's gap: the reference's best logit minus its
    logit of the served token (inf for a token outside the vocabulary).
    The reference runs each prompt with its served tokens, variant by
    variant, ``REF_BLOCK`` sequences at a time, with ``product`` as its
    matmul; ``rank`` (the control) picks, in place of the served token,
    the token that its own logits put first."""
    fam = cfg["family"]
    ref = reference.load(fam)
    dtype = getattr(torch, cfg["serve_dtype"])
    out: List[float] = []
    for idx, v in enumerate(cfg["variants"]):
        mine = sorted(i for i in tokens if variant_of[i] == v["name"])
        if not mine:
            continue
        _, W = weights.make(fam, v, cfg["init"], seed, idx, dtype, device)
        V = v["vocab_size"]
        for lo in range(0, len(mine), REF_BLOCK):
            block = mine[lo:lo + REF_BLOCK]
            k = len(tokens[block[0]])
            seqs = torch.tensor(np.stack([
                np.concatenate([toks[i], np.asarray(tokens[i][:k - 1],
                                                    dtype=toks.dtype)])
                for i in block]),
                device=device)
            lg = ref.logits(v, W, seqs, k)                    # (b, k, V)
            picks = torch.tensor([tokens[i] for i in block], device=device)
            if rank is not None:
                picks = torch.argmax(ref.logits(v, W, seqs, k, rank), -1)
            best = lg.max(dim=-1).values
            inside = picks < V
            got = torch.gather(lg, -1, torch.clamp_max(picks, V - 1)[..., None]
                               )[..., 0]
            g = torch.where(inside, best - got, torch.full_like(best,
                                                                math.inf))
            out += g.flatten().tolist()
        del W, _
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def check(cfg, toks, tokens, variant_of, seed, device) -> float:
    gaps = gaps_of(cfg, toks, tokens, variant_of, seed, device)
    return max(gaps) if gaps else math.inf


def control_gaps(cfg, toks, tokens, variant_of, seed, device) -> List[float]:
    """The control: the reference in fp8 in the program's place, read at
    the same positions of the same prompts and tokens."""
    return gaps_of(cfg, toks, tokens, variant_of, seed, device,
                   rank=mm_fp8)
