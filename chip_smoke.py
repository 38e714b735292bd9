#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of ModiPick on one card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build the hand-written kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print their register use;
2. hold each kernel against its plain PyTorch version on the card at
   the server's shapes, with the stated tolerance, and time the kernel,
   the plain version and one PyTorch library call as a yardstick;
3. serve: a pool of full-width qwen2-1.5b variants (widths 0.5 and 1.0,
   bf16, random weights from a seed) behind PoolExecutor → Router →
   ModiPick, answering requests; the launch counters are zeroed just
   before and read just after, and must show the prefill and decode
   kernels ran on every layer of every request; the full-width variant's
   logits on the kernel path are held against the plain path;
4. the batched selection entry point ``ModiPick.select_batch`` on the
   executor's profile store at B = 8192 on the card: the stage-3
   kernel's counter must grow, and its picks must equal the plain
   path's on the same uniforms;
5. timings for the record: per-variant warm prefill / prefill+decode and
   selection throughput (numpy vs the card);

then prints the ``kernels`` JSON line, the card's name and power limit,
and the result line.  Without a card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
            torch.float32: 67e12}          # fp32 outside the tensor cores
SEQ, BATCH, N_DECODE, N_REQUESTS = 128, 4, 2, 24
T_SLA_MS, THRESHOLD_MS = 120.0, 25.0
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),   # summation order only
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}  # ~1 bf16 ulp of |x| ≤ 2
LOGIT_RTOL = 3e-2   # full model, bf16: kernel vs plain path, of max |logit|


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of one call, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, reps=7) -> float:
    """Median host wall time of a call that ends in a synchronise."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, tol) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, tol {tol})")
    return err


def phase_kernels(ops, ref, policy_select, gen):
    """Each kernel against its plain version at the server's shapes."""
    import torch.nn.functional as F
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # K2: prefill attention.  q/k/v arrive as transposed views of the
    # model's (B, S, H, hd) activations.
    B, H, KV = BATCH, 12, 2
    for dtype in (torch.bfloat16, torch.float32):
        for S, hd in ((128, 128), (200, 128), (128, 64)):
            q = randn(B, S, H, hd, dtype=dtype).transpose(1, 2)
            k = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
            v = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
            out = ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = check(f"flash_attention S={S} hd={hd} {dtype}", out,
                        ref.flash_attention_ref(q, k, v, causal=True),
                        TOL[dtype])
            log(f"K2 flash_attention B={B} H={H} KV={KV} S={S} hd={hd} "
                f"{dtype}: max_abs_err={err:.3g} tol={TOL[dtype]}")
            if (S, hd, dtype) != (SEQ, 128, torch.bfloat16):
                continue
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            esize = q.element_size()
            pairs = S * (S + 1) // 2
            b = bound(esize * (2 * q.numel() + 2 * k.numel()),
                      4 * hd * pairs * B * H, dtype)
            rows["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:28",
                max_abs_err=err,
                ms=time_ms(lambda: ops.flash_attention(q, k, v)),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v)),
                bound_ms=b[0], bound_by=b[1],
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True)))

    # K3: decode attention over the server's 144-slot cache, read through
    # the model's (B, C, KV, hd) layout, pos in [128, 143].
    C, G = SEQ + 16, H // KV
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (128, 64):
            # q as the model hands it: the query heads of the fused
            # (B, 1, H + 2 KV, hd) projection output, grouped per KV head
            q = randn(B, 1, H + 2 * KV, hd, dtype=dtype)[:, :, :H]
            q = q.reshape(B, KV, G, hd)
            ck = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
            cv = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
            pos = torch.randint(SEQ, C, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
            out = ops.decode_attention(q, ck, cv, pos)
            torch.cuda.synchronize()
            err = check(f"decode_attention hd={hd} {dtype}", out,
                        ref.decode_attention_ref(q, ck, cv, pos), TOL[dtype])
            log(f"K3 decode_attention B={B} KV={KV} G={G} C={C} hd={hd} "
                f"pos={pos.tolist()} {dtype}: max_abs_err={err:.3g} "
                f"tol={TOL[dtype]}")
            if (hd, dtype) != (128, torch.bfloat16):
                continue
            live = int((pos.to(torch.int64) + 1).sum()) * KV
            esize = q.element_size()
            b = bound(esize * (2 * q.numel() + 2 * live * hd) + 4 * B,
                      4 * G * hd * live, dtype)
            qs = q.reshape(B, H, 1, hd).contiguous()
            kc, vc = ck.contiguous(), cv.contiguous()
            mask = (torch.arange(C, device="cuda")[None, :]
                    <= pos[:, None])[:, None, None, :]
            rows["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:22",
                max_abs_err=err,
                ms=time_ms(lambda: ops.decode_attention(q, ck, cv, pos)),
                plain_ms=time_ms(
                    lambda: ref.decode_attention_ref(q, ck, cv, pos)),
                bound_ms=b[0], bound_by=b[1],
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=True)))

    # K1: stage 3 on the stage-2 eligibility of a synthetic 3-model pool
    # (the server's own 2-model store is checked in the selection phase).
    rng = np.random.default_rng(0)
    n, Bsel = 3, 8192
    mu, sig = rng.uniform(5, 60, n), rng.uniform(0, 5, n)
    acc = rng.uniform(0.3, 0.9, n)
    pool = policy_select.DevicePool(mu, sig, acc,
                                    np.argsort(-acc, kind="stable"),
                                    int(np.argmin(mu)), device="cuda")
    err, ms, plain = k1_check(ops, ref, policy_select, pool,
                              rng.uniform(0, 90, Bsel), gen)
    log(f"K1 modipick_probs B={Bsel} n={n}: max_abs_err={err:.3g} "
        "(picks equal on shared uniforms)")
    nbytes = 4 * (3 * n + 2 * Bsel + 2 * Bsel * n)
    b = bound(nbytes, 12 * Bsel * n, torch.float32)
    rows["modipick_probs"] = dict(
        name="modipick_probs", route="triton",
        source="src/repro_torch/kernels/policy_select.py",
        replaces="src/repro/kernels/policy_select.py:51",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
        bound_by=b[1], library_ms=None)
    return rows


def k1_check(ops, ref, policy_select, pool, budgets, gen):
    """Stage 3 (kernel vs plain) on the stage-2 eligibility the pipeline
    feeds it, and the whole pipeline's picks with the kernel vs with the
    plain version on the same uniforms.  Returns (err, ms, plain_ms)."""
    t_u = torch.tensor(budgets, dtype=torch.float32, device="cuda")
    t_l = t_u - THRESHOLD_MS
    _, _, elig = policy_select._stages12(pool.mu, pool.sigma, pool.rank,
                                         t_u, t_l)
    e = elig.to(torch.float32)
    args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, e)
    got = ops.modipick_probs(*args)
    err = check("modipick_probs", got, ref.policy_probs_ref(*args),
                TOL[torch.float32])
    r01 = torch.rand(t_u.shape[0], generator=gen, device="cuda")
    fused = [policy_select._fused_select(pool.mu, pool.sigma, pool.acc,
                                         pool.rank, t_u, t_l, r01, gamma=1.0,
                                         stage3=s3)
             for s3 in (ops.modipick_probs, ref.policy_probs_ref)]
    if not torch.equal(*fused):
        raise AssertionError("select_fused picks differ between the stage-3 "
                             "kernel and its plain version")
    return (err, time_ms(lambda: ops.modipick_probs(*args)),
            time_ms(lambda: ref.policy_probs_ref(*args)))


def trace_request(v, tokens) -> None:
    """One warm request (prefill + N_DECODE steps) under torch.profiler:
    the device's busy and idle share of the wall time, the number of
    kernels launched, and where the host and device time go."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    v.run(tokens, n_decode=N_DECODE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = v.run(tokens, n_decode=N_DECODE)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"[trace] {v.name}: request {ms:.3f} ms under the profiler, "
        f"{len(kernels)} device kernels, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / ms:.3f})")
    avg = prof.key_averages()
    for key, label in (("self_device_time_total", "device"),
                       ("self_cpu_time_total", "host")):
        top = sorted(avg, key=lambda e: getattr(e, key), reverse=True)[:8]
        log(f"[trace] {v.name} top {label} self time: " + "; ".join(
            f"{e.key} {getattr(e, key) / 1e3:.3f} ms x{e.count}"
            for e in top))


def build_pool(Variant, get_config, gen):
    base = get_config("qwen2-1.5b")
    pool = []
    for w in (0.5, 1.0):
        cfg = base.scaled(w, name=f"{base.name}-w{w:g}")
        v = Variant(name=cfg.name, cfg=cfg,
                    quality=base.quality * (0.6 + 0.4 * w),
                    cache_len=SEQ + 16)
        v.build(gen, torch.bfloat16)
        pool.append(v)
    full = pool[-1].cfg
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.padded_vocab) == (28, 1536, 12, 2, 128, 8960, 151_936,
                                   152_064), full
    return pool


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.kernels import build, ops, policy_select, ref
    from repro_torch.models import model as M
    from repro_torch.models.attention import KERNELS, PLAIN
    from repro_torch.serving.executor import PoolExecutor
    from repro_torch.serving.pool import Variant

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    build.build()
    log(f"[build] {time.perf_counter() - t0:.1f}s")
    for name, out in build.BUILD_LOGS.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill stores" not in line:
                log(f"[ptxas {name}] {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # 2. kernels against their plain versions
    rows = phase_kernels(ops, ref, policy_select, gen)

    # 3. serve full-width qwen2-1.5b through PoolExecutor → Router → ModiPick
    t0 = time.perf_counter()
    pool = build_pool(Variant, get_config, gen)
    tokens = np.random.default_rng(0).integers(0, 500, (BATCH, SEQ),
                                               dtype=np.int32)
    ex = PoolExecutor(pool, NetworkModel.from_cv(20.0, 0.5),
                      ModiPick(THRESHOLD_MS))
    ex.warm_up(tokens, n_decode=N_DECODE)
    log(f"[serve] pool built and warmed in {time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{v.name} d={v.cfg.d_model} L={v.cfg.n_layers} "
                    f"hd={v.cfg.resolved_head_dim}" for v in pool))
    ops.reset_launch_counts()
    results = [ex.execute(tokens, t_sla=T_SLA_MS, n_decode=N_DECODE)
               for _ in range(N_REQUESTS)]
    serve_counts = ops.launch_counts()
    summary = ex.summary()
    log("[serve] summary " + json.dumps(summary))
    log("[serve] launches " + json.dumps(serve_counts))
    layers = [ex.by_name[r.variant].cfg.n_layers for r in results]
    want = {"flash_attention": sum(layers),
            "decode_attention": N_DECODE * sum(layers),
            "modipick_probs": 0}
    if serve_counts != want:
        raise AssertionError(f"serve launches {serve_counts} != {want}")
    if summary["n"] != N_REQUESTS or not all(
            np.isfinite(r.t_infer_ms) and r.t_infer_ms > 0 for r in results):
        raise AssertionError("serve phase returned bad results")

    full = pool[-1]
    with torch.inference_mode():
        tok = torch.as_tensor(tokens, device="cuda")
        pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")
        outs, nxt = {}, None
        for label, impl in (("plain", PLAIN), ("kernel", KERNELS)):
            cache, logits = M.prefill(full.cfg, full.params, tok,
                                      full.cache_len, impl=impl)
            if nxt is None:  # both paths decode the same next tokens
                nxt = torch.argmax(logits, -1)
            step, _ = M.decode_step(full.cfg, full.params, cache, nxt, pos,
                                    impl=impl)
            outs[label] = (logits.float(), step.float())
    for i, what in enumerate(("prefill", "decode step")):
        lk, lp = outs["kernel"][i], outs["plain"][i]
        vs = full.cfg.vocab_size
        if not torch.isfinite(lk[:, :vs]).all():
            raise AssertionError(f"{what} logits are not finite")
        err = float((lk - lp).abs().max())
        scale = float(lp[:, :vs].abs().max())
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        log(f"[serve] full-width {what} logits, kernel vs plain path: "
            f"max_abs_err={err:.4g} max|logit|={scale:.4g} "
            f"tol={LOGIT_RTOL}*max|logit| greedy_agreement={agree:.3f}")
        if err > LOGIT_RTOL * scale:
            raise AssertionError(f"{what} logits disagree: {err} > "
                                 f"{LOGIT_RTOL} * {scale}")

    # 4. batched selection on the executor's store, on the card
    rng = np.random.default_rng(1)
    B_SEL = 8192
    budgets = T_SLA_MS - 2.0 * ex.network.sample(rng, B_SEL)
    ops.reset_launch_counts()
    picks = ex.policy.select_batch(ex.store, budgets, rng, backend="cuda")
    sel_counts = ops.launch_counts()
    log(f"[select] B={B_SEL} launches {json.dumps(sel_counts)} usage "
        + json.dumps({n: picks.count(n) / B_SEL for n in ex.by_name}))
    if sel_counts["modipick_probs"] < 1 or len(picks) != B_SEL \
            or not set(picks) <= set(ex.by_name):
        raise AssertionError("batched selection did not run the stage-3 "
                             "kernel or returned bad picks")
    tab = ex.store.table()
    err, _, _ = k1_check(ops, ref, policy_select, tab.device_pool("cuda"),
                         budgets, gen)
    log(f"[select] executor store n={len(tab)}: stage-3 max_abs_err={err:.3g}, "
        "picks equal with kernel and plain stage 3")
    launches = dict(serve_counts, modipick_probs=sel_counts["modipick_probs"])
    for name, row in rows.items():
        row["launches"] = launches[name]

    # 5. timings for the record
    for v in pool:
        pre = wall_ms(lambda: v.run(tokens, n_decode=0))
        both = wall_ms(lambda: v.run(tokens, n_decode=N_DECODE))
        log(f"[perf] {v.name}: warm prefill {pre:.3f} ms, prefill + "
            f"{N_DECODE} decode {both:.3f} ms (B={BATCH}, S={SEQ}, "
            f"median of 7)")
        trace_request(v, tokens)
    for B in (1000, 8192, 100_000):
        b = T_SLA_MS - 2.0 * ex.network.sample(rng, B)
        for backend in ("numpy", "cuda"):
            ms = wall_ms(lambda: ex.policy.select_batch(ex.store, b, rng,
                                                        backend=backend), 5)
            log(f"[perf] select_batch B={B} backend={backend}: {ms:.3f} ms "
                f"= {B / ms * 1e3:.4g} requests/s (median of 5)")

    for row in rows.values():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if row[key] is not None and not row[key] > 0:
                raise AssertionError(f"{row['name']}: bad {key} {row[key]}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    order = ("flash_attention", "decode_attention", "modipick_probs")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys}
                                  for n in order]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
