#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of ModiPick on one card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build the hand-written kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print their register use; every
   bf16 instantiation of the tensor-core kernels (K2, K3, K4) must show
   no spills;
2. hold each kernel against its plain PyTorch version on the card at
   the server's shapes, with the stated tolerance, and time the kernel,
   the plain version and, where there is one, a PyTorch library call as
   a yardstick; the SSD scan (with its final state) and the RG-LRU scan
   also at a ragged multi-chunk length, and the attention kernels also
   at recurrentgemma's shapes (hd 256, 10 query heads over 1 KV head);
   K4's occupancy (two blocks an SM at the serve shape) and its time
   over S; K5's segment plan; the selection kernels (K1 bit for bit at
   gamma 1, the fused selection's picks, all five of the charged pass's
   outputs) on synthetic pools with rows that have no base, degenerate
   rows, SLA-aware admission that sheds, replica speeds and a replica
   that is down, timed there as ``[extra]`` lines; the charged block's
   shared memory as the kernel reports it against its Python mirror;
3. serve, for each of qwen2-1.5b, mamba2-1.3b and recurrentgemma-2b: a
   pool of the published config at widths 0.5 and 1.0 (full depth, bf16,
   random weights from a seed) behind PoolExecutor → Router → ModiPick,
   answering requests; the launch counters are zeroed just before and
   read just after, and must show that every layer of every request ran
   its kernels (prefill attention per attention layer, decode attention
   per attention layer and decode step, the SSD scan per SSD layer, the
   RG-LRU scan per RG-LRU layer); the full-width variant's logits on the
   kernel path are held against the plain path, for prefill and one
   decode step;
4. the batched selection on the qwen2 executor's profile store, each
   entry point with the counters zeroed just before and read just after
   and required to launch exactly its one kernel:
   ``ModiPick.select_batch`` on the card at B = 8192 (the fused
   selection), ``select_batch_traced(detail=True)`` (K1), and a charged
   ``Router.route_batch_arrays`` burst on ``cuda`` and on ``auto`` at
   B = DEVICE_MIN_BATCH (the charged pass), whose decisions must equal
   the same route's on the CPU through the plain version, on the same
   uniforms; then each of the three kernels on the very operands its
   entry point handed it, held against its plain version there and
   timed there for its row of the kernels line;
5. timings for the record: per-variant warm prefill / prefill+decode
   with a profiler trace; ``select_batch`` and charged routing on numpy
   and on the card (``[perf]``), and the batch size at which the card
   overtakes numpy for each (``[crossover]``, three rounds);

then prints the ``kernels`` JSON line, the card's name and power limit,
and the result line.  Without a card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
            torch.float32: 67e12}          # fp32 outside the tensor cores
SEQ, BATCH, N_DECODE = 128, 4, 2
N_REQUESTS = {"qwen2-1.5b": 24, "mamba2-1.3b": 12, "recurrentgemma-2b": 12}
# The published dims each pool's full-width variant must have: layers,
# d_model, vocab and padded vocab, then the family's own widths.
PUBLISHED = {
    "qwen2-1.5b": dict(n_layers=28, d_model=1536, vocab_size=151_936,
                       padded_vocab=152_064, n_heads=12, n_kv_heads=2,
                       resolved_head_dim=128, d_ff=8960),
    "mamba2-1.3b": dict(n_layers=48, d_model=2048, vocab_size=50_280,
                        padded_vocab=50_432, d_inner=4096, ssm_heads=64,
                        ssm=(128, 64, 2, 256, 4, 1)),
    "recurrentgemma-2b": dict(n_layers=26, d_model=2560,
                              vocab_size=256_000, padded_vocab=256_000,
                              n_heads=10, n_kv_heads=1,
                              resolved_head_dim=256, d_ff=7680,
                              window=2048, lru_width=2560),
}
T_SLA_MS, THRESHOLD_MS = 120.0, 25.0
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),   # summation order only
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}  # ~1 bf16 ulp of |x| ≤ 2
LOGIT_RTOL = 3e-2   # full model, bf16: kernel vs plain path, of max |logit|
# The families whose free-running kernel-path logits are held to
# LOGIT_RTOL.  The random-weight mamba2 and recurrentgemma stacks amplify
# a bf16 rounding difference layer by layer, so after 48 (26) layers the
# two paths' logits are unrelated whatever the kernels do; the
# layer-by-layer check holds every family instead.
FREE_RUNNING = ("qwen2-1.5b",)
# The SSD scan relative to max |y| (the chunked kernel and the sequential
# plain version sum in different orders; tests/test_kernels.py's bounds).
SSD_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


HOST_PACED = {}  # label → host-paced ms, host µs, device µs, kernels per call


def device_us(fn, iters=20) -> tuple:
    """(device µs, kernels) per call: the summed durations of the device
    kernels that ``iters`` calls ran under torch.profiler, without the
    gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in kernels) / iters,
            len(kernels) / iters)


def time_ms(fn, iters=50, warmup=5, label=None) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    that run back to back: a sleep kernel holds the device while the
    host queues all of them, so the host's own time per call (Python,
    argument checks, the launch) does not pace the device.  If the
    device still reaches the first event before the host has queued the
    last call, the sleep is doubled and the run repeated (up to four
    times; after that the queue cannot be filled ahead, and the time is
    the host-paced one).  With ``label``, also records in HOST_PACED the
    time per call when the host paces the calls, the host's own time per
    call, and ``device_us``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    end.synchronize()
    paced = start.elapsed_time(end) / iters
    if label is not None:
        HOST_PACED[label] = (paced, host_s / iters * 1e6, *device_us(fn))
    sleep_s = 2 * host_s + 1e-3
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * 2e9))  # ~2 GHz SM clock
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        sleep_s *= 2
    return paced


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


def check_scaled(name, got, want, tol) -> float:
    """Max error relative to max(max |want|, 1), held to ``tol``."""
    scale = max(float(want.float().abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max()) / scale
    if not torch.allclose(got.float() / scale, want.float() / scale, **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max err {err} of max |y|, tol {tol})")
    return err


def extra(name, ms, plain_ms, b, library_ms=None) -> None:
    """A kernel's numbers at a shape beside the row of its kernels line."""
    log(f"[extra] {name}: ms={ms:.5g} plain_ms={plain_ms:.5g} "
        f"bound_ms={b[0]:.4g} ({b[1]}) library_ms="
        + ("null" if library_ms is None else f"{library_ms:.5g}"))


def check(name, got, want, tol) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, tol {tol})")
    return err


# The bf16 tensor-core kernels ptxas must report on without a spill:
# library → (kernel, instantiations): K2 and K3 at five head sizes, K4
# at four.
BF16_KERNELS = {"flash_attention": ("flash_bf16_kernel", 5),
                "decode_attention": ("decode_kernel", 5),
                "ssd_scan": ("ssd_bf16_kernel", 4)}


def bf16_ptxas(logs) -> None:
    """Log each bf16 K2/K3/K4 instantiation's registers, static shared
    memory and spills as ptxas reports them; fail on any spill or a
    missing report."""
    for lib, (kern, want) in BF16_KERNELS.items():
        entry, seen = None, 0
        for line in logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                ok = kern in name and (kern == "ssd_bf16_kernel"
                                       or "bfloat16" in name)
                entry = name if ok else None
                spill = None
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if not m:
                continue
            smem = re.search(r"(\d+) bytes smem", line)
            tmpl = ",".join(re.findall(r"Li(\d+)E", entry))
            log(f"[ptxas bf16] {kern} <{tmpl}>: registers={m.group(1)} "
                f"static_smem={smem.group(1) if smem else 0} bytes "
                f"spill_stores={spill[0]} spill_loads={spill[1]}")
            if spill != (0, 0):
                raise AssertionError(f"{kern} <{tmpl}> spills: {spill}")
            seen += 1
            entry = None
        if seen != want:
            raise AssertionError(f"ptxas reported on {seen} bf16 {kern} "
                                 f"instantiations, not {want}")


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
                ms=time_ms(lambda: ops.flash_attention(q, k, v),
                           label="K2 qwen2 kernel"),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v)),
                bound_ms=b[0], bound_by=b[1],
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True),
                    label="K2 qwen2 SDPA"))

    # K2 against SDPA over prompt lengths at qwen2's heads: how each
    # grows with the work.
    for S in (16, 64, 128, 200):
        q = randn(B, S, H, 128, dtype=torch.bfloat16).transpose(1, 2)
        k = randn(B, S, KV, 128, dtype=torch.bfloat16).transpose(1, 2)
        qc, kc = q.contiguous(), k.contiguous()
        ms = time_ms(lambda: ops.flash_attention(q, k, k))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, kc, is_causal=True, enable_gqa=True))
        log(f"[scaling] K2 B={B} H={H} KV={KV} S={S} hd=128 bf16: "
            f"ms={ms:.5g} SDPA ms={sdpa:.5g}")

    # K3: decode attention over the server's 144-slot cache, read through
    # the model's (B, C, KV, hd) layout, pos in [128, 143].
    C, G = SEQ + 16, H // KV
    log_split(B, KV, G, C)
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
                ms=time_ms(lambda: ops.decode_attention(q, ck, cv, pos),
                           label="K3 qwen2 kernel"),
                plain_ms=time_ms(
                    lambda: ref.decode_attention_ref(q, ck, cv, pos)),
                bound_ms=b[0], bound_by=b[1],
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=True),
                    label="K3 qwen2 SDPA"))

    # K2 and K3 at recurrentgemma's local layers: hd 256, 10 query heads
    # over one KV head (G = 10), window 2048; K3 over a 144-slot ring
    # that has wrapped (every slot valid: pos_eff = C - 1, no window).
    B, H, KV, hd, dtype = BATCH, 10, 1, 256, torch.bfloat16
    q = randn(B, SEQ, H, hd, dtype=dtype).transpose(1, 2)
    k = randn(B, SEQ, KV, hd, dtype=dtype).transpose(1, 2)
    v = randn(B, SEQ, KV, hd, dtype=dtype).transpose(1, 2)
    err = check("flash_attention hd=256 H=10 KV=1",
                ops.flash_attention(q, k, v, window=2048),
                ref.flash_attention_ref(q, k, v, window=2048), TOL[dtype])
    log(f"K2 flash_attention B={B} H={H} KV={KV} S={SEQ} hd={hd} "
        f"window=2048 {dtype}: max_abs_err={err:.3g} tol={TOL[dtype]}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    pairs = SEQ * (SEQ + 1) // 2
    extra(f"flash_attention B={B} H={H} KV={KV} S={SEQ} hd={hd} bf16",
          time_ms(lambda: ops.flash_attention(q, k, v, window=2048),
                  label="K2 hd256 kernel"),
          time_ms(lambda: ref.flash_attention_ref(q, k, v, window=2048)),
          bound(2 * (2 * q.numel() + 2 * k.numel()),
                4 * hd * pairs * B * H, dtype),
          time_ms(lambda: F.scaled_dot_product_attention(
              qc, kc, vc, is_causal=True, enable_gqa=True),
              label="K2 hd256 SDPA"))
    C, G = SEQ + 16, H // KV
    q = randn(B, 1, H + 2 * KV, hd, dtype=dtype)[:, :, :H].reshape(B, KV, G,
                                                                    hd)
    ck = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    cv = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
    pos = torch.full((B,), C - 1, dtype=torch.int32, device="cuda")
    log_split(B, KV, G, C)
    err = check("decode_attention G=10 hd=256",
                ops.decode_attention(q, ck, cv, pos),
                ref.decode_attention_ref(q, ck, cv, pos), TOL[dtype])
    log(f"K3 decode_attention B={B} KV={KV} G={G} C={C} hd={hd} wrapped "
        f"ring (pos_eff={C - 1}) {dtype}: max_abs_err={err:.3g} "
        f"tol={TOL[dtype]}")
    qs = q.reshape(B, H, 1, hd).contiguous()
    kc, vc = ck.contiguous(), cv.contiguous()
    extra(f"decode_attention B={B} KV={KV} G={G} C={C} hd={hd} bf16",
          time_ms(lambda: ops.decode_attention(q, ck, cv, pos),
                  label="K3 G10 kernel"),
          time_ms(lambda: ref.decode_attention_ref(q, ck, cv, pos)),
          bound(2 * (2 * q.numel() + 2 * B * KV * C * hd) + 4 * B,
                4 * G * hd * B * KV * C, dtype),
          time_ms(lambda: F.scaled_dot_product_attention(
              qs, kc, vc, enable_gqa=True), label="K3 G10 SDPA"))

    attention_edges(ops, ref, randn)

    # K4: the SSD scan at mamba2-1.3b's full width (H 64, hd 64, N 128,
    # G 1, chunk 256), inputs as the model hands them: transposed views
    # of its (B, S, H, hd), (B, S, H) and (B, S, G, N) activations.  At
    # S = 128 and 600 (chunks 256 + 256 + 88) in both types, y and final
    # state.
    def ssd_args(B, S, H, hd, N, G, dtype):
        x = (randn(B, S, H, hd, dtype=torch.float32) * 0.5).to(dtype)
        dt = F.softplus(randn(B, S, H, dtype=torch.float32) - 2.0)
        A = -torch.exp(randn(H, dtype=torch.float32) * 0.3)
        bc = (randn(B, S, 2 * G * N, dtype=torch.float32) * 0.3).to(dtype)
        Bm = bc[..., :G * N].view(B, S, G, N)
        Cm = bc[..., G * N:].view(B, S, G, N)
        return (x.transpose(1, 2), dt.transpose(1, 2), A,
                Bm.transpose(1, 2), Cm.transpose(1, 2))

    H, hd, N, G, chunk = 64, 64, 128, 1, 256
    log_ssd_occupancy(hd, N, chunk)
    for S, dtype in ((SEQ, torch.bfloat16), (600, torch.bfloat16),
                     (SEQ, torch.float32), (600, torch.float32)):
        args = ssd_args(BATCH, S, H, hd, N, G, dtype)
        y, st = ops.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, st_ref = ref.ssd_scan_ref(*args, chunk=chunk)
        err = check_scaled(f"ssd_scan S={S} {dtype} y", y, y_ref,
                           SSD_TOL[dtype])
        err_st = check_scaled(f"ssd_scan S={S} {dtype} final state", st,
                              st_ref, SSD_TOL[dtype])
        log(f"K4 ssd_scan B={BATCH} H={H} S={S} hd={hd} N={N} G={G} "
            f"chunk={chunk} {dtype}: max err of max|y| y={err:.3g} "
            f"state={err_st:.3g} tol={SSD_TOL[dtype]}")
        if (S, dtype) != (SEQ, torch.bfloat16):
            continue
        b = ssd_bound(BATCH, H, G, S, hd, N, chunk, dtype)
        rows["ssd_scan"] = dict(
            name="ssd_scan", route="cuda",
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:21",
            max_abs_err=max(err, err_st),
            ms=time_ms(lambda: ops.ssd_scan(*args, chunk=chunk),
                       label="K4 kernel"),
            plain_ms=time_ms(lambda: ref.ssd_scan_ref(*args), iters=5),
            bound_ms=b[0], bound_by=b[1], library_ms=None)

    # K4 over S at mamba2's heads: 1 to 8 chunks, the state carried
    for S in (128, 256, 600, 1024, 2048):
        args = ssd_args(BATCH, S, H, hd, N, G, torch.bfloat16)
        ms = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk))
        b = ssd_bound(BATCH, H, G, S, hd, N, chunk, torch.bfloat16)
        log(f"[scaling] K4 B={BATCH} H={H} S={S} hd={hd} N={N} chunk={chunk} "
            f"({-(-S // chunk)} chunks) bf16: ms={ms:.5g} bound_ms={b[0]:.4g} "
            f"({b[1]}) share of bound={b[0] / ms:.3f}")

    # K5: the RG-LRU scan at recurrentgemma-2b's width (W 2560, f32, as
    # the model's gates produce a and b), and at a ragged S = 600 in both
    # types.
    W = 2560
    for S, dtype in ((SEQ, torch.float32), (600, torch.float32),
                     (600, torch.bfloat16)):
        log_segments(BATCH, S, W)
        a = (torch.sigmoid(randn(BATCH, S, W, dtype=torch.float32))
             * 0.98).to(dtype)
        bb = (randn(BATCH, S, W, dtype=torch.float32) * 0.1).to(dtype)
        err = check(f"rglru_scan S={S} {dtype}", ops.rglru_scan(a, bb),
                    ref.rglru_scan_ref(a, bb), TOL[dtype])
        log(f"K5 rglru_scan B={BATCH} S={S} W={W} {dtype}: "
            f"max_abs_err={err:.3g} tol={TOL[dtype]}")
        if S != SEQ:
            continue
        b = bound(4 * 3 * a.numel(), 2 * a.numel(), torch.float32)
        rows["rglru_scan"] = dict(
            name="rglru_scan", route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:21",
            max_abs_err=err, ms=time_ms(lambda: ops.rglru_scan(a, bb),
                                        label="K5 kernel"),
            plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, bb), iters=10),
            bound_ms=b[0], bound_by=b[1], library_ms=None)

    selection_kernels(ops, ref, policy_select, gen)
    log_timing()
    return rows


def log_timing() -> None:
    """Print the ``[timing]`` lines recorded since the last call."""
    for label, (paced, host_us, dev_us, n) in HOST_PACED.items():
        log(f"[timing] {label}: host-paced {paced:.5g} ms per call (as "
            f"timed before the queue was filled ahead), host "
            f"{host_us:.1f} us per call, device kernels {dev_us:.2f} us "
            f"per call ({n:g} kernels, profiler)")
    HOST_PACED.clear()


def ssd_bound(B, H, G, S, hd, N, chunk, dtype) -> tuple:
    """K4's bound: x, B_, C_, dt, A read once, y and the final state
    written once; the scores once per (batch, group) and chunk, M.X and
    the state update per head and chunk, and the inter-chunk term on
    every chunk but the first (where the state is zero)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (esize * (2 * B * H * S * hd + 2 * B * G * S * N)
              + 4 * (B * H * S + H + B * H * hd * N))
    ops_ = 0
    for s0 in range(0, S, chunk):
        ln = min(chunk, S - s0)
        pairs = ln * (ln + 1) // 2
        ops_ += 2 * B * G * pairs * N + 2 * B * H * (
            pairs * hd + ln * hd * N * (2 if s0 else 1))
    return bound(nbytes, ops_, dtype)


def log_ssd_occupancy(hd, N, chunk) -> None:
    """K4's shared memory a block and blocks an SM, as the card reports
    them, at the serve shape's chunk length (S = 128) and a full chunk;
    fails unless two bf16 blocks of one head share an SM at S = 128 and
    the wrapper's smem_bytes mirrors the kernel."""
    from repro_torch.kernels.ssd_scan import occupancy, smem_bytes
    for dtype in (torch.bfloat16, torch.float32):
        for cs in (SEQ, chunk):
            smem, blocks = occupancy(dtype, hd, N, cs)
            log(f"[occupancy] K4 {dtype} hd={hd} N={N} chunk length {cs}: "
                f"{smem} bytes of shared memory a block, {blocks} blocks "
                "an SM")
            if smem != smem_bytes(hd, N, cs, dtype):
                raise AssertionError("smem_bytes does not mirror the K4 "
                                     f"kernel: {smem} bytes")
            if (dtype, cs) == (torch.bfloat16, SEQ) and blocks < 2:
                raise AssertionError(f"K4 runs {blocks} block an SM at the "
                                     "serve shape")


def log_segments(B, S, W) -> None:
    """K5's segment plan; fails unless it reaches its warp target at the
    serve shape."""
    from repro_torch.kernels.rglru_scan import WARPS_PER_SM, segment_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seg, n_seg = segment_plan(B, S, W, sms)
    warps = B * -(-W // 32) * n_seg
    log(f"[plan] K5 B={B} S={S} W={W}: {n_seg} segments of {seg} steps, "
        f"{warps} warps = {warps / sms:.1f} an SM on {sms} SMs")
    if S == SEQ and warps < WARPS_PER_SM * sms:
        raise AssertionError("K5's segment plan misses its warp target")


def log_split(B, KV, G, C) -> None:
    from repro_torch.kernels.decode_attention import split_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, n_split = split_plan(B, KV, C, sms)
    log(f"K3 split B={B} KV={KV} G={G} C={C}: n_split={n_split} "
        f"chunk={chunk} blocks={B * KV * n_split} on {sms} SMs")
    if n_split < 2:
        raise AssertionError("K3 does not split the serve-shape cache")


def attention_edges(ops, ref, randn) -> None:
    """K2 and K3 at their edges: K2 at hd 256 with a window of 64 over
    Sq 16, 17 and 200; K3 with pos at 0, at both sides of the first
    chunk boundary and at the last slot, for G 1, 6, 10 and 17, with
    and without a window that drops whole chunks."""
    from repro_torch.kernels.decode_attention import split_plan
    dtype = torch.bfloat16
    for S in (16, 17, 200):
        q = randn(2, S, 10, 256, dtype=dtype).transpose(1, 2)
        k = randn(2, S, 1, 256, dtype=dtype).transpose(1, 2)
        v = randn(2, S, 1, 256, dtype=dtype).transpose(1, 2)
        err = check(f"flash_attention S={S} hd=256 window=64",
                    ops.flash_attention(q, k, v, window=64),
                    ref.flash_attention_ref(q, k, v, window=64), TOL[dtype])
        log(f"K2 flash_attention edge B=2 H=10 KV=1 S={S} hd=256 window=64 "
            f"{dtype}: max_abs_err={err:.3g} tol={TOL[dtype]}")
    B, KV, C = 4, 2, SEQ + 16
    chunk, _ = split_plan(B, KV, C,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    pos = torch.tensor([0, chunk - 1, chunk, C - 1], dtype=torch.int32,
                       device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        worst = 0.0
        for G in (1, 6, 10, 17):
            for hd, window in ((128, 0), (256, 0), (64, 20)):
                q = randn(B, KV, G, hd, dtype=dt)
                k = randn(B, C, KV, hd, dtype=dt).permute(0, 2, 1, 3)
                v = randn(B, C, KV, hd, dtype=dt).permute(0, 2, 1, 3)
                worst = max(worst, check(
                    f"decode_attention edge G={G} hd={hd} window={window} "
                    f"{dt}", ops.decode_attention(q, k, v, pos, window=window),
                    ref.decode_attention_ref(q, k, v, pos, window=window),
                    TOL[dt]))
        log(f"K3 decode_attention edges B={B} KV={KV} C={C} "
            f"pos={pos.tolist()} G=1,6,10,17 hd=128,256,64(window 20) "
            f"{dt}: worst max_abs_err={worst:.3g} tol={TOL[dt]}")


def probs_bound(B, n) -> tuple:
    """K1: the pool, the row bounds and the eligibility read once, the
    probabilities written; ~12 fp32 operations a (request, model)."""
    return bound(4 * (3 * n + 2 * B + 2 * B * n), 12 * B * n, torch.float32)


def fused_bound(B, n) -> tuple:
    """The fused selection: pool and rows read once, picks written; ~20
    fp32 operations a (request, model): Eq. 2, the window, Eq. 3-4, the
    mass, the normalisation and the running sum."""
    return bound(4 * (4 * n + 3 * B) + 4 * B, 20 * B * n, torch.float32)


def charged_bound(args) -> tuple:
    """The charged pass: pool, mask, ledger and rows read once, five
    outputs written; per request a wait per (model, replica), ~20 fp32
    operations a model and the replica argmin."""
    n, R, B = args[0].shape[0], args[6].shape[0], args[8].shape[0]
    nbytes = 4 * (5 * n + 2 * R + 4 * B) + n * R + 14 * B
    return bound(nbytes, B * (n * R + 20 * n + R), torch.float32)


def select_pool(policy_select, n, seed):
    """A synthetic pool of n models on the card, from a seed."""
    rng = np.random.default_rng(seed)
    mu, sig = rng.uniform(5, 60, n), rng.uniform(0, 5, n)
    acc = rng.uniform(0.3, 0.9, n)
    return rng, policy_select.DevicePool(mu, sig, acc,
                                         np.argsort(-acc, kind="stable"),
                                         int(np.argmin(mu)), device="cuda")


def fused_inputs(pool, rng, gen, B):
    """Budget rows for the fused kernel, t_u in [-5, 90) ms: the first
    2% of the rows forced to have no base, the next 3% to a negative
    mass (uniform over their eligible models)."""
    t_u = rng.uniform(-5, 90, B).astype(np.float32)
    t_u[: B // 50] = float(pool.mu.min()) - 50.0
    t_l = t_u - THRESHOLD_MS
    t_l[B // 50: B // 20] = t_u[B // 50: B // 20] + 40.0
    return (pool.mu, pool.sigma, pool.acc, pool.rank,
            torch.tensor(t_u, device="cuda"), torch.tensor(t_l, device="cuda"),
            torch.rand(B, generator=gen, device="cuda"))


# The charged pass's cases: (n, R, speeds vary, a replica down, slack,
# include_mu, or None for AdmitAll).  Each SLA-aware case sheds some of
# its requests and admits the rest.
CHARGED_CASES = {"admit_all": (3, 6, False, False, 0.0, None),
                 "sla": (3, 6, False, False, 0.0, False),
                 "sla_mu": (8, 16, False, False, 4.0, True),
                 "speeds_down": (8, 8, True, True, 2.0, True)}


def charged_inputs(policy_select, gen, case, B):
    """The charged pass's operands on the card: each model served by 2
    of R replicas (model 0 only by replica 0 when one is down, at an
    infinite wait), waits in [0, 30) ms, budgets in [20, 160) ms, and a
    charge of 2% of mu a pick, so that the waits cross the budgets in
    the course of the batch."""
    n, R, speeds, down, slack, include_mu = CHARGED_CASES[case]
    rng, pool = select_pool(policy_select, n, len(case))
    cand = torch.zeros(n, R, dtype=torch.bool)
    for m in range(n):
        cand[m, rng.choice(R, size=2, replace=False)] = True
    rep_wait = rng.uniform(0.0, 30.0, R)
    if down:
        rep_wait[0] = np.inf
        cand[0] = False
        cand[0, 0] = True
    speed = rng.uniform(0.5, 2.0, R) if speeds else np.ones(R)
    budgets = rng.uniform(20.0, 160.0, B)
    lim = budgets if include_mu is not None else np.full(B, np.inf)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device="cuda")

    args = (pool.mu, pool.sigma, pool.acc, pool.rank, pool.mu * 0.02,
            cand.cuda(), f32(speed), f32(rep_wait), f32(budgets),
            f32(budgets - THRESHOLD_MS),
            torch.rand(B, generator=gen, device="cuda"), f32(lim))
    return args, dict(slack=slack, include_mu=bool(include_mu),
                      fastest=pool.fastest)


def selection_kernels(ops, ref, policy_select, gen) -> None:
    """K1, the fused selection and the charged pass against their plain
    versions on synthetic pools: K1 bit for bit at gamma 1 and to TOL at
    gamma 2; the fused picks equal at B = 8192 (n = 2, 3, 8, 128) and
    ragged B = 1000; all five charged outputs equal at B = 1024, every
    SLA-aware case shedding some requests and admitting others.  Timed
    as ``[extra]`` lines at B = 8192, n = 3 (K1, fused), B = 100,000
    (fused) and B = 1024-8192, n = 3, R = 6 (charged); the kernels line
    takes the main path's shapes (``main_selection``)."""
    # K1 on the stage-2 eligibility of a synthetic 3-model pool, as the
    # detailed-trace path hands it
    n, B = 3, 8192
    rng, pool = select_pool(policy_select, n, 0)
    t_u = torch.tensor(rng.uniform(0, 90, B), dtype=torch.float32,
                       device="cuda")
    t_l = t_u - THRESHOLD_MS
    _, _, elig = policy_select._stages12(pool.mu, pool.sigma, pool.rank,
                                         t_u, t_l)
    args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, elig.float())
    got, want = ops.modipick_probs(*args), ref.policy_probs_ref(*args)
    if not torch.equal(got, want):
        raise AssertionError("modipick_probs differs from its plain "
                             "version at gamma 1")
    err2 = check("modipick_probs gamma 2", ops.modipick_probs(*args, gamma=2.0),
                 ref.policy_probs_ref(*args, gamma=2.0), TOL[torch.float32])
    log(f"K1 modipick_probs B={B} n={n}: equal to its plain version at "
        f"gamma 1; gamma 2 max_abs_err={err2:.3g} tol={TOL[torch.float32]}")
    extra(f"modipick_probs B={B} n={n}",
          time_ms(lambda: ops.modipick_probs(*args)),
          time_ms(lambda: ref.policy_probs_ref(*args)), probs_bound(B, n))

    # fused_select: picks equal to the plain version's
    for n_ in (2, 3, 8, 128):
        for B_ in (8192, 1000):
            rng_, pool_ = select_pool(policy_select, n_, n_ + B_)
            sel = fused_inputs(pool_, rng_, gen, B_)
            got = ops.fused_select(*sel)
            if not torch.equal(got, ref.fused_select_ref(*sel)):
                raise AssertionError(f"fused_select picks differ from the "
                                     f"plain version's at n={n_} B={B_}")
            log(f"B2 fused_select B={B_} n={n_}: picks equal to the plain "
                f"version's ({int((got < 0).sum())} rows with no base)")
    for B_ in (8192, 100_000):
        rng_, pool_ = select_pool(policy_select, 3, B_)
        sel = fused_inputs(pool_, rng_, gen, B_)
        extra(f"fused_select B={B_} n=3",
              time_ms(lambda: ops.fused_select(*sel)),
              time_ms(lambda: ref.fused_select_ref(*sel), iters=10),
              fused_bound(B_, 3))

    # charged_select: all five outputs equal to the plain version's
    for case in CHARGED_CASES:
        args, kw = charged_inputs(policy_select, gen, case, 1024)
        n_, R = args[0].shape[0], args[6].shape[0]
        need = policy_select.charged_smem(n_, R, "cuda")[0]
        if need != policy_select.charged_smem_bytes(n_, R):
            raise AssertionError(f"charged_smem_bytes({n_}, {R}) does not "
                                 f"mirror the kernel's {need} bytes")
        got = ops.charged_select(*args, **kw)
        want = ref.charged_select_ref(*args, **kw)
        for what, g, w in zip(("picks", "admitted", "has_base", "replica",
                               "w_chosen"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"charged_select {case}: {what} differs "
                                     "from the plain version's")
        admitted = int(got[1].sum())
        if CHARGED_CASES[case][5] is not None and not 0 < admitted < 1024:
            raise AssertionError(f"charged_select {case}: {admitted} of 1024 "
                                 "admitted; the case must shed some and "
                                 "admit others")
        log(f"B3 charged_select {case} B=1024 n={n_} R={R}: all five outputs "
            f"equal to the plain version's ({admitted} admitted, "
            f"{int((~got[2]).sum())} without a base; {need} bytes of shared "
            "memory, as charged_smem_bytes mirrors it)")
    for B_ in (1024, 4096, 8192):
        args, kw = charged_inputs(policy_select, gen, "sla", B_)
        ms = time_ms(lambda: ops.charged_select(*args, **kw), iters=10)
        b = charged_bound(args)
        log(f"[extra] charged_select B={B_} n=3 R=6: ms={ms:.5g} "
            f"= {ms / B_ * 1e3:.4g} us per request; bound_ms={b[0]:.4g} "
            f"({b[1]})")
    limit = policy_select.charged_smem(1, 1, "cuda")[1]
    log(f"[extra] charged_select block shared memory limit: {limit} bytes")


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


def published_dims(cfg) -> dict:
    """The dims of ``cfg`` that ``PUBLISHED`` names for its arch."""
    out = {k: getattr(cfg, k) for k in ("n_layers", "d_model", "vocab_size",
                                        "padded_vocab", "n_heads",
                                        "n_kv_heads", "resolved_head_dim",
                                        "d_ff", "window")}
    if cfg.ssm is not None:
        s = cfg.ssm
        out["ssm"] = (s.d_state, s.head_dim, s.expand, s.chunk_size,
                      s.conv_width, s.n_groups)
        out["d_inner"], out["ssm_heads"] = (s.d_inner(cfg.d_model),
                                            s.n_heads(cfg.d_model))
    if cfg.rglru is not None:
        out["lru_width"] = cfg.rglru.width(cfg.d_model)
    return out


def build_pool(arch, gen):
    """Widths 0.5 and 1.0 of the published config of ``arch``, at full
    depth, bf16, random weights from ``gen``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.pool import Variant

    base = get_config(arch)
    pool = []
    for w in (0.5, 1.0):
        cfg = base.scaled(w, name=f"{base.name}-w{w:g}")
        v = Variant(name=cfg.name, cfg=cfg,
                    quality=base.quality * (0.6 + 0.4 * w),
                    cache_len=SEQ + 16)
        v.build(gen, torch.bfloat16)
        pool.append(v)
    dims = published_dims(pool[-1].cfg)
    want = PUBLISHED[arch]
    got = {k: dims[k] for k in want}
    if got != want:
        raise AssertionError(f"{arch} full width is not the published "
                             f"config: {got} != {want}")
    return pool


def expected_launches(cfgs) -> dict:
    """The kernel launches of one request (prefill + N_DECODE steps) on
    each config: prefill and decode attention per attention layer (and
    decode step), the SSD scan per SSD layer, the RG-LRU scan per RG-LRU
    layer; no selection kernel on the scalar path."""
    want = dict(flash_attention=0, decode_attention=0, ssd_scan=0,
                rglru_scan=0, modipick_probs=0, fused_select=0,
                charged_select=0)
    for cfg in cfgs:
        kinds = cfg.block_kinds
        n_attn = sum(k in ("attn", "local") for k in kinds)
        want["flash_attention"] += n_attn
        want["decode_attention"] += n_attn * N_DECODE
        want["ssd_scan"] += kinds.count("ssd")
        want["rglru_scan"] += kinds.count("rglru")
    return want


def logits_err(what, lk, lp, vocab) -> tuple:
    """(max |kernel − plain|, max |plain|) over the real vocabulary, and
    a log line; raises on non-finite kernel logits."""
    lk, lp = lk.float()[:, :vocab], lp.float()[:, :vocab]
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{what} logits are not finite")
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"{what} logits, kernel vs plain path: max_abs_err={err:.4g} "
        f"max|logit|={scale:.4g} tol={LOGIT_RTOL}*max|logit| "
        f"greedy_agreement={agree:.3f}")
    return err, scale


def free_running(arch, v, M, ops, tokens) -> None:
    """Prefill and one decode step of the full-width variant, once on
    the kernel path and once on the plain path, each on its own.  Held
    to LOGIT_RTOL only where FREE_RUNNING says so."""
    tok = torch.as_tensor(tokens, device="cuda")
    pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")
    outs, nxt = {}, None
    for label, impl in (("plain", ops.PLAIN), ("kernel", ops.KERNELS)):
        cache, logits = M.prefill(v.cfg, v.params, tok, v.cache_len,
                                  impl=impl)
        if nxt is None:  # both paths decode the same next tokens
            nxt = torch.argmax(logits, -1)
        step, _ = M.decode_step(v.cfg, v.params, cache, nxt, pos, impl=impl)
        outs[label] = (logits, step)
    for i, what in enumerate(("prefill", "decode step")):
        err, scale = logits_err(f"[serve {arch}] free-running {what}",
                                outs["kernel"][i], outs["plain"][i],
                                v.cfg.vocab_size)
        if arch in FREE_RUNNING and err > LOGIT_RTOL * scale:
            raise AssertionError(f"{arch} free-running {what} logits "
                                 f"disagree: {err} > {LOGIT_RTOL} * {scale}")


def layer_by_layer(arch, v, M, ops, tokens) -> None:
    """Prefill and one decode step of the full-width variant with every
    layer run on both paths from the plain path's input to it: each
    layer's output, and the logits of the last layer's output, held to
    LOGIT_RTOL of their largest magnitude.  This bounds what each
    layer's kernels change without the depth amplifying it."""
    cfg, params = v.cfg, v.params
    layers = list(enumerate(zip(cfg.block_kinds, params["layers"])))

    def held(label, x_k, x_p) -> float:
        err = float((x_k.float() - x_p.float()).abs().max())
        scale = float(x_p.float().abs().max())
        if err > LOGIT_RTOL * scale:
            raise AssertionError(f"{arch} layer by layer {label} disagrees: "
                                 f"{err} > {LOGIT_RTOL} * {scale}")
        return err / scale

    def report(label, worst, x_k, x_p) -> None:
        log(f"[serve {arch}] layer by layer {label}: worst layer output "
            f"err {worst:.4g} of its max |x| over {cfg.n_layers} layers")
        err, scale = logits_err(f"[serve {arch}] layer by layer {label}",
                                M.final_logits(cfg, params, x_k),
                                M.final_logits(cfg, params, x_p),
                                cfg.vocab_size)
        if err > LOGIT_RTOL * scale:
            raise AssertionError(f"{arch} layer-by-layer {label} logits "
                                 f"disagree: {err} > {LOGIT_RTOL} * {scale}")

    tok = torch.as_tensor(tokens, device="cuda")
    positions = torch.arange(SEQ, device="cuda")[None, :].expand(BATCH, SEQ)
    tables = M.rope_for(cfg, positions)
    x = M.embed_tokens(cfg, params, tok)
    caches, worst = [], 0.0
    for i, (kind, p) in layers:
        x_k, _ = M.block_prefill(cfg, kind, p, x, tables, v.cache_len,
                                 ops.KERNELS)
        x, c = M.block_prefill(cfg, kind, p, x, tables, v.cache_len,
                               ops.PLAIN)
        worst = max(worst, held(f"prefill layer {i} ({kind})", x_k, x))
        caches.append(c)
    report("prefill", worst, x_k, x)

    nxt = torch.argmax(M.final_logits(cfg, params, x), -1)
    pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")
    tables = M.rope_for(cfg, pos[:, None])
    x = M.embed_tokens(cfg, params, nxt[:, None])
    worst = 0.0
    for i, (kind, p) in layers:
        # an attention cache is written in place: the kernel path gets a copy
        copy = {k: t.clone() for k, t in caches[i].items()}
        x_k, _ = M.block_decode(cfg, kind, p, x, copy, pos, tables,
                                ops.KERNELS)
        x, _ = M.block_decode(cfg, kind, p, x, caches[i], pos, tables,
                              ops.PLAIN)
        worst = max(worst, held(f"decode layer {i} ({kind})", x_k, x))
    report("decode step", worst, x_k, x)


def serve_family(arch, gen, tokens):
    """Serve ``N_REQUESTS[arch]`` requests from a pool of ``arch``
    through PoolExecutor → Router → ModiPick, with the launch counters
    zeroed just before and read just after; hold the full-width logits
    on the kernel path against the plain path; time each variant.
    Returns (executor, the launch counts of the serve run)."""
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PoolExecutor

    t0 = time.perf_counter()
    pool = build_pool(arch, gen)
    ex = PoolExecutor(pool, NetworkModel.from_cv(20.0, 0.5),
                      ModiPick(THRESHOLD_MS))
    ex.warm_up(tokens, n_decode=N_DECODE)
    log(f"[serve {arch}] pool built and warmed in "
        f"{time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{v.name} d={v.cfg.d_model} L={v.cfg.n_layers} "
                    f"kinds={sorted(set(v.cfg.block_kinds))}" for v in pool))
    n = N_REQUESTS[arch]
    ops.reset_launch_counts()
    results = [ex.execute(tokens, t_sla=T_SLA_MS, n_decode=N_DECODE)
               for _ in range(n)]
    counts = ops.launch_counts()
    summary = ex.summary()
    log(f"[serve {arch}] summary " + json.dumps(summary))
    log(f"[serve {arch}] launches " + json.dumps(counts))
    want = expected_launches(ex.by_name[r.variant].cfg for r in results)
    if counts != want:
        raise AssertionError(f"{arch} serve launches {counts} != {want}")
    if summary["n"] != n or not all(
            np.isfinite(r.t_infer_ms) and r.t_infer_ms > 0 for r in results):
        raise AssertionError(f"{arch} serve phase returned bad results")

    with torch.inference_mode():
        free_running(arch, pool[-1], M, ops, tokens)
        layer_by_layer(arch, pool[-1], M, ops, tokens)

    for v in pool:
        pre = wall_ms(lambda: v.run(tokens, n_decode=0))
        both = wall_ms(lambda: v.run(tokens, n_decode=N_DECODE))
        log(f"[perf] {v.name}: warm prefill {pre:.3f} ms, prefill + "
            f"{N_DECODE} decode {both:.3f} ms (B={BATCH}, S={SEQ}, "
            f"median of 7)")
        trace_request(v, tokens)
        v.params = None  # free the card for the next family
    return ex, counts


def charged_router(ex, backend):
    """A Router over the executor's store whose charged batches take the
    device pass (ModiPick, queue-aware, lean traces, SLA-aware admission
    with 2 ms slack and the service time)."""
    from repro_torch.core.policy import ModiPick
    from repro_torch.router import Router, SlaAwareAdmission
    return Router(ex.store, ModiPick(THRESHOLD_MS),
                  admission=SlaAwareAdmission(slack_ms=2.0,
                                              include_service_time=True),
                  queue_aware=True, trace_detail=False, backend=backend)


def charged_batch(ex, router, B, seed):
    """A burst of B requests, SLAs in [T_SLA_MS, 10 T_SLA_MS), routed
    with intra-batch charging over two replicas a model (waits in
    [0, 30) ms, speeds in [0.5, 2)), all drawn from ``seed``; a fresh
    ledger each call."""
    from repro_torch.router import ChargedWaits
    tab = ex.store.table()
    n = len(tab)
    rng = np.random.default_rng(seed)
    state = ChargedWaits(rep_wait=rng.uniform(0.0, 30.0, 2 * n),
                         cand=[[2 * m, 2 * m + 1] for m in range(n)],
                         speed=rng.uniform(0.5, 2.0, 2 * n), mu=tab.mu,
                         names=tab.names)
    t_sla = rng.uniform(T_SLA_MS, 10 * T_SLA_MS, B)
    return router.route_batch_arrays(t_sla, ex.network.sample(rng, B), rng,
                                      charged=state, charge=True)


def captured_call(module, name, fn) -> tuple:
    """Run ``fn`` with ``module.name`` recording the operands of each
    call to it (the wrapper still runs); returns the (args, kwargs) of
    the one call ``fn`` made.  The wrapper counts its launch on its
    module's name, so that launch lands on the recorder and is not
    counted."""
    wrapper, calls = getattr(module, name), []

    def record(*args, **kw):
        calls.append((args, kw))
        return wrapper(*args, **kw)

    record.launches = 0
    setattr(module, name, record)
    fn()
    setattr(module, name, wrapper)
    if len(calls) != 1:
        raise AssertionError(f"{name} was called {len(calls)} times")
    return calls[0]


def main_selection(ex, ops, ref, policy_select) -> tuple:
    """The main path's batched selection on the qwen2 executor's store,
    each entry point driven with the launch counters zeroed just before
    and read just after, and each required to launch exactly its one
    kernel: ``select_batch`` on the card (fused_select),
    ``select_batch_traced(detail=True)`` on the card (modipick_probs),
    and a charged ``route_batch_arrays`` on ``cuda`` and on ``auto`` at
    B = DEVICE_MIN_BATCH (charged_select).  Then checks what came out:
    valid picks and traces; the fused kernel's picks on this store equal
    to the plain version's on the same uniforms; each charged decision
    column equal to the same route on the CPU (the plain version) on the
    card's draws.  Last, each entry point is driven once more with its
    kernel's operands recorded: each kernel is held against its plain
    version on them (K1 and the fused picks bit for bit, all five
    charged outputs equal) and timed on them.  Returns the summed launch
    counts of the counted runs and the three kernels' rows."""
    from repro_torch.core import policy_vec
    rng = np.random.default_rng(1)
    names = set(ex.by_name)
    total = dict.fromkeys(ops.launch_counts(), 0)

    def counted(label, kernel, fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"[select] {label}: launches {json.dumps(counts)}")
        if counts != {k: int(k == kernel) for k in counts}:
            raise AssertionError(f"{label} did not launch {kernel} exactly "
                                 f"once and nothing else: {counts}")
        for k, c in counts.items():
            total[k] += c
        return out

    B = 8192
    budgets = T_SLA_MS - 2.0 * ex.network.sample(rng, B)
    picks = counted(f"select_batch B={B} backend=cuda", "fused_select",
                    lambda: ex.policy.select_batch(ex.store, budgets, rng,
                                                   backend="cuda"))
    traces = counted(f"select_batch_traced detail B={B} backend=cuda",
                     "modipick_probs",
                     lambda: policy_vec.select_batch_traced(
                         ex.policy, ex.store, budgets, rng, backend="cuda",
                         detail=True))
    if len(picks) != B or not set(picks) <= names or len(traces) != B \
            or not all(t.fallback or t.chosen in t.eligible for t in traces):
        raise AssertionError("batched selection returned bad picks")
    log(f"[select] B={B} usage " + json.dumps(
        {n: picks.count(n) / B for n in sorted(names)}))


    Bc = policy_vec.DEVICE_MIN_BATCH
    card_uniforms = policy_select.uniforms
    for backend in ("cuda", "auto"):
        res = counted(f"route_batch_arrays charged B={Bc} backend={backend}",
                      "charged_select",
                      lambda: charged_batch(ex, charged_router(ex, backend),
                                            Bc, 3))
        # the same route on the CPU (the plain version), on the card's
        # uniforms
        policy_select.uniforms = (lambda seed, n, device:
                                  card_uniforms(seed, n, "cuda").to(device))
        plain = charged_batch(ex, charged_router(ex, "cpu"), Bc, 3)
        policy_select.uniforms = card_uniforms
        for col in ("model_idx", "admitted", "fallback", "w_queue_ms",
                    "replica_idx", "reject_code"):
            if not np.array_equal(getattr(res, col), getattr(plain, col)):
                raise AssertionError(f"charged route backend={backend}: "
                                     f"{col} differs from the plain pass")
        log(f"[select] charged B={Bc} backend={backend}: "
            f"{int(res.admitted.sum())} admitted, usage "
            + json.dumps(np.bincount(res.model_idx[res.admitted],
                                     minlength=len(names)).tolist())
            + ", every column equal to the plain pass on the CPU")

    # each kernel on the operands the main path hands it
    rows = {}
    source = "src/repro_torch/csrc/policy_select.cu"
    (a, kw) = captured_call(policy_select, "modipick_probs",
                            lambda: policy_vec.select_batch_traced(
                                ex.policy, ex.store, budgets, rng,
                                backend="cuda", detail=True))
    if not torch.equal(ops.modipick_probs(*a, **kw),
                       ref.policy_probs_ref(*a, **kw)):
        raise AssertionError("modipick_probs differs from its plain version "
                             "on the main path's operands")
    Bk, n = a[5].shape
    b = probs_bound(Bk, n)
    rows["modipick_probs"] = dict(
        name="modipick_probs", route="cuda", source=source,
        replaces="src/repro/kernels/policy_select.py:51", max_abs_err=0.0,
        ms=time_ms(lambda: ops.modipick_probs(*a, **kw), label="K1 kernel"),
        plain_ms=time_ms(lambda: ref.policy_probs_ref(*a, **kw)),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    log(f"[select] modipick_probs on the main path's operands B={Bk} n={n} "
        f"gamma={kw.get('gamma', 1.0)}: equal to its plain version")

    (f, fkw) = captured_call(policy_select, "fused_select",
                             lambda: ex.policy.select_batch(
                                 ex.store, budgets, rng, backend="cuda"))
    if not torch.equal(ops.fused_select(*f, **fkw),
                       ref.fused_select_ref(*f, **fkw)):
        raise AssertionError("fused_select differs from its plain version "
                             "on the main path's operands")
    Bf, n = f[4].shape[0], f[0].shape[0]
    b = fused_bound(Bf, n)
    rows["fused_select"] = dict(
        name="fused_select", route="cuda", source=source,
        replaces="src/repro/kernels/policy_select.py:217", max_abs_err=0.0,
        ms=time_ms(lambda: ops.fused_select(*f, **fkw),
                   label="fused_select kernel"),
        plain_ms=time_ms(lambda: ref.fused_select_ref(*f, **fkw)),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    log(f"[select] fused_select on the main path's operands B={Bf} n={n}: "
        "picks equal to its plain version's")

    (c, ckw) = captured_call(policy_select, "charged_select",
                             lambda: charged_batch(
                                 ex, charged_router(ex, "cuda"), Bc, 3))
    got = ops.charged_select(*c, **ckw)
    t0 = time.perf_counter()
    want = ref.charged_select_ref(*c, **ckw)
    torch.cuda.synchronize()
    charged_plain_ms = (time.perf_counter() - t0) * 1e3
    for what, g, w in zip(("picks", "admitted", "has_base", "replica",
                           "w_chosen"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"charged_select: {what} differs from the "
                                 "plain version's on the main path's "
                                 "operands")
    n, R = c[0].shape[0], c[6].shape[0]
    b = charged_bound(c)
    ms = time_ms(lambda: ops.charged_select(*c, **ckw), iters=20,
                 label="charged_select kernel")
    rows["charged_select"] = dict(
        name="charged_select", route="cuda", source=source,
        replaces="src/repro/kernels/policy_select.py:466", max_abs_err=0.0,
        # the plain pass is a Python loop of small launches: timed by
        # the host, once
        ms=ms, plain_ms=charged_plain_ms,
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    log(f"[select] charged_select on the main path's operands B={Bc} n={n} "
        f"R={R}: all five outputs equal to the plain version's; "
        f"{ms / Bc * 1e3:.4g} us per request")
    return total, rows


def perf_selection(ex) -> None:
    """``select_batch`` and charged ``route_batch_arrays`` on numpy and
    on the card, host wall time (median of 5)."""
    rng = np.random.default_rng(4)
    for B in (1000, 8192, 100_000):
        b = T_SLA_MS - 2.0 * ex.network.sample(rng, B)
        for backend in ("numpy", "cuda"):
            ms = wall_ms(lambda: ex.policy.select_batch(ex.store, b, rng,
                                                        backend=backend), 5)
            log(f"[perf] select_batch B={B} backend={backend}: {ms:.3f} ms "
                f"= {B / ms * 1e3:.4g} requests/s (median of 5)")
    for B in (4096, 8192):
        for backend in ("numpy", "cuda"):
            router = charged_router(ex, backend)
            ms = wall_ms(lambda: charged_batch(ex, router, B, 5), 5)
            log(f"[perf] route_batch_arrays charged B={B} "
                f"backend={backend}: {ms:.3f} ms = {B / ms * 1e3:.4g} "
                "requests/s (median of 5)")


def crossover(ex, rounds=3) -> None:
    """Bracket the batch size at which the card overtakes numpy, for
    ``select_batch`` and for charged routing: per round, each size's
    median of 5 on each backend, the largest size numpy still wins and
    the smallest the card wins."""
    rng = np.random.default_rng(6)
    runs = {
        "select_batch": ((64, 128, 256, 512, 1024, 2048, 4096, 8192),
                         lambda B, backend: ex.policy.select_batch(
                             ex.store, T_SLA_MS - 2.0 * ex.network.sample(
                                 rng, B), rng, backend=backend)),
        "charged": ((2, 4, 8, 16, 32, 64, 128, 256, 512),
                    lambda B, backend: charged_batch(
                        ex, charged_router(ex, backend), B, B))}
    for r in range(rounds):
        for what, (sizes, run) in runs.items():
            t = {B: [wall_ms(lambda: run(B, be), 5)
                     for be in ("numpy", "cuda")] for B in sizes}
            numpy_wins = [B for B in sizes if t[B][0] <= t[B][1]]
            card_wins = [B for B in sizes if t[B][1] < t[B][0]]
            log(f"[crossover] {what} round {r}: " + "; ".join(
                f"B={B} numpy {a:.3f} cuda {b:.3f} ms"
                for B, (a, b) in t.items())
                + f" | numpy wins up to B={max(numpy_wins, default=None)}, "
                f"the card from B={min(card_wins, default=None)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops, policy_select, ref

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. build (always anew, so that ptxas reports on every kernel)
    t0 = time.perf_counter()
    build.build(force=True)
    log(f"[build] {time.perf_counter() - t0:.1f}s")
    for name, out in build.BUILD_LOGS.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill stores" not in line:
                log(f"[ptxas {name}] {line.strip()}")
    bf16_ptxas(build.BUILD_LOGS)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # 2. kernels against their plain versions
    rows = phase_kernels(ops, ref, policy_select, gen)

    # 3. serve each family through PoolExecutor → Router → ModiPick
    tokens = np.random.default_rng(0).integers(0, 500, (BATCH, SEQ),
                                               dtype=np.int32)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    executors = {}
    for arch in N_REQUESTS:
        executors[arch], counts = serve_family(arch, gen, tokens)
        for name, c in counts.items():
            launches[name] += c
    ex = executors["qwen2-1.5b"]

    # 4. the batched selection entry points on the executor's store
    counts, selection_rows = main_selection(ex, ops, ref, policy_select)
    log_timing()
    rows.update(selection_rows)
    for name, c in counts.items():
        launches[name] += c
    for name, row in rows.items():
        row["launches"] = launches[name]
        if not row["launches"] > 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # 5. timings for the record
    perf_selection(ex)
    crossover(ex)

    for row in rows.values():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if row[key] is not None and not row[key] > 0:
                raise AssertionError(f"{row['name']}: bad {key} {row[key]}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    order = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
             "modipick_probs", "fused_select", "charged_select")
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
