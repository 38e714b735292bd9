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
   at recurrentgemma's shapes (hd 256, 10 query heads over 1 KV head),
   moonshot's (G = 1) and gemma3's (G = 2 at hd 256 in float32, an
   1100-token prompt, per-slot positions in a wrapped ring), K2
   without the causal mask and K3 over 1500 frames at whisper-tiny's
   encoder and cross-attention shapes, and K3-int8
   (``decode_attention_int8``) with the new token's quantize-and-write
   at the int8 serve phase's shape, at the edges of its plan's chunks,
   on a wrapped ring and over 32768 slots (the written cache held
   exactly, the output to TOL), and beside bf16 K3 over a 32768-slot
   cache, where it must be the faster;
   K4's occupancy (two blocks an SM at the serve shape; the fp32
   training path's passes) and its time over S; K5's segment plan; the
   selection kernels (K1 bit for bit at gamma 1, the fused selection's
   picks, all five of the charged pass's
   outputs) on synthetic pools with rows that have no base, degenerate
   rows, SLA-aware admission that sheds, replica speeds and a replica
   that is down, and at the engine's pool, at 33, 64 and 128 models
   (the models wrap the warp's lanes) and with dead models, timed there
   as ``[extra]`` lines beside the charged pass's chain bound; the
   charged block's shared memory as the kernel reports it against its
   Python mirror; K1 and the fused selection past 128 models (129, 200
   and 1000), the launch plans of K1 and of the fused and stacked
   kernels as the kernel reports them against their Python mirrors, and
   a pool one model wider than a block holds refused with a ValueError
   (``[plan]`` lines); K2's backward kernel against its plain version
   (``flash_attention_bwd_ref``, from the forward's log-sum-exp, itself
   held against ``flash_attention_lse_ref``) at the training phase's
   shapes and edges (hd 256, whisper's unmasked encoder, a window inside
   S, a ragged S, G = 1) in both types, K5's
   (``rglru_scan_bwd_ref``) at recurrentgemma's training shape, a
   ragged S, segments held in registers and walked from memory, and
   K4's (``ssd_scan_bwd_ref``, from the chunk states K4 writes when
   asked, held against ``ssd_chunk_states_ref``) at mamba2-1.3b's
   training shape, a ragged S, one short chunk, groups, hd 32 and a
   16-chunk chain (``SSD_BWD``); two calls of each give the same bits;
3. serve, for each of qwen2-1.5b, mamba2-1.3b and recurrentgemma-2b: a
   pool of the published config at widths 0.5 and 1.0 (full depth, bf16,
   random weights from a seed) behind PoolExecutor → Router → ModiPick,
   answering requests; and moonshot-v1-16b-a3b (48 layers of a 64-expert
   top-6 MoE) the same way at widths 0.25 and 1.0 (69.0 GB of weights;
   each pool is released before the next is built, and its peak memory
   logged); and qwen2-1.5b again with an int8 KV cache (``[serve
   qwen2-1.5b int8kv]``: 24 requests; one request's decode logits held
   against the same weights with a bf16 cache to the reference's 5e-2
   of max |logit|; a ``[count]`` line: the device kernels of a request
   against the bf16 cache's, and the kernels of the plain
   quantize-and-write the fused write took off the path); the launch
   counters are zeroed just before and
   read just after, and must show that every layer of every request ran
   its kernels (prefill attention per attention layer, decode attention
   per attention layer and decode step, the SSD scan per SSD layer, the
   RG-LRU scan per RG-LRU layer); the full-width variant's logits on the
   kernel path are held against the plain path, for prefill and one
   decode step, layer by layer (a MoE layer on one routing, from the
   plain path's input); one MoE layer's routing, expert products and
   ``moe_ffn`` are timed beside its attention kernel (``[moe]``);
   then whisper-tiny (``[encdec whisper-tiny]``: 4 encoder and 4
   decoder layers, 1500 frames, B 4, 64 text tokens, 80 cache slots, 4
   decode steps) and internvl2-2b (``[vlm internvl2-2b]``: 24 layers,
   B 4, 256 image embeddings before 128 text tokens, 400 slots, 2
   steps) at their published widths in bf16, each request through
   ``models/api.py``'s prefill and serve steps on inputs from its
   ``make_train_batch``, with the counters zeroed just before and read
   just after, held layer by layer (the encoder's layers, each decoder
   layer's self- and cross-attention and feed-forward), logits finite;
4. the continuous batcher (``ContinuousBatcher``) over gemma3-4b at full
   width in float32: 8 requests with prompts of 5 to 1100 tokens (the
   longest two wrap the 1024-slot local ring in prefill) on 4 slots,
   which retire and are reused mid-run; its launches counted as in
   phase 3; each request's logits, step by step, held to 1e-4 of their
   max |logit| against the request run alone, teacher-forced on its
   tokens (``[batcher ...]`` lines);
4b. training at full width (``[train <arch>]`` lines): qwen2-1.5b at
   B 4, S 1024, recurrentgemma-2b at B 2, S 1024 and mamba2-1.3b at B 2,
   S 1024, fp32 parameters and moments, remat "full", through
   ``make_train_step``: the first step's loss and every gradient on the
   kernel path held against the plain path on the card (mamba2's over
   its first 2 layers at full width: at 48 layers its random-weight
   gradient moves by as much when the embedding moves by one ulp), with
   the peak memory of that step with and without remat; 5 steps on one
   repeated batch (the loss must fall), the launch counters zeroed just
   before and read just after (K2's, K4's and K5's backward kernels
   once per attention / SSD / RG-LRU layer a step, no other kernel);
   a checkpoint restored onto fresh templates whose next step equals
   the un-restored one bit for bit; one more step under torch.profiler
   (``[trace]``); step ms, tokens/s and peak memory;
4c. the mesh tooling (``[mesh ...]`` lines): the dry-run
   (``launch/dryrun.py``) of each training cell on the ``meta`` device
   at the training phase's B and S, its parameter and optimizer-state
   bytes equal to what the training phase allocated and its kernels a
   step to what the card launched, with its H100 roofline beside the
   measured step; the sharded wrappers of K2, K3, K4 and K5
   (``distributed/shardmap_ops.py``) at the main path's shapes on a
   (1, 1) and a (2, 4) data x model mesh of the card, each held against
   the unsharded kernel; ``fleet_steady`` on a four-cell ``cell`` mesh,
   every epoch's picks, the spills and the attainment equal to the
   unsharded run's; the counters zeroed just before the sharded calls
   and the sharded fleet run and read just after;
5. the batched selection on the qwen2 executor's profile store, each
   entry point with the counters zeroed just before and read just after
   and required to launch exactly its one kernel:
   ``ModiPick.select_batch`` on the card at B = 8192 (the fused
   selection), ``select_batch_traced(detail=True)`` (K1), and a charged
   ``Router.route_batch_arrays`` burst on ``cuda`` and on ``auto`` at
   B = DEVICE_MIN_BATCH (the charged pass), whose decisions must equal
   the same route's on the CPU through the plain version, on the same
   uniforms; then each of the three kernels on the very operands its
   entry point handed it, held against its plain version there and
   timed there (K1's and B3's rows of the kernels line; the fused
   selection's time there is an ``[extra]`` line);
6. the discrete-event engine (``repro_torch.sim``) at the reference
   engine benchmark's ``batched`` size: 100,000 requests in 200-wide
   simultaneous bursts over Table 2's 11 models, 4 replicas each, on
   ``cuda`` (one charged pass a burst) and on numpy, ``batched_snapshot``
   on ``cuda`` (one fused selection a burst), and the registered
   ``faulty`` scenario turned into 200-wide bursts through
   ``scenario.build(sc).run()`` on ``cuda``; each run with the counters
   zeroed just before and read just after, and each required to launch
   its kernel exactly once per multi-request burst, to select on the
   current profiles, and (on ``cuda``) to have its first 20 launches
   equal to the plain version on the same operands; the charged
   ``batched`` run must attain 0.5 (``[engine ...]`` lines); the fused
   selection's row of the kernels line is timed on the first
   ``batched_snapshot`` burst (B 200, n 11), beside the card's launch
   floor (``[floor]``: one empty kernel, ``torch.cuda._sleep(0)``);
7. premodel and the multi-cell fleet through the stacked selection
   kernel (B4, ``stacked_select``): first the kernel against its plain
   version, exactly, on synthetic operands (classed rows with K = 1, 2
   and 8 classes and queue shifts, fleet cells of unequal widths padded
   with ``PAD_MU`` lanes, rows with no base and degenerate rows, B = 1,
   97 and the main path's shapes, each timed as an ``[extra]`` line;
   and pools of 129, 200 and 1000 models, not timed);
   then, each with the counters zeroed just before and read just after,
   the registered ``premodel_mix`` as 20 simultaneous bursts of 200 over
   a zero-jitter uplink, and ``fleet_steady`` and ``fleet_diurnal``,
   all through ``scenario.build(sc).run()`` on ``cuda``: one launch a
   burst (20) and one an epoch with pending requests (17 and 12), the
   first 20 launches of each replayed through the plain version, and
   each run equal to the same run on ``cpu`` (the plain version) on the
   card's uniforms (``[stacked ...]`` lines; ``fleet_diurnal`` must
   spill);
8. timings for the record: per-variant warm prefill / prefill+decode
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

SEQ, BATCH, N_DECODE = 128, 4, 2
N_REQUESTS = {"qwen2-1.5b": 24, "mamba2-1.3b": 12, "recurrentgemma-2b": 12,
              "moonshot-v1-16b-a3b": 12}
# Each pool's widths of the published config.  moonshot's experts keep
# their width at every width (``scaled`` leaves ``moe`` alone): widths 0.5
# and 1.0 would hold 82.8 GB of bf16 weights, 0.25 and 1.0 hold 69.0 GB.
WIDTHS = {"moonshot-v1-16b-a3b": (0.25, 1.0)}
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
    "moonshot-v1-16b-a3b": dict(n_layers=48, d_model=2048,
                                vocab_size=163_840, padded_vocab=163_840,
                                n_heads=16, n_kv_heads=16,
                                resolved_head_dim=128, d_ff=1408,
                                moe=(64, 6, 1408)),
    "gemma3-4b": dict(n_layers=34, d_model=2560, vocab_size=262_144,
                      padded_vocab=262_144, n_heads=8, n_kv_heads=4,
                      resolved_head_dim=256, d_ff=10_240, window=1024),
    "whisper-tiny": dict(n_layers=4, d_model=384, vocab_size=51_865,
                         padded_vocab=51_968, n_heads=6, n_kv_heads=6,
                         resolved_head_dim=64, d_ff=1536, encdec=(4, 1500)),
    "internvl2-2b": dict(n_layers=24, d_model=2048, vocab_size=92_553,
                         padded_vocab=92_672, n_heads=16, n_kv_heads=8,
                         resolved_head_dim=128, d_ff=8192, vlm=256),
}
# The int8-KV serve phase: ModiPick over qwen2-1.5b with
# kv_cache_dtype="int8" at widths 0.5 and 1.0, as the other serve phases;
# one request's decode logits are held against the same weights with a
# bf16 cache to the reference's bound (tests/test_models.py
# test_int8_kv_cache_decode_close_to_bf16), of max |logit|.
INT8_ARCH, INT8_REQUESTS, INT8_RTOL = "qwen2-1.5b", 24, 5e-2
# The encoder-decoder and VLM phases: each model at its published width
# and depth in bf16, random weights, inputs from api.make_train_batch;
# B, text tokens, cache slots, decode steps.
MODEL_PHASES = {"whisper-tiny": dict(B=4, S=64, cache_len=80, steps=4),
                "internvl2-2b": dict(B=4, S=128, cache_len=400, steps=2)}
# The continuous batcher's run: gemma3-4b at full width in float32 (so
# that greedy tokens are stable), 4 slots of 1152 positions; prompts of
# these lengths (the last two wrap the 1024-slot local ring in prefill)
# and token budgets, so that slots retire and are reused mid-run.  Each
# request's logits, step by step, are held to BATCHER_RTOL of their max
# |logit| against the request run alone, teacher-forced on its tokens.
BATCHER = dict(arch="gemma3-4b", slots=4, cache_len=1152,
               prompts=(5, 17, 64, 128, 300, 777, 1030, 1100),
               max_new=(12, 3, 9, 5, 11, 4, 8, 6))
BATCHER_RTOL = 1e-4
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
# The backward kernels relative to max(max |want|, 1) (``check_scaled``):
# summation order in float32; one rounding of the output in bfloat16
# (kernel and plain version both accumulate in fp32).
BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
           torch.bfloat16: dict(atol=1e-2, rtol=0.0)}
# K2's backward against its plain version: (B, H, KV, Sq, Sk, hd, causal,
# window) in both types; the first is the training phase's qwen2 shape,
# the kernels line's row in float32.
FLASH_BWD = ((4, 12, 2, 1024, 1024, 128, True, 0),   # qwen2 training
             (2, 10, 1, 1024, 1024, 256, True, 2048),  # recurrentgemma
             (1, 6, 6, 1500, 1500, 64, False, 0),    # whisper's encoder
             (1, 4, 2, 1024, 1024, 128, True, 256),  # a window inside S
             (1, 4, 2, 1000, 1000, 128, True, 0),    # ragged S
             (2, 8, 8, 256, 256, 128, True, 0),      # G = 1
             (1, 16, 1, 1024, 1024, 128, True, 0),   # a small grid, G 16
             (1, 10, 1, 4096, 4096, 256, True, 2048))  # the window bites
# K5's backward: (B, S, W, dtype); the first is recurrentgemma's
# training shape (the kernels line's row); S past 192 chains chunks of
# up to 192 steps held in registers, 3000 ends on a short chunk.
RGLRU_BWD = ((2, 1024, 2560, torch.float32), (2, 1000, 2560, torch.float32),
             (2, 512, 2560, torch.float32), (2, 1000, 2560, torch.bfloat16),
             (2, 4096, 2560, torch.float32), (2, 3000, 2560, torch.bfloat16))
# The training phase: full width, fp32 parameters and moments, remat
# "full", on one repeated batch of B sequences of S tokens.  The first
# step's loss and every gradient on the kernel path are held against
# the same step on the plain path (ops.PLAIN) on the card, to
# TRAIN_LOSS_RTOL and to TRAIN_GRAD_TOL of each leaf's max |gradient|;
# both run fp32 throughout, so only summation orders differ (PERF.md
# states them with their reason).
# mamba2-1.3b's loss and gradients are held over a copy of its config cut
# to ``check_layers`` layers at full width (its steps run at full depth):
# the random-weight 48-layer stack's gradient moves by as much as the two
# paths differ when its embedding moves by one ulp (15% of max |g| at full
# depth, 0.2% at 4 layers: ``tools/train_grad_depth.py``, PERF.md).
TRAIN = {"qwen2-1.5b": dict(B=4, S=1024),
         "recurrentgemma-2b": dict(B=2, S=1024),
         "mamba2-1.3b": dict(B=2, S=1024, check_layers=2)}
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_STEPS = 1e-4, 2e-3, 5
# The SSD scan relative to max |y| (the chunked kernel and the sequential
# plain version sum in different orders; tests/test_kernels.py's bounds).
SSD_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# K4's backward against its plain version, each gradient relative to
# max(max |want|, 1): float32 to SSD_TOL, bfloat16 to BWD_TOL.  (B, H, G,
# S, hd, N, chunk, dtype); the first is mamba2-1.3b's training shape
# (the kernels line's row), then a ragged S, one short chunk, groups in
# bf16, four groups at hd 32, and a chain of 16 chunks.
SSD_BWD = ((2, 64, 1, 1024, 64, 128, 256, torch.float32),
           (2, 64, 1, 1000, 64, 128, 256, torch.float32),
           (2, 64, 1, 128, 64, 128, 256, torch.float32),
           (1, 8, 2, 600, 64, 128, 256, torch.bfloat16),
           (2, 16, 4, 512, 32, 64, 128, torch.float32),
           (1, 64, 1, 4096, 64, 128, 256, torch.float32))


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
    """(ms, "bytes" or "operations") of work at ``dtype``'s peak
    (``kernels/cost.py`` with the H100's constants of
    ``distributed/hlo.py``: bf16 on the tensor cores, fp32 outside
    them)."""
    from repro_torch.kernels import cost
    return cost.bound(cost.Cost(
        ops, nbytes, "bf16" if dtype == torch.bfloat16 else "fp32"))


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


# The bf16 kernels ptxas must report on without a spill: library →
# ((kernel, instantiations), ...): K2 at five head sizes, K3 at five over
# a bf16 cache and K3-int8 at five over an int8 cache, K4 at four.
BF16_KERNELS = {"flash_attention": (("flash_bf16_kernel", 5),),
                "decode_attention": (("decode_kernel", 5),
                                     ("decode_int8_kernel", 5)),
                "ssd_scan": (("ssd_bf16_kernel", 4),)}


def bf16_ptxas(logs) -> None:
    """Log each bf16 K2/K3/K3-int8/K4 instantiation's registers, static
    shared memory and spills as ptxas reports them; fail on any spill or
    a missing report."""
    for lib, kernels in BF16_KERNELS.items():
        for kern, want in kernels:
            entry, seen = None, 0
            for line in logs.get(lib, "").splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = m.group(1)
                    ok = re.search(rf"\d{kern}I", name) and (
                        kern == "ssd_bf16_kernel" or "bfloat16" in name)
                    entry = name if ok else None
                    spill = None
                    continue
                if entry is None:
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
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


# Spill stores (bytes) that ptxas gives the backward kernels'
# instantiations that spill at all, as built: the fp32 dK/dV body runs
# at the 255-register cap from hd 128.  Any other spill, or a larger
# one, fails `bwd_ptxas`.
BWD_SPILLS = {("bwd_dq_kernel", "13__nv_bfloat16Li256"): 4,
              ("bwd_dkdv_kernel", "fLi128"): 12,
              ("bwd_dkdv_kernel", "fLi256"): 12,
              ("rglru_bwd_kernel", "13__nv_bfloat16"): 8}


# K4's fp32 training path: (kernel, instantiations).  The forward's
# passes run fp32 only (four head sizes where templated), the
# backward's both types (four head sizes where templated).
SSD_TRAIN_KERNELS = (("ssd_fwd_scores_kernel", 1), ("ssd_fwd_state_kernel", 4),
                     ("ssd_fwd_chain_kernel", 1), ("ssd_fwd_out_kernel", 4),
                     ("ssd_bwd_scores_kernel", 2), ("ssd_bwd_local_kernel", 8),
                     ("ssd_bwd_ds_kernel", 8), ("ssd_bwd_chain_kernel", 1),
                     ("ssd_bwd_dx_kernel", 8), ("ssd_bwd_dbdc_kernel", 8),
                     ("ssd_bwd_dt_kernel", 1), ("ssd_bwd_da_kernel", 1))


def bwd_ptxas(logs) -> None:
    """The registers and spills ptxas reports for the backward kernels'
    instantiations (K2-bwd's dQ and dK/dV kernels at both types and five
    head sizes, K5-bwd's at both types) and for every instantiation of
    K4's fp32 training path, forward and backward
    (``SSD_TRAIN_KERNELS``): every one must be reported and spill no more
    than ``BWD_SPILLS`` allows."""
    for lib, kern, want in (("flash_attention", "bwd_dq_kernel", 10),
                            ("flash_attention", "bwd_dkdv_kernel", 10),
                            ("rglru_scan", "rglru_bwd_kernel", 2)) + tuple(
            ("ssd_scan_bwd" if k.startswith("ssd_bwd") else "ssd_scan", k, n)
            for k, n in SSD_TRAIN_KERNELS):
        entry = spill = None
        seen = 0
        for line in logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1) if kern in m.group(1) else None
                spill = None
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if entry and m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if entry and m:
                args = re.search(rf"{kern}I(\w+?)E", entry)
                tmpl = args.group(1) if args else "?"
                log(f"[ptxas bwd] {kern} <{tmpl}>: registers={m.group(1)} "
                    f"spill_stores={spill}")
                if spill is None or spill > BWD_SPILLS.get((kern, tmpl), 0):
                    raise AssertionError(f"{kern} <{tmpl}> spills {spill} "
                                         "bytes")
                seen += 1
                entry = None
        if seen != want:
            raise AssertionError(f"ptxas reported on {seen} {kern} "
                                 f"instantiations, not {want}")


def phase_kernels(ops, ref, policy_select, gen):
    """Each kernel against its plain version at the server's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
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
            b = cost.bound(cost.flash_attention(q, k))
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
            b = cost.bound(cost.decode_attention(q, live))
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
    serving_shapes(ops, ref, randn)
    encdec_shapes(ops, ref, randn)
    rows["decode_attention_int8"] = int8_decode(ops, ref, randn, gen)

    # K4: the SSD scan at mamba2-1.3b's full width (H 64, hd 64, N 128,
    # G 1, chunk 256), inputs as the model hands them (``ssd_args``).  At
    # S = 128 and 600 (chunks 256 + 256 + 88) in both types, y and final
    # state.
    H, hd, N, G, chunk = 64, 64, 128, 1, 256
    log_ssd_occupancy(hd, N, chunk)
    for S, dtype in ((SEQ, torch.bfloat16), (600, torch.bfloat16),
                     (SEQ, torch.float32), (600, torch.float32)):
        args = ssd_args(randn, BATCH, S, H, hd, N, G, dtype)
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
        if dtype == torch.float32:
            b = ssd_bound(BATCH, H, G, S, hd, N, chunk, dtype)
            bc = ssd_bound(BATCH, H, G, S, hd, N, chunk, dtype,
                           cuda_cores=True)
            log(f"[extra] ssd_scan fp32 forward B={BATCH} H={H} S={S} "
                f"hd={hd} N={N} chunk={chunk}: ms="
                f"{time_ms(lambda: ops.ssd_scan(*args, chunk=chunk)):.5g} "
                f"bound_ms={b[0]:.4g} ({b[1]}, 3xTF32); fp32 CUDA-core "
                f"bound {bc[0]:.4g} ms")
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
        args = ssd_args(randn, BATCH, S, H, hd, N, G, torch.bfloat16)
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
        b = cost.bound(cost.rglru_scan(a))
        rows["rglru_scan"] = dict(
            name="rglru_scan", route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:21",
            max_abs_err=err, ms=time_ms(lambda: ops.rglru_scan(a, bb),
                                        label="K5 kernel"),
            plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, bb), iters=10),
            bound_ms=b[0], bound_by=b[1], library_ms=None)

    rows.update(backward_kernels(ops, ref, randn))
    selection_kernels(ops, ref, policy_select, gen)
    log_timing()
    return rows


def ssd_args(randn, B, S, H, hd, N, G, dtype):
    """K4's inputs as the model hands them: transposed views of its (B,
    S, H, hd), (B, S, H) and (B, S, G, N) activations (B_ and C_ side by
    side in one row, as in its projection)."""
    import torch.nn.functional as F
    x = (randn(B, S, H, hd, dtype=torch.float32) * 0.5).to(dtype)
    dt = F.softplus(randn(B, S, H, dtype=torch.float32) - 2.0)
    A = -torch.exp(randn(H, dtype=torch.float32) * 0.3)
    bc = (randn(B, S, 2 * G * N, dtype=torch.float32) * 0.3).to(dtype)
    Bm = bc[..., :G * N].view(B, S, G, N)
    Cm = bc[..., G * N:].view(B, S, G, N)
    return (x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2),
            Cm.transpose(1, 2))


def flash_bwd_bound(q, k, causal, window) -> tuple:
    """K2's backward: q, k, v, o, dO and the lse read once, dq, dk, dv
    written once; the FA2 backward's five products (S, dP, dV, dK, dQ:
    2·hd operations each) over the visible (query, key) pairs.  The
    bf16 body does them on the tensor cores at the bf16 rate; the fp32
    body as 3xTF32, three TF32 products each, at the TF32 rate (so the
    bound is the least time for what the body issues, and no run of it
    can read faster than its bound)."""
    from repro_torch.kernels import cost
    return cost.bound(cost.flash_attention_bwd(q, k, causal, window))


def sdpa_bwd_ms(q, k, v, dout, causal, window, label) -> float:
    """SDPA's backward on contiguous copies of q, k, v with K2's mask
    (``is_causal``, or a boolean mask where the window bites): the
    yardstick of K2-bwd."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    Sq, Sk = q.shape[2], k.shape[2]
    mask = (ref.attention_mask(Sq, Sk, causal, window, q.device)
            if window and window < Sk else None)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
    doc = dout.contiguous()
    return time_ms(lambda: torch.autograd.grad(
        out, (qc, kc, vc), doc, retain_graph=True), iters=10, label=label)


def log_bwd_plans() -> None:
    """K2-bwd's launch plan as the kernels report it against its Python
    mirror, for both types and every head size; K5-bwd's chunk plan;
    K4's fp32 training path (``log_ssd_plans``)."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.rglru_scan import bwd_plan
    fn = build.function("flash_attention", "flash_attention_bwd_plan",
                        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            out = (ctypes.c_int * 5)()
            if fn(fa.DTYPES[dtype], hd, ctypes.cast(out, ctypes.c_void_p)):
                raise AssertionError(f"no K2-bwd plan for {dtype} hd {hd}")
            p = fa.bwd_plan(1, 1, 1, 1, 1, hd, dtype)
            want = [p.rows, p.walk, p.cols, p.smem, p.threads]
            if list(out) != want:
                raise AssertionError(f"K2-bwd plan {dtype} hd {hd}: kernel "
                                     f"{list(out)}, mirror {want}")
            log(f"[plan] K2-bwd {dtype} hd={hd}: rows={p.rows} "
                f"walk={p.walk} cols={p.cols} smem={p.smem} "
                f"threads={p.threads} (kernel and mirror agree)")
    for (B, S, W, _) in RGLRU_BWD[:1] + RGLRU_BWD[4:5]:
        seg, n_seg, n_chunk = bwd_plan(S)
        blocks = B * -(-W // 32) * n_chunk
        log(f"[plan] K5-bwd B={B} S={S} W={W}: {n_chunk} chunks of "
            f"{n_seg} segments of {seg} steps, {blocks} blocks of "
            f"{32 * n_seg} threads")
    log_ssd_plans()


def log_ssd_plans() -> None:
    """K4's fp32 training path: the shared memory its blocks take, as the
    kernels report it (``ssd_scan_train_smem``), against the wrapper's
    mirror at every head size, and the forward's and backward's plans at
    the ``SSD_BWD`` shapes."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd
    fn = build.function("ssd_scan", "ssd_scan_train_smem",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    shapes = {(hd, N, min(chunk, S))
              for (_, _, _, S, hd, N, chunk, _) in SSD_BWD}
    shapes |= {(hd, N, cs) for hd in ssd.HEAD_DIMS
               for N, cs in ((128, 256), (24, 100), (136, 128))}
    for hd, N, cs in sorted(shapes):
        out = (ctypes.c_longlong * 8)()
        want = list(ssd.train_smem(hd, N, cs))
        if fn(hd, N, cs, ctypes.cast(out, ctypes.c_void_p)) or list(
                out) != want:
            raise AssertionError(f"K4 fp32 path shared memory at hd {hd} N "
                                 f"{N} chunk {cs}: kernel {list(out)}, "
                                 f"mirror {want}")
    log(f"[plan] K4 fp32 path: shared memory of {len(shapes)} (hd, N, "
        "chunk) shapes, kernel and mirror agree")
    for (B, H, G, S, hd, N, chunk, _) in SSD_BWD:
        f = ssd.fwd_plan(B, H, G, S, hd, N, chunk)
        p = ssd.bwd_plan(B, H, G, S, hd, N, chunk)
        log(f"[plan] K4 fp32 forward B={B} H={H} G={G} S={S} hd={hd} N={N} "
            f"chunk={f.cs}: {f.n_chunks} chunks of {f.tiles} tiles; "
            + ", ".join(f"{n} {g} x {t} threads {m} bytes" for n, g, t, m in
                        zip(ssd.FWD_PASSES, f.grids, f.threads, f.smem))
            + f"; scratch {f.scratch} bytes")
        log(f"[plan] K4-bwd B={B} H={H} G={G} S={S} hd={hd} N={N} "
            f"chunk={p.cs}: heads in {p.nsplit} splits; "
            + ", ".join(f"{n} {g} x {t} threads {m} bytes" for n, g, t, m in
                        zip(ssd.BWD_PASSES, p.grids, p.threads, p.smem))
            + f"; scratch {p.scratch} bytes")


def backward_kernels(ops, ref, randn) -> dict:
    """K2's, K4's and K5's backward kernels against their plain versions
    at the training phase's shapes and edges, two calls each equal bit
    for bit (no atomics); their kernels-line rows (fp32, the training
    shapes), K2's with SDPA's backward at the same shape as its
    yardstick, and ``[extra]`` lines for K2-bwd at recurrentgemma's
    training shape, in bf16 at qwen2's and where recurrentgemma's window
    bites (S 4096), for K5-bwd at S 4096, and for K4-bwd
    (``ssd_backward``)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attention as fa
    log_bwd_plans()
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, H, KV, Sq, Sk, hd, causal, window) in enumerate(FLASH_BWD):
            q = randn(B, Sq, H, hd, dtype=dtype).transpose(1, 2)
            k = randn(B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
            v = randn(B, Sk, KV, hd, dtype=dtype).transpose(1, 2)
            dout = randn(B, H, Sq, hd, dtype=dtype)  # not o's layout
            with torch.no_grad():
                o, lse = fa._forward(q, k, v, causal, window, with_lse=True)
            args = (q, k, v, o, lse, dout)
            kw = dict(causal=causal, window=window)
            err_lse = check(f"K2 lse {dtype}", lse,
                            ref.flash_attention_lse_ref(q, k, v, **kw),
                            TOL[torch.float32])
            got = ops.flash_attention_bwd(*args, **kw)
            again = ops.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_bwd_ref(*args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("flash_attention_bwd: two calls differ")
            err = max(check_scaled(f"flash_attention_bwd d{n} {dtype}", g, w,
                                   BWD_TOL[dtype])
                      for n, g, w in zip("qkv", got, want))
            del got, again, want
            log(f"K2-bwd flash_attention_bwd B={B} H={H} KV={KV} Sq={Sq} "
                f"Sk={Sk} hd={hd} causal={causal} window={window} {dtype}: "
                f"max err of max|d| {err:.3g} (tol {BWD_TOL[dtype]}), lse "
                f"max_abs_err {err_lse:.3g}; two calls equal")
            # timed: both training shapes in fp32, qwen2's in bf16, and
            # recurrentgemma's window where it bites
            timed = (i in (0, 1) and dtype == torch.float32) or (
                i == 0 and dtype == torch.bfloat16) or (
                i == len(FLASH_BWD) - 1 and dtype == torch.float32)
            if not timed:
                continue
            arch = ("qwen2", "recurrentgemma")[min(i, 1)]
            tag = f"{arch} train {dtype}" if i < 2 else "S 4096 window"
            b = flash_bwd_bound(q, k, causal, window)
            row = dict(
                name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/models/attention.py:84 (XLA autodiff of "
                         "attention_full; the Pallas _flash_kernel, "
                         "src/repro/kernels/flash_attention.py:28, has no "
                         "backward)",
                max_abs_err=err,
                ms=time_ms(lambda: ops.flash_attention_bwd(*args, **kw),
                           iters=10, label=f"K2-bwd {tag} kernel"),
                plain_ms=time_ms(
                    lambda: ref.flash_attention_bwd_ref(*args, **kw),
                    iters=5),
                bound_ms=b[0], bound_by=b[1],
                library_ms=sdpa_bwd_ms(q, k, v, dout, causal, window,
                                       f"K2-bwd {tag} SDPA backward"))
            log(f"[ratio] K2-bwd {tag}: kernel / SDPA backward "
                f"{row['ms'] / row['library_ms']:.3f}, kernel / plain "
                f"{row['ms'] / row['plain_ms']:.3f}, bound / kernel "
                f"{row['bound_ms'] / row['ms']:.3f}")
            if i == 0 and dtype == torch.float32:
                rows["flash_attention_bwd"] = row
            else:
                extra(f"flash_attention_bwd B={B} H={H} KV={KV} S={Sq} "
                      f"hd={hd} window={window} {dtype}", row["ms"],
                      row["plain_ms"], b, row["library_ms"])
            if i > 1 or dtype != torch.float32:
                continue
            with torch.no_grad():
                lse_ms = time_ms(lambda: fa._forward(q, k, v, causal, window,
                                                     with_lse=True), iters=10)
                serve_ms = time_ms(lambda: fa._forward(
                    q, k, v, causal, window, with_lse=False), iters=10)
            log(f"[extra] flash_attention forward at {arch}'s training "
                f"shape fp32: with its lse {lse_ms:.5g} ms, without "
                f"{serve_ms:.5g} ms")
    for i, (B, S, W, dtype) in enumerate(RGLRU_BWD):
        a = (torch.sigmoid(randn(B, S, W, dtype=torch.float32))
             * 0.98).to(dtype)
        b = (randn(B, S, W, dtype=torch.float32) * 0.1).to(dtype)
        dh = randn(B, S, W, dtype=dtype)
        with torch.no_grad():
            h = ops.rglru_scan(a, b)
        got = ops.rglru_scan_bwd(a, h, dh)
        again = ops.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        want = ref.rglru_scan_bwd_ref(a, h, dh)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("rglru_scan_bwd: two calls differ")
        err = max(check_scaled(f"rglru_scan_bwd {n} {dtype}", g, w,
                               BWD_TOL[dtype])
                  for n, g, w in zip(("da", "db"), got, want))
        log(f"K5-bwd rglru_scan_bwd B={B} S={S} W={W} {dtype}: max err of "
            f"max|d| {err:.3g} (tol {BWD_TOL[dtype]}); two calls equal")
        if i not in (0, 4):
            continue
        bb = cost.bound(cost.rglru_scan_bwd(a))
        row = dict(
            name="rglru_scan_bwd", route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu",
            replaces="src/repro/models/rglru.py:56 (XLA autodiff of "
                     "rglru_scan_xla; the Pallas _rglru_kernel, "
                     "src/repro/kernels/rglru_scan.py:21, has no backward)",
            max_abs_err=err,
            ms=time_ms(lambda: ops.rglru_scan_bwd(a, h, dh),
                       label=f"K5-bwd S {S} kernel"),
            plain_ms=time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, dh),
                             iters=3),
            bound_ms=bb[0], bound_by=bb[1], library_ms=None)
        log(f"[ratio] K5-bwd S={S}: kernel / bound "
            f"{row['ms'] / row['bound_ms']:.3f}")
        if i == 0:
            if row["ms"] > 2 * row["bound_ms"]:
                raise AssertionError("K5-bwd takes more than twice its bound")
            rows["rglru_scan_bwd"] = row
        else:
            extra(f"rglru_scan_bwd B={B} S={S} W={W} {dtype}", row["ms"],
                  row["plain_ms"], bb)
    rows.update(ssd_backward(ops, ref, randn))
    return rows


def ssd_bwd_bound(B, H, G, S, hd, N, chunk, dtype, dstate=False,
                  cuda_cores=False) -> tuple:
    """K4's backward (``kernels/cost.py``): x, dy, dt, A, B_, C_, the
    forward's chunk states (and dstate) read once, dx, ddt, dA, dB_ and
    dC_ written once, the chunked products; in fp32 as 3xTF32, with
    ``cuda_cores`` as fp32 FMAs at the CUDA cores' rate (the first
    version's bound)."""
    from repro_torch.kernels import cost
    c = cost.ssd_scan_bwd(B, H, G, S, hd, N, chunk, dtype, dstate)
    return cost.bound(c, "fp32" if cuda_cores and dtype == torch.float32
                      else None)


def ssd_backward(ops, ref, randn) -> dict:
    """K4-bwd against ``ref.ssd_scan_bwd_ref`` at every ``SSD_BWD`` shape
    (each with a nonzero final-state gradient, the training shape also
    without one, as training calls it), the forward's chunk states
    against ``ref.ssd_chunk_states_ref``, two calls equal bit for bit;
    its kernels-line row at the training shape in fp32; ``[extra]``
    lines for K4 forward at the training shape with and without the
    chunk-state write, K4-bwd in bf16 at the training shape and at S
    4096."""
    from repro_torch.kernels import ssd_scan as ssd
    rows = {}

    cases = [(shape, True) for shape in SSD_BWD]
    cases.insert(0, (SSD_BWD[0], False))
    cases.append(((2, 64, 1, 1024, 64, 128, 256, torch.bfloat16), False))
    for (B, H, G, S, hd, N, chunk, dtype), with_dstate in cases:
        args = ssd_args(randn, B, S, H, hd, N, G, dtype)
        dy = randn(B, S, H, hd, dtype=dtype).transpose(1, 2)
        dstate = (randn(B, H, hd, N, dtype=torch.float32) if with_dstate
                  else None)
        with torch.no_grad():
            _, _, states = ssd._forward(*args, chunk, with_states=True)
        err_st = check_scaled(f"ssd_scan chunk states {dtype}", states,
                              ref.ssd_chunk_states_ref(*args, chunk=chunk),
                              SSD_TOL[dtype])
        kw = dict(chunk=chunk, states=states)
        got = ops.ssd_scan_bwd(*args, dy, dstate, **kw)
        again = ops.ssd_scan_bwd(*args, dy, dstate, **kw)
        torch.cuda.synchronize()
        want = ref.ssd_scan_bwd_ref(*args, dy, dstate, chunk=chunk)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("ssd_scan_bwd: two calls differ")
        tol = SSD_TOL[torch.float32] if dtype == torch.float32 else \
            BWD_TOL[dtype]
        err = max(check_scaled(f"ssd_scan_bwd {n} {dtype}", g, w, tol)
                  for n, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                     want))
        del got, again, want
        tag = (f"B={B} H={H} G={G} S={S} hd={hd} N={N} chunk={chunk} "
               f"{dtype}")
        log(f"K4-bwd ssd_scan_bwd {tag} dstate={with_dstate}: max err of "
            f"max|d| {err:.3g} (tol {tol}), chunk states {err_st:.3g}; two "
            "calls equal")
        training = (B, H, G, S, hd, N, chunk) == SSD_BWD[0][:7]
        if not ((training and not with_dstate) or S == 4096):
            continue
        b = ssd_bwd_bound(B, H, G, S, hd, N, chunk, dtype, with_dstate)
        ms = time_ms(lambda: ops.ssd_scan_bwd(*args, dy, dstate, **kw),
                     iters=10, label=f"K4-bwd {tag} kernel")
        plain_ms = time_ms(lambda: ref.ssd_scan_bwd_ref(
            *args, dy, dstate, chunk=chunk), iters=2, warmup=1)
        log(f"[ratio] K4-bwd {tag}: kernel / plain {ms / plain_ms:.4f}, "
            f"bound / kernel {b[0] / ms:.3f} ({b[1]})")
        if dtype == torch.float32:
            bc = ssd_bwd_bound(B, H, G, S, hd, N, chunk, dtype, with_dstate,
                               cuda_cores=True)
            log(f"[bound] K4-bwd {tag}: 3xTF32 bound {b[0]:.4g} ms "
                f"({b[1]}); fp32 CUDA-core bound {bc[0]:.4g} ms ({bc[1]})")
        log_passes(f"K4-bwd {tag} dstate={with_dstate}",
                   lambda: ops.ssd_scan_bwd(*args, dy, dstate, **kw))
        if training and dtype == torch.float32:
            rows["ssd_scan_bwd"] = dict(
                name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/models/ssm.py:64 (XLA autodiff of "
                         "ssd_chunked; the Pallas _ssd_kernel, "
                         "src/repro/kernels/ssd_scan.py:21, has no "
                         "backward)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=None)
            with torch.no_grad():
                fwd = [time_ms(lambda: ssd._forward(
                    *args, chunk, with_states=w), iters=10)
                    for w in (True, False)]
            fb = ssd_bound(B, H, G, S, hd, N, chunk, dtype)
            fc = ssd_bound(B, H, G, S, hd, N, chunk, dtype, cuda_cores=True)
            log(f"[extra] ssd_scan forward at mamba2's training shape "
                f"{tag}: with its chunk states {fwd[0]:.5g} ms, without "
                f"{fwd[1]:.5g} ms (bound without {fb[0]:.4g} ms, {fb[1]}, "
                f"3xTF32; fp32 CUDA-core bound {fc[0]:.4g} ms)")
            with torch.no_grad():
                log_passes(f"K4 fp32 forward {tag} with its chunk states",
                           lambda: ssd._forward(*args, chunk,
                                                with_states=True))
        else:
            extra(f"ssd_scan_bwd {tag} dstate={with_dstate}", ms, plain_ms,
                  b)
        del args, dy, states
    return rows


def log_passes(label, fn, iters=10) -> None:
    """An ``[extra]`` line: the device µs a call of each K4 pass that
    ``fn`` launches (torch.profiler), so the chains read apart from the
    passes around them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        m = re.search(r"\bssd_(fwd|bwd)_(\w+?)_kernel\b", e.name)
        if e.device_type == DeviceType.CUDA and m:
            us[m.group(2)] = us.get(m.group(2), 0.0) + \
                e.time_range.elapsed_us() / iters
    log(f"[extra] {label} passes, device us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in us.items())
        + f"; all {sum(us.values()):.2f}")


def log_timing() -> None:
    """Print the ``[timing]`` lines recorded since the last call."""
    for label, (paced, host_us, dev_us, n) in HOST_PACED.items():
        log(f"[timing] {label}: host-paced {paced:.5g} ms per call (as "
            f"timed before the queue was filled ahead), host "
            f"{host_us:.1f} us per call, device kernels {dev_us:.2f} us "
            f"per call ({n:g} kernels, profiler)")
    HOST_PACED.clear()


def ssd_bound(B, H, G, S, hd, N, chunk, dtype, cuda_cores=False) -> tuple:
    """K4's bound (``kernels/cost.py``): x, B_, C_, dt, A read once, y
    and the final state written once, the chunked products; in fp32 as
    3xTF32, with ``cuda_cores`` as fp32 FMAs at the CUDA cores' rate
    (the first version's bound)."""
    from repro_torch.kernels import cost
    c = cost.ssd_scan(B, H, G, S, hd, N, chunk, dtype)
    return cost.bound(c, "fp32" if cuda_cores and dtype == torch.float32
                      else None)


def log_ssd_occupancy(hd, N, chunk) -> None:
    """K4's shared memory a block and blocks an SM, as the card reports
    them, at the serve shape's chunk length (S = 128) and a full chunk;
    fails unless two bf16 blocks of one head share an SM at S = 128 and
    the wrapper's smem_bytes mirrors the kernel; for the fp32 forward each
    of its passes, against ``fwd_plan``."""
    from repro_torch.kernels import ssd_scan as ssd
    for cs in (SEQ, chunk):
        smem, blocks = ssd.occupancy(torch.bfloat16, hd, N, cs)
        log(f"[occupancy] K4 {torch.bfloat16} hd={hd} N={N} chunk length "
            f"{cs}: {smem} bytes of shared memory a block, {blocks} blocks "
            "an SM")
        if smem != ssd.smem_bytes(hd, N, cs, torch.bfloat16):
            raise AssertionError("smem_bytes does not mirror the K4 "
                                 f"kernel: {smem} bytes")
        if cs == SEQ and blocks < 2:
            raise AssertionError(f"K4 runs {blocks} block an SM at the "
                                 "serve shape")
        plan = ssd.fwd_plan(1, 1, 1, cs, hd, N, cs)
        for i, name in enumerate(ssd.FWD_PASSES):
            smem, blocks = ssd.occupancy(torch.float32, hd, N, cs, i)
            log(f"[occupancy] K4 {torch.float32} pass {name} hd={hd} N={N} "
                f"chunk length {cs}: {smem} bytes of shared memory a block "
                f"of {plan.threads[i]} threads, {blocks} blocks an SM")
            if smem != plan.smem[i]:
                raise AssertionError(f"fwd_plan does not mirror K4's fp32 "
                                     f"{name} pass: {smem} bytes")


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


def serving_shapes(ops, ref, randn) -> None:
    """K2 and K3 at the shapes moonshot-v1-16b-a3b's serve phase and
    gemma3-4b's batcher give them, held against their plain versions and
    timed as ``[extra]`` lines beside SDPA: moonshot's 16 query heads
    over 16 KV heads (G = 1) at hd 128 in bf16; gemma3's 8 over 4
    (G = 2) at hd 256 in float32 — K2 over an 1100-token prompt with the
    1024-position window (local) and without (global), K3 over 4 slots
    with their own positions in the 1024-slot local ring (pos_eff =
    min(pos, C − 1): two slots have wrapped) and in the 1152-slot global
    cache."""
    import torch.nn.functional as F
    name = {torch.bfloat16: "bf16", torch.float32: "f32"}
    for label, B, H, KV, S, hd, window, dtype in (
            ("moonshot", BATCH, 16, 16, SEQ, 128, 0, torch.bfloat16),
            ("gemma3 local", 1, 8, 4, 1100, 256, 1024, torch.float32),
            ("gemma3 global", 1, 8, 4, 1100, 256, 0, torch.float32)):
        q = randn(B, S, H, hd, dtype=dtype).transpose(1, 2)
        k = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
        v = randn(B, S, KV, hd, dtype=dtype).transpose(1, 2)
        shape = (f"{label} B={B} H={H} KV={KV} S={S} hd={hd} "
                 f"window={window} {name[dtype]}")
        err = check(f"flash_attention {shape}",
                    ops.flash_attention(q, k, v, window=window),
                    ref.flash_attention_ref(q, k, v, window=window),
                    TOL[dtype])
        log(f"K2 flash_attention {shape}: max_abs_err={err:.3g} "
            f"tol={TOL[dtype]}")
        i = torch.arange(S, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window:
            mask &= i[None, :] > i[:, None] - window
        pairs = int(mask.sum())
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        sdpa = (lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, enable_gqa=True)) if window else (
            lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True))
        extra(f"flash_attention {shape}",
              time_ms(lambda: ops.flash_attention(q, k, v, window=window),
                      label=f"K2 {label} kernel"),
              time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                      window=window),
                      iters=10),
              bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                    4 * hd * pairs * B * H, dtype),
              time_ms(sdpa))

    for label, KV, G, C, hd, pos, dtype in (
            ("moonshot", 16, 1, SEQ + 16, 128,
             [SEQ, SEQ + 5, SEQ + 11, SEQ + 15], torch.bfloat16),
            ("gemma3 local ring", 4, 2, 1024, 256, [5, 300, 1023, 1023],
             torch.float32),
            ("gemma3 global", 4, 2, 1152, 256, [5, 300, 1030, 1100],
             torch.float32)):
        B, H = BATCH, KV * G
        q = randn(B, 1, H + 2 * KV, hd, dtype=dtype)[:, :, :H]
        q = q.reshape(B, KV, G, hd)
        ck = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
        cv = randn(B, C, KV, hd, dtype=dtype).permute(0, 2, 1, 3)
        pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
        shape = (f"{label} B={B} KV={KV} G={G} C={C} hd={hd} "
                 f"pos={pos.tolist()} {name[dtype]}")
        err = check(f"decode_attention {shape}",
                    ops.decode_attention(q, ck, cv, pos),
                    ref.decode_attention_ref(q, ck, cv, pos), TOL[dtype])
        log(f"K3 decode_attention {shape}: max_abs_err={err:.3g} "
            f"tol={TOL[dtype]}")
        live = int((pos.to(torch.int64) + 1).sum()) * KV
        qs = q.reshape(B, H, 1, hd).contiguous()
        kc, vc = ck.contiguous(), cv.contiguous()
        mask = (torch.arange(C, device="cuda")[None, :]
                <= pos[:, None])[:, None, None, :]
        extra(f"decode_attention {shape}",
              time_ms(lambda: ops.decode_attention(q, ck, cv, pos),
                      label=f"K3 {label} kernel"),
              time_ms(lambda: ref.decode_attention_ref(q, ck, cv, pos)),
              bound(q.element_size() * (2 * q.numel() + 2 * live * hd)
                    + 4 * B, 4 * G * hd * live, dtype),
              time_ms(lambda: F.scaled_dot_product_attention(
                  qs, kc, vc, attn_mask=mask, enable_gqa=True)))


def encdec_shapes(ops, ref, randn) -> None:
    """K2 without the causal mask at whisper-tiny's encoder shape (B 4,
    H = KV = 6, 1500 frames, hd 64) and its cross-attention prefill (64
    text tokens over the 1500 frames), and K3 over the 1500-frame cross
    cache at pos 1499 (no multiple of its 16-slot tile; B·KV = 24), each
    held against its plain version and timed as an ``[extra]`` line
    beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import split_plan
    dtype, B, H, hd, Fr = torch.bfloat16, BATCH, 6, 64, 1500
    for label, Sq in (("encoder", Fr), ("cross prefill", 64)):
        q = randn(B, Sq, H, hd, dtype=dtype).transpose(1, 2)
        k = randn(B, Fr, H, hd, dtype=dtype).transpose(1, 2)
        v = randn(B, Fr, H, hd, dtype=dtype).transpose(1, 2)
        shape = f"whisper {label} B={B} H={H} KV={H} Sq={Sq} Sk={Fr} hd={hd}"
        err = check(f"flash_attention {shape}",
                    ops.flash_attention(q, k, v, causal=False),
                    ref.flash_attention_ref(q, k, v, causal=False),
                    TOL[dtype])
        log(f"K2 flash_attention {shape} non-causal bf16: "
            f"max_abs_err={err:.3g} tol={TOL[dtype]}")
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        extra(f"flash_attention {shape} non-causal bf16",
              time_ms(lambda: ops.flash_attention(q, k, v, causal=False),
                      label=f"K2 whisper {label} kernel"),
              time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=False),
                      iters=10),
              bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * hd * Sq * Fr * B * H, dtype),
              time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc)))
    q = randn(B, 1, H, hd, dtype=dtype).reshape(B, H, 1, hd)
    ck = randn(B, Fr, H, hd, dtype=dtype).permute(0, 2, 1, 3)
    cv = randn(B, Fr, H, hd, dtype=dtype).permute(0, 2, 1, 3)
    pos = torch.full((B,), Fr - 1, dtype=torch.int32, device="cuda")
    chunk, n_split = split_plan(B, H, Fr, torch.cuda.get_device_properties(
        0).multi_processor_count)
    shape = (f"whisper cross decode B={B} KV={H} G=1 C={Fr} hd={hd} "
             f"pos={Fr - 1} (n_split={n_split}, chunk={chunk})")
    err = check(f"decode_attention {shape}",
                ops.decode_attention(q, ck, cv, pos),
                ref.decode_attention_ref(q, ck, cv, pos), TOL[dtype])
    log(f"K3 decode_attention {shape} bf16: max_abs_err={err:.3g} "
        f"tol={TOL[dtype]}")
    kc, vc = ck.contiguous(), cv.contiguous()
    extra(f"decode_attention {shape} bf16",
          time_ms(lambda: ops.decode_attention(q, ck, cv, pos),
                  label="K3 whisper cross kernel"),
          time_ms(lambda: ref.decode_attention_ref(q, ck, cv, pos)),
          bound(2 * (2 * q.numel() + 2 * ck.numel()) + 4 * B,
                4 * hd * B * H * Fr, dtype),
          time_ms(lambda: F.scaled_dot_product_attention(q, kc, vc)))


def int8_bound(q, pos, KV, hd, write=False) -> tuple:
    """K3-int8 (``kernels/cost.py``) over the live slots of ``pos``:
    their int8 k and v rows and fp32 scales read once, q read and the
    output written once, with the write the new token's quantize and
    store."""
    from repro_torch.kernels import cost
    live = int((pos.to(torch.int64) + 1).sum()) * KV
    return cost.bound(cost.decode_attention_int8(q, live, write))


def int8_cache(randn, B, C, KV, hd, dtype):
    """An int8 cache as the model holds it, quantized from normal
    values: its (B,KV,C,hd) int8 views and (B,KV,C) scale views."""
    from repro_torch.models.attention import quantize_kv
    k8, ks = quantize_kv(randn(B, C, KV, hd, dtype=dtype))
    v8, vs = quantize_kv(randn(B, C, KV, hd, dtype=dtype))
    return (k8.permute(0, 2, 1, 3), v8.permute(0, 2, 1, 3),
            ks.transpose(1, 2), vs.transpose(1, 2))


def fused_write(label, ops, ref, randn, q, C, KV, pos, slot, window=0):
    """K3-int8 with the new token's quantize-and-write against its plain
    version, each on its own copy of one int8 cache: the cache held
    exactly, the output to TOL.  Returns (max abs err, a call of the
    kernel for timing, a call of the plain version, pos on the card)."""
    B, _, _, hd = q.shape
    cache = int8_cache(randn, B, C, KV, hd, q.dtype)
    kn = randn(B, KV, hd, dtype=q.dtype) * 3
    vn = randn(B, KV, hd, dtype=q.dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    slot = torch.tensor(slot, dtype=torch.int32, device="cuda")
    mine, plain = ([t.clone() for t in cache] for _ in range(2))
    new = dict(k_new=kn, v_new=vn, slot=slot, window=window)
    out = ops.decode_attention_int8(q, *mine, pos, **new)
    want = ref.decode_attention_int8_ref(q, *plain, pos, **new)
    for what, g, w in zip(("k", "v", "k_scale", "v_scale"), mine, plain):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: the kernel's written {what} "
                                 "differs from the plain version's")
    if torch.equal(mine[2], cache[2]):
        raise AssertionError(f"{label}: nothing was written")
    err = check(label, out, want, TOL[q.dtype])
    return (err, lambda: ops.decode_attention_int8(q, *mine, pos, **new),
            lambda: ref.decode_attention_int8_ref(q, *plain, pos, **new),
            pos)


def int8_decode(ops, ref, randn, gen) -> dict:
    """K3-int8 (``decode_attention_int8``) against its plain version.
    At the int8 serve phase's shape (qwen2-1.5b's B 4, KV 2, G 6, 144
    slots, pos 128–143, hd 128, bf16 q) with the new token's write, as
    the model calls it: its row of the kernels line, the written cache
    held exactly; dequantize + SDPA (two calls) timed beside it.  The
    write also at the edges of the int8 plan's chunks, on a wrapped ring
    and over 32768 slots ([extra] lines), and K3-int8 beside bf16 K3
    over a long cache (B 8, KV 2, G 6, 32768 slots, hd 128, pos near the
    end), where both are bound by the cache's bytes."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import split_plan_int8
    from repro_torch.models.attention import dequantize_kv
    dtype = torch.bfloat16

    B, KV, G, C, hd = BATCH, 2, 6, SEQ + 16, 128
    q = randn(B, 1, KV * (G + 2), hd, dtype=dtype)[:, :, :KV * G]
    q = q.reshape(B, KV, G, hd)
    pos = torch.randint(SEQ, C, (B,), generator=gen, device="cuda",
                        dtype=torch.int32).tolist()
    for window in (40, 0):
        label = (f"K3-int8 decode_attention_int8 with the write B={B} "
                 f"KV={KV} G={G} C={C} hd={hd} pos=slot={pos} "
                 f"window={window} bf16 q, int8 cache")
        err, kernel, plain, pos_t = fused_write(label, ops, ref, randn, q,
                                                C, KV, pos, pos, window)
        log(f"{label}: written cache equal, max_abs_err={err:.3g} "
            f"tol={TOL[dtype]}")
    b = int8_bound(q, pos_t, KV, hd, write=True)
    k, v, ks, vs = int8_cache(randn, B, C, KV, hd, dtype)
    qs = q.reshape(B, KV * G, 1, hd)
    mask = (torch.arange(C, device="cuda")[None, :]
            <= pos_t[:, None])[:, None, None, :]
    pair = lambda: F.scaled_dot_product_attention(
        qs, dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype),
        attn_mask=mask, enable_gqa=True)
    row = dict(name="decode_attention_int8", route="cuda",
               source="src/repro_torch/csrc/decode_attention.cu",
               # the reference's int8 decode step (quantize, write,
               # dequantize, einsums); it reaches no pallas_call
               replaces="src/repro/models/attention.py:325",
               max_abs_err=err,
               ms=time_ms(kernel, label="K3-int8 qwen2 kernel"),
               plain_ms=time_ms(plain), bound_ms=b[0], bound_by=b[1],
               library_ms=None)
    ms_nowrite = time_ms(lambda: ops.decode_attention_int8(q, k, v, ks, vs,
                                                           pos_t))
    log(f"[extra] decode_attention_int8 B={B} KV={KV} G={G} C={C} hd={hd}: "
        f"dequantize + SDPA (two calls, for reference only) "
        f"ms={time_ms(pair):.5g}; the kernel without the write "
        f"ms={ms_nowrite:.5g}")

    # the write at the plan's chunk edges and on a wrapped ring
    chunk, n_split = split_plan_int8(B, KV, C)
    edges = [chunk - 1, chunk, 2 * chunk - 1, 2 * chunk]
    ring = [C + 5, 3 * C - 1, 2 * C + chunk, 5 * C + chunk - 1]
    for what, p_, slot in (
            (f"slots at the edges of chunks of {chunk}", edges, edges),
            ("a wrapped ring, slot = pos % C, pos_eff = C - 1",
             [C - 1] * B, [p % C for p in ring])):
        label = f"decode_attention_int8 write at {what} B={B} C={C}"
        err, kernel, plain, pos_t = fused_write(label, ops, ref, randn, q,
                                                C, KV, p_, slot)
        extra(f"{label} (written cache equal, max_abs_err {err:.3g})",
              time_ms(kernel), time_ms(plain),
              int8_bound(q, pos_t, KV, hd, write=True))

    B, C = 8, 32768
    q = randn(B, KV, G, hd, dtype=dtype)
    pos = [C - 1 - 37 * i for i in range(B)]
    chunk, n_split = split_plan_int8(B, KV, C)
    label = (f"decode_attention_int8 write B={B} KV={KV} G={G} C={C} "
             f"hd={hd} ({n_split} chunks of {chunk})")
    err8w, kernel, plain, pos_t = fused_write(label, ops, ref, randn, q, C,
                                              KV, pos, pos)
    ms8w = time_ms(kernel)
    extra(f"{label} (written cache equal, max_abs_err {err8w:.3g})", ms8w,
          time_ms(plain, iters=5), int8_bound(q, pos_t, KV, hd, write=True))
    k, v, ks, vs = int8_cache(randn, B, C, KV, hd, dtype)
    kb, vb = (dequantize_kv(k, ks, dtype).permute(0, 2, 1, 3).contiguous()
              .permute(0, 2, 1, 3),
              dequantize_kv(v, vs, dtype).permute(0, 2, 1, 3).contiguous()
              .permute(0, 2, 1, 3))
    pos = pos_t
    shape = (f"B={B} KV={KV} G={G} C={C} hd={hd} "
             f"pos={C - 1 - 37 * (B - 1)}..{C - 1}")
    err8 = check(f"decode_attention_int8 {shape}",
                 ops.decode_attention_int8(q, k, v, ks, vs, pos),
                 ref.decode_attention_int8_ref(q, k, v, ks, vs, pos),
                 TOL[dtype])
    err16 = check(f"decode_attention {shape}",
                  ops.decode_attention(q, kb, vb, pos),
                  ref.decode_attention_ref(q, kb, vb, pos), TOL[dtype])
    live = int((pos.to(torch.int64) + 1).sum()) * KV
    ms8 = time_ms(lambda: ops.decode_attention_int8(q, k, v, ks, vs, pos))
    ms16 = time_ms(lambda: ops.decode_attention(q, kb, vb, pos))
    qs, kc, vc = q.reshape(B, KV * G, 1, hd), kb.contiguous(), vb.contiguous()
    pair = lambda: F.scaled_dot_product_attention(
        qs, dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype),
        enable_gqa=True)
    extra(f"decode_attention_int8 long cache {shape} (max_abs_err "
          f"{err8:.3g}; library_ms: dequantize + SDPA, two calls)", ms8,
          time_ms(lambda: ref.decode_attention_int8_ref(q, k, v, ks, vs, pos),
                  iters=5),
          int8_bound(q, pos, KV, hd), time_ms(pair, iters=10))
    extra(f"decode_attention (bf16 cache) long cache {shape} (max_abs_err "
          f"{err16:.3g}; library_ms: SDPA)", ms16,
          time_ms(lambda: ref.decode_attention_ref(q, kb, vb, pos), iters=5),
          bound(2 * (2 * q.numel() + 2 * live * hd) + 4 * B,
                4 * G * hd * live, dtype),
          time_ms(lambda: F.scaled_dot_product_attention(
              qs, kc, vc, enable_gqa=True), iters=10))
    log(f"[extra] K3-int8 against bf16 K3 at {C} slots: {ms8:.5g} ms "
        f"({ms8w:.5g} with the write) against {ms16:.5g} ms "
        f"({ms16 / ms8:.3f}x)")
    if not ms8 < ms16:
        raise AssertionError(f"K3-int8 takes {ms8} ms at {C} slots, bf16 "
                             f"K3 {ms16}: the int8 cache's half of the "
                             "bytes is not read faster")
    return row


def probs_bound(B, n) -> tuple:
    """K1 (``kernels/cost.py``): the pool, the row bounds and the
    eligibility read once, the probabilities written; ~12 fp32
    operations a (request, model)."""
    from repro_torch.kernels import cost
    return cost.bound(cost.modipick_probs(B, n))


def fused_bound(B, n) -> tuple:
    """The fused selection (``kernels/cost.py``): pool and rows read
    once, picks written; ~20 fp32 operations a (request, model)."""
    from repro_torch.kernels import cost
    return cost.bound(cost.fused_select(B, n))


def charged_bound(args, kw, got) -> tuple:
    """The charged pass: pool, candidate lists, ledger and rows read
    once, five outputs written; the operations this run's data needs:
    ~20 fp32 operations a (request, model) for stages 1-3, and for each
    admitted request a rescan of the rows of the models its replica
    serves (one compare a candidate)."""
    from repro_torch.kernels import cost, policy_select
    n, R, B = args[0].shape[0], args[6].shape[0], args[8].shape[0]
    lists = kw.get("cand_lists")  # or those the wrapper builds
    lists = (policy_select.candidate_lists(args[5]) if lists is None
             else lists).cpu().numpy()
    nnz = (len(lists) - n - R - 2) // 2
    off, roff = lists[:n + 1], lists[n + 1 + nnz:n + R + 2 + nnz]
    mods = lists[n + R + 2 + nnz:]
    row = np.diff(off)
    rescan = np.array([row[mods[roff[r]:roff[r + 1]]].sum()
                       for r in range(R)])
    rep, admitted = got[3].cpu().numpy(), got[1].cpu().numpy()
    return cost.bound(cost.charged_select(n, R, B, len(lists),
                                          rescan[rep[admitted]].sum()))


# The charged pass's chain: the steps of one request that depend on the
# one before it, with latencies assumed for Hopper (not measured here):
# a shared-memory load, a shuffle level, a dependent fp32 add.
SMEM_CYCLES, SHFL_CYCLES, FADD_CYCLES = 30, 25, 4


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def charged_chain(B, n) -> tuple:
    """(cycles a request, ms for B requests at the card's highest SM
    clock) of the dependent steps no charged request can avoid: one
    ledger read-modify-write in shared memory, one pool-order sum of n
    dependent adds after a shuffle, and two five-level warp reductions
    (the base's argmin, and the vote and draw ballots taken as one)."""
    cycles = (SMEM_CYCLES + FADD_CYCLES + SHFL_CYCLES + n * FADD_CYCLES
              + 2 * 5 * SHFL_CYCLES)
    return cycles, B * cycles / (sm_clock_mhz() * 1e3)


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

    # fused_select: picks equal to the plain version's, in segments of
    # 2, 4, 8 and 32 lanes (four models a lane at 128), and past 128
    # models with the lanes' state in shared memory
    for n_ in (2, 3, 8, 128, 129, 200, 1000):
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
    wide_pools(ops, ref, policy_select, gen)

    # charged_select: all five outputs equal to the plain version's
    for case in CHARGED_CASES:
        args, kw = charged_inputs(policy_select, gen, case, 1024)
        n_, R = args[0].shape[0], args[6].shape[0]
        nnz = int(args[5].sum())
        need = policy_select.charged_smem(n_, R, "cuda", nnz)[0]
        if need != policy_select.charged_smem_bytes(n_, R, nnz):
            raise AssertionError(f"charged_smem_bytes({n_}, {R}, {nnz}) "
                                 f"does not mirror the kernel's {need} "
                                 "bytes")
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
        kw["cand_lists"] = policy_select.candidate_lists(args[5])
        ms = time_ms(lambda: ops.charged_select(*args, **kw), iters=10)
        b = charged_bound(args, kw, ops.charged_select(*args, **kw))
        log(f"[extra] charged_select B={B_} n=3 R=6: ms={ms:.5g} "
            f"= {ms / B_ * 1e3:.4g} us per request; bound_ms={b[0]:.4g} "
            f"({b[1]}); chain bound {charged_chain(B_, 3)[1]:.4g} ms")
    limit = policy_select.charged_smem(1, 1, "cuda")[1]
    log(f"[extra] charged_select block shared memory limit: {limit} bytes")
    charged_shapes(ops, ref, policy_select, gen)


def wide_pools(ops, ref, policy_select, gen) -> None:
    """Pools wider than 128 models: K1 at n = 129, 200 and 1000 bit for
    bit, the launch plans of K1 and of the fused and stacked kernels as
    the kernel's library reports them equal to their Python mirrors, and
    one model past the largest pool a block holds refused with a
    ValueError, launching nothing.  (B2 and B4 at these widths:
    ``selection_kernels``, ``stacked_kernels``.)"""
    for n in (129, 200, 1000):
        rng, pool = select_pool(policy_select, n, n)
        t_u = torch.tensor(rng.uniform(0, 90, 4096), dtype=torch.float32,
                           device="cuda")
        t_l = t_u - THRESHOLD_MS
        elig = (torch.rand(4096, n, generator=gen, device="cuda")
                > 0.5).float()
        args = (pool.mu, pool.sigma, pool.acc, t_u, t_l, elig)
        if not torch.equal(ops.modipick_probs(*args),
                           ref.policy_probs_ref(*args)):
            raise AssertionError(f"modipick_probs differs from its plain "
                                 f"version at n={n}")
        rows = policy_select.selection_plan("probs", 4096, n, "cuda")["rows"]
        log(f"K1 modipick_probs B=4096 n={n}: equal to its plain version "
            f"({rows} rows a block)")
    limit = None
    for kernel, mirror in (("probs", policy_select.probs_plan),
                           ("select", policy_select.select_plan)):
        for B in (1, 7, 200, 2550, 8192, 100_000):
            for n in (1, 2, 5, 11, 33, 128, 129, 200, 1000, 4096):
                got = policy_select.selection_plan(kernel, B, n, "cuda")
                limit = got.pop("limit")
                if got != mirror(B, n, limit):
                    raise AssertionError(
                        f"{kernel} plan at B={B} n={n}: the kernel's {got} "
                        f"is not its mirror's {mirror(B, n, limit)}")
        log(f"[plan] {kernel}: the kernel's launch plan equals its Python "
            f"mirror at 60 shapes; at most "
            f"{policy_select.max_pool(kernel, limit)} models under the "
            f"card's {limit} bytes a block")
    before = ops.launch_counts()
    for kernel in ("select", "probs"):
        n = policy_select.max_pool(kernel, limit) + 1
        one = torch.ones(n, device="cuda")
        rows = torch.ones(3, device="cuda")
        calls = {"select": (lambda: ops.fused_select(
                     one, one, one, one, rows, rows, rows),
                            lambda: ops.stacked_select(
                     one[None], one[None], one, one,
                     torch.zeros(3, dtype=torch.int32, device="cuda"),
                     rows, rows, rows)),
                 "probs": (lambda: ops.modipick_probs(
                     one, one, one, rows, rows,
                     torch.ones(3, n, device="cuda")),)}[kernel]
        for call in calls:
            try:
                call()
            except ValueError as e:
                if f"{limit} bytes" not in str(e):
                    raise
            else:
                raise AssertionError(f"a pool of {n} models was not "
                                     f"refused ({kernel})")
        log(f"[plan] {kernel}: a pool of {n} models refused with a "
            "ValueError")
    if ops.launch_counts() != before:
        raise AssertionError("a refused pool launched a kernel")


# B3 at the engine's pool and where the models wrap the warp's lanes:
# (n, R, replicas a model, B, dead models).  The engine's pool is Table
# 2's 11 models over 4 replicas each; 33 models give a lane two, 64 two
# full slots, 128 four; the last case kills every replica of three
# models, replica 0's among them.  A pick is charged its whole mu, so
# that the waits cross the budgets and every case sheds some requests.
CHARGED_SHAPES = {"engine": (11, 44, 4, 200, ()),
                  "n33": (33, 66, 4, 600, ()),
                  "n64": (64, 128, 4, 600, ()),
                  "n128": (128, 128, 3, 600, ()),
                  "dead models": (11, 44, 4, 200, (0, 5, 10))}


def charged_shapes(ops, ref, policy_select, gen) -> None:
    """B3 on the shapes of CHARGED_SHAPES, SLA-aware with the service
    time: all five outputs equal to the plain version's, then timed
    beside the chain bound ([extra] lines)."""
    for name, (n, R, per, B, dead) in CHARGED_SHAPES.items():
        rng, pool = select_pool(policy_select, n, 7 + n)
        cand = torch.zeros(n, R, dtype=torch.bool)
        for m in range(n):
            cand[m, [(per * m + i) % R for i in range(per)]] = True
        rep_wait = rng.uniform(0.0, 30.0, R)
        for m in dead:
            rep_wait[cand[m].numpy()] = np.inf
        budgets = rng.uniform(20.0, 160.0, B)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device="cuda")

        args = (pool.mu, pool.sigma, pool.acc, pool.rank, pool.mu,
                cand.cuda(), f32(np.ones(R)), f32(rep_wait), f32(budgets),
                f32(budgets - THRESHOLD_MS),
                torch.rand(B, generator=gen, device="cuda"), f32(budgets))
        kw = dict(slack=2.0, include_mu=True, fastest=pool.fastest,
                  cand_lists=policy_select.candidate_lists(args[5]))
        got = ops.charged_select(*args, **kw)
        t0 = time.perf_counter()
        want = ref.charged_select_ref(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for what, g, w in zip(("picks", "admitted", "has_base", "replica",
                               "w_chosen"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"charged_select {name}: {what} "
                                     "differs from the plain version's")
        if dead and not torch.isin(got[0].long(), torch.tensor(
                dead, device="cuda")).any():
            raise AssertionError("charged_select dead models: no pick of a "
                                 "dead model, the case tests nothing")
        if not 0 < int(got[1].sum()) < B:
            raise AssertionError(f"charged_select {name}: the case must shed "
                                 "some requests and admit others")
        ms = time_ms(lambda: ops.charged_select(*args, **kw), iters=20)
        cycles, chain_ms = charged_chain(B, n)
        extra(f"charged_select {name} B={B} n={n} R={R} (all five outputs "
              f"equal; {int(got[1].sum())} admitted; {ms / B * 1e3:.4g} us "
              f"a request; chain bound {chain_ms:.4g} ms = {cycles} cycles "
              "a request; plain_ms host-timed, once)", ms, plain_ms,
              charged_bound(args, kw, got))


TRACED = {}  # (variant, KV cache dtype) → (request ms, device kernels)


def trace_request(v, tokens) -> None:
    """One warm request (prefill + N_DECODE steps) under torch.profiler:
    the device's busy and idle share of the wall time, the number of
    kernels launched (kept in TRACED), and where the host and device
    time go."""
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
    TRACED[v.name, v.cfg.kv_cache_dtype] = (ms, len(kernels))
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
    if cfg.moe is not None:
        e = cfg.moe
        out["moe"] = (e.n_experts, e.top_k, e.d_ff_expert)
    if cfg.encdec is not None:
        out["encdec"] = (cfg.encdec.n_encoder_layers, cfg.encdec.n_frames)
    if cfg.vlm is not None:
        out["vlm"] = cfg.vlm.n_image_tokens
    return out


def check_published(arch, cfg) -> None:
    want = PUBLISHED[arch]
    got = {k: v for k, v in published_dims(cfg).items() if k in want}
    if got != want:
        raise AssertionError(f"{arch} full width is not the published "
                             f"config: {got} != {want}")


def build_pool(arch, gen, kv_cache_dtype="bf16"):
    """The ``WIDTHS`` of the published config of ``arch`` (0.5 and 1.0
    unless it says otherwise), at full depth, bf16, random weights from
    ``gen``, with a KV cache of ``kv_cache_dtype``."""
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.pool import Variant

    base = replace(get_config(arch), kv_cache_dtype=kv_cache_dtype)
    pool = []
    for w in WIDTHS.get(arch, (0.5, 1.0)):
        cfg = base.scaled(w, name=f"{base.name}-w{w:g}")
        v = Variant(name=cfg.name, cfg=cfg,
                    quality=base.quality * (0.6 + 0.4 * w),
                    cache_len=SEQ + 16)
        v.build(gen, torch.bfloat16)
        pool.append(v)
    check_published(arch, pool[-1].cfg)
    return pool


def expected_launches(cfgs) -> dict:
    """The kernel launches of one request (prefill + N_DECODE steps) on
    each config: prefill and decode attention per attention layer (and
    decode step), the SSD scan per SSD layer, the RG-LRU scan per RG-LRU
    layer; no selection kernel on the scalar path."""
    from repro_torch.kernels import ops
    want = dict.fromkeys(ops.launch_counts(), 0)
    for cfg in cfgs:
        kinds = cfg.block_kinds
        n_attn = sum(k in ("attn", "local") for k in kinds)
        want["flash_attention"] += n_attn
        decode = ("decode_attention_int8" if cfg.kv_cache_dtype == "int8"
                  else "decode_attention")
        want[decode] += n_attn * N_DECODE
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
        cache, logits = M.prefill(v.cfg, v.params, {"tokens": tok},
                                  v.cache_len,
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


def routing_changes(a, b, T) -> int:
    """(token, k) entries of the first T tokens that two routings send
    to another expert or keep differently."""
    K = a.idx.shape[-1]
    diff = (a.idx != b.idx) | (a.keep != b.keep)
    return int(diff.reshape(-1, K)[:T].sum())


def layer_by_layer(label, cfg, params, batch, cache_len, M, ops) -> None:
    """Prefill of ``batch`` and one decode step with every layer run on
    both paths from the plain path's input to it: each layer's output,
    and the logits of the last layer's output, held to LOGIT_RTOL of
    their largest magnitude.  This bounds what each layer's kernels
    change without the depth amplifying it.  An encoder's layers are
    held the same way, and a decoder layer's self-attention and
    cross-attention each on their own before its feed-forward.

    A MoE layer routes once, from the plain path's input to its
    feed-forward, and both paths apply that routing: a bf16 difference
    there could flip a near-tied top-k choice or a capacity drop and
    move a token by a whole expert's share, whatever the kernels do.
    How many (token, k) entries the kernel path's own input would have
    routed differently is logged."""
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm, sinusoidal_pos
    layers = list(enumerate(zip(M.layer_kinds(cfg), params["layers"])))

    def held(what, x_k, x_p) -> float:
        err = float((x_k.float() - x_p.float()).abs().max())
        scale = float(x_p.float().abs().max())
        if err > LOGIT_RTOL * scale:
            raise AssertionError(f"{label} layer by layer {what} disagrees: "
                                 f"{err} > {LOGIT_RTOL} * {scale}")
        return err / scale

    def ffn(kind, p, x_k, x_p, changed):
        """Both paths' feed-forward, a MoE on the plain path's routing;
        adds the kernel path's own routing changes to ``changed``."""
        if kind == "ssd":
            return x_k, x_p
        route = None
        if cfg.moe is not None:
            norm2 = lambda x: apply_norm(cfg.norm, x, p["norm2"],
                                         cfg.norm_eps)
            router = p["mlp"]["router"]
            route = moe.moe_route(router, norm2(x_p), cfg)
            changed[0] += routing_changes(
                route, moe.moe_route(router, norm2(x_k), cfg),
                x_p.shape[0] * x_p.shape[1])
            changed[1] += x_p.shape[0] * x_p.shape[1] * cfg.moe.top_k
        return (M.ffn_block(cfg, p, x_k, route),
                M.ffn_block(cfg, p, x_p, route))

    def report(what, worst, x_k, x_p, changed) -> None:
        log(f"{label} layer by layer {what}: worst layer output err "
            f"{worst:.4g} of its max |x| over {cfg.n_layers} layers")
        if cfg.moe is not None:
            log(f"{label} layer by layer {what}: {changed[0]} of "
                f"{changed[1]} (token, k) entries would route differently "
                "on the kernel path's own input")
        err, scale = logits_err(f"{label} layer by layer {what}",
                                M.final_logits(cfg, params, x_k),
                                M.final_logits(cfg, params, x_p),
                                cfg.vocab_size)
        if err > LOGIT_RTOL * scale:
            raise AssertionError(f"{label} layer-by-layer {what} logits "
                                 f"disagree: {err} > {LOGIT_RTOL} * {scale}")

    if cfg.encdec is not None:
        frames = batch["frames"]
        dt = params["embed"].dtype
        x = frames.to(dt) + sinusoidal_pos(
            torch.arange(frames.shape[1], device="cuda"), cfg.d_model).to(dt)
        worst = 0.0
        for i, p in enumerate(params["encoder"]["layers"]):
            x_k = M.encoder_block(cfg, p, x, ops.KERNELS)
            x = M.encoder_block(cfg, p, x, ops.PLAIN)
            worst = max(worst, held(f"encoder layer {i}", x_k, x))
        log(f"{label} layer by layer encoder: worst layer output err "
            f"{worst:.4g} of its max |x| over "
            f"{cfg.encdec.n_encoder_layers} layers")
    x, positions, enc = M.assemble_input(cfg, params, batch, ops.PLAIN)
    tables = M.rope_for(cfg, positions)
    caches, worst, changed = [], 0.0, [0, 0]
    for i, (kind, p) in layers:
        mix = "attn" if kind == "xdec" else kind
        x_k, _ = M.mix_prefill(cfg, mix, p, x, tables, cache_len,
                               ops.KERNELS)
        x, c = M.mix_prefill(cfg, mix, p, x, tables, cache_len, ops.PLAIN)
        if kind == "xdec":
            worst = max(worst, held(f"prefill layer {i} self", x_k, x))
            x_k = M.cross_block(cfg, p, x, enc, ops.KERNELS)[0]
            x, c["xk"], c["xv"] = M.cross_block(cfg, p, x, enc, ops.PLAIN)
            worst = max(worst, held(f"prefill layer {i} cross", x_k, x))
        x_k, x = ffn(kind, p, x_k, x, changed)
        worst = max(worst, held(f"prefill layer {i} ({kind})", x_k, x))
        caches.append(c)
    report("prefill", worst, x_k, x, changed)

    nxt = torch.argmax(M.final_logits(cfg, params, x), -1)
    pos = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                     device="cuda")
    tables = M.rope_for(cfg, pos[:, None])
    x = M.embed_tokens(cfg, params, nxt[:, None], pos[:, None])
    worst, changed = 0.0, [0, 0]
    for i, (kind, p) in layers:
        mix = "attn" if kind == "xdec" else kind
        # an attention cache is written in place: the kernel path gets a copy
        copy = {k: t.clone() for k, t in caches[i].items()}
        x_k, _ = M.mix_decode(cfg, mix, p, x, copy, pos, tables,
                              ops.KERNELS)
        x, _ = M.mix_decode(cfg, mix, p, x, caches[i], pos, tables,
                            ops.PLAIN)
        if kind == "xdec":
            worst = max(worst, held(f"decode layer {i} self", x_k, x))
            x_k = M.cross_decode_block(cfg, p, x, caches[i], ops.KERNELS)
            x = M.cross_decode_block(cfg, p, x, caches[i], ops.PLAIN)
            worst = max(worst, held(f"decode layer {i} cross", x_k, x))
        x_k, x = ffn(kind, p, x_k, x, changed)
        worst = max(worst, held(f"decode layer {i} ({kind})", x_k, x))
    report("decode step", worst, x_k, x, changed)


def serve_family(arch, gen, tokens, kv_cache_dtype="bf16"):
    """Serve ``N_REQUESTS[arch]`` requests (``INT8_REQUESTS`` with an
    int8 KV cache) from a pool of ``arch`` through PoolExecutor → Router
    → ModiPick, with the launch counters zeroed just before and read just
    after; hold the full-width logits on the kernel path against the
    plain path (and, with an int8 cache, one request's decode logits
    against the same weights with a bf16 cache); time each variant.
    Returns (executor, the launch counts of the serve run)."""
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.policy import ModiPick
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.executor import PoolExecutor

    int8 = kv_cache_dtype == "int8"
    label = f"[serve {arch}{' int8kv' if int8 else ''}]"
    t0 = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    pool = build_pool(arch, gen, kv_cache_dtype)
    log(f"{label} weights: " + ", ".join(
        f"{v.name} {v.cfg.param_count() / 1e9:.2f} B parameters "
        f"({2 * v.cfg.param_count() / 1e9:.1f} GB bf16)" for v in pool)
        + f"; allocated after the build {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB; KV cache {kv_cache_dtype}")
    ex = PoolExecutor(pool, NetworkModel.from_cv(20.0, 0.5),
                      ModiPick(THRESHOLD_MS))
    ex.warm_up(tokens, n_decode=N_DECODE)
    log(f"{label} pool built and warmed in "
        f"{time.perf_counter() - t0:.1f}s: "
        + ", ".join(f"{v.name} d={v.cfg.d_model} L={v.cfg.n_layers} "
                    f"kinds={sorted(set(v.cfg.block_kinds))}" for v in pool))
    n = INT8_REQUESTS if int8 else N_REQUESTS[arch]
    ops.reset_launch_counts()
    results = [ex.execute(tokens, t_sla=T_SLA_MS, n_decode=N_DECODE)
               for _ in range(n)]
    counts = ops.launch_counts()
    summary = ex.summary()
    log(f"{label} summary " + json.dumps(summary))
    log(f"{label} launches " + json.dumps(counts))
    want = expected_launches(ex.by_name[r.variant].cfg for r in results)
    if counts != want:
        raise AssertionError(f"{label} serve launches {counts} != {want}")
    if summary["n"] != n or not all(
            np.isfinite(r.t_infer_ms) and r.t_infer_ms > 0 for r in results):
        raise AssertionError(f"{label} serve phase returned bad results")

    with torch.inference_mode():
        v = pool[-1]
        free_running(arch, v, M, ops, tokens)
        layer_by_layer(label, v.cfg, v.params,
                       {"tokens": torch.as_tensor(tokens, device="cuda")},
                       v.cache_len, M, ops)
        if int8:
            int8_against_bf16(label, v, M, tokens)
        if v.cfg.moe is not None:
            moe_timings(ops, v, gen)

    for v in pool:
        pre = wall_ms(lambda: v.run(tokens, n_decode=0))
        both = wall_ms(lambda: v.run(tokens, n_decode=N_DECODE))
        log(f"[perf] {v.name}{' int8kv' if int8 else ''}: warm prefill "
            f"{pre:.3f} ms, prefill + {N_DECODE} decode {both:.3f} ms "
            f"(B={BATCH}, S={SEQ}, median of 7)")
        trace_request(v, tokens)
        if int8:
            count_int8_request(label, v)
    log(f"{label} peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for v in pool:
        v.params = None  # free the card for the next phase
    release()
    return ex, counts


def old_int8_write_kernels(v) -> int:
    """Device kernels, a layer and decode step, of the plain-torch
    quantize-and-write that the int8 cache ran before the write moved
    into K3-int8's call: the slot and row indices, ``quantize_kv`` of
    the new token's k and v, and four indexed writes, as
    ``models/attention.py`` made them, on ``v``'s shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = v.cfg
    KV, hd, C = cfg.n_kv_heads, cfg.resolved_head_dim, v.cache_len
    cache = {"k": torch.zeros(BATCH, C, KV, hd, dtype=torch.int8,
                              device="cuda"),
             "k_scale": torch.ones(BATCH, C, KV, device="cuda")}
    cache["v"], cache["v_scale"] = cache["k"].clone(), cache["k_scale"].clone()
    new = torch.randn(BATCH, 1, KV, hd, device="cuda").to(torch.bfloat16)
    pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")

    def write():
        rows = torch.arange(BATCH, device="cuda")
        slot = pos.to(torch.int64)
        for key in ("k", "v"):
            xf = new[:, 0].to(torch.float32)
            scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-12
            qv = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
            cache[key][rows, slot], cache[f"{key}_scale"][rows, slot] = \
                qv.to(torch.int8), scale

    write()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        write()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def count_int8_request(label, v) -> None:
    """The count line: the device kernels of one int8-cache request
    against the same variant's bf16-cache request, and the kernels the
    plain quantize-and-write launched, which the fused write took off
    the path."""
    ms8, k8 = TRACED[v.name, "int8"]
    ms16, k16 = TRACED.get((v.name, "bf16"), (float("nan"), -1))
    per = old_int8_write_kernels(v)
    n_attn = sum(k in ("attn", "local") for k in v.cfg.block_kinds)
    log(f"[count] {label} {v.name}: {k8} device kernels a request "
        f"({ms8:.3f} ms under the profiler) against {k16} with a bf16 "
        f"cache ({ms16:.3f} ms); K3-int8 launches a request "
        f"{n_attn * N_DECODE} (one a layer and step); the plain "
        f"quantize-and-write launched {per} kernels a layer and step, "
        f"{per * n_attn * N_DECODE} a request, no longer on the path")


def int8_against_bf16(label, v, M, tokens) -> None:
    """One request's decode step on the int8 cache against the same
    weights, tokens and next token with a bf16 cache, both on the kernel
    path: held to INT8_RTOL of max |logit|, the reference's bound."""
    from dataclasses import replace
    tok = torch.as_tensor(tokens, device="cuda")
    pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")
    outs, nxt = [], None
    for cfg in (v.cfg, replace(v.cfg, kv_cache_dtype="bf16")):
        cache, logits = M.prefill(cfg, v.params, {"tokens": tok},
                                  v.cache_len)
        if nxt is None:
            nxt = torch.argmax(logits, -1)
        outs.append(M.decode_step(cfg, v.params, cache, nxt, pos)[0])
    a, b = (o.float()[:, :v.cfg.vocab_size] for o in outs)
    if not torch.isfinite(a).all():
        raise AssertionError(f"{label} int8-cache logits are not finite")
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"{label} decode logits, int8 against bf16 cache: max_abs_err="
        f"{err:.4g} = {err / scale:.4g} of max |logit| (bound {INT8_RTOL}), "
        f"greedy_agreement={agree:.3f}")
    if err > INT8_RTOL * scale:
        raise AssertionError(f"{label} int8-cache decode logits are "
                             f"{err / scale} of max |logit| from the bf16 "
                             f"cache's > {INT8_RTOL}")


def model_phase(arch, gen) -> dict:
    """``MODEL_PHASES[arch]`` at the published width and depth in bf16:
    one request (a prefill of the batch, then greedy decode steps)
    through ``api.make_prefill_step`` and ``api.make_serve_step``, with
    the launch counters zeroed just before and read just after (K2 per
    encoder layer and per decoder self- and cross-attention, K3 per
    decoder attention per step, the cross decode's too); its logits
    finite, and beside the plain path's; every layer held layer by
    layer; prefill and step ms, peak memory.  Returns the launch
    counts."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    ph = MODEL_PHASES[arch]
    cfg = get_config(arch)
    check_published(arch, cfg)
    label = f"[{'encdec' if cfg.encdec is not None else 'vlm'} {arch}]"
    release()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, gen, torch.bfloat16)
    n_img = cfg.vlm.n_image_tokens if cfg.vlm is not None else 0
    B, S, C, steps = ph["B"], ph["S"], ph["cache_len"], ph["steps"]
    batch = api.make_train_batch(cfg, ShapeConfig(arch, S + n_img, B,
                                                  "prefill"), gen)
    log(f"{label} {cfg.param_count() / 1e9:.4g} B parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.3f} GB allocated); batch "
        + ", ".join(f"{k} {tuple(t.shape)} {t.dtype}"
                    for k, t in batch.items())
        + f"; {C} cache slots, {steps} decode steps")

    def request(impl):
        prefill = api.make_prefill_step(cfg, C, impl)
        step = api.make_serve_step(cfg, impl)
        cache, logits = prefill(params, batch)
        outs = [logits]
        for i in range(steps):
            pos = torch.full((B,), S + n_img + i, dtype=torch.int32,
                             device="cuda")
            logits, cache = step(params, cache, torch.argmax(outs[-1], -1),
                                 pos)
            outs.append(logits)
        return outs, cache

    with torch.inference_mode():
        request(ops.KERNELS)  # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outs, cache = request(ops.KERNELS)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        n_enc = cfg.encdec.n_encoder_layers if cfg.encdec is not None else 0
        x = 2 if cfg.encdec is not None else 1  # self (and cross) a layer
        want = dict.fromkeys(counts, 0)
        want["flash_attention"] = n_enc + x * cfg.n_layers
        want["decode_attention"] = x * cfg.n_layers * steps
        log(f"{label} launches " + json.dumps(counts))
        if counts != want:
            raise AssertionError(f"{label} launches {counts} != {want}")
        for i, lg in enumerate(outs):
            if lg.shape != (B, cfg.padded_vocab) or not torch.isfinite(
                    lg[:, :cfg.vocab_size]).all():
                raise AssertionError(f"{label} logits {i} are not finite "
                                     f"of shape {(B, cfg.padded_vocab)}")
        plain, _ = request(ops.PLAIN)
        for i, what in ((0, "prefill"), (1, "first decode step")):
            logits_err(f"{label} free-running {what}", outs[i], plain[i],
                       cfg.vocab_size)
        layer_by_layer(label, cfg, params, batch, C, M, ops)
        prefill = api.make_prefill_step(cfg, C)
        step = api.make_serve_step(cfg)
        nxt = torch.argmax(outs[-1], -1)
        pos = torch.full((B,), S + n_img + steps, dtype=torch.int32,
                         device="cuda")
        pre_ms = wall_ms(lambda: prefill(params, batch))
        step_ms = wall_ms(lambda: step(params, cache, nxt, pos))
    log(f"{label} prefill {pre_ms:.3f} ms, decode step {step_ms:.3f} ms "
        f"(B={B}, {S} text tokens{f' after {n_img} image embeddings' if n_img else ''}"
        f", median of 7); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; phase "
        f"{time.perf_counter() - t0:.1f}s")
    del params, cache, outs, plain
    release()
    return counts


def trace_step(label, step) -> None:
    """One training step under torch.profiler: its wall time, the
    device's busy and idle share, the kernels launched, the device time
    of the backward kernels (K2-bwd's four, K4-bwd's eight passes,
    K5-bwd's) and of K4's fp32 forward passes,
    and the top
    device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"{label} [trace] step {ms:.1f} ms under the profiler, "
        f"{len(kernels)} device kernels, device busy {busy:.1f} ms (idle "
        f"share {1 - busy / ms:.3f})")
    for name, pat in (("K2-bwd", r"\bbwd_(dot|dq|dkdv|reduce)_kernel\b"),
                      ("K4-bwd", r"\bssd_bwd_\w+_kernel\b"),
                      ("K4-f32", r"\bssd_fwd_\w+_kernel\b"),
                      ("K5-bwd", r"\brglru_bwd_kernel\b")):
        mine = [e for e in kernels if re.search(pat, e.name)]
        if not mine:
            continue
        mine_ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        log(f"{label} [trace] {name} kernels {mine_ms:.2f} ms x{len(mine)}, "
            f"{mine_ms / busy:.4f} of device busy")
    top = sorted(prof.key_averages(),
                 key=lambda e: e.self_device_time_total, reverse=True)[:8]
    log(f"{label} [trace] top device self time: " + "; ".join(
        f"{e.key} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
        for e in top))


def train_phase(arch, ops) -> dict:
    """``TRAIN[arch]`` at the published width and depth: fp32 parameters
    and moments, remat "full", through ``make_train_step``.  Before any
    step: the first step's loss and every leaf's gradient on the kernel
    path against the plain path (``ops.PLAIN``) on the card (over the
    first ``check_layers`` layers at full width where TRAIN names
    them), and the peak memory of that step with and without remat.  Then
    ``TRAIN_STEPS`` steps on one repeated batch (the loss must fall), a
    checkpoint, one more step, and the same step again from the
    checkpoint restored onto fresh templates (loss and every parameter
    equal bit for bit).  The launch counters are zeroed just before the
    steps and read just after: K2's, K4's and K5's backward kernels
    launch once per attention / SSD / RG-LRU layer a step, and no other
    kernel launches.  Returns the counts."""
    import shutil
    from dataclasses import replace
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.models.convert import leaf_layout, named_leaves
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import (loss_and_grads,
                                                 make_train_step)

    t0 = time.perf_counter()
    label = f"[train {arch}]"
    cfg = get_config(arch)
    check_published(arch, cfg)
    B, S = TRAIN[arch]["B"], TRAIN[arch]["S"]
    release()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    params = M.init_params(cfg, gen, torch.float32)
    stream = TokenStream(cfg.vocab_size, B, S, seed=23)
    batch = to_device(stream.batch_at(0), "cuda")
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds)
    n_rglru = sum(k == "rglru" for k in cfg.block_kinds)
    n_ssd = sum(k == "ssd" for k in cfg.block_kinds)
    log(f"{label} {cfg.param_count() / 1e9:.4g} B parameters fp32 "
        f"({torch.cuda.memory_allocated() / 1e9:.3f} GB); B={B} S={S}; "
        f"{n_attn} attention, {n_ssd} SSD and {n_rglru} RG-LRU layers")

    # the first step's gradients, kernel path against plain path, and
    # the peak memory with and without remat
    peak = {}
    for remat in (False, True):
        release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss_k, _, grads_k = loss_and_grads(
            api.make_forward_loss(cfg, remat=remat), params, batch)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        if not remat:
            del grads_k
    log(f"{label} peak memory of one forward and backward above the "
        f"parameters: remat none {peak[False]:.3f} GB, remat full "
        f"{peak[True]:.3f} GB")
    check_cfg, check_params = cfg, params
    cut = TRAIN[arch].get("check_layers")
    if cut:
        del grads_k
        check_cfg = replace(cfg, n_layers=cut)
        check_params = M.init_params(check_cfg, gen, torch.float32)
        loss_k, _, grads_k = loss_and_grads(
            api.make_forward_loss(check_cfg, remat=True), check_params, batch)
        label_check = f"{label} (first {cut} of {cfg.n_layers} layers)"
    else:
        label_check = label
    loss_p, _, grads_p = loss_and_grads(
        api.make_forward_loss(check_cfg, remat=True, impl=ops.PLAIN),
        check_params, batch)
    err_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not err_loss <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label_check} first-step loss "
                             f"{float(loss_k)} on the kernel path, "
                             f"{float(loss_p)} on the plain path")
    worst = (0.0, "")
    for path, g in grads_k.items():
        want = grads_p[path]
        err = float((g - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{label_check} gradient of {path}: "
                                 f"kernel path off by {err} of its max "
                                 "|gradient|")
        worst = max(worst, (err, path))
    log(f"{label_check} first step, kernel path against plain path: loss "
        f"{float(loss_k):.6f} (rel err {err_loss:.3g}, tol "
        f"{TRAIN_LOSS_RTOL}); {len(grads_k)} gradients, worst "
        f"{worst[0]:.3g} of max |g| at {worst[1]} (tol {TRAIN_GRAD_TOL})")
    del grads_k, grads_p, check_params

    # steps on one repeated batch, with the counters zeroed around them
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=0, schedule="constant",
                       remat="full", opt_moments="fp32")
    step_fn = make_train_step(cfg, tcfg)
    opt = init_opt_state(params, "fp32", leaf_layout(cfg, params))
    TRAINED[arch] = dict(
        params=sum(t.nbytes for _, t in named_leaves(params)),
        opt_state=opt.step.nbytes + sum(
            t.nbytes for m in (opt.mu, opt.nu) for t in m.values()))
    release()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    log(f"{label} launches over {TRAIN_STEPS} steps " + json.dumps(counts))
    # remat: a superblock's forward runs again in backward, the tail's not
    stacked = cfg.block_kinds[:cfg.n_superblocks * len(cfg.pattern)]
    want = {"flash_attention_bwd": n_attn * TRAIN_STEPS,
            "ssd_scan_bwd": n_ssd * TRAIN_STEPS,
            "rglru_scan_bwd": n_rglru * TRAIN_STEPS,
            "flash_attention": (n_attn + sum(
                k in ("attn", "local") for k in stacked)) * TRAIN_STEPS,
            "ssd_scan": (n_ssd + stacked.count("ssd")) * TRAIN_STEPS,
            "rglru_scan": (n_rglru + stacked.count("rglru")) * TRAIN_STEPS}
    got = {k: counts[k] for k in want}
    if got != want or not any(got[k] for k in (
            "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd")):
        raise AssertionError(f"{label} launches {got} != {want}")
    if any(counts[k] for k in counts if k not in want):
        raise AssertionError(f"{label} launched other kernels: {counts}")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError(f"{label} the loss did not fall: {losses}")
    step_s = float(np.median(times[1:]))
    TRAINED[arch].update(step_ms=step_s * 1e3, calls={
        k: counts[k] // TRAIN_STEPS for k in want})
    log(f"{label} losses " + " ".join(f"{x:.5f}" for x in losses)
        + f"; step {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
        f"first {times[0] * 1e3:.1f} ms), {B * S / step_s:.1f} tokens/s; "
        f"per step K2-bwd {counts['flash_attention_bwd'] // TRAIN_STEPS}, "
        f"K4-bwd {counts['ssd_scan_bwd'] // TRAIN_STEPS}, "
        f"K5-bwd {counts['rglru_scan_bwd'] // TRAIN_STEPS} launches; peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # checkpoint, one more step, and the same step from the checkpoint
    ckdir = str(Path(__file__).resolve().parent / "build" / "train_ckpt"
                / arch)
    shutil.rmtree(ckdir, ignore_errors=True)
    ts = time.perf_counter()
    ckpt.save(ckdir, TRAIN_STEPS, params, opt,
              extra={"data": stream.state()}, keep_last=1)
    save_s = time.perf_counter() - ts
    params, opt, m_next = step_fn(params, opt, batch)  # the un-restored
    del opt
    release()
    fresh = M.init_params(cfg, gen, torch.float32)
    fresh_opt = init_opt_state(fresh, "fp32", leaf_layout(cfg, fresh))
    ts = time.perf_counter()
    fresh, fresh_opt, extra = ckpt.restore(ckdir, TRAIN_STEPS, fresh,
                                           fresh_opt)
    restore_s = time.perf_counter() - ts
    if extra["data"] != stream.state() or int(fresh_opt.step) != TRAIN_STEPS:
        raise AssertionError(f"{label} restored {extra}, step "
                             f"{int(fresh_opt.step)}")
    fresh, fresh_opt, m_again = step_fn(fresh, fresh_opt, batch)
    torch.cuda.synchronize()
    same = [path for (path, a), (_, b) in zip(named_leaves(params),
                                                named_leaves(fresh))
            if torch.equal(a, b)]
    if float(m_again["loss"]) != float(m_next["loss"]) or len(same) != len(
            named_leaves(params)):
        raise AssertionError(
            f"{label} the restored step differs: loss "
            f"{float(m_again['loss'])} vs {float(m_next['loss'])}, "
            f"{len(same)} of {len(named_leaves(params))} leaves equal")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"{label} checkpoint of step {TRAIN_STEPS}: save {save_s:.1f}s, "
        f"restore {restore_s:.1f}s; the restored step equals the "
        f"un-restored one bit for bit (loss {float(m_next['loss']):.6f}, "
        f"{len(same)} leaves)")
    del params
    release()
    trace_step(label, lambda: step_fn(fresh, fresh_opt, batch))
    log(f"{label} phase {time.perf_counter() - t0:.1f}s")
    del fresh, fresh_opt
    release()
    return counts


# What train_phase allocated and measured, for the [mesh] phase's
# dry-run: arch → parameter and optimizer-state bytes, the step's ms and
# the kernels launched a step.
TRAINED = {}
# The sharded wrappers' meshes (data x model) over the one card, and the
# fleet's cell mesh: fleet_steady's four cells, one a block.
MESH_SHAPES = ((1, 1), (2, 4))
FLEET_MESH_CELLS = 4


def mesh_phase(ops, randn) -> dict:
    """The mesh tooling on the card (``[mesh ...]`` lines):

    - the dry-run (``launch/dryrun.py``) of each ``TRAIN`` cell on the
      ``meta`` device at the training phase's B and S, fp32 parameters
      and moments: its parameter and optimizer-state bytes must equal
      what the training phase allocated, exactly, and its kernels a step
      what the card launched; its H100 roofline beside the measured
      step;
    - the sharded kernel wrappers (``distributed/shardmap_ops.py``) at
      the main path's shapes (K2 qwen2, K3, K4 mamba2 serve, K5) on a
      (1, 1) and a (2, 4) data x model mesh of the one card, each held
      against the unsharded kernel to the smoke's tolerance;
    - ``fleet_steady`` with ``mesh=`` a four-cell ``cell`` mesh of the
      card: every epoch's picks, the spills and the attainment equal to
      the unsharded run's, bit for bit.

    The counters are zeroed just before the sharded calls and the
    sharded fleet run and read just after; returns those launches."""
    from math import prod
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import shardmap_ops as SH
    from repro_torch.fleet import frontend
    from repro_torch.fleet.engine import FleetEngine
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.scenario import get_scenario
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.launch_counts(), 0)

    single = dryrun.make_dryrun_mesh("single")
    for arch, tr in TRAIN.items():
        B, S = tr["B"], tr["S"]
        shape = ShapeConfig(f"train_b{B}_s{S}", S, B, "train")
        res = dryrun.run_cell(arch, shape.name, single, "single",
                              shape=shape, param_dtype=torch.float32,
                              grad_accum=1, verbose=False)
        got = res["memory"]["argument_bytes_by_role"]
        done = TRAINED[arch]
        if (got["params"], got["opt_state"]) != (done["params"],
                                                 done["opt_state"]):
            raise AssertionError(
                f"[mesh dryrun {arch}] counts {got['params']} parameter "
                f"and {got['opt_state']} optimizer-state bytes; the "
                f"training phase allocated {done['params']} and "
                f"{done['opt_state']}")
        calls = {k: v for k, v in done["calls"].items() if v}
        if res["cost"]["kernel_calls"] != calls:
            raise AssertionError(f"[mesh dryrun {arch}] kernels a step "
                                 f"{res['cost']['kernel_calls']}, the card "
                                 f"launched {calls}")
        ro, c = res["roofline"], res["cost"]
        step = max(ro["compute_s"], ro["memory_s"]) * 1e3
        log(f"[mesh dryrun {arch}] B={B} S={S} fp32: parameter bytes "
            f"{got['params']} and optimizer-state bytes {got['opt_state']} "
            f"equal the training phase's; kernels a step {calls} equal "
            f"the card's; H100 roofline: FLOPs {ro['hlo_flops']:.6g} "
            f"(aten {c['aten_flops']:.6g}, kernels "
            f"{c['kernel_flops']:.6g}), bytes {ro['hlo_bytes']:.6g}, "
            f"compute {ro['compute_s'] * 1e3:.6g} ms, memory "
            f"{ro['memory_s'] * 1e3:.6g} ms ({ro['dominant']}), model "
            f"FLOPs {ro['model_flops']:.6g} (useful "
            f"{ro['useful_flops_ratio']:.4g}, mfu_bound "
            f"{ro['mfu_bound']:.4g}); measured step {done['step_ms']:.6g} "
            f"ms, bound / step {step / done['step_ms']:.4g}; dry-run "
            f"{res['timing']['run_s']:.1f}s")

    dev = torch.device("cuda", torch.cuda.current_device())
    meshes = [make_mesh(sh, ("data", "model"), [dev] * prod(sh))
              for sh in MESH_SHAPES]
    B, H, KV, hd = BATCH, 12, 2, 128
    bf = torch.bfloat16
    q = randn(B, SEQ, H, hd, dtype=bf).transpose(1, 2)
    k = randn(B, SEQ, KV, hd, dtype=bf).transpose(1, 2)
    v = randn(B, SEQ, KV, hd, dtype=bf).transpose(1, 2)
    C, G = SEQ + 16, H // KV
    qd = randn(B, 1, H + 2 * KV, hd, dtype=bf)[:, :, :H].reshape(B, KV, G, hd)
    ck = randn(B, C, KV, hd, dtype=bf).permute(0, 2, 1, 3)
    cv = randn(B, C, KV, hd, dtype=bf).permute(0, 2, 1, 3)
    pos = torch.randint(SEQ, C, (B,), generator=randn.gen, device="cuda",
                        dtype=torch.int32)
    sargs = ssd_args(randn, BATCH, SEQ, 64, 64, 128, 1, bf)
    a = torch.sigmoid(randn(BATCH, SEQ, 2560, dtype=torch.float32)) * 0.98
    b = randn(BATCH, SEQ, 2560, dtype=torch.float32) * 0.1
    cases = (  # name, unsharded, sharded on a mesh, tolerance, scaled
        ("flash_attention", lambda: ops.flash_attention(q, k, v),
         lambda m: SH.sharded_flash_attention(q, k, v, m), TOL[bf], False),
        ("decode_attention", lambda: ops.decode_attention(qd, ck, cv, pos),
         lambda m: SH.sharded_decode_attention(qd, ck, cv, pos, m), TOL[bf],
         False),
        ("ssd_scan", lambda: ops.ssd_scan(*sargs, chunk=256),
         lambda m: SH.sharded_ssd_scan(*sargs, m, chunk=256), SSD_TOL[bf],
         True),
        ("rglru_scan", lambda: ops.rglru_scan(a, b),
         lambda m: SH.sharded_rglru_scan(a, b, m), TOL[torch.float32],
         False))
    wants = {name: unsharded() for name, unsharded, _, _, _ in cases}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for name, _, sharded, tol, scaled in cases:
        for m in meshes:
            got = sharded(m)
            outs = got if isinstance(got, tuple) else (got,)
            want = wants[name]
            want = want if isinstance(want, tuple) else (want,)
            hold = check_scaled if scaled else check
            err = max(hold(f"sharded {name} on {m}", g, w, tol)
                      for g, w in zip(outs, want))
            log(f"[mesh sharded] {name} on {m}: max "
                f"{'err of max|y|' if scaled else 'abs err'} {err:.3g} "
                f"against the unsharded kernel (tol {tol})")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {name: sum(m.size for m in meshes) for name, *_ in cases}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"[mesh sharded] launches {counts}, want "
                             f"{want} and nothing else")
    log(f"[mesh sharded] launches {want}: one a device of each mesh")
    for key, c in counts.items():
        total[key] += c

    sc = on_backend(get_scenario("fleet_steady"), "cuda")
    n_cells = len(sc.deployment.fleet.cells)
    if n_cells != FLEET_MESH_CELLS:
        raise AssertionError(f"fleet_steady has {n_cells} cells")
    cell_mesh = make_mesh((n_cells,), ("cell",), [dev] * n_cells)
    picks, runs = {}, {}
    select = frontend.select_fleet
    for label, mesh in (("unsharded", None), ("sharded", cell_mesh)):
        picks[label] = []

        def recorded(*args, _out=picks[label], **kw):
            out = select(*args, **kw)
            _out.append(out.copy())
            return out

        frontend.select_fleet = recorded
        try:
            if mesh is not None:
                ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs[label] = FleetEngine(sc, mesh=mesh).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            frontend.select_fleet = select
    counts = ops.launch_counts()
    epochs = len(picks["sharded"])
    if counts != {k: n_cells * epochs * (k == "stacked_select")
                  for k in counts}:
        raise AssertionError(f"[mesh fleet_steady] launches {counts}, want "
                             f"{n_cells} stacked_select an epoch")
    same = len(picks["unsharded"]) == epochs and all(
        np.array_equal(x, y) for x, y in zip(picks["unsharded"],
                                             picks["sharded"]))
    keys = ("sla_attainment", "mean_accuracy", "mean_latency")
    res = {label: r.as_scenario_result() for label, r in runs.items()}
    got = {k: getattr(res["sharded"], k) for k in keys}
    want = {k: getattr(res["unsharded"], k) for k in keys}
    for k in ("spill_rate", "locality", "n_spilled"):
        got[k], want[k] = getattr(runs["sharded"], k), getattr(
            runs["unsharded"], k)
    if not same or got != want:
        raise AssertionError(f"[mesh fleet_steady] sharded {got} (picks "
                             f"equal: {same}), unsharded {want}")
    log(f"[mesh fleet_steady] on {cell_mesh}: {epochs} epochs, every "
        "epoch's picks equal the unsharded run's, and " + " ".join(
            f"{k}={v:.6g}" for k, v in got.items())
        + f"; launches={counts['stacked_select']} wall_s={wall:.4g}")
    total["stacked_select"] += counts["stacked_select"]
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f}s")
    return total


def release() -> None:
    """Hand the allocator's cached blocks of freed tensors back to the
    card, so that the next phase's weights find room."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def moe_timings(ops, v, gen) -> None:
    """One MoE layer of ``v`` at the serve phase's prefill (B x S tokens)
    and decode (B tokens) shapes: the routing, the experts' three batched
    products over all E experts (the port's choice) and, for the record,
    over only the experts that hold a token (their weights gathered
    first), and the whole ``moe_ffn``; beside that layer's attention
    kernel at the same step (K2 in prefill, K3 in decode)."""
    from repro_torch.models import moe
    cfg, p = v.cfg, v.params["layers"][0]["mlp"]
    e = cfg.moe
    E, D, F = e.n_experts, cfg.d_model, e.d_ff_expert
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for label, S in (("prefill", SEQ), ("decode", 1)):
        x = randn(BATCH, S, D)
        r = moe.moe_route(p["router"], x, cfg)
        G, g, K = r.idx.shape
        n = E * G * r.capacity
        xin = randn(E, n // E, D)
        used = torch.unique(r.idx[r.keep])
        route_ms = time_ms(lambda: moe.moe_route(p["router"], x, cfg))
        all_ms = time_ms(lambda: moe.expert_ffn(p, xin))
        some = lambda: moe.expert_ffn({k: w[used] for k, w in p.items()
                                       if k != "router"}, xin[used])
        some_ms = time_ms(some)
        ffn_ms = time_ms(lambda: moe.moe_ffn(p, x, cfg),
                         label=f"moe_ffn {v.name} {label}")
        b = bound(2 * (3 * E * D * F + 2 * n * D), 2 * 3 * n * D * F,
                  torch.bfloat16)
        if S > 1:
            q = randn(BATCH, S, H, hd).transpose(1, 2)
            k = randn(BATCH, S, KV, hd).transpose(1, 2)
            att = ("K2", time_ms(lambda: ops.flash_attention(q, k, k)))
        else:
            C = SEQ + 16
            q = randn(BATCH, KV, H // KV, hd)
            k = randn(BATCH, C, KV, hd).permute(0, 2, 1, 3)
            pos = torch.full((BATCH,), SEQ, dtype=torch.int32, device="cuda")
            att = ("K3", time_ms(lambda: ops.decode_attention(q, k, k, pos)))
        log(f"[moe] {v.name} layer 0 {label}: T={BATCH * S} tokens, "
            f"G={G} group(s) of {g}, capacity {r.capacity}, {n // E} slots "
            f"an expert, {used.numel()} of {E} experts hold a token; "
            f"route {route_ms:.5g} ms; expert products over all {E} "
            f"experts (library ms: 3 torch.bmm) {all_ms:.5g} ms, bound "
            f"{b[0]:.4g} ms ({b[1]}); over the {used.numel()} used experts "
            f"with their weights gathered {some_ms:.5g} ms; moe_ffn "
            f"{ffn_ms:.5g} ms; the layer's {att[0]} {att[1]:.5g} ms")
    log_timing()


def batcher_phase(gen) -> dict:
    """The continuous batcher (``ContinuousBatcher``) over BATCHER's
    config at full width in float32: its requests submitted at once and
    run to completion, with the launch counters zeroed just before and
    read just after (prefill attention per attention layer and request,
    decode attention per attention layer and batched step).  Each
    request's prefill and per-step logits are then held to BATCHER_RTOL
    of their max |logit| against the request run alone (batch 1, the
    kernel path, teacher-forced on the batched run's tokens).  Returns
    the launch counts of the batched run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.batcher import ContinuousBatcher, GenRequest

    t0 = time.perf_counter()
    arch = BATCHER["arch"]
    cfg = get_config(arch)
    check_published(arch, cfg)
    release()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, gen, torch.float32)
    eng = ContinuousBatcher(cfg, params, max_slots=BATCHER["slots"],
                            cache_len=BATCHER["cache_len"],
                            dtype=torch.float32, model_name=arch)
    rng = np.random.default_rng(7)
    reqs = [GenRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, n,
                                                  dtype=np.int32),
                       max_new=m)
            for i, (n, m) in enumerate(zip(BATCHER["prompts"],
                                           BATCHER["max_new"]))]

    # record each request's logits: its prefill's (admission is FIFO, so
    # the i-th prefill is request i's) and each batched step's row
    first, steps, inserted = [], [], []
    prefill, decode, insert = eng._prefill, eng._decode, eng._insert_slot

    def recording_prefill(tokens):
        cache, logits = prefill(tokens)
        first.append(logits[0].clone())
        return cache, logits

    def recording_decode(tokens, pos):
        logits = decode(tokens, pos)
        steps.append({r.rid: logits[s].clone()
                      for s, r in enumerate(eng.slots) if r is not None})
        return logits

    def recording_insert(slot, req):
        inserted.append(slot)
        return insert(slot, req)

    eng._prefill, eng._decode = recording_prefill, recording_decode
    eng._insert_slot = recording_insert
    for r in reqs:
        eng.submit(r)
    telemetry = eng.telemetry()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()
    n_attn = sum(k in ("attn", "local") for k in cfg.block_kinds)
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = n_attn * len(reqs)
    want["decode_attention"] = n_attn * eng.n_steps
    log(f"[batcher {arch}] launches " + json.dumps(counts))
    if counts != want:
        raise AssertionError(f"batcher launches {counts} != {want}")
    n_tok = sum(len(r.generated) for r in reqs)
    reuses = len(inserted) - len(set(inserted))
    log(f"[batcher {arch}] {len(reqs)} requests (prompts "
        f"{list(BATCHER['prompts'])}, max_new {list(BATCHER['max_new'])}) "
        f"on {eng.max_slots} slots of {eng.cache_len}: {eng.n_steps} "
        f"batched steps, {reuses} slot reuses (slots in order "
        f"{inserted}), {n_tok} tokens in {wall * 1e3:.1f} ms "
        f"({n_tok / wall:.1f} tokens/s, prefills included); telemetry "
        f"at submission {json.dumps(telemetry)}, after "
        f"{json.dumps(eng.telemetry())}")
    if not all(r.done and len(r.generated) == r.max_new for r in reqs) \
            or reuses < 1:
        raise AssertionError("batcher run did not finish every request "
                             "or reuse a slot")

    # each request alone, teacher-forced on the batched run's tokens
    worst, agree, total = 0.0, 0, 0
    with torch.inference_mode():
        for r in reqs:
            tok = torch.as_tensor(r.prompt[None, :], device="cuda")
            cache, logits = M.prefill(cfg, params, {"tokens": tok},
                                      eng.cache_len)
            alone = [logits[0]]
            batched = [first[r.rid]] + [s[r.rid] for s in steps
                                        if r.rid in s]
            if len(batched) != len(r.generated):
                raise AssertionError(f"batcher request {r.rid}: "
                                     f"{len(batched)} logit rows for "
                                     f"{len(r.generated)} tokens")
            pos = torch.full((1,), len(r.prompt), dtype=torch.int32,
                             device="cuda")
            for j, t in enumerate(r.generated[:-1]):
                logits, cache = M.decode_step(
                    cfg, params, cache,
                    torch.tensor([t], dtype=torch.int32, device="cuda"),
                    pos + j)
                alone.append(logits[0])
            a = torch.stack(alone)[:, :cfg.vocab_size]
            b = torch.stack(batched)[:, :cfg.vocab_size]
            if not torch.isfinite(b).all():
                raise AssertionError(f"batcher request {r.rid}: logits "
                                     "are not finite")
            err = float((a - b).abs().max()) / float(a.abs().max())
            worst = max(worst, err)
            agree += int((a.argmax(-1).cpu()
                          == torch.tensor(r.generated)).sum())
            total += len(r.generated)
            if err > BATCHER_RTOL:
                raise AssertionError(
                    f"batcher request {r.rid} (prompt {len(r.prompt)}): "
                    f"logits differ from the request alone by {err} of "
                    f"max |logit| > {BATCHER_RTOL}")
    log(f"[batcher {arch}] each request alone (batch 1, teacher-forced): "
        f"worst logit err {worst:.3g} of max |logit| (tol {BATCHER_RTOL}), "
        f"greedy agreement {agree}/{total}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
        f"{time.perf_counter() - t0:.1f}s")
    return counts


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


class Recorder:
    """Stands in for a kernel wrapper on its module for one run: passes
    every call through, and keeps the operands and outputs (copied) of
    the first ``keep`` calls.  Its ``launches`` is the wrapper's own
    count, so the wrapper's ``+= 1`` at its launch lands on the wrapper.
    ``check(args)`` runs on every call before the wrapper does."""

    def __init__(self, module, name, keep, check=None):
        self.module, self.name, self.keep, self.check = module, name, keep, \
            check
        self.wrapper = getattr(module, name)
        self.calls, self.n_calls = [], 0

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, value):
        self.wrapper.launches = value

    def __call__(self, *args, **kw):
        if self.check is not None:
            self.check(args)
        self.n_calls += 1
        out = self.wrapper(*args, **kw)
        if len(self.calls) < self.keep:
            clone = lambda x: x.clone() if torch.is_tensor(x) else x
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((tuple(clone(a) for a in args), dict(kw),
                               tuple(clone(o) for o in outs)))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapper)


def captured_call(module, name, fn) -> tuple:
    """Run ``fn`` with ``module.name`` recording the operands of each
    call to it (the wrapper still runs); returns the (args, kwargs) of
    the one call ``fn`` made.  Its launch counts on the wrapper, outside
    any counted run."""
    with Recorder(module, name, 1) as rec:
        fn()
    if rec.n_calls != 1:
        raise AssertionError(f"{name} was called {rec.n_calls} times")
    return rec.calls[0][:2]


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
    counts of the counted runs and the rows of K1 and B3 (B2's row is
    taken on the engine's first burst: ``engine_fused_times``)."""
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
    extra(f"fused_select on select_batch's operands B={Bf} n={n}",
          time_ms(lambda: ops.fused_select(*f, **fkw),
                  label="fused_select select_batch"),
          time_ms(lambda: ref.fused_select_ref(*f, **fkw)),
          fused_bound(Bf, n))
    log(f"[select] fused_select on the main path's operands B={Bf} n={n}: "
        "picks equal to its plain version's (its row: the engine's "
        "first batched_snapshot burst)")

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
    b = charged_bound(c, ckw, got)
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
        f"{ms / Bc * 1e3:.4g} us per request; chain bound "
        f"{charged_chain(Bc, n)[1]:.4g} ms")
    return total, rows


# The engine phase: the reference engine benchmark's constants
# (``benchmarks/engine_throughput.py``), copied here.
ENGINE_N, ENGINE_SLA_MS, ENGINE_SEED = 100_000, 250.0, 3
BURST, BURST_EVERY_MS = 200, 400.0
REPLAYED = 20           # recorded launches of each kernel held exactly
# The burst ``faulty`` scenario: 100 bursts one second apart; the
# registered faults plus r1 and r2 down from 30.5 s to 32.5 s, so that
# every replica is down for two bursts.
FAULTY_BURSTS, FAULTY_EVERY_MS = 100, 1000.0


def burst_times(n_bursts, every_ms):
    return np.repeat(np.arange(n_bursts) * every_ms, BURST)


def batched_engine(backend, charge=True):
    """The reference benchmark's ``batched`` (``batched_snapshot`` with
    ``charge=False``) configuration: Table 2's 11 models over 4
    replicas each, queue-aware, a zero-jitter 50 ms uplink."""
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.zoo import TABLE2
    from repro_torch.sim import ServingSimulator, per_model_replicas
    return ServingSimulator(
        TABLE2, NetworkModel(50.0, 0.0),
        per_model_replicas(TABLE2, replicas_per_model=4), seed=ENGINE_SEED,
        queue_aware=True, backend=backend, charge_batches=charge)


def faulty_burst_scenario():
    """The registered ``faulty`` scenario with 200-wide simultaneous
    bursts (a trace over a zero-jitter uplink, so that each burst is one
    Router batch), the selection on the card, and every replica down for
    two bursts; its SLA-aware admission is the registered one."""
    import dataclasses
    from repro_torch.scenario import get_scenario
    from repro_torch.scenario.spec import FaultSpec
    sc = get_scenario("faulty")
    dep = sc.deployment
    down = tuple(FaultSpec(kind=k, replica=r, at_ms=t)
                 for r in ("r1", "r2")
                 for k, t in (("kill", 30_500.0), ("recover", 32_500.0)))
    return dataclasses.replace(
        sc, name="faulty_burst",
        workload=dataclasses.replace(
            sc.workload, arrival="trace",
            times_ms=tuple(burst_times(FAULTY_BURSTS,
                                       FAULTY_EVERY_MS).tolist())),
        network=dataclasses.replace(sc.network, std_ms=0.0),
        deployment=dataclasses.replace(
            dep, faults=tuple(sorted(dep.faults + down,
                                     key=lambda f: f.at_ms))),
        policy=dataclasses.replace(sc.policy, backend="cuda"))


def engine_run(label, backend, kernel, run, router_of):
    """Drive one engine run with the launch counters zeroed just before
    and read just after.  Counts the Router's multi-request batches and
    its host time in them, the device pool's uploads, and, on the card,
    records the kernel in use (``kernel``): every call must select on
    the current profiles (a charged pass on the store's table as it
    stands; a fused pick on a pool uploaded for that burst).  Returns
    (summary, stats, the recorder)."""
    from repro_torch.kernels import ops, policy_select
    from repro_torch.router import Router

    stats = dict(multi=0, route_s=0.0, uploads=0, upload_s=0.0, stale=0)
    uploaded = {}                      # id(pool.mu) → (upload no., mu)
    last = [0]
    orig_route, orig_pool = Router.route_batch_arrays, policy_select.DevicePool

    def route(self, t_sla_ms, *a, **kw):
        t0 = time.perf_counter()
        out = orig_route(self, t_sla_ms, *a, **kw)
        if len(t_sla_ms) > 1:
            stats["multi"] += 1
            stats["route_s"] += time.perf_counter() - t0
        return out

    def pool(mu, *a, **kw):
        t0 = time.perf_counter()
        out = orig_pool(mu, *a, **kw)
        stats["uploads"] += 1
        stats["upload_s"] += time.perf_counter() - t0
        uploaded[id(out.mu)] = (stats["uploads"], np.float32(mu))
        return out

    def current(args):
        no, mu = uploaded[id(args[0])]
        if kernel == "charged_select":
            ok = np.array_equal(mu, np.float32(router_of().store.table().mu))
        else:
            ok = no > last[0]
        last[0] = no
        stats["stale"] += not ok

    rec = Recorder(policy_select, kernel, REPLAYED,
                   current if backend == "cuda" else None)
    Router.route_batch_arrays, policy_select.DevicePool = route, pool
    ops.reset_launch_counts()
    with rec:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    Router.route_batch_arrays, policy_select.DevicePool = orig_route, \
        orig_pool
    counts = ops.launch_counts()
    r = res.result if hasattr(res, "epochs") else res
    n_batches = (res.epochs[-1].router_stats if hasattr(res, "epochs")
                 else router_of().stats())["n_batches"]
    n = r.n_arrived
    events = 4 * r.n_completed + 2 * r.n_rejected
    multi = max(stats["multi"], 1)
    log(f"[engine {label} {backend}] requests/s={n / wall:.6g} "
        f"events/s={events / wall:.6g} wall_s={wall:.4g} n={n} "
        f"sla_attainment={r.sla_attainment:.6g} "
        f"mean_accuracy={r.mean_accuracy:.6g} shed={r.n_rejected} "
        f"n_batches={n_batches} multi_request_batches={stats['multi']} "
        f"launches={counts[kernel]} "
        f"host_us_per_burst={stats['route_s'] / multi * 1e6:.5g} "
        f"pool_uploads={stats['uploads']} "
        f"upload_us_per_burst={stats['upload_s'] / multi * 1e6:.5g} "
        f"stale_pool_bursts={stats['stale']}")
    want = {k: 0 for k in counts}
    if backend == "cuda":
        want[kernel] = stats["multi"]
    if counts != want:
        raise AssertionError(f"engine {label} {backend}: launches {counts}, "
                             f"want one {kernel} per multi-request batch: "
                             f"{want}")
    if stats["stale"]:
        raise AssertionError(f"engine {label} {backend}: {stats['stale']} "
                             "bursts selected on a stale device pool")
    if not (n > 0 and np.isfinite(r.sla_attainment)
            and np.isfinite(r.mean_accuracy)):
        raise AssertionError(f"engine {label} {backend}: bad summary {r}")
    return r, dict(stats, launches=counts[kernel], wall=wall), rec


def replay(label, kernel, rec, ref, tag="engine") -> None:
    """The first recorded launches of ``kernel``, each replayed through
    its plain version on the same operands: every output equal."""
    plain = {"charged_select": ref.charged_select_ref,
             "fused_select": ref.fused_select_ref,
             "stacked_select": ref.stacked_select_ref}[kernel]
    if not rec.calls:
        raise AssertionError(f"engine {label}: no {kernel} call recorded")
    for i, (args, kw, outs) in enumerate(rec.calls):
        want = plain(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for j, (g, w) in enumerate(zip(outs, want)):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"engine {label}: {kernel} launch {i} "
                                     f"output {j} differs from the plain "
                                     "version's")
    a = rec.calls[0][0]
    if kernel == "charged_select":
        shape = f"B={a[8].shape[0]} n={a[0].shape[0]} R={a[6].shape[0]}"
    elif kernel == "fused_select":
        shape = f"B={a[4].shape[0]} n={a[0].shape[0]}"
    else:
        shape = (f"B={a[4].shape[0]} pool rows {a[0].shape[0]} "
                 f"n={a[0].shape[1]}")
    log(f"[{tag} {label}] first {len(rec.calls)} {kernel} launches "
        f"({shape}) replayed through the plain version: every output equal")


def engine_phase(ops, ref) -> dict:
    """The port's discrete-event engine on the card, at the size the
    reference's engine benchmark calls routine: ``batched`` (100,000
    requests in 200-wide bursts, one charged pass a burst) on ``cuda``
    and on numpy, ``batched_snapshot`` (one fused selection a burst) on
    ``cuda``, and the burst ``faulty`` scenario through
    ``scenario.build(sc).run()`` on ``cuda``.  Returns the launches of
    the counted runs and B2's row, timed on the first
    ``batched_snapshot`` burst."""
    from repro_torch.core.policy import ModiPick
    from repro_torch.scenario import build
    from repro_torch.sim import TraceArrivals

    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.launch_counts(), 0)
    times = burst_times(-(-ENGINE_N // BURST), BURST_EVERY_MS)[:ENGINE_N]

    def batched(backend, charge):
        eng = batched_engine(backend, charge)
        run = lambda: eng.run(ModiPick(t_threshold=20.0), ENGINE_SLA_MS,
                              ENGINE_N, arrivals=TraceArrivals(times))
        return run, lambda: eng.router

    results = {}
    for label, backend, charge, kernel in (
            ("batched", "cuda", True, "charged_select"),
            ("batched", "numpy", True, "charged_select"),
            ("batched_snapshot", "cuda", False, "fused_select")):
        run, router_of = batched(backend, charge)
        r, st, rec = engine_run(label, backend, kernel, run, router_of)
        results[label, backend] = (r, st)
        if backend == "cuda":
            replay(label, kernel, rec, ref)
            total[kernel] += st["launches"]
        if (label, backend) == ("batched_snapshot", "cuda"):
            fused_row = engine_fused_times(ops, ref, rec)
        if (label, backend) == ("batched", "cuda"):
            ms = engine_kernel_times(ops, ref, rec)
            busy = st["launches"] * ms / 1e3
            log(f"[engine] batched cuda: the card busy about {busy:.4g} s "
                f"of the run's {st['wall']:.4g} s (launches x the kernel's "
                f"ms on the first burst), idle share about "
                f"{1 - busy / st['wall']:.3f}")
    if results["batched", "cuda"][0].sla_attainment < 0.5:
        raise AssertionError("charged batched engine attains "
                             f"{results['batched', 'cuda'][0].sla_attainment}"
                             " < 0.5: intra-batch charging regressed")
    cuda_s, numpy_s = (results["batched", b][1]["wall"]
                       for b in ("cuda", "numpy"))
    log(f"[engine] batched: the card's run takes {cuda_s:.4g} s, numpy's "
        f"{numpy_s:.4g} s ({numpy_s / cuda_s:.3g}x)")

    harness = build(faulty_burst_scenario())
    engines, make = [], harness.engine

    def engine(*a, **kw):
        engines.append(make(*a, **kw))
        return engines[-1]

    harness.engine = engine
    r, st, rec = engine_run("faulty_burst", "cuda", "charged_select",
                            harness.run, lambda: engines[-1].router)
    replay("faulty_burst", "charged_select", rec, ref)
    if not st["launches"] > 0:
        raise AssertionError("the faulty burst scenario launched no kernel")
    total["charged_select"] += st["launches"]
    log(f"[engine] phase {time.perf_counter() - t_phase:.1f}s")
    return total, fused_row


def launch_floor(tag) -> float:
    """The card's launch floor: one empty kernel
    (``torch.cuda._sleep(0)``) a call through ``time_ms``, device ms a
    call; logged as a ``[floor]`` line."""
    ms = time_ms(lambda: torch.cuda._sleep(0), label=f"launch floor {tag}")
    log(f"[floor] {tag}: torch.cuda._sleep(0) {ms:.5g} ms a call (device "
        "time, the queue filled ahead)")
    return ms


def engine_fused_times(ops, ref, rec) -> dict:
    """B2's row: the fused selection on the first burst the engine's
    ``batched_snapshot`` run handed it (B = 200, n = 11), with µs a
    request and the launch floor beside it."""
    args, kw, _ = rec.calls[0]
    B, n = args[4].shape[0], args[0].shape[0]
    ms = time_ms(lambda: ops.fused_select(*args, **kw),
                 label="fused_select engine burst")
    plain_ms = time_ms(lambda: ref.fused_select_ref(*args, **kw))
    b = fused_bound(B, n)
    floor = launch_floor("engine")
    log(f"[engine] fused_select B={B} n={n}: ms={ms:.5g} = "
        f"{ms / B * 1e3:.4g} us per request; plain_ms={plain_ms:.5g}; "
        f"bound_ms={b[0]:.4g} ({b[1]}); {ms / floor:.3g}x the launch floor")
    return dict(name="fused_select", route="cuda",
                source="src/repro_torch/csrc/policy_select.cu",
                replaces="src/repro/kernels/policy_select.py:217",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=None)


def engine_kernel_times(ops, ref, rec) -> float:
    """The charged pass on the first burst the engine handed it (B =
    200, n = 11, R = 44): its time and µs per request, the plain
    version's, and the bound.  Returns the kernel's ms."""
    args, kw, outs = rec.calls[0]
    B, n, R = args[8].shape[0], args[0].shape[0], args[6].shape[0]
    ms = time_ms(lambda: ops.charged_select(*args, **kw), iters=50)
    t0 = time.perf_counter()
    ref.charged_select_ref(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b = charged_bound(args, kw, outs)
    cycles, chain_ms = charged_chain(B, n)
    log(f"[engine] charged_select B={B} n={n} R={R}: ms={ms:.5g} = "
        f"{ms / B * 1e3:.4g} us per request; plain_ms={plain_ms:.5g} "
        f"(host-timed, once); bound_ms={b[0]:.4g} ({b[1]}); chain bound "
        f"{chain_ms:.4g} ms ({cycles} cycles a request)")
    return ms


# The stacked selection's synthetic cases: (form, pool rows, n, B (a
# cell's B in the fleet form), queue shifts).  The last three are the
# main path's shapes: a premodel burst (K = 2 classes of Table 2's 11
# models), fleet_diurnal's epoch (6 cells of 5 models) and
# fleet_steady's (4 cells of 11).
STACKED_CASES = {"classed K=1": ("classed", 1, 11, 200, True),
                 "classed K=8": ("classed", 8, 3, 97, True),
                 "classed B=1": ("classed", 2, 11, 1, True),
                 "classed no shifts": ("classed", 2, 11, 97, False),
                 "fleet B=1": ("fleet", 2, 4, 1, False),
                 "fleet B=97": ("fleet", 3, 11, 97, False),
                 "classed K=2 B=200": ("classed", 2, 11, 200, True),
                 "fleet C=6 npad=5 B=2550": ("fleet", 6, 5, 2550, False),
                 "fleet C=4 npad=11 B=1200": ("fleet", 4, 11, 1200, False)}
# Pools wider than 128 models, checked and not timed: the lanes' state
# in shared memory, in the classed form and in a fleet of padded cells.
WIDE_STACKED = {"classed n=129": ("classed", 3, 129, 500, True),
                "classed n=200 no shifts": ("classed", 2, 200, 300, False),
                "fleet n=1000": ("fleet", 3, 1000, 100, False)}
PREMODEL_BURSTS, PREMODEL_EVERY_MS = 20, 2000.0


def stacked_inputs(policy_select, gen, form, P, n, B, shifts, seed):
    """The stacked kernel's operands on the card.  ``classed``: P class
    rows of mu/sigma over one shared acc/rank, a random class a request;
    ``fleet``: P cells of B requests each, acc/rank a row each, every
    cell but the first narrower than n, its padded lanes at
    PAD_MU/0/1/PAD_RANK.  The first 2% of the requests have no base, the
    next 3% a negative mass (uniform over their eligible models)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(5.0, 60.0, (P, n))
    sig = rng.uniform(0.0, 5.0, (P, n))
    if form == "classed":
        acc = rng.uniform(0.3, 0.9, n)
        rank = np.argsort(np.argsort(-acc, kind="stable"))
        row = rng.integers(0, P, B)
    else:
        acc = rng.uniform(0.3, 0.9, (P, n))
        rank = np.argsort(np.argsort(-acc, kind="stable", axis=1), axis=1)
        for c, w in enumerate(rng.integers(1, n + 1, P)):
            w = n if c == 0 else w
            mu[c, w:], sig[c, w:] = policy_select.PAD_MU, 0.0
            acc[c, w:], rank[c, w:] = 1.0, policy_select.PAD_RANK
        row = np.repeat(np.arange(P), B)
        B = P * B
    t_u = rng.uniform(-5.0, 120.0, B)
    t_u[: B // 50] = float(mu.min()) - 50.0
    t_l = t_u - THRESHOLD_MS
    t_l[B // 50: B // 20] = t_u[B // 50: B // 20] + 40.0

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device="cuda")

    args = (f32(mu), f32(sig), f32(acc), f32(rank),
            torch.tensor(row, dtype=torch.int32, device="cuda"), f32(t_u),
            f32(t_l), torch.rand(B, generator=gen, device="cuda"))
    kw = dict(shifts=f32(rng.uniform(0.0, 20.0, n)) if shifts else None,
              fallback=form == "classed")
    return args, kw


def stacked_bound(args, kw) -> tuple:
    """The stacked selection (``kernels/cost.py``): the pool rows (mu,
    sigma, acc, rank, the shifts) and per request its row, bounds and
    uniform read once, its pick and flag written; ~20 fp32 operations a
    (request, model)."""
    from repro_torch.kernels import cost
    return cost.bound(cost.stacked_select(args[0], args[2], args[4],
                                          kw.get("shifts")))


def stacked_kernels(ops, ref, policy_select, gen) -> None:
    """B4 against its plain version on synthetic operands (picks and
    has_base equal at gamma 1), each case of ``STACKED_CASES`` timed as
    an ``[extra]`` line, those of ``WIDE_STACKED`` not."""
    cases = {**STACKED_CASES, **WIDE_STACKED}
    for i, (case, spec) in enumerate(cases.items()):
        args, kw = stacked_inputs(policy_select, gen, *spec, seed=i)
        got = ops.stacked_select(*args, **kw)
        want = ref.stacked_select_ref(*args, **kw)
        for what, g, w in zip(("picks", "has_base"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"stacked_select {case}: {what} "
                                     "differs from the plain version's")
        B = args[4].shape[0]
        if B > 50 and (got[1].all() or not got[1].any()):
            raise AssertionError(f"stacked_select {case}: the case must "
                                 "have rows with a base and rows without")
        log(f"B4 stacked_select {case}: picks and has_base equal to the "
            f"plain version's ({int((~got[1]).sum())} of {B} rows with no "
            "base)")
        if case in WIDE_STACKED:
            continue
        extra(f"stacked_select {case}",
              time_ms(lambda: ops.stacked_select(*args, **kw)),
              time_ms(lambda: ref.stacked_select_ref(*args, **kw), iters=10),
              stacked_bound(args, kw))


def premodel_bursts_scenario():
    """The registered ``premodel_mix`` as 20 simultaneous bursts of 200
    over a zero-jitter uplink (every burst one classed Router batch),
    the selection on the card."""
    import dataclasses
    from repro_torch.scenario import get_scenario
    sc = get_scenario("premodel_mix")
    times = np.repeat(np.arange(PREMODEL_BURSTS) * PREMODEL_EVERY_MS, BURST)
    return dataclasses.replace(
        sc, name="premodel_bursts",
        workload=dataclasses.replace(sc.workload, arrival="trace",
                                     n_requests=len(times),
                                     times_ms=tuple(times.tolist())),
        network=dataclasses.replace(sc.network, std_ms=0.0),
        policy=dataclasses.replace(sc.policy, backend="cuda"))


def on_backend(sc, backend):
    import dataclasses
    return dataclasses.replace(sc, policy=dataclasses.replace(
        sc.policy, backend=backend))


def stacked_phase(ops, ref, policy_select, gen) -> tuple:
    """Premodel and the fleet through B4 (phase 6): the synthetic cases,
    then the three counted runs, each required to launch
    ``stacked_select`` exactly once a multi-request burst (premodel) or
    an epoch with pending requests (fleet) and nothing else, its first
    launches replayed through the plain version, and its result equal
    to the same run on ``cpu`` on the card's uniforms.  Returns the
    launches of the counted runs and the kernel's row, timed on the
    first premodel burst's operands."""
    from repro_torch.scenario import build, get_scenario
    t_phase = time.perf_counter()
    stacked_kernels(ops, ref, policy_select, gen)
    card_uniforms = policy_select.uniforms
    runs = (("premodel_mix bursts", premodel_bursts_scenario()),
            ("fleet_steady", on_backend(get_scenario("fleet_steady"),
                                        "cuda")),
            ("fleet_diurnal", on_backend(get_scenario("fleet_diurnal"),
                                         "cuda")))
    launches, first = 0, {}
    for label, sc in runs:
        rec = Recorder(policy_select, "stacked_select", REPLAYED)
        ops.reset_launch_counts()
        with rec:
            t0 = time.perf_counter()
            res = build(sc).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        fleet = res.fleet
        calls = PREMODEL_BURSTS if fleet is None else len(fleet.epochs)
        if counts != {k: calls * (k == "stacked_select") for k in counts}:
            raise AssertionError(f"{label}: launches {counts}, want "
                                 f"{calls} stacked_select and nothing else")
        replay(label, "stacked_select", rec, ref, tag="stacked")
        policy_select.uniforms = (lambda seed, n, device:
                                  card_uniforms(seed, n, "cuda").to(device))
        t0 = time.perf_counter()
        plain = build(on_backend(sc, "cpu")).run()
        cpu_wall = time.perf_counter() - t0
        policy_select.uniforms = card_uniforms
        keys = ("sla_attainment", "mean_accuracy", "mean_latency")
        got = {k: getattr(res, k) for k in keys}
        want = {k: getattr(plain, k) for k in keys}
        if fleet is not None:
            got.update(spill_rate=fleet.spill_rate, locality=fleet.locality)
            want.update(spill_rate=plain.fleet.spill_rate,
                        locality=plain.fleet.locality)
        if got != want or not all(np.isfinite(v) for v in got.values()):
            raise AssertionError(f"{label}: the card's run {got} differs "
                                 f"from the plain version's {want}")
        log(f"[stacked {label}] cuda: " + " ".join(
            f"{k}={v:.6g}" for k, v in got.items())
            + f" n={res.result.n_arrived if fleet is None else fleet.n_arrived}"
            f" launches={counts['stacked_select']} wall_s={wall:.4g}; "
            f"cpu (plain version, the card's uniforms): the same, "
            f"wall_s={cpu_wall:.4g}")
        launches += counts["stacked_select"]
        first[label] = rec.calls[0][:2]
    if not res.fleet.n_spilled > 0:          # res: the fleet_diurnal run
        raise AssertionError("fleet_diurnal spilled no request")
    for label in ("fleet_steady", "fleet_diurnal"):
        a, kw = first[label]
        extra(f"stacked_select {label} first epoch pool rows "
              f"{a[0].shape[0]} n={a[0].shape[1]} B={a[4].shape[0]}",
              time_ms(lambda: ops.stacked_select(*a, **kw)),
              time_ms(lambda: ref.stacked_select_ref(*a, **kw), iters=10),
              stacked_bound(a, kw))
    a, kw = first["premodel_mix bursts"]
    b = stacked_bound(a, kw)
    row = dict(
        name="stacked_select", route="cuda",
        source="src/repro_torch/csrc/policy_select.cu",
        replaces="src/repro/kernels/policy_select.py:403", max_abs_err=0.0,
        ms=time_ms(lambda: ops.stacked_select(*a, **kw),
                   label="stacked_select kernel"),
        plain_ms=time_ms(lambda: ref.stacked_select_ref(*a, **kw)),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    floor = launch_floor("stacked")
    log(f"[stacked] row timed on the first premodel burst's operands: "
        f"B={a[4].shape[0]} classes={a[0].shape[0]} n={a[0].shape[1]}: "
        f"{row['ms'] / floor:.3g}x the launch floor")
    log_timing()
    log(f"[stacked] phase {time.perf_counter() - t_phase:.1f}s")
    return launches, row


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
    bwd_ptxas(build.BUILD_LOGS)

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
    _, counts = serve_family(INT8_ARCH, gen, tokens, kv_cache_dtype="int8")
    for name, c in counts.items():
        launches[name] += c

    # 3b. the encoder-decoder and the VLM through models/api.py
    for arch in MODEL_PHASES:
        for name, c in model_phase(arch, gen).items():
            launches[name] += c

    # 4. the continuous batcher
    for name, c in batcher_phase(gen).items():
        launches[name] += c
    release()

    # 4b. training at full width: forward and backward kernels
    for arch in TRAIN:
        for name, c in train_phase(arch, ops).items():
            launches[name] += c

    # 4c. the mesh tooling: the dry-run, the sharded wrappers, the fleet
    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    randn.gen = gen
    for name, c in mesh_phase(ops, randn).items():
        launches[name] += c

    # 5. the batched selection entry points on the executor's store
    counts, selection_rows = main_selection(ex, ops, ref, policy_select)
    log_timing()
    rows.update(selection_rows)
    for name, c in counts.items():
        launches[name] += c
    for name, row in rows.items():
        row["launches"] = launches[name]
        if not row["launches"] > 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # 6. the discrete-event engine's bursts through the selection kernels
    counts, rows["fused_select"] = engine_phase(ops, ref)
    for name, c in counts.items():
        launches[name] += c
    for name, row in rows.items():
        row["launches"] = launches[name]

    # 7. premodel and the fleet through the stacked selection kernel
    n, rows["stacked_select"] = stacked_phase(ops, ref, policy_select, gen)
    launches["stacked_select"] += n
    for name, row in rows.items():
        row["launches"] = launches[name]
        if not row["launches"] > 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # 8. timings for the record
    perf_selection(ex)
    crossover(ex)

    for row in rows.values():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if row[key] is not None and not row[key] > 0:
                raise AssertionError(f"{row['name']}: bad {key} {row[key]}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    order = ("flash_attention", "decode_attention", "decode_attention_int8",
             "ssd_scan", "rglru_scan", "modipick_probs", "fused_select",
             "charged_select", "stacked_select", "flash_attention_bwd",
             "rglru_scan_bwd", "ssd_scan_bwd")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: rows[n][k] for k in keys}
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
