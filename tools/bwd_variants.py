#!/usr/bin/env python3
"""Time variants of the backward kernels on the card, each built from a
copy of its source with one choice changed, in turns.

    python3 tools/bwd_variants.py

K2-bwd (``csrc/flash_attention.cu``) in fp32 at qwen2-1.5b's training
shape (B 4, H 12, KV 2, S 1024, hd 128, causal) and at
recurrentgemma-2b's (B 2, H 10, KV 1, S 1024, hd 256, window 2048):

- ``as built``: the source as it is;
- ``partial every k-step`` / ``no partials``: a score product's
  tensor-core partial added to the fp32 sum every k-step, or the whole
  product summed on the tensor core (``kSsChunk``);
- ``cvt split``: each operand split with two ``cvt.rna.tf32.f32``
  instead of by its bits (``split_tf32``).

Each variant patches one regex match of the source (a constant's
definition, or ``split_tf32``'s body) and fails if it matches other
than once.  Each is held against the plain version (max error relative to
max(max |want|, 1)) and timed twice, in turns and then in reverse.

K5-bwd (``csrc/rglru_scan.cu``) at B 2, S 1024 and 4096, W 2560, fp32,
with 8, 12 or 16 steps a thread (``kBwdR``) at two blocks an SM, and 16
steps at one (``__launch_bounds__``), the chunk plan following the
steps as ``rglru_scan.bwd_plan`` does.

The variants are built under ``build/variants/`` (git ignores
``build/``) with the flags of ``kernels/build.py``, one ``nvcc`` each,
all started together.  Prints one line a measurement, then the card's
name and power limit.
"""
from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402

OUT = ROOT / "build" / "variants"
SPLIT_BITS = (r"  big = \(__float_as_uint\(x\) \+ 0x1000u\) & 0xffffe000u;\n"
              r"  small = __float_as_uint\(x - __uint_as_float\(big\)\);")
SPLIT_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));
  const float r = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(r));"""
CHUNK = r"constexpr int kSsChunk = \d+;"
STEPS = r"constexpr int kBwdR = (\d+);"
BOUNDS = r"__launch_bounds__\(kCh \* kBwdSeg, \d+\)"


def patch(text: str, pattern: str, repl: str) -> str:
    """text with the one match of the regex ``pattern`` replaced by
    ``repl`` (taken literally); raises if it does not match once."""
    out, n = re.subn(pattern, lambda _: repl, text)
    if n != 1:
        raise RuntimeError(f"{pattern!r} matches {n} times, not once")
    return out


def variants():
    """name → (library, patched source text, steps a K5 thread)."""
    fa_src = (build.CSRC / "flash_attention.cu").read_text()
    rs_src = (build.CSRC / "rglru_scan.cu").read_text()
    steps = int(re.search(STEPS, rs_src).group(1))
    k5_16 = patch(rs_src, STEPS, "constexpr int kBwdR = 16;")
    return {
        "K2 as built": ("flash_attention", fa_src, None),
        "K2 partial every k-step": (
            "flash_attention", patch(fa_src, CHUNK, "constexpr int kSsChunk = 1;"), None),
        "K2 no partials": (
            "flash_attention", patch(fa_src, CHUNK, "constexpr int kSsChunk = 1 << 20;"), None),
        "K2 cvt split": ("flash_attention", patch(fa_src, SPLIT_BITS, SPLIT_CVT), None),
        "K5 8 steps": ("rglru_scan", patch(rs_src, STEPS, "constexpr int kBwdR = 8;"), 8),
        f"K5 {steps} steps (as built)": ("rglru_scan", rs_src, steps),
        "K5 16 steps": ("rglru_scan", k5_16, 16),
        "K5 16 steps, one block an SM": (
            "rglru_scan", patch(k5_16, BOUNDS, "__launch_bounds__(kCh * kBwdSeg, 1)"), 16),
    }


def build_all(vs):
    """Build every variant (in parallel); name → (library, its C entry
    point, steps)."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (lib, text, steps) in vs.items():
        tag = re.sub(r"\W+", "_", name)
        src = OUT / f"{tag}.cu"
        src.write_text(text)
        so = OUT / f"{tag}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        jobs.append((name, lib, steps, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, lib, steps, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        sym = f"{lib}_bwd"
        fn = getattr(ctypes.CDLL(str(so)), sym)
        fn.argtypes = (fa if lib == "flash_attention" else rs)._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = (lib, fn, steps)
    return fns


@contextlib.contextmanager
def use(fns, name):
    """Within the block, the backward wrapper of ``name``'s kernel
    launches that variant: its entry point in ``build``'s function
    cache, and K5-bwd's plan (``rglru_scan.bwd_plan``) at its steps a
    thread.  Both are restored on leaving it."""
    lib, fn, steps = fns[name]
    key = (lib, f"{lib}_bwd")
    saved = build._FUNCS.get(key), rs.BWD_STEPS
    build._FUNCS[key] = fn
    if steps is not None:
        rs.BWD_STEPS = steps
    try:
        yield
    finally:
        if saved[0] is None:
            build._FUNCS.pop(key, None)
        else:
            build._FUNCS[key] = saved[0]
        rs.BWD_STEPS = saved[1]


def scaled_err(got, want) -> float:
    """The worst of the outputs' max errors, each relative to
    max(max |want|, 1), as chip_smoke.py's ``check_scaled``."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1.0)
               for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    fns = build_all(variants())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for B, H, KV, S, hd, window in ((4, 12, 2, 1024, 128, 0),
                                    (2, 10, 1, 1024, 256, 2048)):
        q = randn(B, S, H, hd).transpose(1, 2)
        k = randn(B, S, KV, hd).transpose(1, 2)
        v = randn(B, S, KV, hd).transpose(1, 2)
        dout = randn(B, H, S, hd)
        with torch.no_grad():
            o, lse = fa._forward(q, k, v, True, window, with_lse=True)
        args, kw = (q, k, v, o, lse, dout), dict(causal=True, window=window)
        want = ref.flash_attention_bwd_ref(*args, **kw)
        names = [n for n in fns if n.startswith("K2")]
        for name in names:
            with use(fns, name):
                err = scaled_err(fa.flash_attention_bwd(*args, **kw), want)
            print(f"[err] {name} B={B} H={H} KV={KV} S={S} hd={hd}: "
                  f"{err:.3g}", flush=True)
        for order in (names, names[::-1]):
            for name in order:
                with use(fns, name):
                    ms = cs.time_ms(
                        lambda: fa.flash_attention_bwd(*args, **kw), iters=10)
                print(f"[time] {name} B={B} H={H} KV={KV} S={S} hd={hd} "
                      f"fp32: {ms:.4f} ms", flush=True)
        del q, k, v, o, lse, dout, want
    for S in (1024, 4096):
        a = torch.sigmoid(randn(2, S, 2560)) * 0.98
        h, dh = randn(2, S, 2560), randn(2, S, 2560)
        want = ref.rglru_scan_bwd_ref(a, h, dh)
        bound = 5 * 4 * a.numel() / cs.HBM_BYTES_PER_S * 1e3
        names = [n for n in fns if n.startswith("K5")]
        for name in names:
            with use(fns, name):
                err = scaled_err(rs.rglru_scan_bwd(a, h, dh), want)
            print(f"[err] {name} S={S}: {err:.3g}", flush=True)
        for order in (names, names[::-1]):
            for name in order:
                with use(fns, name):
                    ms = cs.time_ms(lambda: rs.rglru_scan_bwd(a, h, dh))
                print(f"[time] {name} B=2 S={S} W=2560 fp32: {ms:.5f} ms "
                      f"({ms / bound:.3f}× the byte bound {bound:.5f})",
                      flush=True)
        zero_ms = cs.time_ms(lambda: torch.zeros(
            rs.bwd_scratch_words(2, S, 2560), dtype=torch.int32, device="cuda"))
        print(f"[time] K5-bwd's scratch zeroing at S={S}: {zero_ms:.5f} ms",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
