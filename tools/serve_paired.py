#!/usr/bin/env python3
"""Time K2 and K5 (forward) at the serve shapes of ``chip_smoke.py``'s
kernels line (device ms, ``time_ms``), then serve qwen2-1.5b and
recurrentgemma-2b through its serve phase (``serve_family``: the pool at
widths 0.5 and 1.0 behind PoolExecutor → Router → ModiPick, held layer
by layer against the plain path, then each variant's warm prefill and
request timed) from several trees of the repository, in turns, on one
card.

    python3 tools/serve_paired.py <tree> [<tree> ...]

for example, with the parent unpacked under ``build/parent`` (``git
archive <parent> | tar -x -C build/parent``): ``build/parent . .
build/parent``.  Each tree runs in a process of its own from its own
root, so it builds and loads its own kernels.  Prints each tree's
``[kernel]``, ``[perf]`` and ``summary`` lines, prefixed with the tree,
then the card's name and power limit.
"""
import subprocess
import sys

CODE = r'''
import sys; sys.path.insert(0, "src"); sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
gen = torch.Generator(device="cuda"); gen.manual_seed(0)
tokens = np.random.default_rng(0).integers(0, 500, (cs.BATCH, cs.SEQ), dtype=np.int32)
from repro_torch.kernels import ops
r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
a, b = torch.sigmoid(r(cs.BATCH, cs.SEQ, 2560)) * 0.98, r(cs.BATCH, cs.SEQ, 2560) * 0.1
cs.log(f"[kernel] rglru_scan B={cs.BATCH} S={cs.SEQ} W=2560 fp32: "
       f"{cs.time_ms(lambda: ops.rglru_scan(a, b)):.5f} ms")
q = r(cs.BATCH, cs.SEQ, 12, 128).to(torch.bfloat16).transpose(1, 2)
k, v = (r(cs.BATCH, cs.SEQ, 2, 128).to(torch.bfloat16).transpose(1, 2) for _ in "kv")
cs.log(f"[kernel] flash_attention B={cs.BATCH} H=12 KV=2 S={cs.SEQ} hd=128 bf16: "
       f"{cs.time_ms(lambda: ops.flash_attention(q, k, v)):.5f} ms")
for arch in ("qwen2-1.5b", "recurrentgemma-2b"):
    cs.serve_family(arch, gen, tokens)
'''


def main(trees) -> int:
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(("[kernel]", "[perf]")) or "summary" in line:
                print(f"[{tree}] {line}", flush=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-3000:])
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
