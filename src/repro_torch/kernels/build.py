"""Build and load the hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled on its own by
``nvcc`` into a shared library with a plain C interface, and loaded with
``ctypes``.  A library's file name carries a digest of its source, the
headers of ``csrc/`` it includes and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Builds go to ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``); nothing is compiled when a module is
imported, only at a kernel's first launch or when :func:`build` is
called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from re import MULTILINE, compile as regex
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

from repro_torch import obs

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "ssd_scan_bwd",
           "rglru_scan", "policy_select", "adamw")
# --split-compile=0: nvcc optimizes a source's device functions on all of
# the host's cores (the SSD scan's backward, 37 instantiations, builds in
# half the time; ptxas reports the same registers and spills).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# nvcc's output for each library built by this process (``-Xptxas -v``
# lists every kernel's registers, shared memory and spills).
BUILD_LOGS: Dict[str, str] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


_INCLUDE = regex(rb'^#include "([^"]+)"', MULTILINE)


def _source_bytes(path: Path, seen=None) -> bytes:
    """A source and, after it, every header of ``csrc/`` it includes
    (``#include "..."``), recursively, each once."""
    seen = set() if seen is None else seen
    seen.add(path.name)
    src = path.read_bytes()
    out = src
    for inc in _INCLUDE.findall(src):
        name = inc.decode()
        if name not in seen:
            out += _source_bytes(CSRC / name, seen)
    return out


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}.{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES, *, force: bool = False) -> None:
    """Compile every named source whose library is missing (every one
    with ``force``): one ``nvcc`` per source, all started together.
    Raises with the compiler's output if any fails."""
    todo = [(name, library_path(name)) for name in names]
    todo = [(name, out) for name, out in todo if force or not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    failed = []
    with obs.span("kernels.build"):
        jobs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
        for name, proc, tmp, out in jobs:
            log = proc.communicate()[0]
            BUILD_LOGS[name] = log
            if proc.returncode != 0:
                failed.append(
                    f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def refuse_grad(name: str, *tensors) -> None:
    """Raise RuntimeError if, under ``torch.is_grad_enabled()``, any
    floating tensor of ``tensors`` requires grad.  Every wrapper whose
    kernel has no backward calls this on its CUDA path: its kernel fills
    a fresh output through ``ctypes``, so the gradient would be lost
    without a word (``flash_attention``, ``ssd_scan`` and
    ``rglru_scan`` go through their autograd Functions instead; their
    backward wrappers refuse a second derivative).  The CPU path (the differentiable plain
    version) does not call it."""
    import torch
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad
           for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           "it under torch.no_grad() or on inputs that do "
                           "not require grad")


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib``, built on first
    use, with its argument types declared (pointers and the stream as
    ``c_void_p``, so none is cut to 32 bits)."""
    fn = _FUNCS.get((lib, symbol))
    if fn is None:
        build((lib,))
        fn = getattr(ctypes.CDLL(str(library_path(lib))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(lib, symbol)] = fn
    return fn

