"""Checkpoints with atomic commits and keep-last-k, on the reference's
protocol (``repro/training/checkpoint.py``).

A checkpoint holds one ``.npy`` file a leaf, keyed by its path
(``params/layers/3/wqkv``, ``opt/mu/embed``, ``opt/step``; ``/``
becomes ``__`` in the file name), and a ``manifest.json`` with the step,
the caller's ``extra`` (the data pipeline's state) and each array's
file, dtype and shape.  A save writes into ``<dir>/tmp.<step>``, renames
it to ``<dir>/step_<step:08d>`` (atomic on POSIX), then prunes to the
last ``keep_last`` and removes any ``tmp.*`` left by a crashed write.
bfloat16, which numpy lacks, is stored as its 16-bit pattern.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import named_leaves
from repro_torch.training.optimizer import OptState

def _trees(params, opt_state) -> Dict[str, Any]:
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = {"step": opt_state.step, "mu": opt_state.mu,
                        "nu": opt_state.nu}
    return trees


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save(ckpt_dir: str, step: int, params, opt_state: OptState = None,
         extra: Optional[dict] = None, keep_last: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "extra": extra or {},
                                "arrays": {}}
    for prefix, tree in _trees(params, opt_state).items():
        for key, leaf in named_leaves(tree):
            name = f"{prefix}/{key}"
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), _to_numpy(leaf))
            manifest["arrays"][name] = {
                "file": fn, "dtype": str(leaf.dtype).removeprefix("torch."),
                "shape": list(leaf.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit

    _prune(ckpt_dir, keep_last)
    return final


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))
    for d in os.listdir(ckpt_dir):  # GC crashed partial writes
        if d.startswith("tmp."):
            shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, params_like,
            opt_like: OptState = None) -> Tuple[Any, Any, dict]:
    """Load checkpoint ``step`` into the templates: ``params_like`` (the
    port's parameters) and ``opt_like`` (an ``OptState`` of the same
    moment kind), each leaf copied in place on its own device.  Raises
    ValueError where a saved array's shape or dtype differs from its
    template's.  Returns (params, opt_state, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with torch.no_grad():
        for prefix, tree in _trees(params_like, opt_like).items():
            for key, leaf in named_leaves(tree):
                meta = manifest["arrays"][f"{prefix}/{key}"]
                want = (list(leaf.shape),
                        str(leaf.dtype).removeprefix("torch."))
                if (meta["shape"], meta["dtype"]) != want:
                    raise ValueError(
                        f"{prefix}/{key}: checkpoint holds {meta['shape']} "
                        f"{meta['dtype']}, the template {want[0]} {want[1]}")
                arr = torch.from_numpy(np.load(os.path.join(path,
                                                            meta["file"])))
                if meta["dtype"] == "bfloat16":
                    arr = arr.view(torch.bfloat16)
                leaf.copy_(arr)
    return params_like, opt_like, manifest["extra"]
