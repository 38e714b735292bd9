"""Public wrappers of the port's kernels and their launch counters.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its hand-written kernel for a tensor on the card (or raises);
it adds one to its ``launches`` count each time it launches the kernel,
and nowhere else.  On ``meta`` tensors, inside ``cost.counting()`` (the
dry-run, ``launch/dryrun.py``), it records its kernel's cost
(``kernels/cost.py``) and returns empty outputs; elsewhere ``meta``
raises.  ``flash_attention``, ``ssd_scan`` and ``rglru_scan``
have backward kernels (``flash_attention_bwd``, ``ssd_scan_bwd``,
``rglru_scan_bwd``, counted on their own), which autograd launches on
the card; every other wrapper raises under grad mode on an input that
requires grad (``build.refuse_grad``), the backward wrappers too.
All kernels are CUDA C++ for ``sm_90a``, one source each under
``csrc/``, built with ``nvcc`` and bound with ``ctypes``
(``kernels/build.py``); the four selection kernels share one source, and
each backward kernel its forward's, but for the SSD scan's, which
has its own (``csrc/ssd_scan_bwd.cu``, sharing ``csrc/ssd_train.cuh``
with the forward) so that the two build in parallel.

| wrapper            | kernel                          | replaces (reference ``kernels/``)            |
| ------------------ | ------------------------------- | -------------------------------------------- |
| ``flash_attention``  | ``csrc/flash_attention.cu``   | ``flash_attention.py`` ``_flash_kernel``         |
| ``flash_attention_bwd`` | ``csrc/flash_attention.cu`` | the reference's XLA autodiff of ``attention_full`` / ``attention_windowed`` (``models/attention.py``) |
| ``decode_attention`` | ``csrc/decode_attention.cu``  | ``decode_attention.py`` ``_decode_kernel``       |
| ``decode_attention_int8`` | ``csrc/decode_attention.cu`` | the reference's int8-cache decode step (``models/attention.py``: quantize and write the new token, dequantize, einsums) |
| ``ssd_scan``         | ``csrc/ssd_scan.cu``          | ``ssd_scan.py`` ``_ssd_kernel``                  |
| ``ssd_scan_bwd``     | ``csrc/ssd_scan_bwd.cu``      | the reference's XLA autodiff of ``ssd_chunked`` (``models/ssm.py``) |
| ``rglru_scan``       | ``csrc/rglru_scan.cu``        | ``rglru_scan.py`` ``_rglru_kernel``              |
| ``rglru_scan_bwd``   | ``csrc/rglru_scan.cu``        | the reference's XLA autodiff of ``rglru_scan_xla`` (``models/rglru.py``) |
| ``modipick_probs``   | ``csrc/policy_select.cu``     | ``policy_select.py`` ``_probs_kernel``           |
| ``fused_select``     | ``csrc/policy_select.cu``     | ``policy_select.py`` ``_fused_select`` (jnp)     |
| ``charged_select``   | ``csrc/policy_select.cu``     | ``policy_select.py`` ``_charged_step`` under ``lax.scan`` |
| ``stacked_select``   | ``csrc/policy_select.cu``     | ``policy_select.py`` ``_classed_select``, ``fleet_select_body`` (jnp) |
| ``adamw``            | ``csrc/adamw.cu``             | none: the reference's jnp AdamW step under jit (``training/optimizer.py`` ``adamw_update``) |

``adamw`` launches several kernels a call (a norm and a step a group of
leaves, one finish), each counted; the dry-run records one call.
``reset_launch_counts`` also zeroes ``adamw.UPDATES``, the elements
AdamW updated by path.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import ref
from repro_torch.kernels.adamw import adamw
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.policy_select import (charged_select, fused_select,
                                               modipick_probs, stacked_select)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

WRAPPERS = (flash_attention, decode_attention, decode_attention_int8,
            ssd_scan, rglru_scan, modipick_probs, fused_select,
            charged_select, stacked_select, flash_attention_bwd,
            rglru_scan_bwd, ssd_scan_bwd, adamw)
# The wrappers whose kernel has a backward kernel on the card: under grad
# mode they run their autograd Functions, and refuse_grad never sees them.
DIFFERENTIABLE = (flash_attention, ssd_scan, rglru_scan)


class ModelKernels(NamedTuple):
    """The kernel functions a forward pass calls, with the signatures of
    the wrappers of the same names."""
    flash_attention: Callable
    decode_attention: Callable
    ssd_scan: Callable
    rglru_scan: Callable
    decode_attention_int8: Callable


# The kernel wrappers: what the model runs.
KERNELS = ModelKernels(flash_attention, decode_attention, ssd_scan,
                       rglru_scan, decode_attention_int8)
# The plain versions on any device: what a check holds the model against.
PLAIN = ModelKernels(ref.flash_attention_ref, ref.decode_attention_ref,
                     ref.ssd_scan_ref, ref.rglru_scan_ref,
                     ref.decode_attention_int8_ref)


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    adamw_mod.UPDATES.update(fused=0, eager=0)
